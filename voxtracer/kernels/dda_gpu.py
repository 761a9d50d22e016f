"""Occupancy-bitmask traversal as one GPU kernel (Pallas, Triton route).

Same results as kernels/dda_occ.py — the XLA loop, which stays the CPU
path and the reference — computed in a different shape.  XLA runs
dda_occ's `lax.while_loop` over a [K, N] pair state that goes through
device memory on every outer iteration, and every lane iterates until the
slowest of all N rays is done.  Here each program owns one tile of
`block` rays and keeps their whole walk state in registers:

  * per-LANE sequential candidates: each ray walks its volumes in
    cube-entry-t order (sorted in XLA beforehand, `_sort_candidates`) and
    stops as soon as its best hit precedes the next candidate's entry;
  * the per-walk limit is min(t_limit, nextafter(best_t)), so an exact-t
    tie in a later candidate can still be recorded and then lose the
    earliest-original-volume tie-break (renderer.cpp:946-1018);
  * the brick-occupied bitmask and the 512-bit cell rows are read by
    direct gathers from the global tables (a few hundred KiB at V=4:
    they stay in L2), one word per fine step;
  * each program loops while ANY of its lanes is live, so a finished
    tile exits on its own;
  * the kernel writes only its results (hit, t, volume, material,
    normal) — no per-iteration state leaves the SM.

Modes: "nearest", "occluded" (renderer.cpp:209-243) and "exit" (the
per-ray FindMaterialExit / FindSmokeExit march through the ray's own
volume, renderer.cpp:1160-1179, 1265-1280).

Under a ray-sharded mesh (`ray_sharding`) the pallas_call runs inside
`shard_map` over the rays axis: XLA's partitioner cannot split a custom
call and would otherwise gather every ray onto each device.
"""

from __future__ import annotations

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton
from jax.sharding import PartitionSpec as P

from voxtracer.core.types import (MAT_NONE, OCC_ANY, OCC_EXIT_GLASS,
                                  OCC_EXIT_SMOKE)
from voxtracer.kernels.dda import BIG, BRICK, EXIT_SMOKE, F32, I32, _setup
from voxtracer.kernels.dda_occ import _entry_t, _normals_from, volume_table

BLOCK = 128      # rays per program: one lane per thread at 4 warps
INNER = 8        # fine cell steps per outer iteration
MAX_OUTER = 4096  # outer-iteration bound, a guard against a stuck walk
NUM_WARPS = 4

_RAY_MESH: list = []


@contextlib.contextmanager
def ray_sharding(mesh, axis: str):
    """Trace traversal calls inside this context with rays sharded over
    mesh axis `axis`: each device runs the kernel on its own ray shard."""
    _RAY_MESH.append((mesh, axis))
    try:
        yield
    finally:
        _RAY_MESH.pop()


def _brick_mask(occ):
    """[3, V, M^3, 16] cell rows -> brick-occupied bitmask words: bit
    (plane * V * M^3 + vol * M^3 + brick) is set iff that row is non-zero."""
    nz = jnp.any(occ != 0, axis=-1).reshape(-1).astype(I32)
    nz = jnp.pad(nz, (0, (-nz.shape[0]) % 32))
    shifts = jnp.arange(32, dtype=I32)[None, :]
    return jnp.sum(jnp.left_shift(nz.reshape(-1, 32), shifts), axis=1,
                   dtype=I32)


def _make_kernel(mode, v, vp, side, mside, block):
    is_exit = mode == "exit"
    is_occl = mode == "occluded"
    g3 = side ** 3
    m3 = mside ** 3

    def vconst(vtab_ref, c, vol):
        return vtab_ref[c * v + vol]

    def walk_consts(vtab_ref, vol, wo, wd):
        """Object ray, macro/fine DDA setups and box of volume `vol`."""
        iv = [vconst(vtab_ref, c, vol) for c in range(12)]
        bx, by, bz = (vconst(vtab_ref, 21, vol), vconst(vtab_ref, 22, vol),
                      vconst(vtab_ref, 23, vol))
        gs_f, ms_f = vconst(vtab_ref, 24, vol), vconst(vtab_ref, 25, vol)
        ox, oy, oz = wo
        dx, dy, dz = wd
        rdx = iv[0] * dx + iv[1] * dy + iv[2] * dz
        rdy = iv[4] * dx + iv[5] * dy + iv[6] * dz
        rdz = iv[8] * dx + iv[9] * dy + iv[10] * dz
        r = dict(ox=iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3],
                 oy=iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7],
                 oz=iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11],
                 dx=rdx, dy=rdy, dz=rdz,
                 rdx=1.0 / rdx, rdy=1.0 / rdy, rdz=1.0 / rdz,
                 sx=jnp.signbit(rdx).astype(F32),
                 sy=jnp.signbit(rdy).astype(F32),
                 sz=jnp.signbit(rdz).astype(F32))
        gs_i = gs_f.astype(I32)
        ms_i = ms_f.astype(I32)
        return dict(r=r, bx=bx, by=by, bz=bz, gs_f=gs_f, gs_i=gs_i,
                    ms_i=ms_i, sm=_setup(r, bx, by, bz, ms_f, ms_i),
                    sf=_setup(r, bx, by, bz, gs_f, gs_i))

    def fine_init_at(w, t):
        """Setup3DDDA position seeding (scene.cpp:736-745) at t."""
        r, gs_f, gs_i = w["r"], w["gs_f"], w["gs_i"]
        cellw = 1.0 / gs_f

        def axis(oc, dc, rdc, sc, b0):
            pos = gs_f * ((oc - b0) + (t + 5e-5) * dc)
            pln = (jnp.ceil(pos) - sc) * cellw
            p = jnp.clip(pos.astype(I32), 0, gs_i - 1)
            return p, (pln - (oc - b0)) * rdc

        px, tmx = axis(r["ox"], r["dx"], r["rdx"], r["sx"], w["bx"])
        py, tmy = axis(r["oy"], r["dy"], r["rdy"], r["sy"], w["by"])
        pz, tmz = axis(r["oz"], r["dz"], r["rdz"], r["sz"], w["bz"])
        return px, py, pz, tmx, tmy, tmz

    def pick_axis(tx, ty, tz):
        first = tx < ty
        ux = first & (tx < tz)
        uy = (~first) & (ty < tz)
        return ux, uy, ~(ux | uy)

    def walk_step(st, w, vol, plane, eff_tl, bm_ref, occ_ref):
        """One outer iteration of the two-level walk for every lane:
        brick test, descend, INNER fine steps, macro advance.  Mirrors
        dda_occ._core op for op.  Returns the updated walk state and
        this iteration's (hit, t, cell index) per lane."""
        walking = st["walking"] != 0
        level = st["level"] != 0
        gs_i, ms_i = w["gs_i"], w["ms_i"]
        sm, sf = w["sm"], w["sf"]
        midx = (st["mpx"] * mside + st["mpy"]) * mside + st["mpz"]
        row = (plane * v + vol) * m3 + midx
        bmw = bm_ref[row >> 5]
        occupied = (jnp.right_shift(bmw, row & 31) & 1) == 1
        at_m = walking & ~level
        descend = at_m & occupied
        skip = at_m & ~occupied

        fpx, fpy, fpz, ftmx, ftmy, ftmz = fine_init_at(w, st["t"])
        blox = st["mpx"] * BRICK
        bloy = st["mpy"] * BRICK
        bloz = st["mpz"] * BRICK
        fpx = jnp.clip(fpx, blox, jnp.minimum(blox + BRICK - 1, gs_i - 1))
        fpy = jnp.clip(fpy, bloy, jnp.minimum(bloy + BRICK - 1, gs_i - 1))
        fpz = jnp.clip(fpz, bloz, jnp.minimum(bloz + BRICK - 1, gs_i - 1))
        px = jnp.where(descend, fpx, st["px"])
        py = jnp.where(descend, fpy, st["py"])
        pz = jnp.where(descend, fpz, st["pz"])
        tmx = jnp.where(descend, ftmx, st["tmx"])
        tmy = jnp.where(descend, ftmy, st["tmy"])
        tmz = jnp.where(descend, ftmz, st["tmz"])

        act_f = walking & (level | descend)
        t = st["t"]
        t_out = st.get("t_out")
        hit = jnp.zeros_like(act_f)
        hit_t = jnp.zeros_like(t)
        hit_c = jnp.zeros_like(px)
        go_macro = jnp.zeros_like(act_f)
        word_base = row * 16
        for _ in range(INNER):
            b = ((px - blox) * 8 + (py - bloy)) * 8 + (pz - bloz)
            word = occ_ref[word_base + (b >> 5)]
            bit = (jnp.right_shift(word, b & 31) & 1) == 1
            pred = act_f & bit if is_exit else act_f & bit & (t < eff_tl)
            hit = hit | pred
            hit_t = jnp.where(pred, t, hit_t)
            hit_c = jnp.where(pred, (px * side + py) * side + pz, hit_c)
            act_f = act_f & ~pred

            ux, uy, uz = pick_axis(tmx, tmy, tmz)
            t_new = jnp.where(ux, tmx, jnp.where(uy, tmy, tmz))
            px = px + jnp.where(act_f & ux, sm["stx"], 0)
            py = py + jnp.where(act_f & uy, sm["sty"], 0)
            pz = pz + jnp.where(act_f & uz, sm["stz"], 0)
            moved = jnp.where(ux, px, jnp.where(uy, py, pz))
            out_grid = (moved < 0) | (moved >= gs_i)
            blo = jnp.where(ux, blox, jnp.where(uy, bloy, bloz))
            out_brick = (moved < blo) | (moved >= blo + BRICK)
            tmx = tmx + jnp.where(act_f & ux, sf["tdx"], 0.0)
            tmy = tmy + jnp.where(act_f & uy, sf["tdy"], 0.0)
            tmz = tmz + jnp.where(act_f & uz, sf["tdz"], 0.0)
            t = jnp.where(act_f, t_new, t)
            if is_exit:
                t_out = jnp.where(pred, hit_t, t_out)
                t_out = jnp.where(act_f & out_grid, t_new, t_out)
            else:
                act_f = act_f & (t_new < eff_tl)
            go_macro = go_macro | (act_f & out_brick & ~out_grid)
            act_f = act_f & ~out_grid & ~out_brick

        was_fine = level | descend
        do_m = skip | go_macro
        mx, my, mz = pick_axis(st["mtmx"], st["mtmy"], st["mtmz"])
        mt_new = jnp.where(mx, st["mtmx"], jnp.where(my, st["mtmy"],
                                                     st["mtmz"]))
        mpx = st["mpx"] + jnp.where(do_m & mx, sm["stx"], 0)
        mpy = st["mpy"] + jnp.where(do_m & my, sm["sty"], 0)
        mpz = st["mpz"] + jnp.where(do_m & mz, sm["stz"], 0)
        mmoved = jnp.where(mx, mpx, jnp.where(my, mpy, mpz))
        m_out = (mmoved < 0) | (mmoved >= ms_i)
        out = dict(
            st, px=px, py=py, pz=pz, tmx=tmx, tmy=tmy, tmz=tmz,
            mpx=mpx, mpy=mpy, mpz=mpz,
            mtmx=st["mtmx"] + jnp.where(do_m & mx, sm["tdx"], 0.0),
            mtmy=st["mtmy"] + jnp.where(do_m & my, sm["tdy"], 0.0),
            mtmz=st["mtmz"] + jnp.where(do_m & mz, sm["tdz"], 0.0),
            t=jnp.where(do_m, mt_new, t),
            level=(was_fine & act_f).astype(I32),
        )
        macro_end = do_m & m_out
        if is_exit:
            out["t_out"] = jnp.where(macro_end, mt_new, t_out)
        else:
            macro_end = macro_end | (do_m & ~(mt_new < eff_tl))
        fine_end = was_fine & ~act_f & ~go_macro
        out["walking"] = (walking & ~fine_end & ~macro_end).astype(I32)
        return out, hit, hit_t, hit_c

    def normals(vtab_ref, vol, wo, t):
        w = walk_consts(vtab_ref, vol, wo[:3], wo[3:])
        fw = tuple(vconst(vtab_ref, 12 + c, vol) for c in range(9))
        return _normals_from(w["r"], w["gs_f"], fw, t)

    def live(st):
        return jnp.max(st["walking"] | (1 - st["done"])) > 0

    def exit_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, act_ref,
                    vol_ref, plane_ref, vtab_ref, bm_ref, occ_ref, grid_ref,
                    inv_ref, t_ref, cell_ref, nx_ref, ny_ref, nz_ref):
        wo = (ox_ref[...], oy_ref[...], oz_ref[...])
        wd = (dx_ref[...], dy_ref[...], dz_ref[...])
        vol = jnp.clip(vol_ref[...], 0, v - 1)
        plane = plane_ref[...]
        w = walk_consts(vtab_ref, vol, wo, wd)
        sm = w["sm"]
        valid = sm["valid"]
        zi = jnp.zeros_like(vol)
        st = dict(
            walking=((act_ref[...] != 0) & valid).astype(I32), level=zi,
            done=jnp.ones_like(vol), in_vol=zi, cidx=zi,
            t=sm["t0"], t_out=jnp.where(valid, sm["t0"], 0.0),
            px=w["sf"]["px"], py=w["sf"]["py"], pz=w["sf"]["pz"],
            tmx=w["sf"]["tmx"], tmy=w["sf"]["tmy"], tmz=w["sf"]["tmz"],
            mpx=sm["px"], mpy=sm["py"], mpz=sm["pz"],
            mtmx=sm["tmx"], mtmy=sm["tmy"], mtmz=sm["tmz"],
            outer=jnp.int32(0))

        def body(st):
            st, hit, _, hit_c = walk_step(st, w, vol, plane, None, bm_ref,
                                          occ_ref)
            st["in_vol"] = st["in_vol"] | hit.astype(I32)
            st["cidx"] = jnp.where(hit, hit_c, st["cidx"])
            st["outer"] = st["outer"] + 1
            return st

        st = jax.lax.while_loop(
            lambda s: live(s) & (s["outer"] < MAX_OUTER), body, st)
        in_v = st["in_vol"] != 0
        nx, ny, nz = normals(vtab_ref, vol, wo + wd, st["t_out"])
        inv_ref[...] = st["in_vol"]
        t_ref[...] = st["t_out"]
        cell_ref[...] = jnp.where(in_v, grid_ref[vol * g3 + st["cidx"]],
                                  MAT_NONE)
        nx_ref[...] = jnp.where(in_v, nx, 0.0)
        ny_ref[...] = jnp.where(in_v, ny, 0.0)
        nz_ref[...] = jnp.where(in_v, nz, 0.0)

    def walk_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tl_ref,
                    act_ref, ct_ref, cid_ref, vtab_ref, bm_ref, occ_ref,
                    grid_ref, *out_refs):
        wo = (ox_ref[...], oy_ref[...], oz_ref[...])
        wd = (dx_ref[...], dy_ref[...], dz_ref[...])
        tl = tl_ref[...]
        zi = jnp.zeros(tl.shape, I32)
        zf = jnp.zeros(tl.shape, F32)
        st = dict(
            done=(act_ref[...] == 0).astype(I32), walking=zi, level=zi,
            best_hit=zi, best_t=jnp.full(tl.shape, BIG, F32),
            best_vol=jnp.full(tl.shape, -2, I32), best_c=zi,
            k=zi, vol=zi, eff_tl=zf,
            t=zf, px=zi, py=zi, pz=zi, tmx=zf, tmy=zf, tmz=zf,
            mpx=zi, mpy=zi, mpz=zi, mtmx=zf, mtmy=zf, mtmz=zf,
            outer=jnp.int32(0))

        def body(st):
            st = dict(st)
            # ---- candidate switch for lanes between walks
            need = (st["done"] == 0) & (st["walking"] == 0)
            k = st["k"]
            ci = jnp.arange(block, dtype=I32) * vp + jnp.minimum(k, v - 1)
            t0_k = ct_ref[ci]
            vid_k = cid_ref[ci]
            best_t = st["best_t"]
            bound = jnp.minimum(tl, jnp.nextafter(best_t, BIG))
            ok = (need & (k < v) & (t0_k < 1e33)
                  & (t0_k <= jnp.minimum(tl, best_t)))
            st["done"] = st["done"] | (need & ~ok).astype(I32)
            st["k"] = jnp.where(ok, k + 1, k)
            vol = jnp.where(ok, vid_k, st["vol"])
            st["vol"] = vol
            w = walk_consts(vtab_ref, vol, wo, wd)
            sm = w["sm"]
            start = ok & sm["valid"] & (sm["t0"] < bound)
            st["walking"] = st["walking"] | start.astype(I32)
            st["level"] = jnp.where(start, 0, st["level"])
            st["eff_tl"] = jnp.where(ok, bound, st["eff_tl"])
            st["t"] = jnp.where(start, sm["t0"], st["t"])
            for nm in ("px", "py", "pz", "tmx", "tmy", "tmz"):
                st["m" + nm] = jnp.where(start, sm[nm], st["m" + nm])

            # ---- walk
            st, hit, hit_t, hit_c = walk_step(st, w, vol, OCC_ANY,
                                              st["eff_tl"], bm_ref, occ_ref)

            # ---- merge into the per-ray best, (t, volume) tie-break
            if is_occl:
                st["best_hit"] = st["best_hit"] | hit.astype(I32)
                st["done"] = st["done"] | hit.astype(I32)
            else:
                had = st["best_hit"] != 0
                better = hit & (~had | (hit_t < st["best_t"])
                                | ((hit_t == st["best_t"])
                                   & (vol < st["best_vol"])))
                st["best_hit"] = st["best_hit"] | better.astype(I32)
                st["best_t"] = jnp.where(better, hit_t, st["best_t"])
                st["best_vol"] = jnp.where(better, vol, st["best_vol"])
                st["best_c"] = jnp.where(better, hit_c, st["best_c"])
            st["outer"] = st["outer"] + 1
            return st

        st = jax.lax.while_loop(
            lambda s: live(s) & (s["outer"] < MAX_OUTER), body, st)
        h = st["best_hit"] != 0
        out_refs[0][...] = st["best_hit"]
        if is_occl:
            return
        hit_ref, t_ref, vol_ref, cell_ref, nx_ref, ny_ref, nz_ref = out_refs
        volw = jnp.maximum(st["best_vol"], 0)
        nx, ny, nz = normals(vtab_ref, volw, wo + wd, st["best_t"])
        t_ref[...] = jnp.where(h, st["best_t"], BIG)
        vol_ref[...] = jnp.where(h, st["best_vol"], -2)
        cell_ref[...] = jnp.where(h, grid_ref[volw * g3 + st["best_c"]],
                                  MAT_NONE)
        nx_ref[...] = jnp.where(h, nx, 0.0)
        ny_ref[...] = jnp.where(h, ny, 0.0)
        nz_ref[...] = jnp.where(h, nz, 0.0)

    return exit_kernel if is_exit else walk_kernel


def _bitonic_pairs(v):
    """Compare-exchange pairs (a, b), a < b, of a bitonic sorting network
    over `v` entries, in the form where every pair puts the smaller entry
    at `a`.  Entries past `v` count as +inf, so pairs that reach past `v`
    never swap and are dropped: O(V log^2 V) pairs for any V."""
    pairs = []
    p = 1
    while p < v:
        for lo in range(0, v, 2 * p):         # merge: mirrored partners
            pairs += [(lo + i, lo + 2 * p - 1 - i) for i in range(p)
                      if lo + 2 * p - 1 - i < v]
        q = p // 2
        while q:                               # then half-cleaners
            for lo in range(0, v, 2 * q):
                pairs += [(lo + i, lo + i + q) for i in range(q)
                          if lo + i + q < v]
            q //= 2
        p *= 2
    return pairs


def _sort_candidates(t0):
    """Per-ray volume order by (entry t, volume id): [V, N] entry t ->
    ([N, V] sorted t, [N, V] volume ids).

    A bitonic network of compare-exchanges: elementwise work that XLA
    fuses into one pass over the rays (XLA's sort along the short volume
    axis cost more than the kernel it feeds)."""
    v, n = t0.shape
    ts = [t0[i] for i in range(v)]
    ids = [jnp.full((n,), i, I32) for i in range(v)]
    for a, b in _bitonic_pairs(v):
        swap = (ts[b] < ts[a]) | ((ts[b] == ts[a]) & (ids[b] < ids[a]))
        ts[a], ts[b] = (jnp.where(swap, ts[b], ts[a]),
                        jnp.where(swap, ts[a], ts[b]))
        ids[a], ids[b] = (jnp.where(swap, ids[b], ids[a]),
                          jnp.where(swap, ids[a], ids[b]))
    return jnp.stack(ts, axis=1), jnp.stack(ids, axis=1)


def _pad(x, n, fill=0):
    return jnp.pad(x, (0, n - x.shape[0]), constant_values=fill)


def _traverse_local(tables, rays, *, mode, v, vp, side, mside, block,
                    interpret):
    """pallas_call over rays whose count is a multiple of `block`."""
    n = rays[0].shape[0]
    kernel = _make_kernel(mode, v, vp, side, mside, block)
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    n_ray_in = 8 if mode != "exit" else 9
    in_specs = [ray_spec] * n_ray_in
    if mode != "exit":  # per-ray candidate lists [n * vp]
        in_specs += [pl.BlockSpec((block * vp,), lambda i: (i,))] * 2
    in_specs += [pl.BlockSpec(x.shape, lambda i: (0,)) for x in tables]
    if mode == "occluded":
        out_dts = [I32]
    elif mode == "exit":
        out_dts = [I32, F32, I32, F32, F32, F32]
    else:
        out_dts = [I32, F32, I32, I32, F32, F32, F32]
    return pl.pallas_call(
        kernel,
        grid=(n // block,),
        in_specs=in_specs,
        out_specs=[ray_spec] * len(out_dts),
        out_shape=[jax.ShapeDtypeStruct((n,), dt) for dt in out_dts],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name=f"dda_{mode}",
    )(*rays, *tables)


def traverse(*args, **kwargs):
    """Drop-in for dda_occ.traverse_occ_topk (nearest / occluded) and
    dda_occ.traverse_occ (exit): same arguments, same per-ray dicts.
    Extra keywords: block (rays per program), interpret (run the kernel
    through the Pallas interpreter, for CPU tests)."""
    mesh_axis = _RAY_MESH[-1] if _RAY_MESH else None
    return _traverse(*args, mesh_axis=mesh_axis, **kwargs)


@partial(jax.jit, static_argnames=("mode", "block", "interpret",
                                   "mesh_axis"))
def _traverse(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit,
              ray_active, vol_enabled, occ, bricksize, mode="nearest",
              mode_code=None, vol_match=None, block=BLOCK, interpret=False,
              mesh_axis=None):
    assert mode in ("nearest", "occluded", "exit")
    v = gridsize.shape[0]
    n = o.shape[0]
    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    mside = round(occ.shape[2] ** (1.0 / 3.0))
    vp = 1 << max(v - 1, 0).bit_length()

    shards = mesh_axis[0].shape[mesh_axis[1]] if mesh_axis else 1
    npad = -(-n // (block * shards)) * (block * shards)

    rays = [_pad(o[:, 0], npad), _pad(o[:, 1], npad), _pad(o[:, 2], npad),
            _pad(d[:, 0], npad, 1.0), _pad(d[:, 1], npad, 1.0),
            _pad(d[:, 2], npad, 1.0)]
    act = _pad(ray_active.astype(I32), npad)
    if mode == "exit":
        plane = jnp.where(mode_code == EXIT_SMOKE, OCC_EXIT_SMOKE,
                          OCC_EXIT_GLASS).astype(I32)
        rays += [act, _pad(vol_match.astype(I32), npad), _pad(plane, npad)]
    else:
        # per-ray candidates by (entry t, volume id), [npad, vp] row-major
        t0 = _entry_t(inv, cube_min, o, d)
        t0 = jnp.where(vol_enabled[:, None], t0, BIG)
        t0 = jnp.where(jnp.isnan(t0), BIG, t0)
        t0, ids = _sort_candidates(t0)
        cand_t = jnp.pad(t0, ((0, npad - n), (0, vp - v)),
                         constant_values=BIG).reshape(-1)
        cand_id = jnp.pad(ids, ((0, npad - n), (0, vp - v))).reshape(-1)
        rays += [_pad(t_limit, npad, BIG), act, cand_t, cand_id]
    # per-volume constants, row-major: row c of volume v at c * V + v
    vtab = volume_table(inv, fwd, cube_min, gridsize, bricksize)
    tables = [vtab.T.reshape(-1), _brick_mask(occ), occ.reshape(-1),
              grids_flat.astype(I32)]

    local = partial(_traverse_local, mode=mode, v=v, vp=vp, side=side,
                    mside=mside, block=block, interpret=interpret)
    if mesh_axis is not None:
        mesh, axis = mesh_axis
        local = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                              out_specs=P(axis), check_vma=False)
    outs = [x[:n] for x in local(tables, rays)]

    sg = jax.lax.stop_gradient
    if mode == "occluded":
        return dict(hit=sg(outs[0] != 0))
    if mode == "exit":
        in_v, t, cell, nx, ny, nz = outs
        return dict(in_vol=sg(in_v != 0), t=sg(t), cell=sg(cell), nx=sg(nx),
                    ny=sg(ny), nz=sg(nz))
    hit, t, vol, cell, nx, ny, nz = outs
    return dict(hit=sg(hit != 0), t=sg(t), cell=sg(cell), vol=sg(vol),
                nx=sg(nx), ny=sg(ny), nz=sg(nz))
