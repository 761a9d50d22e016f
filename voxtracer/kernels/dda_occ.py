"""Occupancy-bitmask wavefront DDA — the gather-starved traversal.

Second-generation traversal (same semantics as kernels/dda.py's brick
variant, which remains the oracle-adjacent fallback for the dynamic
skip-range modes).  This is the XLA path: the CPU runs it, and it is the
reference the GPU kernel (kernels/dda_gpu.py) is tested against.

 * The v1 kernel's cost is per-step cell gathers over all ray x volume
   pairs, lockstep to the worst pair.
 * A 2-D **row gather** (``take(table[T,16], idx, axis=0)``) returns 16
   int32 = the full 512-bit occupancy of an 8^3 brick in one fetch.
 * Register bit tests + a 16-way where-tree select are a few elementwise
   ops — once a brick's bits are in registers, cell stepping needs no
   gather.

Loop structure: one outer iteration = ONE occupancy row fetch per pair
(serving both levels: macro pairs test brick emptiness, fine pairs read
their current brick's bits), then a macro DDA step for pairs over empty
bricks, a descend for pairs entering occupied bricks, and up to INNER
unrolled gather-free cell steps for fine pairs.  Gathers per pair drop
from one per cell crossed to one per brick crossed.

Because the loop is lockstep, per-iteration cost is proportional to the
PAIR COUNT, dead or alive.  ``traverse_occ_topk`` therefore compacts
[V, N] pairs to the K nearest-entry candidate volumes per ray (per-pair
transforms re-gathered from a packed constants table), with fallback
rounds for rays whose hit isn't proven before their (K+1)-th candidate —
the earliest-entry ordering makes each round's result conclusive for
rays whose best hit precedes the next round's entry t.  This realizes the
reference's dormant TLAS intent (BasicBVH, renderer.h:220) as data
culling rather than tree walking.

Semantics parity: identical to dda.traverse with bricks (t updated to the
crossing before bounds checks, earliest-volume tie wins, NaN axis-pick
behavior, stop_gradient'ed outputs).  Reference call stack being replaced:
Scene::FindNearest / FindMaterialExit / FindSmokeExit / IsOccluded
(scene.cpp:719-1047) under Renderer::FindNearest's instance loop
(renderer.cpp:946-1018).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from voxtracer.core.types import MAT_NONE, OCC_EXIT_GLASS, OCC_EXIT_SMOKE
from voxtracer.kernels.dda import (
    BIG,
    BRICK,
    EXIT_SMOKE,
    F32,
    I32,
    _object_rays,
    _pick_axis,
    _setup,
)

INNER = 8  # gather-free fine steps per outer iteration


def _tree16(words, w):
    """Select words[w] per lane from 16 [P, N] arrays via a where-tree
    (elementwise selects instead of a take_along_axis gather)."""
    sel = list(words)
    for k in range(4):
        bit = (w >> k) & 1
        sel = [jnp.where(bit == 1, sel[2 * j + 1], sel[2 * j])
               for j in range(len(sel) // 2)]
    return sel[0]


def _normals_from(r, gs_f, fwd_rows, t):
    """GetNormalVoxel (scene.cpp:121-148) with PER-PAIR forward-matrix
    components fwd_rows = 9 arrays m00..m22 (broadcastable to t)."""
    def frac(o, dc):
        i1 = (o + t * dc) * gs_f
        fg = i1 - jnp.floor(i1)
        return jnp.minimum(fg, 1.0 - fg)

    ddx = frac(r["ox"], r["dx"])
    ddy = frac(r["oy"], r["dy"])
    ddz = frac(r["oz"], r["dz"])
    mind = jnp.minimum(ddx, jnp.minimum(ddy, ddz))
    nx = jnp.where(ddx == mind, r["sx"] * 2.0 - 1.0, 0.0)
    ny = jnp.where(ddy == mind, r["sy"] * 2.0 - 1.0, 0.0)
    nz = jnp.where(ddz == mind, r["sz"] * 2.0 - 1.0, 0.0)
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = fwd_rows
    wx = m00 * nx + m01 * ny + m02 * nz
    wy = m10 * nx + m11 * ny + m12 * nz
    wz = m20 * nx + m21 * ny + m22 * nz
    inv_len = jax.lax.rsqrt(jnp.maximum(wx * wx + wy * wy + wz * wz, 1e-20))
    return wx * inv_len, wy * inv_len, wz * inv_len


def _core(r, c, occ_flat, tl, active0, mode, inner, max_outer):
    """The fetch/descend/step loop over per-pair SoA state.

    r: object-space ray components dict (shapes [P, N]).
    c: per-pair constants — bx/by/bz, gs_f, gs_i, ms_f, ms_i (broadcastable
       to [P, N]), cell_base, occ_base (int, cell/occ-row index offsets).
    Returns the final loop state (per-pair hit/t_hit/gidx/in_vol/t_out).
    """
    is_exit = mode == "exit"
    bx, by, bz = c["bx"], c["by"], c["bz"]
    gs_f, gs_i = c["gs_f"], c["gs_i"]
    ms_i = c["ms_i"]
    side = c["side"]
    mside = c["mside"]
    cellw = 1.0 / gs_f

    s = _setup(r, bx, by, bz, gs_f, gs_i)      # fine-level consts
    sm = _setup(r, bx, by, bz, c["ms_f"], ms_i)  # macro level
    valid = sm["valid"]
    t0 = sm["t0"]

    if is_exit:
        active0 = active0 & valid
    else:
        active0 = active0 & valid & (t0 < tl)

    def fine_init_at(t):
        """Setup3DDDA position seeding (scene.cpp:736-745) at parameter t."""
        def axis(oc, dc, rdc, sc, b0):
            pos = gs_f * ((oc - b0) + (t + 5e-5) * dc)
            pln = (jnp.ceil(pos) - sc) * cellw
            p = jnp.clip(pos.astype(I32), 0, gs_i - 1)
            tm = (pln - (oc - b0)) * rdc
            return p, tm

        px, tmx = axis(r["ox"], r["dx"], r["rdx"], r["sx"], bx)
        py, tmy = axis(r["oy"], r["dy"], r["rdy"], r["sy"], by)
        pz, tmz = axis(r["oz"], r["dz"], r["rdz"], r["sz"], bz)
        return px, py, pz, tmx, tmy, tmz

    shape = active0.shape
    state = dict(
        t=t0, active=active0, level=jnp.zeros(shape, bool),
        hit=jnp.zeros(shape, bool),
        t_hit=jnp.zeros(shape, F32),
        gidx=jnp.zeros(shape, I32),
        in_vol=jnp.zeros(shape, bool),
        t_out=jnp.where(valid, t0, 0.0),
        px=s["px"], py=s["py"], pz=s["pz"],
        tmx=s["tmx"], tmy=s["tmy"], tmz=s["tmz"],
        mpx=sm["px"], mpy=sm["py"], mpz=sm["pz"],
        mtmx=sm["tmx"], mtmy=sm["tmy"], mtmz=sm["tmz"],
        outer=jnp.int32(0),
    )
    stx, sty, stz = s["stx"], s["sty"], s["stz"]

    def body(st):
        # ---- cross-pair pruning: a ray's best recorded hit bounds every
        # one of its pairs (ordered-traversal effect without ordering);
        # for occlusion any hit retires the whole ray.  Strictly-greater
        # pruning keeps exact-t ties alive so the earliest-volume
        # tie-break stays bit-identical to the v1 kernel.
        if mode == "occluded":
            ray_done = jnp.any(st["hit"], axis=0)
            st = dict(st, active=st["active"] & ~ray_done[None, :])
        elif not is_exit:
            best = jnp.min(jnp.where(st["hit"], st["t_hit"], BIG), axis=0)
            st = dict(st, active=st["active"] & (st["t"] <= best[None, :]))

        # ---- ONE row fetch per pair: current brick's 512 occupancy bits.
        # Macro pairs use it for the empty test; fine pairs for bit tests
        # (their macro position still points at the brick they walk).
        midx = (st["mpx"] * mside + st["mpy"]) * mside + st["mpz"]
        rows_idx = c["occ_base"] + midx
        rows = jnp.take(occ_flat, rows_idx.reshape(-1), axis=0, mode="clip")
        words = tuple(rows[:, k].reshape(shape) for k in range(16))
        nonempty = words[0]
        for k in range(1, 16):
            nonempty = nonempty | words[k]
        occupied = nonempty != 0

        act_m = st["active"] & ~st["level"]
        descend = act_m & occupied
        skip = act_m & ~occupied

        # ---- descend: (re)seed fine DDA at t, clamp into the brick
        fpx, fpy, fpz, ftmx, ftmy, ftmz = fine_init_at(st["t"])
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

        # ---- gather-free fine steps
        act_f = st["active"] & (st["level"] | descend)
        t = st["t"]
        t_out = st["t_out"]
        hit, t_hit, gidx = st["hit"], st["t_hit"], st["gidx"]
        in_vol = st["in_vol"]
        go_macro = jnp.zeros_like(act_f)
        for _ in range(inner):
            b = ((px - blox) * 8 + (py - bloy)) * 8 + (pz - bloz)
            word = _tree16(words, b >> 5)
            bit = (jnp.right_shift(word, b & 31) & 1) == 1
            if is_exit:
                pred = act_f & bit
            else:
                pred = act_f & bit & (t < tl)
            hit = hit | pred
            t_hit = jnp.where(pred, t, t_hit)
            gidx = jnp.where(pred,
                             c["cell_base"] + (px * side + py) * side + pz,
                             gidx)
            if is_exit:
                in_vol = in_vol | pred
                t_out = jnp.where(pred, t, t_out)
            act_f = act_f & ~pred

            use_x, use_y, use_z = _pick_axis(tmx, tmy, tmz)
            t_new = jnp.where(use_x, tmx, jnp.where(use_y, tmy, tmz))
            px = px + jnp.where(act_f & use_x, stx, 0)
            py = py + jnp.where(act_f & use_y, sty, 0)
            pz = pz + jnp.where(act_f & use_z, stz, 0)
            moved = jnp.where(use_x, px, jnp.where(use_y, py, pz))
            out_grid = (moved < 0) | (moved >= gs_i)
            blo = jnp.where(use_x, blox, jnp.where(use_y, bloy, bloz))
            out_brick = (moved < blo) | (moved >= blo + BRICK)
            tmx = tmx + jnp.where(act_f & use_x, s["tdx"], 0.0)
            tmy = tmy + jnp.where(act_f & use_y, s["tdy"], 0.0)
            tmz = tmz + jnp.where(act_f & use_z, s["tdz"], 0.0)
            t = jnp.where(act_f, t_new, t)
            if not is_exit:
                act_f = act_f & (t_new < tl)
            if is_exit:
                t_out = jnp.where(act_f & out_grid, t_new, t_out)
            leave = act_f & out_brick & ~out_grid
            go_macro = go_macro | leave
            act_f = act_f & ~out_grid & ~out_brick

        # terminated fine pairs (hit or fell off grid or over t-limit) are
        # exactly those that were fine, aren't stepping on, and aren't
        # handing back to the macro walk
        was_fine = st["level"] | descend
        active = jnp.where(was_fine, act_f | go_macro, st["active"])
        level = was_fine & act_f

        # ---- macro advance: empty-brick skips + fine walks that left
        do_m = skip | go_macro
        mx, my, mz = _pick_axis(st["mtmx"], st["mtmy"], st["mtmz"])
        mt_new = jnp.where(mx, st["mtmx"], jnp.where(my, st["mtmy"], st["mtmz"]))
        mpx = st["mpx"] + jnp.where(do_m & mx, stx, 0)
        mpy = st["mpy"] + jnp.where(do_m & my, sty, 0)
        mpz = st["mpz"] + jnp.where(do_m & mz, stz, 0)
        mmoved = jnp.where(mx, mpx, jnp.where(my, mpy, mpz))
        m_out = (mmoved < 0) | (mmoved >= ms_i)
        mtmx = st["mtmx"] + jnp.where(do_m & mx, sm["tdx"], 0.0)
        mtmy = st["mtmy"] + jnp.where(do_m & my, sm["tdy"], 0.0)
        mtmz = st["mtmz"] + jnp.where(do_m & mz, sm["tdz"], 0.0)
        t = jnp.where(do_m, mt_new, t)
        if is_exit:
            t_out = jnp.where(do_m & m_out, mt_new, t_out)
        active = active & ~(do_m & m_out)
        if not is_exit:
            active = active & ~(do_m & ~(mt_new < tl))

        return dict(
            t=t, active=active, level=level, hit=hit, t_hit=t_hit,
            gidx=gidx, in_vol=in_vol, t_out=t_out,
            px=px, py=py, pz=pz, tmx=tmx, tmy=tmy, tmz=tmz,
            mpx=mpx, mpy=mpy, mpz=mpz, mtmx=mtmx, mtmy=mtmy, mtmz=mtmz,
            outer=st["outer"] + 1,
        )

    def cond(st):
        return jnp.any(st["active"]) & (st["outer"] < max_outer)

    return jax.lax.while_loop(cond, body, state)


@partial(jax.jit, static_argnames=("mode", "max_outer", "inner"))
def traverse_occ(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit,
                 ray_active, vol_enabled, occ, bricksize,
                 mode="nearest", mode_code=None, vol_match=None,
                 max_outer=1024, inner=INNER):
    """Fused all-rays x all-volumes traversal over occupancy bitmasks.

    occ: [3, V, M^3, 16] int32 (core.types.OCC_* planes).
    Returns the same per-ray dicts as dda.traverse for the matching mode.
    """
    v = gridsize.shape[0]
    n = o.shape[0]
    is_exit = mode == "exit"

    r = _object_rays(inv, o, d)

    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    assert side ** 3 == g3, "grids must be padded cubes"
    m3 = occ.shape[2]
    mside = round(m3 ** (1.0 / 3.0))
    assert mside ** 3 == m3, "occ must be padded cubes"
    occ_flat = occ.reshape(3 * v * m3, 16)
    macro_base = (jnp.arange(v, dtype=I32) * m3)[:, None]
    if is_exit:
        plane = jnp.where(mode_code[None, :] == EXIT_SMOKE,
                          OCC_EXIT_SMOKE, OCC_EXIT_GLASS).astype(I32) * (v * m3)
        match = vol_match[None, :] == jnp.arange(v, dtype=I32)[:, None]

    c = dict(
        bx=cube_min[:, 0][:, None], by=cube_min[:, 1][:, None],
        bz=cube_min[:, 2][:, None],
        gs_f=gridsize.astype(F32)[:, None], gs_i=gridsize[:, None],
        ms_f=bricksize.astype(F32)[:, None], ms_i=bricksize[:, None],
        side=jnp.int32(side), mside=jnp.int32(mside),
        cell_base=(jnp.arange(v, dtype=I32) * g3)[:, None],
        occ_base=(plane + macro_base) if is_exit else macro_base,
    )

    tl = t_limit[None, :]
    if is_exit:
        active0 = ray_active[None, :] & match
    else:
        active0 = ray_active[None, :] & vol_enabled[:, None]

    st = _core(r, c, occ_flat, tl, active0, mode, inner, max_outer)
    sg = jax.lax.stop_gradient
    gs_f = c["gs_f"]

    if mode == "occluded":
        return dict(hit=sg(jnp.any(st["hit"], axis=0)))

    fwd_rows = tuple(fwd[:, i, j][:, None] for i in range(3) for j in range(3))

    if is_exit:
        nx, ny, nz = _normals_from(r, gs_f, fwd_rows, st["t_out"])
        pick = lambda a: sg(jnp.sum(jnp.where(match, a, 0), axis=0))
        gidx_ray = pick(jnp.where(st["in_vol"], st["gidx"], 0)).astype(I32)
        cell = jnp.take(grids_flat, gidx_ray, mode="clip")
        in_v = sg(jnp.any(st["in_vol"] & match, axis=0))
        return dict(
            in_vol=in_v,
            t=pick(st["t_out"]),
            cell=sg(jnp.where(in_v, cell, MAT_NONE)),
            nx=pick(jnp.where(st["in_vol"], nx, 0.0)),
            ny=pick(jnp.where(st["in_vol"], ny, 0.0)),
            nz=pick(jnp.where(st["in_vol"], nz, 0.0)),
        )

    # nearest: merge volumes, earliest volume wins ties (argmin is first-min)
    t_pair = jnp.where(st["hit"], st["t_hit"], BIG)
    win = jnp.argmin(t_pair, axis=0)  # [N]
    winm = win[None, :] == jnp.arange(v, dtype=I32)[:, None]
    nx, ny, nz = _normals_from(r, gs_f, fwd_rows, st["t_hit"])
    pick = lambda a, zero: sg(jnp.sum(jnp.where(winm & st["hit"], a, zero),
                                      axis=0))
    any_hit = jnp.any(st["hit"], axis=0)
    gidx_ray = pick(st["gidx"], 0).astype(I32)
    mat = jnp.take(grids_flat, gidx_ray, mode="clip")
    return dict(
        hit=sg(any_hit),
        t=sg(jnp.where(any_hit, jnp.min(t_pair, axis=0), BIG)),
        cell=sg(jnp.where(any_hit, mat, MAT_NONE)),
        vol=sg(jnp.where(any_hit, win, -2)),
        nx=pick(nx, 0.0), ny=pick(ny, 0.0), nz=pick(nz, 0.0),
    )


def volume_table(inv, fwd, cube_min, gridsize, bricksize):
    """Packed per-volume constants [V, 26]: 12 inv, 9 fwd, 3 cube_min,
    gridsize, bricksize."""
    v = gridsize.shape[0]
    return jnp.concatenate([
        inv[:, :3, :].reshape(v, 12),
        fwd[:, :3, :3].reshape(v, 9),
        cube_min,
        gridsize.astype(F32)[:, None],
        bricksize.astype(F32)[:, None],
    ], axis=1)


def _entry_t(inv, cube_min, o, d):
    """Per-pair cube entry t [V, N] (BIG on miss) + the object rays dict —
    the candidate-selection key for top-K compaction."""
    from voxtracer.kernels.dda import _slab_entry

    r = _object_rays(inv, o, d)
    bx = cube_min[:, 0][:, None]
    by = cube_min[:, 1][:, None]
    bz = cube_min[:, 2][:, None]
    inside = ((r["ox"] >= bx) & (r["ox"] <= bx + 1.0)
              & (r["oy"] >= by) & (r["oy"] <= by + 1.0)
              & (r["oz"] >= bz) & (r["oz"] <= bz + 1.0))
    t0 = jnp.where(inside, 0.0, _slab_entry(bx, by, bz, r))
    return t0


@partial(jax.jit, static_argnames=("mode", "max_outer", "inner", "k"))
def traverse_occ_topk(grids_flat, gridsize, inv, fwd, cube_min, o, d,
                      t_limit, ray_active, vol_enabled, occ, bricksize,
                      mode="nearest", k=2, max_outer=1024, inner=INNER):
    """Nearest/occluded traversal over PAIR-COMPACTED candidates.

    Per ray, only the k volumes with earliest cube-entry t traverse per
    round; a next round runs only for rays whose result isn't conclusive
    (no hit at or before the next candidate's entry).  Lockstep cost per
    iteration drops from V x N to k x N.  Semantics match traverse_occ
    (earliest-ORIGINAL-volume tie-break preserved explicitly)."""
    v = gridsize.shape[0]
    n = o.shape[0]
    assert mode in ("nearest", "occluded")
    if k >= v:
        return traverse_occ(grids_flat, gridsize, inv, fwd, cube_min, o, d,
                            t_limit, ray_active, vol_enabled, occ, bricksize,
                            mode=mode, max_outer=max_outer, inner=inner)

    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    m3 = occ.shape[2]
    mside = round(m3 ** (1.0 / 3.0))
    occ_flat = occ.reshape(3 * v * m3, 16)

    # ---- candidate selection: per-ray (entry t, vol id) ascending
    t0_all = _entry_t(inv, cube_min, o, d)  # [V, N]
    t0_all = jnp.where(vol_enabled[:, None], t0_all, BIG)
    t0_all = jnp.where(jnp.isnan(t0_all), BIG, t0_all)
    ids = jnp.broadcast_to(jnp.arange(v, dtype=I32)[:, None], (v, n))
    t0_sorted, id_sorted = jax.lax.sort((t0_all, ids), dimension=0,
                                        num_keys=1)

    vtab = volume_table(inv, fwd, cube_min, gridsize, bricksize)

    rounds = -(-v // k)
    tl = t_limit[None, :]
    sg = jax.lax.stop_gradient

    # running per-ray best
    best = dict(
        hit=jnp.zeros(n, bool), t=jnp.full(n, BIG, F32),
        vol=jnp.full(n, -2, I32), gidx=jnp.zeros(n, I32),
        nx=jnp.zeros(n, F32), ny=jnp.zeros(n, F32), nz=jnp.zeros(n, F32),
    )
    ray_live = ray_active

    for rd in range(rounds):
        lo = rd * k
        vid = jax.lax.dynamic_slice_in_dim(id_sorted, lo, k, axis=0)  # [K,N]
        kt0 = jax.lax.dynamic_slice_in_dim(t0_sorted, lo, k, axis=0)

        rows = jnp.take(vtab, vid.reshape(-1), axis=0,
                        mode="clip").reshape(k, n, 26)
        iv = [rows[..., i] for i in range(12)]
        fw = tuple(rows[..., 12 + i] for i in range(9))
        bx, by, bz = rows[..., 21], rows[..., 22], rows[..., 23]
        gs_f = rows[..., 24]
        ms_f = rows[..., 25]
        gs_i = gs_f.astype(I32)
        ms_i = ms_f.astype(I32)

        # object-space rays with per-pair matrices (renderer.cpp:959-975)
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        vox = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3]
        voy = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7]
        voz = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11]
        vdx = iv[0] * dx + iv[1] * dy + iv[2] * dz
        vdy = iv[4] * dx + iv[5] * dy + iv[6] * dz
        vdz = iv[8] * dx + iv[9] * dy + iv[10] * dz
        r = dict(ox=vox, oy=voy, oz=voz, dx=vdx, dy=vdy, dz=vdz,
                 rdx=1.0 / vdx, rdy=1.0 / vdy, rdz=1.0 / vdz,
                 sx=jnp.signbit(vdx).astype(F32),
                 sy=jnp.signbit(vdy).astype(F32),
                 sz=jnp.signbit(vdz).astype(F32))

        c = dict(bx=bx, by=by, bz=bz, gs_f=gs_f, gs_i=gs_i,
                 ms_f=ms_f, ms_i=ms_i,
                 side=jnp.int32(side), mside=jnp.int32(mside),
                 cell_base=vid * g3, occ_base=vid * m3)

        # conclusive-so-far rays skip this round's pairs entirely: a ray is
        # open iff its best hit doesn't precede this round's entry t
        open_pair = ray_live[None, :] & (kt0 <= jnp.minimum(tl, best["t"][None, :]))
        # bound later rounds by the running best, but strictly ABOVE it so a
        # later candidate can still record an exact-t tie and win the
        # original-volume-index tie-break (v1 parity)
        eff_tl = (jnp.minimum(tl, jnp.nextafter(best["t"], BIG)[None, :])
                  if mode == "nearest" else tl)

        st = _core(r, c, occ_flat, eff_tl, open_pair, mode, inner, max_outer)

        if mode == "occluded":
            best["hit"] = best["hit"] | jnp.any(st["hit"], axis=0)
            ray_live = ray_live & ~best["hit"]
            continue

        nx, ny, nz = _normals_from(r, gs_f, fw, st["t_hit"])
        # sequential merge with (t, ORIGINAL vol id) tie-break
        for kk in range(k):
            h = st["hit"][kk]
            tk = st["t_hit"][kk]
            vk = vid[kk]
            better = h & (~best["hit"] | (tk < best["t"])
                          | ((tk == best["t"]) & (vk < best["vol"])))
            best["hit"] = best["hit"] | (h & better)
            best["t"] = jnp.where(better, tk, best["t"])
            best["vol"] = jnp.where(better, vk, best["vol"])
            best["gidx"] = jnp.where(better, st["gidx"][kk], best["gidx"])
            best["nx"] = jnp.where(better, nx[kk], best["nx"])
            best["ny"] = jnp.where(better, ny[kk], best["ny"])
            best["nz"] = jnp.where(better, nz[kk], best["nz"])

        # rays done for good: best hit at or before the next candidate's
        # entry (non-strict keeps exact ties alive for the tie-break)
        if rd + 1 < rounds:
            nxt = t0_sorted[min((rd + 1) * k, v - 1)]
            ray_live = ray_live & ~(best["hit"] & (best["t"] < nxt))

    if mode == "occluded":
        return dict(hit=sg(best["hit"]))

    hitm = best["hit"]
    mat = jnp.take(grids_flat, best["gidx"], mode="clip")
    return dict(
        hit=sg(hitm),
        t=sg(jnp.where(hitm, best["t"], BIG)),
        cell=sg(jnp.where(hitm, mat, MAT_NONE)),
        vol=sg(jnp.where(hitm, best["vol"], -2)),
        nx=sg(jnp.where(hitm, best["nx"], 0.0)),
        ny=sg(jnp.where(hitm, best["ny"], 0.0)),
        nz=sg(jnp.where(hitm, best["nz"], 0.0)),
    )
