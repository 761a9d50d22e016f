"""Wavefront 3D-DDA (Amanatides–Woo) traversal — batched, masked, jittable.

Array-program redesign of the reference's scalar per-ray DDA loops
(Scene::FindNearest / FindNearestExcept / FindMaterialExit / FindSmokeExit /
IsOccluded, scene.cpp:719-1047).  Design drivers:

 * **SoA component layout** — every ray quantity is a flat array per
   x/y/z component, never [..., 3].
 * **Volume-fused traversal** — all V instances traverse together in one
   `lax.while_loop` over ray x volume pairs (shape [V, N]) instead of the
   reference's sequential per-volume loop: iteration count = max over
   volumes, and the fixed per-iteration overhead is paid once for the
   whole scene.
 * **One gather per step** — cell fetches hit the concatenation of all
   volume grids.
 * **Step unrolling** — UNROLL DDA steps per loop iteration, so the
   fused elementwise work amortizes the iteration overhead.

Semantics parity notes:
 * Axis selection replicates the reference's nested branches *including*
   their NaN behavior (0 * inf products for axis-parallel rays poison the
   comparisons identically, scene.cpp:773-801).
 * `t` is updated to the crossing BEFORE the bounds check, so boundary
   exits report the crossing t (FindMaterialExit, scene.cpp:929).
 * Volume merge order matches the reference's sequential loop: the
   earliest volume wins exact-t ties (renderer.cpp:952-993).
 * Traversal outputs are stop_gradient'ed — geometry is discrete;
   differentiability comes from the relaxed integrator in diff/.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from voxtracer.core.types import GLASS, MAT_NONE, SMOKE_LOW_DENSITY, SMOKE_PLAYER

BIG = 1e34
UNROLL = 4

# leave-predicate codes for exit marches
EXIT_GLASS = 0  # leave when cell != GLASS        (FindMaterialExit)
EXIT_SMOKE = 1  # leave when cell outside smoke   (FindSmokeExit)

F32 = jnp.float32
I32 = jnp.int32


def split3(a):
    """[N, 3] -> three [N] arrays (AoS boundary -> SoA interior)."""
    return a[..., 0], a[..., 1], a[..., 2]


def _object_rays(inv, o, d):
    """World rays [N, 3] -> per-volume object-space SoA components [V, N]
    (the SSE transform block, renderer.cpp:959-975)."""
    ox, oy, oz = split3(o)
    dx, dy, dz = split3(d)

    def tr(row, px, py, pz, point):
        c = row[:, None, :]  # [V, 1, 4]
        out = c[..., 0] * px + c[..., 1] * py + c[..., 2] * pz
        return out + c[..., 3] if point else out

    vox = tr(inv[:, 0], ox, oy, oz, True)
    voy = tr(inv[:, 1], ox, oy, oz, True)
    voz = tr(inv[:, 2], ox, oy, oz, True)
    vdx = tr(inv[:, 0], dx, dy, dz, False)
    vdy = tr(inv[:, 1], dx, dy, dz, False)
    vdz = tr(inv[:, 2], dx, dy, dz, False)
    return dict(
        ox=vox, oy=voy, oz=voz, dx=vdx, dy=vdy, dz=vdz,
        rdx=1.0 / vdx, rdy=1.0 / vdy, rdz=1.0 / vdz,
        sx=jnp.signbit(vdx).astype(F32),
        sy=jnp.signbit(vdy).astype(F32),
        sz=jnp.signbit(vdz).astype(F32),
    )


def _slab_entry(bx, by, bz, r):
    """Cube::Intersect (scene.cpp:166-202) on SoA pairs; cube [b, b+1]."""
    def axis(b0, o, d, rd):
        neg = d < 0.0
        lo = jnp.where(neg, b0 + 1.0, b0)
        hi = jnp.where(neg, b0, b0 + 1.0)
        return (lo - o) * rd, (hi - o) * rd

    tminx, tmaxx = axis(bx, r["ox"], r["dx"], r["rdx"])
    tminy, tmaxy = axis(by, r["oy"], r["dy"], r["rdy"])
    tminz, tmaxz = axis(bz, r["oz"], r["dz"], r["rdz"])
    miss = (tminx > tmaxy) | (tminy > tmaxx)
    t0 = jnp.maximum(tminx, tminy)
    t1 = jnp.minimum(tmaxx, tmaxy)
    miss |= (t0 > tmaxz) | (tminz > t1)
    t0 = jnp.maximum(t0, tminz)
    return jnp.where(miss | (t0 <= 0.0), BIG, t0)


def _setup(r, bx, by, bz, gs_f, gs_i):
    """Setup3DDDA (scene.cpp:719-749) on SoA pair arrays."""
    inside = ((r["ox"] >= bx) & (r["ox"] <= bx + 1.0)
              & (r["oy"] >= by) & (r["oy"] <= by + 1.0)
              & (r["oz"] >= bz) & (r["oz"] <= bz + 1.0))
    t0 = jnp.where(inside, 0.0, _slab_entry(bx, by, bz, r))
    valid = t0 < 1e33
    cell = 1.0 / gs_f

    def axis(o, d, rd, sgn, b0):
        pos = gs_f * ((o - b0) + (t0 + 5e-5) * d)
        plane = (jnp.ceil(pos) - sgn) * cell
        p = jnp.clip(pos.astype(I32), 0, gs_i - 1)
        step = (1 - sgn * 2).astype(I32)
        tdelta = cell * step.astype(F32) * rd
        tmax = (plane - (o - b0)) * rd
        return p, step, tdelta, tmax

    px, stx, tdx, tmx = axis(r["ox"], r["dx"], r["rdx"], r["sx"], bx)
    py, sty, tdy, tmy = axis(r["oy"], r["dy"], r["rdy"], r["sy"], by)
    pz, stz, tdz, tmz = axis(r["oz"], r["dz"], r["rdz"], r["sz"], bz)
    return dict(valid=valid, t0=t0,
                px=px, py=py, pz=pz, stx=stx, sty=sty, stz=stz,
                tdx=tdx, tdy=tdy, tdz=tdz, tmx=tmx, tmy=tmy, tmz=tmz)


def _pick_axis(tmx, tmy, tmz):
    """Reference branch structure (scene.cpp:773-801), NaN semantics kept."""
    first = tmx < tmy
    use_x = first & (tmx < tmz)
    use_y = (~first) & (tmy < tmz)
    use_z = ~(use_x | use_y)
    return use_x, use_y, use_z


def _normal_components(r, gs_f, fwd, t):
    """GetNormalVoxel (scene.cpp:121-148) on SoA pairs [V, N] for hit t."""
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
    # object -> world by fwd linear part (row-major, column vector)
    m = fwd[:, :3, :3][:, :, :, None]  # [V, 3, 3, 1]
    wx = m[:, 0, 0] * nx + m[:, 0, 1] * ny + m[:, 0, 2] * nz
    wy = m[:, 1, 0] * nx + m[:, 1, 1] * ny + m[:, 1, 2] * nz
    wz = m[:, 2, 0] * nx + m[:, 2, 1] * ny + m[:, 2, 2] * nz
    inv_len = jax.lax.rsqrt(jnp.maximum(wx * wx + wy * wy + wz * wz, 1e-20))
    return wx * inv_len, wy * inv_len, wz * inv_len


BRICK = 8
BRICK_MIXED = -1


@partial(jax.jit, static_argnames=("mode", "max_steps"))
def traverse(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit,
             ray_active, vol_enabled, skip_lo, skip_hi,
             mode="nearest", mode_code=None, vol_match=None,
             bricks_flat=None, bricksize=None, max_steps=4096):
    """Fused traversal of all rays against all volumes; see module doc.

    With bricks_flat/bricksize supplied, runs the two-level variant: a
    macro DDA over uniform-brick cells skips 8-cell spans per step and
    descends into mixed bricks for exact cell walking; one gather per
    iteration serves both levels (concatenated tables).

    Returns per-ray [N] results:
      mode "nearest":  dict(hit, t, cell, vol, nx, ny, nz)
      mode "occluded": dict(hit)
      mode "exit":     dict(in_vol, t, cell, nx, ny, nz)  (normals/cell
                       only valid where in_vol; vol_match [N] picks pairs)
    """
    v = gridsize.shape[0]
    n = o.shape[0]
    use_bricks = bricks_flat is not None

    r = _object_rays(inv, o, d)
    bx = cube_min[:, 0][:, None]
    by = cube_min[:, 1][:, None]
    bz = cube_min[:, 2][:, None]
    gs_f = gridsize.astype(F32)[:, None]
    gs_i = gridsize[:, None]

    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    assert side * side * side == g3, "grids must be padded cubes"
    side = jnp.int32(side)
    vol_base = (jnp.arange(v, dtype=I32) * g3)[:, None]

    tl = t_limit[None, :]
    is_exit = mode == "exit"

    if is_exit:
        match = vol_match[None, :] == jnp.arange(v, dtype=I32)[:, None]

    def fine_leave_pred(act, cells, t):
        """Hit/leave predicate on fine cells (shared by both variants)."""
        if is_exit:
            glass_mode = mode_code[None, :] == EXIT_GLASS
            leave = jnp.where(
                glass_mode, cells != GLASS,
                (cells > SMOKE_PLAYER) | (cells < SMOKE_LOW_DENSITY))
            return act & leave
        in_skip = (cells >= skip_lo) & (cells <= skip_hi) & (skip_hi >= skip_lo)
        return act & (cells != MAT_NONE) & (t < tl) & ~in_skip

    def brick_skip_pred(vals):
        """Can the macro step skip this uniform brick entirely?"""
        if is_exit:
            glass_mode = mode_code[None, :] == EXIT_GLASS
            return jnp.where(
                glass_mode, vals == GLASS,
                (vals >= SMOKE_LOW_DENSITY) & (vals <= SMOKE_PLAYER))
        in_skip = (vals >= skip_lo) & (vals <= skip_hi) & (skip_hi >= skip_lo)
        return (vals == MAT_NONE) | in_skip

    def record(st, pred, cells):
        out = dict(st)
        out["hit"] = st["hit"] | pred
        out["t_hit"] = jnp.where(pred, st["t"], st["t_hit"])
        out["cell"] = jnp.where(pred, cells, st["cell"])
        if is_exit:
            out["in_vol"] = st["in_vol"] | pred
            out["t_out"] = jnp.where(pred, st["t"], st["t_out"])
        return out

    def fine_init_at(t):
        """(Re)initialize fine DDA state at parameter t — Setup3DDDA's
        position seeding (scene.cpp:736-745) evaluated mid-ray."""
        cell = 1.0 / gs_f

        def axis(oc, dc, rdc, sc, b0):
            pos = gs_f * ((oc - b0) + (t + 5e-5) * dc)
            plane = (jnp.ceil(pos) - sc) * cell
            p = jnp.clip(pos.astype(I32), 0, gs_i - 1)
            tm = (plane - (oc - b0)) * rdc
            return p, tm

        px, tmx = axis(r["ox"], r["dx"], r["rdx"], r["sx"], bx)
        py, tmy = axis(r["oy"], r["dy"], r["rdy"], r["sy"], by)
        pz, tmz = axis(r["oz"], r["dz"], r["rdz"], r["sz"], bz)
        return px, py, pz, tmx, tmy, tmz

    # --- setups
    s = _setup(r, bx, by, bz, gs_f, gs_i)  # fine-level full setup
    if use_bricks:
        ms_f = bricksize.astype(F32)[:, None]
        ms_i = bricksize[:, None]
        sm = _setup(r, bx, by, bz, ms_f, ms_i)  # macro setup (same cube)
        m3 = bricks_flat.shape[0] // v
        mside = round(m3 ** (1.0 / 3.0))
        assert mside ** 3 == m3, "bricks must be padded cubes"
        mside = jnp.int32(mside)
        macro_off = jnp.int32(grids_flat.shape[0])
        macro_base = (jnp.arange(v, dtype=I32) * m3)[:, None]
        table = jnp.concatenate([grids_flat, bricks_flat])
        valid = sm["valid"]
        t0 = sm["t0"]
    else:
        valid = s["valid"]
        t0 = s["t0"]

    if is_exit:
        active0 = ray_active[None, :] & match & valid
    else:
        active0 = (ray_active[None, :] & vol_enabled[:, None] & valid
                   & (t0 < tl))

    state = dict(
        t=t0, active=active0,
        hit=jnp.zeros((v, n), bool),
        t_hit=jnp.zeros((v, n), F32),
        cell=jnp.full((v, n), MAT_NONE, I32),
        in_vol=jnp.zeros((v, n), bool),
        t_out=jnp.where(valid, t0, 0.0),
        steps=jnp.int32(0),
    )
    consts = dict(stx=s["stx"], sty=s["sty"], stz=s["stz"],
                  tdx=s["tdx"], tdy=s["tdy"], tdz=s["tdz"])

    if use_bricks:
        state.update(
            level=jnp.zeros((v, n), bool),  # False = macro, True = fine
            px=s["px"], py=s["py"], pz=s["pz"],  # fine (filled on descend)
            tmx=s["tmx"], tmy=s["tmy"], tmz=s["tmz"],
            mpx=sm["px"], mpy=sm["py"], mpz=sm["pz"],
            mtmx=sm["tmx"], mtmy=sm["tmy"], mtmz=sm["tmz"],
            blox=jnp.zeros((v, n), I32), bloy=jnp.zeros((v, n), I32),
            bloz=jnp.zeros((v, n), I32),
        )
        mconsts = dict(tdx=sm["tdx"], tdy=sm["tdy"], tdz=sm["tdz"])
    else:
        state.update(px=s["px"], py=s["py"], pz=s["pz"],
                     tmx=s["tmx"], tmy=s["tmy"], tmz=s["tmz"])

    def one_step_flat(st):
        idx = (st["px"] * side + st["py"]) * side + st["pz"] + vol_base
        cells = jnp.take(grids_flat, idx, mode="clip")
        pred = fine_leave_pred(st["active"], cells, st["t"])
        st = record(st, pred, cells)
        act = st["active"] & ~pred

        use_x, use_y, use_z = _pick_axis(st["tmx"], st["tmy"], st["tmz"])
        t_new = jnp.where(use_x, st["tmx"], jnp.where(use_y, st["tmy"], st["tmz"]))
        px = st["px"] + jnp.where(act & use_x, consts["stx"], 0)
        py = st["py"] + jnp.where(act & use_y, consts["sty"], 0)
        pz = st["pz"] + jnp.where(act & use_z, consts["stz"], 0)
        moved = jnp.where(use_x, px, jnp.where(use_y, py, pz))
        out = (moved < 0) | (moved >= gs_i)
        tmx = st["tmx"] + jnp.where(act & use_x, consts["tdx"], 0.0)
        tmy = st["tmy"] + jnp.where(act & use_y, consts["tdy"], 0.0)
        tmz = st["tmz"] + jnp.where(act & use_z, consts["tdz"], 0.0)

        t = jnp.where(act, t_new, st["t"])
        t_out = st["t_out"]
        if is_exit:
            t_out = jnp.where(act & out, t_new, t_out)
        act = act & ~out
        if not is_exit:
            act = act & (t_new < tl)
        return dict(st, px=px, py=py, pz=pz, tmx=tmx, tmy=tmy, tmz=tmz,
                    t=t, active=act, t_out=t_out)

    def one_step_brick(st):
        at_fine = st["level"]
        fine_idx = (st["px"] * side + st["py"]) * side + st["pz"] + vol_base
        midx = (st["mpx"] * mside + st["mpy"]) * mside + st["mpz"]
        macro_idx = macro_off + macro_base + midx
        vals = jnp.take(table, jnp.where(at_fine, fine_idx, macro_idx),
                        mode="clip")

        # ---- fine pairs: predicate + step
        act_f = st["active"] & at_fine
        pred = fine_leave_pred(act_f, vals, st["t"])
        st = record(st, pred, vals)
        act_f = act_f & ~pred

        use_x, use_y, use_z = _pick_axis(st["tmx"], st["tmy"], st["tmz"])
        t_new = jnp.where(use_x, st["tmx"], jnp.where(use_y, st["tmy"], st["tmz"]))
        px = st["px"] + jnp.where(act_f & use_x, consts["stx"], 0)
        py = st["py"] + jnp.where(act_f & use_y, consts["sty"], 0)
        pz = st["pz"] + jnp.where(act_f & use_z, consts["stz"], 0)
        moved = jnp.where(use_x, px, jnp.where(use_y, py, pz))
        out_grid = (moved < 0) | (moved >= gs_i)
        blo = jnp.where(use_x, st["blox"], jnp.where(use_y, st["bloy"], st["bloz"]))
        out_brick = (moved < blo) | (moved >= blo + BRICK)
        tmx = st["tmx"] + jnp.where(act_f & use_x, consts["tdx"], 0.0)
        tmy = st["tmy"] + jnp.where(act_f & use_y, consts["tdy"], 0.0)
        tmz = st["tmz"] + jnp.where(act_f & use_z, consts["tdz"], 0.0)
        t = jnp.where(act_f, t_new, st["t"])
        if not is_exit:
            act_f = act_f & (t_new < tl)
        go_macro = act_f & out_brick & ~out_grid
        term_f = act_f & out_grid
        t_out = st["t_out"]
        if is_exit:
            t_out = jnp.where(term_f, t_new, t_out)
        level = at_fine & ~go_macro
        active = jnp.where(at_fine, act_f & ~term_f & ~go_macro | go_macro,
                           st["active"])

        # ---- macro pairs: skip-or-descend
        act_m = st["active"] & ~at_fine
        skip_ok = brick_skip_pred(vals) & act_m
        descend = act_m & ~skip_ok
        fpx, fpy, fpz, ftmx, ftmy, ftmz = fine_init_at(st["t"])
        # brick fine-cell bounds; clamp the entry cell INTO the brick so the
        # macro/fine bookkeeping stays consistent when the setup epsilon
        # lands one cell over a brick boundary
        nblox = st["mpx"] * BRICK
        nbloy = st["mpy"] * BRICK
        nbloz = st["mpz"] * BRICK
        fpx = jnp.clip(fpx, nblox, jnp.minimum(nblox + BRICK - 1, gs_i - 1))
        fpy = jnp.clip(fpy, nbloy, jnp.minimum(nbloy + BRICK - 1, gs_i - 1))
        fpz = jnp.clip(fpz, nbloz, jnp.minimum(nbloz + BRICK - 1, gs_i - 1))
        px = jnp.where(descend, fpx, px)
        py = jnp.where(descend, fpy, py)
        pz = jnp.where(descend, fpz, pz)
        tmx = jnp.where(descend, ftmx, tmx)
        tmy = jnp.where(descend, ftmy, tmy)
        tmz = jnp.where(descend, ftmz, tmz)
        blox = jnp.where(descend, nblox, st["blox"])
        bloy = jnp.where(descend, nbloy, st["bloy"])
        bloz = jnp.where(descend, nbloz, st["bloz"])
        level = level | descend

        # ---- macro advance: skipped bricks + fine walks that left a brick
        do_m = skip_ok | go_macro
        muse_x, muse_y, muse_z = _pick_axis(st["mtmx"], st["mtmy"], st["mtmz"])
        mt_new = jnp.where(muse_x, st["mtmx"],
                           jnp.where(muse_y, st["mtmy"], st["mtmz"]))
        mpx = st["mpx"] + jnp.where(do_m & muse_x, consts["stx"], 0)
        mpy = st["mpy"] + jnp.where(do_m & muse_y, consts["sty"], 0)
        mpz = st["mpz"] + jnp.where(do_m & muse_z, consts["stz"], 0)
        mmoved = jnp.where(muse_x, mpx, jnp.where(muse_y, mpy, mpz))
        m_out = (mmoved < 0) | (mmoved >= ms_i)
        mtmx = st["mtmx"] + jnp.where(do_m & muse_x, mconsts["tdx"], 0.0)
        mtmy = st["mtmy"] + jnp.where(do_m & muse_y, mconsts["tdy"], 0.0)
        mtmz = st["mtmz"] + jnp.where(do_m & muse_z, mconsts["tdz"], 0.0)
        t = jnp.where(do_m, mt_new, t)
        if is_exit:
            t_out = jnp.where(do_m & m_out, mt_new, t_out)
        active = active & ~(do_m & m_out)
        if not is_exit:
            active = active & ~(do_m & ~(mt_new < tl))

        return dict(st, px=px, py=py, pz=pz, tmx=tmx, tmy=tmy, tmz=tmz,
                    mpx=mpx, mpy=mpy, mpz=mpz, mtmx=mtmx, mtmy=mtmy,
                    mtmz=mtmz, blox=blox, bloy=bloy, bloz=bloz,
                    level=level, t=t, active=active, t_out=t_out)

    one_step = one_step_brick if use_bricks else one_step_flat

    def body(st):
        for _ in range(UNROLL):
            st = one_step(st)
        return dict(st, steps=st["steps"] + UNROLL)

    def cond(st):
        return jnp.any(st["active"]) & (st["steps"] < max_steps)

    st = jax.lax.while_loop(cond, body, state)
    sg = jax.lax.stop_gradient

    if mode == "occluded":
        return dict(hit=sg(jnp.any(st["hit"], axis=0)))

    if mode == "exit":
        match = vol_match[None, :] == jnp.arange(v, dtype=I32)[:, None]
        nx, ny, nz = _normal_components(r, gs_f, fwd, st["t_out"])
        pick = lambda a: sg(jnp.sum(jnp.where(match, a, 0), axis=0))
        return dict(
            in_vol=sg(jnp.any(st["in_vol"] & match, axis=0)),
            t=pick(st["t_out"]),
            cell=pick(jnp.where(st["in_vol"], st["cell"], MAT_NONE)).astype(I32),
            nx=pick(jnp.where(st["in_vol"], nx, 0.0)),
            ny=pick(jnp.where(st["in_vol"], ny, 0.0)),
            nz=pick(jnp.where(st["in_vol"], nz, 0.0)),
        )

    # nearest: merge volumes, earliest volume wins ties (argmin is first-min)
    t_pair = jnp.where(st["hit"], st["t_hit"], BIG)
    win = jnp.argmin(t_pair, axis=0)  # [N]
    winm = win[None, :] == jnp.arange(v, dtype=I32)[:, None]
    nx, ny, nz = _normal_components(r, gs_f, fwd, st["t_hit"])
    pick = lambda a, zero: sg(jnp.sum(jnp.where(winm & st["hit"], a, zero), axis=0))
    any_hit = jnp.any(st["hit"], axis=0)
    return dict(
        hit=sg(any_hit),
        t=sg(jnp.where(any_hit, jnp.min(t_pair, axis=0), BIG)),
        cell=sg(jnp.where(any_hit,
                          jnp.sum(jnp.where(winm & st["hit"], st["cell"], 0), axis=0),
                          MAT_NONE)),
        vol=sg(jnp.where(any_hit, win, -2)),
        nx=pick(nx, 0.0), ny=pick(ny, 0.0), nz=pick(nz, 0.0),
    )


# --------------------------------------------------------------------------
# Single-volume wrappers (unit tests + simple callers)
# --------------------------------------------------------------------------

def _wrap_single(grid_flat, gridsize, gpad, cube_min):
    v = 1
    return (grid_flat, jnp.asarray([gridsize], I32).reshape(1),
            jnp.eye(4, dtype=F32)[None], jnp.eye(4, dtype=F32)[None],
            jnp.asarray(cube_min, F32).reshape(1, 3))


def dda_nearest(grid_flat, gridsize, gpad, cube_min, o, d, rd, dsign,
                t_limit, active_in, skip_lo, skip_hi, max_steps=4096):
    """Single-volume FindNearest (object space == world space)."""
    g, gs, inv, fwd, cm = _wrap_single(grid_flat, gridsize, gpad, cube_min)
    o3 = o if o.ndim == 2 else o.reshape(-1, 3)
    res = traverse(g, gs, inv, fwd, cm, o3, d, t_limit, active_in,
                   jnp.ones(1, bool), skip_lo, skip_hi, mode="nearest",
                   max_steps=max_steps)
    return res["hit"], jnp.where(res["hit"], res["t"], 0.0), res["cell"]


def dda_occluded(grid_flat, gridsize, gpad, cube_min, o, d, rd, dsign,
                 t_limit, active_in, max_steps=4096):
    g, gs, inv, fwd, cm = _wrap_single(grid_flat, gridsize, gpad, cube_min)
    res = traverse(g, gs, inv, fwd, cm, o, d, t_limit, active_in,
                   jnp.ones(1, bool), jnp.int32(1), jnp.int32(0),
                   mode="occluded", max_steps=max_steps)
    return res["hit"]


def dda_exit(grid_flat, gridsize, gpad, cube_min, o, d, rd, dsign,
             active_in, mode_code, glass_mat, smoke_lo, smoke_hi,
             max_steps=4096):
    g, gs, inv, fwd, cm = _wrap_single(grid_flat, gridsize, gpad, cube_min)
    res = traverse(g, gs, inv, fwd, cm, o, d,
                   jnp.full(o.shape[0], BIG, F32), active_in,
                   jnp.ones(1, bool), jnp.int32(1), jnp.int32(0),
                   mode="exit", mode_code=mode_code,
                   vol_match=jnp.zeros(o.shape[0], I32), max_steps=max_steps)
    return res["in_vol"], res["t"], res["cell"]


def normal_voxel(gridsize, fwd, o, d, t, dsign):
    """Batched GetNormalVoxel for [N, 3] object-space rays (test helper)."""
    r = dict(ox=o[:, 0][None], oy=o[:, 1][None], oz=o[:, 2][None],
             dx=d[:, 0][None], dy=d[:, 1][None], dz=d[:, 2][None],
             sx=dsign[:, 0][None], sy=dsign[:, 1][None], sz=dsign[:, 2][None])
    gs_f = jnp.asarray(gridsize, F32).reshape(1, 1)
    fwd3 = fwd if fwd.ndim == 3 else fwd[None]
    nx, ny, nz = _normal_components(r, gs_f, fwd3, t[None, :])
    return jnp.stack([nx[0], ny[0], nz[0]], axis=-1)
