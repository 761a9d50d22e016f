"""Wavefront integrators — the array-program rewrite of Renderer::Trace.

The reference shades with a recursive megafunction over scalar rays
(renderer.cpp:1076-1328).  Here the whole ray population advances together:
a while_loop over bounce depth with early exit; per bounce every material
lobe is computed vectorized and masked (SURVEY.md §7 "hard parts").
Scene intersection is ONE fused ray x volume traversal (kernels/dda_gpu.py
on a GPU, kernels/dda_occ.py on the CPU).

Hot-path layout: all per-ray vectors are **component tuples** (x, y, z of
shape [N]) — never [N, 3] — so elementwise work runs on contiguous
per-component arrays with no strided trailing dim.  Gathers from small tables
([256, 3] albedo, sky image) stay row-gathers and are split after.

Modes:
  primary — flat albedo at first hit (BASELINE config 1)
  whitted — deterministic: NEE sum, perfect mirrors, Fresnel-split glass
  path    — full stochastic reference semantics (metals w/ roughness,
            Schlick diffuse/spec split, dielectric marching w/ Beer-Lambert,
            stochastic smoke scattering, emissives, sky)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from voxtracer.config import RenderConfig
from voxtracer.core import mathx
from voxtracer.core.types import (
    EMISSIVE,
    GLASS,
    MAT_NONE,
    METAL_HIGH,
    METAL_LOW,
    SMOKE_LOW_DENSITY,
    SMOKE_PLAYER,
    SceneData,
)
from voxtracer.kernels import dda, dda_gpu, dda_occ
from voxtracer.kernels.primitives import (
    spheres_nearest,
    spheres_occluded,
    triangles_nearest,
    triangles_occluded,
)
from voxtracer.render.sky import sample_sky

BIG = 1e34
F32 = jnp.float32
TWO_PI = 6.283185307179586


def _uni(cfg: RenderConfig, key, salt: int, shape):
    """Uniform [0,1) sample stream: cfg.rng selects the counter-hash
    sampler (core/rng.py, a few integer ops per value) or jax.random
    threefry.
    Both are deterministic functions of (key, salt, lane)."""
    if cfg.rng == "hash":
        from voxtracer.core.rng import hash_uniform

        return hash_uniform(key, salt, shape)
    return jax.random.uniform(jax.random.fold_in(key, salt), shape, F32)


def _nrml(cfg: RenderConfig, key, salt: int, shape):
    if cfg.rng == "hash":
        from voxtracer.core.rng import hash_normal

        return hash_normal(key, salt, shape)
    return jax.random.normal(jax.random.fold_in(key, salt), shape, F32)


# --------------------------------------------------------------------------
# Component-tuple vector helpers (SoA [N] per axis)
# --------------------------------------------------------------------------

def cpack(a):
    """[N, 3] -> (x, y, z)."""
    return a[..., 0], a[..., 1], a[..., 2]


def cstack(c):
    return jnp.stack(c, axis=-1)


def cdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def csub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def cmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def cscale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def cneg(a):
    return (-a[0], -a[1], -a[2])


def cwhere(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def cunit(a):
    inv = jax.lax.rsqrt(jnp.maximum(cdot(a, a), 1e-20))
    return cscale(inv, a)


def creflect(d, n):
    """renderer.cpp:913-916."""
    return csub(d, cscale(2.0 * cdot(d, n), n))


def crefract(d, n, ratio):
    """renderer.cpp:919-925."""
    cos_t = jnp.minimum(cdot(cneg(d), n), 1.0)
    rp = cscale(ratio, cadd(d, cscale(cos_t, n)))
    rpar = -jnp.sqrt(jnp.abs(1.0 - cdot(rp, rp)))
    return cadd(rp, cscale(rpar, n))


def coffset(p, n):
    """OffsetRay per component (tmpl8math.cpp:473-487, elementwise)."""
    return tuple(mathx.offset_ray(p[i], n[i], jnp) for i in range(3))


def csphere_sample(u1, u2, u3):
    """RandomSphereSample (tmpl8math.h:2502-2511)."""
    theta = u1 * TWO_PI
    phi = u2 * jnp.pi
    sp = jnp.sin(phi)
    return (u3 * sp * jnp.cos(theta), u3 * sp * jnp.sin(theta),
            u3 * jnp.cos(phi))


def coctant_dir(g):
    """RandomDirection positive-octant quirk (tmpl8math.cpp:76-93)."""
    a = (jnp.abs(g[0]) + 1e-12, jnp.abs(g[1]) + 1e-12, jnp.abs(g[2]) + 1e-12)
    return cunit(a)


def chemisphere_dir(n, g):
    """DiffuseReflection (tmpl8math.h:2517-2527): uniform hemisphere."""
    d = cunit((g[0] + 1e-12, g[1] + 1e-12, g[2] + 1e-12))
    flip = jnp.where(cdot(d, n) < 0.0, -1.0, 1.0)
    return cscale(flip, d)


# --------------------------------------------------------------------------
# Scene intersection (fused traversal + primitives)
# --------------------------------------------------------------------------

def _vol_args(scene: SceneData):
    v = scene.volumes
    return (v.grids.reshape(-1), v.gridsize, v.inv, v.fwd, v.cube_min)


def _brick_kwargs(scene: SceneData):
    v = scene.volumes
    return dict(bricks_flat=v.bricks.reshape(-1), bricksize=v.bricksize)


def _occ_args(scene: SceneData):
    v = scene.volumes
    return dict(occ=v.occ, bricksize=v.bricksize)


def _topk(scene: SceneData) -> int:
    """Candidate-volume budget per ray per round (kernels/dda_occ.py):
    lockstep traversal cost scales with pairs, so compact to the K
    earliest-entry volumes; most rays resolve in round one."""
    v = scene.volumes.n
    return v if v <= 2 else (2 if v <= 8 else 4)


def traversal_backend() -> str:
    """Which traversal runs, from the platform of the device the program
    is traced for (jax.default_device, else the first device): the Pallas
    kernel (kernels/dda_gpu.py) on a GPU, the XLA loop
    (kernels/dda_occ.py) on the CPU."""
    dev = jax.config.jax_default_device or jax.devices()[0]
    platform = dev if isinstance(dev, str) else dev.platform
    if platform in ("gpu", "cuda"):
        return "kernel"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no traversal for platform {platform!r}")


def _traverse(scene: SceneData, o3, d3, t_limit, active, vol_enabled, mode,
              **kw):
    """Occupancy traversal of all volumes in `mode` (nearest / occluded /
    exit) on the backend traversal_backend() picks."""
    args = (*_vol_args(scene), o3, d3, t_limit, active, vol_enabled)
    if traversal_backend() == "kernel":
        return dda_gpu.traverse(*args, **_occ_args(scene), mode=mode, **kw)
    if mode == "exit":
        return dda_occ.traverse_occ(*args, **_occ_args(scene), mode=mode,
                                    **kw)
    return dda_occ.traverse_occ_topk(*args, **_occ_args(scene), mode=mode,
                                     k=_topk(scene))


def find_nearest_world(scene: SceneData, o, d, active,
                       skip_lo=1, skip_hi=0, skip_first=False):
    """Renderer::FindNearest (renderer.cpp:946-1018) — all instances in ONE
    fused wavefront loop, then spheres/triangles merged.
    o, d: [N, 3] or component tuples.  Returns dict with t, mat, vol, hit,
    normal components (nx, ny, nz) and a stacked `normal`."""
    o3 = o if not isinstance(o, tuple) else cstack(o)
    d3 = d if not isinstance(d, tuple) else cstack(d)
    n = o3.shape[0]
    nvol = scene.volumes.n
    vol_enabled = jnp.ones(nvol, bool)
    if skip_first:
        vol_enabled = vol_enabled.at[0].set(False)
    # occupancy-bitmask kernel for the hot no-skip case; the v1 per-cell
    # kernel only for dynamic material skip ranges (game probes)
    no_skip = (isinstance(skip_lo, int) and isinstance(skip_hi, int)
               and skip_lo > skip_hi)
    if no_skip:
        res = _traverse(scene, o3, d3, jnp.full(n, BIG, F32), active,
                        vol_enabled, "nearest")
    else:
        res = dda.traverse(*_vol_args(scene), o3, d3, jnp.full(n, BIG, F32),
                           active, vol_enabled, jnp.int32(skip_lo),
                           jnp.int32(skip_hi), mode="nearest",
                           **_brick_kwargs(scene))
    t, mat, vol = res["t"], jnp.where(res["hit"], res["cell"], MAT_NONE), res["vol"]
    nrm = (res["nx"], res["ny"], res["nz"])

    # spheres + triangles on a fresh ray then min-merge (renderer.cpp:996-1016)
    st, smat, snrm, sinside = spheres_nearest(scene.spheres, o3, d3)
    tt, tmat, tnrm = triangles_nearest(scene.triangles, o3, d3)
    prim_t = jnp.minimum(st, tt)
    use_tri = tt < st
    prim_mat = jnp.where(use_tri, tmat, smat)
    prim_nrm = cwhere(use_tri, cpack(tnrm), cpack(snrm))
    adopt = active & (t > prim_t)
    nrm = cwhere(adopt, prim_nrm, nrm)
    out = dict(
        t=jnp.where(adopt, prim_t, t),
        mat=jnp.where(adopt, prim_mat, mat),
        nx=nrm[0], ny=nrm[1], nz=nrm[2],
        vol=jnp.where(adopt, -1, vol),
        # sphere hits REPLACE isInsideGlass on adoption (renderer.cpp:1013);
        # the flag comes from the closest sphere even if a triangle won
        # (triangles never write it, Shapes.h) — quirk preserved
        prim_adopt=adopt,
        prim_inside=sinside,
    )
    out["normal"] = cstack(nrm)
    out["hit"] = active & (out["mat"] != MAT_NONE)
    return out


def is_occluded_world(scene: SceneData, o, d, t_limit, active):
    """Renderer::IsOccluded (renderer.cpp:209-243) — one fused pass."""
    o3 = o if not isinstance(o, tuple) else cstack(o)
    d3 = d if not isinstance(d, tuple) else cstack(d)
    res = _traverse(scene, o3, d3, t_limit, active,
                    jnp.ones(scene.volumes.n, bool), "occluded")
    occ = res["hit"]
    occ = occ | spheres_occluded(scene.spheres, o3, d3, t_limit)
    occ = occ | triangles_occluded(scene.triangles, o3, d3, t_limit)
    return occ


def material_exit_world(scene: SceneData, o, d, vol_idx, mode_code, mask):
    """Per-ray FindMaterialExit/FindSmokeExit through the ray's own volume
    (renderer.cpp:1160-1179, 1265-1280).
    Returns (in_volume, t, normal components)."""
    o3 = o if not isinstance(o, tuple) else cstack(o)
    d3 = d if not isinstance(d, tuple) else cstack(d)
    n = o3.shape[0]
    res = _traverse(scene, o3, d3, jnp.full(n, BIG, F32), mask,
                    jnp.ones(scene.volumes.n, bool), "exit",
                    mode_code=mode_code, vol_match=vol_idx)
    return res["in_vol"], res["t"], (res["nx"], res["ny"], res["nz"])


# --------------------------------------------------------------------------
# Materials / lighting (NEE) — renderer.cpp:102-207, 315-338, 738-764
# --------------------------------------------------------------------------

def _albedo(scene, mat):
    return jnp.take(scene.materials.albedo, mat, axis=0)


def _albedo_c(scene, mat):
    return cpack(jnp.take(scene.materials.albedo, mat, axis=0))


def _sky_c(scene, cfg, d):
    return cpack(sample_sky(scene.sky, cstack(d), cfg.activate_sky,
                            cfg.sky_fallback))


def _det_illumination(scene: SceneData, cfg: RenderConfig, p, nrm, alb,
                      active, key):
    """Deterministic all-lights NEE sum (renderer.cpp:102-207, 738-764)
    with ONE batched shadow traversal.

    The per-light loop (_light_contribution x L calls) paid a full
    occlusion pass per light per whitted iteration — room's 2 point
    lights + the black dir light were 3 of its 4 traversals.  All shadow
    segments share the same offset origin, so they concatenate into one
    [L*N]-lane occluded call (bit-identical per lane: the kernel result
    does not depend on block composition) and the per-light contributions
    apply in the original summation order afterwards."""
    L = scene.lights
    nrays = p[0].shape[0]
    zero = (jnp.zeros(nrays, F32),) * 3
    origin = coffset(p, nrm)
    segs = []  # (dirn, shadow_t, need, per-sample contribution)
    plan = []  # ordered: ("one", seg_idx) | ("area", [seg_idx...])
    for i in range(L.n_point):
        lpos = cpack(jnp.take(L.point_pos,
                              jnp.full(nrays, i, jnp.int32), axis=0))
        lcol = cpack(jnp.take(L.point_color,
                              jnp.full(nrays, i, jnp.int32), axis=0))
        to_l = csub(lpos, p)
        dst = jnp.sqrt(cdot(to_l, to_l))
        dirn = cscale(1.0 / dst, to_l)
        cos_t = cdot(dirn, nrm)
        scale = cos_t / (dst * dst)
        plan.append(("one", len(segs)))
        segs.append((dirn, dst, active & (cos_t > 0.0),
                     cmul(cscale(scale, lcol), alb)))
    for i in range(L.n_area):
        ki = jax.random.fold_in(key, 1000 + i)
        idx = jnp.full(nrays, i, jnp.int32)
        lpos = cpack(jnp.take(L.area_pos, idx, axis=0))
        lcol = cpack(jnp.take(L.area_color, idx, axis=0))
        lmul = jnp.take(L.area_mult, idx, axis=0)
        lrad = jnp.take(L.area_radius, idx, axis=0)
        sidx = []
        for k in range(cfg.num_area_samples):
            gk = _nrml(cfg, ki, 200 + k, (3, nrays))
            rnd = coctant_dir((gk[0], gk[1], gk[2]))
            target = cadd(cscale(lrad, rnd), lpos)
            to_l = csub(target, p)
            dst = jnp.sqrt(cdot(to_l, to_l))
            dirn = cscale(1.0 / dst, to_l)
            cos_t = cdot(dirn, nrm)
            scale = (cos_t * lmul * lrad * lrad * (4.0 * jnp.pi)
                     / (dst * dst))
            sidx.append(len(segs))
            segs.append((dirn, dst, active & (cos_t > 0.0),
                         cscale(scale, lcol)))
        plan.append(("area", sidx))
    for i in range(L.n_spot):
        idx = jnp.full(nrays, i, jnp.int32)
        lpos = cpack(jnp.take(L.spot_pos, idx, axis=0))
        ldir = cpack(jnp.take(L.spot_dir, idx, axis=0))
        lcol = cpack(jnp.take(L.spot_color, idx, axis=0))
        lcos = jnp.take(L.spot_cos_angle, idx, axis=0)
        to_l = csub(lpos, p)
        dst = jnp.sqrt(cdot(to_l, to_l))
        dirn = cscale(1.0 / dst, to_l)
        cos_t = cdot(dirn, ldir)
        alpha = 1.0 - (1.0 - cos_t) / (1.0 - lcos)
        plan.append(("one", len(segs)))
        segs.append((dirn, dst, active & (cos_t > lcos),
                     cmul(cscale(cos_t / (dst * dst) * alpha, lcol), alb)))
    # directional light — black default contributes zero; gate the rays
    dirn = tuple(jnp.broadcast_to(-L.dir_direction[i], (nrays,))
                 for i in range(3))
    cos_d = cdot(dirn, nrm)
    dir_on = jnp.any(L.dir_color != 0.0)
    plan.append(("one", len(segs)))
    segs.append((dirn, jnp.full(nrays, BIG, F32),
                 active & (cos_d > 0.0) & dir_on,
                 cmul(cscale(cos_d, tuple(L.dir_color[i]
                                          for i in range(3))), alb)))

    nseg = len(segs)
    o_all = tuple(jnp.concatenate([origin[c]] * nseg) for c in range(3))
    d_all = tuple(jnp.concatenate([s[0][c] for s in segs])
                  for c in range(3))
    t_all = jnp.concatenate([s[1] for s in segs])
    need_all = jnp.concatenate([s[2] for s in segs])
    occ_all = is_occluded_world(scene, o_all, d_all, t_all, need_all)
    lits = [segs[k][2] & ~occ_all[k * nrays:(k + 1) * nrays]
            for k in range(nseg)]

    acc = zero
    for item in plan:
        if item[0] == "one":
            k = item[1]
            acc = cadd(acc, cwhere(lits[k], segs[k][3], zero))
        else:
            a_acc = zero
            for k in item[1]:
                a_acc = cwhere(lits[k], cadd(a_acc, segs[k][3]), a_acc)
            acc = cadd(acc, cmul(cscale(1.0 / cfg.num_area_samples, a_acc),
                                 alb))
    return acc


def illumination(scene: SceneData, cfg: RenderConfig, p, nrm, mat, active, key,
                 alb=None):
    """Renderer::Illumination (renderer.cpp:738-764): one random light
    scaled by lightCount, or the deterministic all-lights sum (same
    expectation) when cfg.deterministic_lights.

    p, nrm: component tuples (or [N, 3] arrays — auto-converted).
    alb: optional precomputed albedo component tuple — callers that already
    gathered material rows pass it to skip a redundant per-ray take.
    Returns a component tuple."""
    if not isinstance(p, tuple):
        p = cpack(p)
    if not isinstance(nrm, tuple):
        nrm = cpack(nrm)
    L = scene.lights
    n_p, n_a, n_s = L.n_point, L.n_area, L.n_spot
    total = L.count
    if alb is None:
        alb = _albedo_c(scene, mat)
    nrays = p[0].shape[0]
    zero = (jnp.zeros(nrays, F32),) * 3

    if cfg.deterministic_lights:
        # one batched shadow pass for ALL lights (numerically identical
        # to the per-light _light_contribution/_area_contribution loop)
        return _det_illumination(scene, cfg, p, nrm, alb, active, key)

    u = _uni(cfg, key, 7, (nrays,))
    idx = jnp.minimum((u * total).astype(jnp.int32), total - 1)
    acc = zero

    # ALL light types fuse into ONE shadow traversal: each ray sampled a
    # single light, so its (direction, t_limit, intensity) are selected per
    # ray and one occlusion pass serves every type — the v1 design paid a
    # full lockstep traversal PER TYPE, and v2 still paid
    # cfg.num_area_samples extra passes for sampled area lights.  Area
    # lights here use a ONE-sample estimate of the reference's N-sample
    # mean (renderer.cpp:161-207) — identical expectation, slightly higher
    # variance, converges under progressive accumulation; the
    # deterministic_lights path above keeps the N-sample loop for oracle
    # parity.
    dirn = tuple(jnp.zeros(nrays, F32) for _ in range(3))
    intensity = zero
    shadow_t = jnp.full(nrays, BIG, F32)
    gate = jnp.zeros(nrays, bool)

    if n_p:
        sel = idx < n_p
        i_p = jnp.clip(idx, 0, n_p - 1)
        lpos = cpack(jnp.take(L.point_pos, i_p, axis=0))
        lcol = cpack(jnp.take(L.point_color, i_p, axis=0))
        to_l = csub(lpos, p)
        dst = jnp.sqrt(cdot(to_l, to_l))
        d_p = cscale(1.0 / dst, to_l)
        cos_t = cdot(d_p, nrm)
        dirn = cwhere(sel, d_p, dirn)
        intensity = cwhere(sel, cscale(cos_t / (dst * dst), lcol), intensity)
        shadow_t = jnp.where(sel, dst, shadow_t)
        gate = jnp.where(sel, cos_t > 0.0, gate)
    if n_a:
        sel = (idx >= n_p) & (idx < n_p + n_a)
        i_a = jnp.clip(idx - n_p, 0, n_a - 1)
        lpos = cpack(jnp.take(L.area_pos, i_a, axis=0))
        lcol = cpack(jnp.take(L.area_color, i_a, axis=0))
        lmul = jnp.take(L.area_mult, i_a, axis=0)
        lrad = jnp.take(L.area_radius, i_a, axis=0)
        gk = _nrml(cfg, key, 11, (3, nrays))
        rnd = coctant_dir((gk[0], gk[1], gk[2]))
        target = cadd(cscale(lrad, rnd), lpos)
        to_l = csub(target, p)
        dst = jnp.sqrt(cdot(to_l, to_l))
        d_a = cscale(1.0 / dst, to_l)
        cos_t = cdot(d_a, nrm)
        scale = cos_t * lmul * lrad * lrad * (4.0 * jnp.pi) / (dst * dst)
        dirn = cwhere(sel, d_a, dirn)
        intensity = cwhere(sel, cscale(scale, lcol), intensity)
        shadow_t = jnp.where(sel, dst, shadow_t)
        gate = jnp.where(sel, cos_t > 0.0, gate)
    if n_s:
        sel = (idx >= n_p + n_a) & (idx < n_p + n_a + n_s)
        i_s = jnp.clip(idx - n_p - n_a, 0, n_s - 1)
        lpos = cpack(jnp.take(L.spot_pos, i_s, axis=0))
        ldir = cpack(jnp.take(L.spot_dir, i_s, axis=0))
        lcol = cpack(jnp.take(L.spot_color, i_s, axis=0))
        lcos = jnp.take(L.spot_cos_angle, i_s, axis=0)
        to_l = csub(lpos, p)
        dst = jnp.sqrt(cdot(to_l, to_l))
        d_s = cscale(1.0 / dst, to_l)
        cos_t = cdot(d_s, ldir)
        alpha = 1.0 - (1.0 - cos_t) / (1.0 - lcos)
        dirn = cwhere(sel, d_s, dirn)
        intensity = cwhere(sel, cscale(cos_t / (dst * dst) * alpha, lcol),
                           intensity)
        shadow_t = jnp.where(sel, dst, shadow_t)
        gate = jnp.where(sel, cos_t > lcos, gate)
    sel_d = idx >= n_p + n_a + n_s
    d_d = tuple(jnp.broadcast_to(-L.dir_direction[i], (nrays,))
                for i in range(3))
    cos_d = cdot(d_d, nrm)
    dirn = cwhere(sel_d, d_d, dirn)
    intensity = cwhere(sel_d, cscale(cos_d, tuple(L.dir_color[i]
                                                  for i in range(3))),
                       intensity)
    shadow_t = jnp.where(sel_d, BIG, shadow_t)
    # a black directional light (the reference default) contributes zero
    # whatever the occlusion says — don't burn infinite shadow rays on it
    dir_on = jnp.any(L.dir_color != 0.0)
    gate = jnp.where(sel_d, (cos_d > 0.0) & dir_on, gate)

    origin = coffset(p, nrm)
    need = active & gate
    occ = is_occluded_world(scene, origin, dirn, shadow_t, need)
    lit = need & ~occ
    acc = cwhere(lit, cadd(acc, cmul(intensity, alb)), acc)
    return cscale(float(total), acc)


# --------------------------------------------------------------------------
# Path integrator (wavefront, SoA) — renderer.cpp:1076-1328 flattened
# --------------------------------------------------------------------------

def _bounce_core(scene: SceneData, cfg: RenderConfig, st, bkey):
    """ONE wavefront bounce (renderer.cpp:1076-1328 flattened): nearest
    traversal, material-lobe shading, NEE, continuation.  Inactive lanes
    pass through unchanged — the chunked compaction driver relies on that."""
    n = st["o"][0].shape[0]
    one3 = (jnp.ones(n, F32),) * 3
    o, d, active = st["o"], st["d"], st["active"]
    rec = find_nearest_world(scene, o, d, active)
    t, mat, vol = rec["t"], rec["mat"], rec["vol"]
    nrm = (rec["nx"], rec["ny"], rec["nz"])
    in_glass = jnp.where(rec["prim_adopt"], rec["prim_inside"],
                         st["in_glass"])

    # miss -> sky, terminate (renderer.cpp:1092-1095).  The sky take is
    # DEFERRED: each ray records (throughput, direction) at its miss and
    # trace_path evaluates the texture ONCE per frame instead of once per
    # bounce (rays miss at most once, so the sum is bitwise identical).
    miss = active & (mat == MAT_NONE)
    sky_tp = cwhere(miss, st["tp"], st["sky_tp"])
    sky_d = cwhere(miss, d, st["sky_d"])
    rad = st["rad"]
    active = active & ~miss

    # one [256, 6] row gather for all material properties
    mtab = jnp.concatenate(
        [scene.materials.albedo,
         scene.materials.roughness[:, None],
         scene.materials.emissive[:, None],
         scene.materials.ior[:, None]], axis=1)
    mrow = jnp.take(mtab, mat, axis=0, mode="clip")
    alb = (mrow[:, 0], mrow[:, 1], mrow[:, 2])
    rough, emis, ior = mrow[:, 3], mrow[:, 4], mrow[:, 5]

    is_metal = (mat >= METAL_HIGH) & (mat <= METAL_LOW)
    is_nonmetal = mat < METAL_HIGH
    is_glass_m = mat == GLASS
    is_smoke = (mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER)
    is_emissive = mat == EMISSIVE
    is_model = (mat > EMISSIVE) & (mat != MAT_NONE)

    # ---- emissive: terminal (renderer.cpp:1315-1316)
    emis_mask = active & is_emissive
    rad = cwhere(emis_mask,
                 cadd(rad, cmul(st["tp"], cscale(emis, alb))), rad)

    # ---- dielectric / smoke medium march (glass & smoke share it);
    # lax.cond skips the whole pass on bounces where no ray is inside a
    # medium (every bounce of the no-dielectric monu bench)
    march = active & in_glass & (is_glass_m | is_smoke) & (vol >= 0)
    mode_code = jnp.where(is_glass_m, dda.EXIT_GLASS, dda.EXIT_SMOKE)
    o3m, d3m = cstack(o), cstack(d)
    in_vol, t_exit, nrm_exit = jax.lax.cond(
        jnp.any(march),
        lambda args: material_exit_world(scene, *args),
        lambda args: (jnp.zeros(n, bool), jnp.zeros(n, F32),
                      (jnp.zeros(n, F32),) * 3),
        (o3m, d3m, vol, mode_code, march))
    t = jnp.where(march, t_exit, t)
    nrm = cwhere(march & in_vol, nrm_exit, nrm)
    # fell off the grid: move origin to boundary, t=0 (renderer.cpp:1175-1179)
    fell = march & ~in_vol
    o = cwhere(fell, cadd(o, cscale(t, d)), o)
    t = jnp.where(fell, 0.0, t)
    p_hit = cadd(o, cscale(t, d))

    # ---- light-kill detection (renderer.cpp:1437-1450): direct light at
    # player-smoke hits; sqrLength > threshold flags the ray for the game's
    # checkpoint revert.  Gated — costs one extra fused shadow pass.
    in_light = st.get("in_light", jnp.zeros(n, bool))
    if cfg.detect_light_kill:
        # gate: SMOKE-class hit in the PLAYER volume (voxIndex == 0),
        # renderer.cpp:1437-1450
        lk_mask = active & is_smoke & (vol == 0)
        lk = illumination(scene, cfg, p_hit, nrm, mat, lk_mask,
                          jax.random.fold_in(bkey, 9), alb=alb)
        in_light = in_light | (lk_mask
                               & (cdot(lk, lk) > cfg.light_kill_threshold))

    # ---- NEE for diffuse-ish lobes
    u_lobe = _uni(cfg, bkey, 1, (n,))
    cos_in = jnp.clip(cdot(cneg(d), nrm), a_max=1.0)
    go_diffuse = u_lobe > mathx.schlick_nonmetal(cos_in)
    nee_mask = active & ((is_nonmetal & go_diffuse) | is_model)
    inc = illumination(scene, cfg, p_hit, nrm, mat, nee_mask,
                       jax.random.fold_in(bkey, 2), alb=alb)
    # nonmetal: rad += T * inc ; model: rad += T * alb * inc
    rad = cwhere(nee_mask & is_nonmetal, cadd(rad, cmul(st["tp"], inc)), rad)
    rad = cwhere(nee_mask & is_model,
                 cadd(rad, cmul(st["tp"], cmul(alb, inc))), rad)

    # ---- continuation directions per lobe
    u_sph = _uni(cfg, bkey, 3, (3, n))
    g_hemi = _nrml(cfg, bkey, 4, (3, n))
    refl = creflect(d, nrm)
    sph = csphere_sample(u_sph[0], u_sph[1], u_sph[2])
    spec_dir = cadd(refl, cscale(rough, sph))
    diff_dir = cadd(nrm, sph)  # RandomLambertianReflectionVector
    model_dir = chemisphere_dir(nrm, (g_hemi[0], g_hemi[1], g_hemi[2]))

    # glass: Fresnel reflect-or-refract (renderer.cpp:1181-1208)
    ratio = jnp.where(in_glass, ior, 1.0 / ior)
    cos_g = jnp.minimum(cdot(cneg(d), nrm), 1.0)
    sin_g = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_g * cos_g))
    cannot_refract = ratio * sin_g > 1.0
    u_f = _uni(cfg, bkey, 5, (n,))
    do_reflect = cannot_refract | (mathx.schlick(cos_g, ratio, jnp) > u_f)
    refr_dir = crefract(d, nrm, ratio)
    glass_dir = cwhere(do_reflect, refl, refr_dir)
    glass_norm = cwhere(do_reflect, nrm, cneg(nrm))
    glass_flip = active & is_glass_m & ~do_reflect

    # smoke: stochastic in-scatter (renderer.cpp:1282-1289), then the
    # unconditional ratio-1 "refraction" pass-through
    intensity = jnp.where(in_glass & is_smoke, emis, 0.0)
    dist = jnp.where(march, t, 0.0)
    u_s = _uni(cfg, bkey, 6, (2, n))
    g_oct = _nrml(cfg, bkey, 8, (3, n))
    thresh = u_s[0] * 100.0 - intensity
    scatter = active & is_smoke & (u_s[1] * dist > thresh)
    scat_t = t * 0.45 + u_s[0] * (t - t * 0.45)  # Rand(t*.45, t)
    o = cwhere(scatter, cadd(o, cscale(scat_t, d)), o)
    d = cwhere(scatter, coctant_dir((g_oct[0], g_oct[1], g_oct[2])), d)
    t = jnp.where(scatter, 0.0, t)
    p_hit = cadd(o, cscale(t, d))
    # Absorption REPLACES the color (renderer.cpp:1290, 1596-1608)
    smoke_trans = tuple(
        jnp.exp(-dist * intensity * (1.0 - alb[i])) for i in range(3))
    # the ratio-1 refract leaves direction unchanged: continuation is d.

    # ---- select continuation
    new_d = cwhere(is_metal, spec_dir, d)
    new_d = cwhere(is_nonmetal & go_diffuse, diff_dir, new_d)
    new_d = cwhere(is_nonmetal & ~go_diffuse, spec_dir, new_d)
    new_d = cwhere(is_glass_m, glass_dir, new_d)
    new_d = cwhere(is_model, model_dir, new_d)
    new_d = cunit(new_d)

    off_n = nrm
    off_n = cwhere(is_glass_m, glass_norm, off_n)
    off_n = cwhere(is_smoke, cneg(nrm), off_n)
    new_o = coffset(p_hit, off_n)

    # ---- throughput updates
    tp = st["tp"]
    tp = cwhere(active & (is_metal | (is_nonmetal & go_diffuse) | is_model),
                cmul(tp, alb), tp)
    glass_color = cwhere(in_glass, alb, one3)
    tp = cwhere(active & is_glass_m, cmul(st["tp"], glass_color), tp)
    tp = cwhere(active & is_smoke, cmul(st["tp"], smoke_trans), tp)

    new_in_glass = jnp.where(glass_flip | (active & is_smoke),
                             ~in_glass, in_glass)
    new_active = active & ~is_emissive

    return dict(
        o=cwhere(new_active, new_o, o),
        d=cwhere(new_active, new_d, d),
        tp=tp, rad=rad, in_glass=new_in_glass, active=new_active,
        in_light=in_light, sky_tp=sky_tp, sky_d=sky_d,
    )


def _apply_deferred_sky(scene, cfg, st):
    """rad += sky_tp * sky(sky_d): the single per-frame sky texture take
    the bounce loop deferred (bitwise equal to per-bounce adds — a ray
    misses at most once and receives nothing afterwards)."""
    sky = _sky_c(scene, cfg, st["sky_d"])
    return cadd(st["rad"], cmul(st["sky_tp"], sky))


def trace_path(scene: SceneData, cfg: RenderConfig, o, d, key,
               return_aux: bool = False):
    """Full stochastic light transport; o, d: [N, 3].  Returns [N, 3]
    radiance (and, with return_aux, a dict with the per-ray `in_light`
    light-kill flags — renderer.cpp:1437-1450)."""
    n = o.shape[0]
    zero3 = (jnp.zeros(n, F32),) * 3
    one3 = (jnp.ones(n, F32),) * 3
    state = dict(
        o=cpack(o), d=cpack(d),
        tp=one3, rad=zero3,
        in_glass=jnp.zeros(n, bool),
        active=jnp.ones(n, bool),
        in_light=jnp.zeros(n, bool),
        sky_tp=zero3, sky_d=cpack(d),
    )

    if (cfg.compact_chunks > 1 and n >= cfg.compact_min
            and n % cfg.compact_chunks == 0):
        rad, aux = _trace_path_compacted(scene, cfg, state, key, n,
                                         cfg.compact_chunks)
        return (rad, aux) if return_aux else rad

    reorder = (cfg.bounce_reorder == "always"
               or (cfg.bounce_reorder == "auto"
                   and scene.volumes.n > 64
                   and n >= cfg.compact_min))
    if reorder and cfg.max_bounces >= 1:
        rad, aux = _trace_path_reordered(scene, cfg, state, key, n)
        return (rad, aux) if return_aux else rad

    def bounce(carry):
        st, depth = carry
        return (_bounce_core(scene, cfg, st, jax.random.fold_in(key, depth)),
                depth + 1)

    # depth loop with early exit (Trace depth semantics: maxBounces+1
    # segments, renderer.cpp:1076-1083)
    def cond(carry):
        st, depth = carry
        return (depth < cfg.max_bounces + 1) & jnp.any(st["active"])

    st, _ = jax.lax.while_loop(cond, bounce, (state, jnp.int32(0)))
    rad = _apply_deferred_sky(scene, cfg, st)
    if return_aux:
        return cstack(rad), dict(in_light=st["in_light"])
    return cstack(rad)


def take_rows(mat, idx):
    """Row gather of a [n, C] matrix in <=8-column chunks.

    XLA fuses the chunks into one gather pass; on the machine this was
    first tuned for, a single gather wider than 8 columns fell off the
    vectorized path.  Not yet re-measured on the GPU.  Every wide row
    permute in the hot paths routes here."""
    if mat.shape[1] <= 8:
        return jnp.take(mat, idx, axis=0)
    parts = [jnp.take(mat[:, c:c + 8], idx, axis=0)
             for c in range(0, mat.shape[1], 8)]
    return jnp.concatenate(parts, axis=1)


def _pack_path(st, pix):
    """Path-wavefront state as ONE [n, 22] f32 matrix (cols: o, d, tp,
    rad, in_glass, active, original ray id — f32-exact for n < 2^24 —
    in_light, sky_tp, sky_d) so per-bounce permutations are a single 2-D
    row gather instead of 16 separate 1-D takes."""
    cols = (list(st["o"]) + list(st["d"]) + list(st["tp"])
            + list(st["rad"])
            + [st["in_glass"].astype(F32), st["active"].astype(F32), pix,
               st["in_light"].astype(F32)]
            + list(st["sky_tp"]) + list(st["sky_d"]))
    return jnp.stack(cols, axis=1)


def _unpack_path(pk):
    return dict(
        o=(pk[:, 0], pk[:, 1], pk[:, 2]),
        d=(pk[:, 3], pk[:, 4], pk[:, 5]),
        tp=(pk[:, 6], pk[:, 7], pk[:, 8]),
        rad=(pk[:, 9], pk[:, 10], pk[:, 11]),
        in_glass=pk[:, 12] > 0.5, active=pk[:, 13] > 0.5,
        in_light=pk[:, 15] > 0.5,
        sky_tp=(pk[:, 16], pk[:, 17], pk[:, 18]),
        sky_d=(pk[:, 19], pk[:, 20], pk[:, 21]),
    ), pk[:, 14]


def _world_bounds(scene: SceneData):
    """World AABB over all instances: the 8 object-cube corners of every
    volume pushed through fwd (instances.instance_world_aabbs, traced)."""
    vols = scene.volumes
    cb = vols.cube_min  # [V, 3]
    lo = None
    hi = None
    for cx in (0.0, 1.0):
        for cy in (0.0, 1.0):
            for cz in (0.0, 1.0):
                p = cb + jnp.asarray([cx, cy, cz], F32)[None, :]
                w = (jnp.einsum("vij,vj->vi", vols.fwd[:, :3, :3], p,
                                precision=jax.lax.Precision.HIGHEST)
                     + vols.fwd[:, :3, 3])
                lo = w if lo is None else jnp.minimum(lo, w)
                hi = w if hi is None else jnp.maximum(hi, w)
    return jnp.min(lo, axis=0), jnp.max(hi, axis=0)


def _trace_path_reordered(scene: SceneData, cfg: RenderConfig, state, key,
                          n: int):
    """Bounce loop with per-bounce SPATIAL re-clustering of the wavefront.

    Diffuse-bounced rays are spatially incoherent: a block of consecutive
    rays holds origins from all over the scene, so whole blocks never
    finish early and the slowest ray sets each block's cost.  Before
    every bounce >= 1 this driver
    sorts the packed state by

        [ terminated : morton(origin, 5 bits/axis) : direction octant ]

    (one stable lax.sort of an i32 key + one [n, 22] row gather), so each
    block's rays start in the same coarse world cell heading the same
    way: terminated rays cluster into dead blocks again, and live blocks
    touch few volumes.  Pure dispatch order —
    per-lane estimators are unchanged; the counter-hash sampler reassigns
    which lane draws which jitter values (same distributions).  The final
    un-permutation is an inverse-index build + row gather instead of a
    row scatter."""
    lo, hi = _world_bounds(scene)
    span = jnp.maximum(hi - lo, 1e-6)
    iota = jnp.arange(n, dtype=jnp.int32)

    def morton_key(pk):
        done = pk[:, 13] <= 0.5
        q = []
        for c in range(3):
            f = (pk[:, c] - lo[c]) / span[c]
            q.append(jnp.clip((f * 32.0).astype(jnp.int32), 0, 31))
        m = jnp.zeros(n, jnp.int32)
        for bit in range(5):
            for c in range(3):
                m = m | (((q[c] >> bit) & 1) << (3 * bit + c + 3))
        oct_ = ((pk[:, 3] < 0).astype(jnp.int32)
                + 2 * (pk[:, 4] < 0).astype(jnp.int32)
                + 4 * (pk[:, 5] < 0).astype(jnp.int32))
        return jnp.where(done, jnp.int32(1 << 30), m | oct_)

    def outer(carry):
        pk, depth = carry

        def reorder(pk):
            k_srt, perm = jax.lax.sort((morton_key(pk), iota), num_keys=1)
            return take_rows(pk, perm)

        # bounce 0 keeps the camera tile order (already coherent); later
        # bounces re-sort every cfg.bounce_reorder_period-th bounce (the
        # [n,22] permute is the dominant cost and origin clusters decay
        # slowly, so period 2 keeps most of the win at half the tax)
        per = max(cfg.bounce_reorder_period, 1)
        pk = jax.lax.cond((depth > 0) & (((depth - 1) % per) == 0),
                          reorder, lambda x: x, pk)
        bkey = jax.random.fold_in(key, depth)
        kc = cfg.reorder_compact_chunks
        if kc > 1 and n % kc == 0:
            # live-prefix chunking: the morton key sorts terminated rays
            # to the tail, so live lanes end at the last set active flag —
            # dispatch n/kc-wide chunks and stop there, so late bounces
            # traverse at a fraction of the width.
            ch = n // kc
            c = jnp.max(jnp.where(pk[:, 13] > 0.5, iota + 1, 0))

            def chunk_cond(cc):
                return cc[0] * ch < c

            def chunk_body(cc):
                j, pk = cc
                sub = jax.lax.dynamic_slice_in_dim(pk, j * ch, ch, axis=0)
                st, pix = _unpack_path(sub)
                st = _bounce_core(scene, cfg, st,
                                  jax.random.fold_in(bkey, j))
                return j + 1, jax.lax.dynamic_update_slice_in_dim(
                    pk, _pack_path(st, pix), j * ch, axis=0)

            _, pk = jax.lax.while_loop(chunk_cond, chunk_body,
                                       (jnp.int32(0), pk))
            return pk, depth + 1
        st, pix = _unpack_path(pk)
        st = _bounce_core(scene, cfg, st, bkey)
        return _pack_path(st, pix), depth + 1

    def cond(carry):
        pk, depth = carry
        return (depth < cfg.max_bounces + 1) & jnp.any(pk[:, 13] > 0.5)

    packed0 = _pack_path(state, jnp.arange(n, dtype=F32))
    pk, _ = jax.lax.while_loop(cond, outer, (packed0, jnp.int32(0)))
    st_f, pixf = _unpack_path(pk)
    radc = cstack(_apply_deferred_sky(scene, cfg, st_f))
    pix = pixf.astype(jnp.int32)
    inv = jnp.zeros(n, jnp.int32).at[pix].set(iota)
    rad = jnp.take(radc, inv, axis=0)
    in_light = jnp.take(pk[:, 15] > 0.5, inv)
    return rad, dict(in_light=in_light)


def _trace_path_compacted(scene: SceneData, cfg: RenderConfig, state, key,
                          n: int, chunks: int):
    """Chunked-wavefront bounce loop: lockstep traversal cost is width x
    iterations whether lanes are alive or not, so each bounce first
    partitions surviving rays to a prefix (stable cumsum partition — no
    sort network), then traces fixed-width chunks of n/chunks in a nested
    while_loop that stops at the last live chunk: survival falls with
    every bounce, so late bounces run few chunks.

    State rides in ONE packed [n, 22] f32 matrix so the per-bounce
    permutation is a single 2-D row gather instead of 16 separate 1-D
    takes: columns 0-2 o, 3-5 d, 6-8
    throughput, 9-11 radiance, 12 in_glass, 13 active, 14 original ray id
    (f32-exact for n < 2^24), 15 in_light."""
    ch = n // chunks
    pack, unpack = _pack_path, _unpack_path

    packed0 = pack(state, jnp.arange(n, dtype=F32))
    iota = jnp.arange(n, dtype=jnp.int32)

    def outer(carry):
        pk, depth = carry
        acti = (pk[:, 13] > 0.5).astype(jnp.int32)
        c = jnp.sum(acti)
        pos_live = jnp.cumsum(acti) - 1
        pos_dead = c + jnp.cumsum(1 - acti) - 1
        dest = jnp.where(acti == 1, pos_live, pos_dead)  # old -> new, stable
        perm = jnp.zeros(n, jnp.int32).at[dest].set(iota)
        pk = take_rows(pk, perm)
        bkey = jax.random.fold_in(key, depth)

        def chunk_cond(cc):
            return cc[0] * ch < c

        def chunk_body(cc):
            j, pk = cc
            sub = jax.lax.dynamic_slice_in_dim(pk, j * ch, ch, axis=0)
            st, pix = unpack(sub)
            st = _bounce_core(scene, cfg, st, jax.random.fold_in(bkey, j))
            return j + 1, jax.lax.dynamic_update_slice_in_dim(
                pk, pack(st, pix), j * ch, axis=0)

        _, pk = jax.lax.while_loop(chunk_cond, chunk_body, (jnp.int32(0), pk))
        return pk, depth + 1

    def cond(carry):
        pk, depth = carry
        return (depth < cfg.max_bounces + 1) & jnp.any(pk[:, 13] > 0.5)

    pk, _ = jax.lax.while_loop(cond, outer, (packed0, jnp.int32(0)))
    st_f, pixf = unpack(pk)
    radc = cstack(_apply_deferred_sky(scene, cfg, st_f))
    pix = pixf.astype(jnp.int32)
    rad = jnp.zeros((n, 3), F32).at[pix].set(radc)
    in_light = jnp.zeros(n, bool).at[pix].set(pk[:, 15] > 0.5)
    return rad, dict(in_light=in_light)


# --------------------------------------------------------------------------
# Deterministic Whitted integrator (recursive, Fresnel-split) — [N, 3] path,
# used by golden tests and the whitted benchmark configs
# --------------------------------------------------------------------------

def _unit(v):
    n = jnp.sqrt((v * v).sum(-1, keepdims=True))
    return v / jnp.maximum(n, 1e-20)


def trace_whitted(scene: SceneData, cfg: RenderConfig, o, d, depth: int,
                  in_glass=None, active=None):
    n = o.shape[0]
    if in_glass is None:
        in_glass = jnp.zeros(n, bool)
    if active is None:
        active = jnp.ones(n, bool)
    if depth < 0:
        return jnp.zeros((n, 3), F32)

    hitrec = find_nearest_world(scene, o, d, active)
    t, mat, nrm, vol = hitrec["t"], hitrec["mat"], hitrec["normal"], hitrec["vol"]
    in_glass = jnp.where(hitrec["prim_adopt"], hitrec["prim_inside"], in_glass)
    sky = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
    miss = active & (mat == MAT_NONE)
    color = jnp.where(miss[:, None], sky, 0.0)

    alb = _albedo(scene, mat)
    emis = jnp.take(scene.materials.emissive, mat)
    ior = jnp.take(scene.materials.ior, mat)

    is_metal = (mat >= METAL_HIGH) & (mat <= METAL_LOW)
    is_glass_m = mat == GLASS
    is_smoke = (mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER)
    is_emissive = mat == EMISSIVE
    is_diffuse = (mat < METAL_HIGH) | ((mat > EMISSIVE) & (mat != MAT_NONE))

    # medium march for glass/smoke entered rays
    march = active & in_glass & (is_glass_m | is_smoke) & (vol >= 0)
    mode_code = jnp.where(is_glass_m, dda.EXIT_GLASS, dda.EXIT_SMOKE)
    in_vol, t_exit, nrm_exit = material_exit_world(scene, o, d, vol, mode_code, march)
    t = jnp.where(march, t_exit, t)
    nrm = jnp.where((march & in_vol)[:, None], cstack(nrm_exit), nrm)
    fell = march & ~in_vol
    o = jnp.where(fell[:, None], o + t[:, None] * d, o)
    t = jnp.where(fell, 0.0, t)
    p_hit = o + t[:, None] * d

    # emissive terminal
    color = color + jnp.where((active & is_emissive)[:, None],
                              alb * emis[:, None], 0.0)

    # diffuse: deterministic NEE sum only
    nee_mask = active & is_diffuse
    inc = cstack(illumination(scene, cfg, p_hit, nrm, mat, nee_mask,
                              jax.random.PRNGKey(0)))
    is_model = (mat > EMISSIVE) & (mat != MAT_NONE)
    color = color + jnp.where((nee_mask & ~is_model)[:, None], inc, 0.0)
    color = color + jnp.where((nee_mask & is_model)[:, None], inc * alb, 0.0)

    if depth == 0:
        return color

    # metal: perfect mirror
    refl = cstack(creflect(cpack(d), cpack(nrm)))
    metal_mask = active & is_metal
    mo = cstack(coffset(cpack(p_hit), cpack(nrm)))
    sub = trace_whitted(scene, cfg, mo, _unit(refl), depth - 1,
                        jnp.zeros(n, bool), metal_mask)
    color = color + jnp.where(metal_mask[:, None], sub * alb, 0.0)

    # glass: deterministic Fresnel split + smoke pass-through
    glass_mask = active & is_glass_m
    smoke_mask = active & is_smoke
    media_mask = glass_mask | smoke_mask
    ratio = jnp.where(in_glass, ior, 1.0 / ior)
    ratio = jnp.where(is_smoke, 1.0, ratio)
    cos_g = jnp.minimum((-d * nrm).sum(-1), 1.0)
    sin_g = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_g * cos_g))
    cannot_refract = (ratio * sin_g > 1.0) & glass_mask
    r_coef = jnp.where(cannot_refract, 1.0, mathx.schlick(cos_g, ratio, jnp))
    r_coef = jnp.where(smoke_mask, 0.0, r_coef)  # smoke never reflects
    glass_color = jnp.where(in_glass[:, None], alb, jnp.ones((n, 3), F32))
    intensity = jnp.where(in_glass & is_smoke, emis, 0.0)
    dist = jnp.where(march, t, 0.0)
    smoke_trans = mathx.absorption(alb, intensity, dist, jnp)
    media_color = jnp.where(smoke_mask[:, None], smoke_trans, glass_color)

    if cfg.whitted_glass_split:
        # reflected branch (glass only, weight r)
        need_refl = glass_mask & (r_coef > 0.0)
        ro = cstack(coffset(cpack(p_hit), cpack(nrm)))
        sub_r = trace_whitted(scene, cfg, ro, _unit(refl), depth - 1,
                              in_glass, need_refl)
        color = color + jnp.where(need_refl[:, None],
                                  sub_r * media_color * r_coef[:, None], 0.0)
        # refracted branch (weight 1-r); smoke passes straight through
        refr_dir = cstack(crefract(cpack(d), cpack(nrm), ratio))
        refr_dir = jnp.where(smoke_mask[:, None], d, refr_dir)
        need_refr = media_mask & (r_coef < 1.0)
        fo = cstack(coffset(cpack(p_hit), cpack(-nrm)))
        sub_t = trace_whitted(scene, cfg, fo, _unit(refr_dir), depth - 1,
                              jnp.where(media_mask, ~in_glass, in_glass),
                              need_refr)
        color = color + jnp.where(need_refr[:, None],
                                  sub_t * media_color * (1.0 - r_coef[:, None]), 0.0)
    return color


def trace_whitted_iter(scene: SceneData, cfg: RenderConfig, o, d,
                       depth: int, return_iters: bool = False):
    """Iterative Whitted as a fixed-width WAVEFRONT QUEUE over branches.

    The reference recurses a megafunction per branch (renderer.cpp:
    1076-1328); a per-ray LIFO stack that pops ONE branch per ray per
    iteration makes the iteration count equal the largest branch TREE
    over the image (room.vox's glass floor at depth 5 runs dozens of
    full-width nearest+shadow passes even after weight culling).
    Branches of one pixel only
    ever ADD radiance, so their processing order is free.  This version
    keeps ALL pixels' pending branches in one compact queue and each
    iteration processes the first W = N of them, whoever's they are:

      * each processed branch contributes its terminal/NEE radiance
        (three 1-D channel scatter-adds instead of a [W, 3] row
        scatter) and emits
        up to two weighted children (metal mirror / Fresnel split,
        weight-culled at cfg.whitted_cull_eps);
      * children compact (one cumsum + 1-D position scatter + row
        gather) and append at the queue tail, preserving parent order so
        the primaries' tile layout keeps traversal blocks coherent;
      * iterations ~ total-branch-work / N + chain depth, and every
        per-iteration op is O(N) — a full-width BFS variant ran O(4N)
        sky/material/scatter ops per level and was slower than the stack
        it replaced.

    The queue rides in ONE packed [cap, 12] f32 matrix (columns: o, d,
    weight, in_glass, depth-left, pixel id); cap = 5N holds every
    measured scene's population (room peaks ~2.6N; growth beyond 4N
    drops newest-first).  Estimator and per-branch math are unchanged vs
    the recursive trace_whitted; only the float SUMMATION ORDER per pixel
    differs (branch adds commute to rounding)."""
    n = o.shape[0]
    W = n
    cap = 5 * n
    NC = 12  # ox oy oz dx dy dz wr wg wb gl dep pix

    def pack(o3, d3, w, gl, dep, pix):
        return jnp.stack([o3[0], o3[1], o3[2], d3[0], d3[1], d3[2],
                          w[0], w[1], w[2], gl, dep, pix], axis=1)

    fr0 = jnp.zeros((cap, NC), F32)
    prim = pack(cpack(o), cpack(d), (jnp.ones(n, F32),) * 3,
                jnp.zeros(n, F32), jnp.full(n, depth, F32),
                jnp.arange(n, dtype=F32))
    fr0 = jax.lax.dynamic_update_slice_in_dim(fr0, prim, 0, axis=0)
    img0 = jnp.zeros(3 * n, F32)  # flat channel-interleaved accumulator

    if cfg.whitted_sort_batch:
        wlo, whi = _world_bounds(scene)
        wspan = jnp.maximum(whi - wlo, 1e-6)

    def body(carry):
        fr, count, img, it = carry
        take = jnp.minimum(count, W)
        batch = fr[:W]
        live = jnp.arange(W, dtype=jnp.int32) < take
        if cfg.whitted_sort_batch:
            # re-cluster the batch: queue pops mix branch generations, so
            # a traversal block holds origins from all over the scene and
            # the walk pays the slowest lane (same disease as path
            # bounces, cfg.bounce_reorder).  One coarse morton sort of the
            # batch restores block coherence; dead rows sort last, so
            # whole blocks finish early.  Radiance adds per
            # pixel commute; children keep their parent's pixel id.
            q = []
            for c in range(3):
                f = (batch[:, c] - wlo[c]) / wspan[c]
                q.append(jnp.clip((f * 32.0).astype(jnp.int32), 0, 31))
            mkey = jnp.zeros(W, jnp.int32)
            for bit in range(5):
                for c in range(3):
                    mkey = mkey | (((q[c] >> bit) & 1) << (3 * bit + c + 3))
            mkey = mkey | ((batch[:, 3] < 0).astype(jnp.int32)
                           + 2 * (batch[:, 4] < 0).astype(jnp.int32)
                           + 4 * (batch[:, 5] < 0).astype(jnp.int32))
            mkey = jnp.where(live, mkey, jnp.int32(1 << 30))
            ks, perm = jax.lax.sort(
                (mkey, jnp.arange(W, dtype=jnp.int32)), num_keys=1)
            batch = take_rows(batch, perm)
            live = ks < (1 << 30)
        toc = (batch[:, 0], batch[:, 1], batch[:, 2])
        tdc = (batch[:, 3], batch[:, 4], batch[:, 5])
        w = (batch[:, 6], batch[:, 7], batch[:, 8])
        in_glass = batch[:, 9] > 0.5
        dep = batch[:, 10].astype(jnp.int32)
        pix = batch[:, 11].astype(jnp.int32)
        to = cstack(toc)
        td = cstack(tdc)

        rec = find_nearest_world(scene, to, td, live)
        t, mat, vol = rec["t"], rec["mat"], rec["vol"]
        nrm = (rec["nx"], rec["ny"], rec["nz"])
        in_glass = jnp.where(rec["prim_adopt"], rec["prim_inside"], in_glass)
        sky = _sky_c(scene, cfg, tdc)
        miss = live & (mat == MAT_NONE)
        contrib = cwhere(miss, cmul(w, sky), (jnp.zeros(W, F32),) * 3)
        live_hit = live & ~miss

        mtab = jnp.concatenate(
            [scene.materials.albedo,
             scene.materials.emissive[:, None],
             scene.materials.ior[:, None]], axis=1)
        mrow = jnp.take(mtab, mat, axis=0, mode="clip")
        alb = (mrow[:, 0], mrow[:, 1], mrow[:, 2])
        emis, ior = mrow[:, 3], mrow[:, 4]

        is_metal = (mat >= METAL_HIGH) & (mat <= METAL_LOW)
        is_glass_m = mat == GLASS
        is_smoke = (mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER)
        is_emissive = mat == EMISSIVE
        is_model = (mat > EMISSIVE) & (mat != MAT_NONE)
        is_diffuse = (mat < METAL_HIGH) | is_model

        # medium march (cond-skipped on iterations with no medium rays)
        march = live_hit & in_glass & (is_glass_m | is_smoke) & (vol >= 0)
        mode_code = jnp.where(is_glass_m, dda.EXIT_GLASS, dda.EXIT_SMOKE)
        in_vol, t_exit, nrm_exit = jax.lax.cond(
            jnp.any(march),
            lambda a: material_exit_world(scene, *a),
            lambda a: (jnp.zeros(W, bool), jnp.zeros(W, F32),
                       (jnp.zeros(W, F32),) * 3),
            (to, td, vol, mode_code, march))
        t = jnp.where(march, t_exit, t)
        nrm = cwhere(march & in_vol, nrm_exit, nrm)
        fell = march & ~in_vol
        toc = cwhere(fell, cadd(toc, cscale(t, tdc)), toc)
        t = jnp.where(fell, 0.0, t)
        p_hit = cadd(toc, cscale(t, tdc))

        # emissive terminal
        contrib = cwhere(live_hit & is_emissive,
                         cadd(contrib, cmul(w, cscale(emis, alb))), contrib)

        # diffuse: NEE sum
        nee_mask = live_hit & is_diffuse & (dep >= 0)
        inc = illumination(scene, cfg, p_hit, nrm, mat, nee_mask,
                           jax.random.PRNGKey(0), alb=alb)
        contrib = cwhere(nee_mask & ~is_model, cadd(contrib, cmul(w, inc)),
                         contrib)
        contrib = cwhere(nee_mask & is_model,
                         cadd(contrib, cmul(w, cmul(alb, inc))), contrib)

        for c in range(3):
            img = img.at[pix * 3 + c].add(
                jnp.where(live, contrib[c], 0.0))

        can_rec = dep > 0
        refl = cunit(creflect(tdc, nrm))

        # metal continuation (weight *= albedo)
        metal_go = live_hit & is_metal & can_rec
        mo = coffset(p_hit, nrm)

        # glass/smoke split
        glass_mask = live_hit & is_glass_m
        smoke_mask = live_hit & is_smoke
        media_mask = (glass_mask | smoke_mask) & can_rec
        ratio = jnp.where(in_glass, ior, 1.0 / ior)
        ratio = jnp.where(is_smoke, 1.0, ratio)
        cos_g = jnp.minimum(cdot(cneg(tdc), nrm), 1.0)
        sin_g = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_g * cos_g))
        cannot_refract = (ratio * sin_g > 1.0) & glass_mask
        r_coef = jnp.where(cannot_refract, 1.0,
                           mathx.schlick(cos_g, ratio, jnp))
        r_coef = jnp.where(smoke_mask, 0.0, r_coef)
        glass_color = cwhere(in_glass, alb, (jnp.ones(W, F32),) * 3)
        intensity = jnp.where(in_glass & is_smoke, emis, 0.0)
        dist = jnp.where(march, t, 0.0)
        smoke_trans = tuple(
            jnp.exp(-dist * intensity * (1.0 - alb[i])) for i in range(3))
        media_color = cwhere(smoke_mask, smoke_trans, glass_color)
        refr_dir = crefract(tdc, nrm, ratio)
        refr_dir = cwhere(smoke_mask, tdc, refr_dir)
        refr_dir = cunit(refr_dir)
        fo = coffset(p_hit, cneg(nrm))

        if cfg.whitted_glass_split:
            need_refr = media_mask & (r_coef < 1.0)
            need_refl = media_mask & glass_mask & (r_coef > 0.0)
        else:
            need_refr = jnp.zeros(W, bool)
            need_refl = jnp.zeros(W, bool)

        # child 1: metal mirror OR refracted branch
        c1 = metal_go | need_refr
        c1_o = cwhere(metal_go, mo, fo)
        c1_d = cwhere(metal_go, refl, refr_dir)
        w_metal = cmul(w, alb)
        w_refr = cscale(1.0 - r_coef, cmul(w, media_color))
        c1_w = cwhere(metal_go, w_metal, w_refr)
        c1_gl = jnp.where(metal_go, 0.0,
                          jnp.where(media_mask, 1.0 - in_glass, in_glass))
        # child 2: reflected glass branch
        ro = coffset(p_hit, nrm)
        w_refl = cscale(r_coef, cmul(w, media_color))
        c2 = need_refl
        if cfg.whitted_cull_eps > 0.0:
            # a culled branch changes its pixel by at most eps x radiance
            eps = cfg.whitted_cull_eps
            c1 = c1 & (jnp.maximum(jnp.maximum(c1_w[0], c1_w[1]), c1_w[2])
                       > eps)
            c2 = c2 & (jnp.maximum(jnp.maximum(w_refl[0], w_refl[1]),
                                   w_refl[2]) > eps)

        ch1 = pack(c1_o, c1_d, c1_w, c1_gl, (dep - 1).astype(F32),
                   pix.astype(F32))
        ch2 = pack(ro, refl, w_refl, in_glass.astype(F32),
                   (dep - 1).astype(F32), pix.astype(F32))
        children = jnp.concatenate([ch1, ch2], axis=0)  # [2W, NC]
        valid = jnp.concatenate([c1, c2])
        # stable compaction of valid children: cumsum + 1-D position
        # scatter + row gather instead of a row SCATTER of the children;
        # invalid rows route out of range and drop
        vi = valid.astype(jnp.int32)
        dest = jnp.cumsum(vi) - 1
        nc = dest[-1] + 1
        dest_w = jnp.where(valid, dest, 2 * W)
        src = jnp.zeros(2 * W, jnp.int32).at[dest_w].set(
            jnp.arange(2 * W, dtype=jnp.int32), mode="drop")
        ch_comp = take_rows(children, src)  # [2W, NC] (prefix valid)

        # pop the batch, append the children: remaining queue shifts down
        # W rows, the compacted child block lands at the new tail.  Rows
        # past the valid prefix are garbage the NEXT append overwrites
        # (appends always start exactly at `count`).
        rem = jnp.minimum(jnp.maximum(count - W, 0), 4 * n - 2 * W)
        fr = jnp.roll(fr, -W, axis=0)
        fr = jax.lax.dynamic_update_slice(fr, ch_comp,
                                          (rem, jnp.int32(0)))
        count = rem + nc
        return fr, count, img, it + 1

    def cond(carry):
        _, count, _, it = carry
        return (count > 0) & (it < 4 * (depth + 2) + 8)

    _, _, img, iters = jax.lax.while_loop(
        cond, body, (fr0, jnp.int32(n), img0, jnp.int32(0)))
    img = img.reshape(n, 3)
    if return_iters:
        return img, iters
    return img


# --------------------------------------------------------------------------
# Top-level rendering
# --------------------------------------------------------------------------

def _pixel_grid(cfg: RenderConfig):
    x = jnp.arange(cfg.width, dtype=F32)
    y = jnp.arange(cfg.height, dtype=F32)
    px, py = jnp.meshgrid(x, y)  # [H, W]
    return px.reshape(-1), py.reshape(-1)


def _sample_pixels(scene: SceneData, cfg: RenderConfig, key, px, py,
                   return_aux: bool = False):
    """One sample for the given pixel coordinates -> radiance [N, 3]."""
    from voxtracer.render.camera import primary_rays

    n = px.shape[0]
    deterministic = cfg.mode in ("primary", "whitted")
    if not deterministic:
        u = _uni(cfg, key, 100, (n, 2))
        px = px + u[:, 0] * cfg.aa_strength
        py = py + u[:, 1] * cfg.aa_strength
    lens = (_uni(cfg, key, 101, (n, 2))
            if (cfg.use_dof and not deterministic) else None)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py, lens, jnp)

    if cfg.mode == "primary":
        rec = find_nearest_world(scene, o, d, jnp.ones(n, bool))
        sky = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
        rad = jnp.where(rec["hit"][:, None], _albedo(scene, rec["mat"]), sky)
        return (rad, dict(in_light=jnp.zeros(n, bool))) if return_aux else rad
    if cfg.mode == "whitted":
        rad = trace_whitted_iter(scene, cfg, o, d, cfg.max_bounces)
        return (rad, dict(in_light=jnp.zeros(n, bool))) if return_aux else rad
    return trace_path(scene, cfg, o, d, key, return_aux=return_aux)


def render_sample(scene: SceneData, cfg: RenderConfig, key):
    """One sample per pixel -> radiance [H*W, 3]."""
    px, py = _pixel_grid(cfg)
    return _sample_pixels(scene, cfg, key, px, py)


@partial(jax.jit, static_argnames=("cfg", "spp"))
def render_game_frame(scene: SceneData, cfg: RenderConfig, key, spp: int = 1):
    """Game-loop frame: radiance image + the light-kill flag (ANY ray this
    frame saw a lit player-smoke cell — renderer.cpp:1437-1450).  Requires
    cfg.detect_light_kill and path mode."""
    px, py = _pixel_grid(cfg)

    def body(carry, i):
        acc, lit = carry
        k = jax.random.fold_in(key, i)
        rad, aux = _sample_pixels(scene, cfg, k, px, py, return_aux=True)
        return (acc + rad, lit | jnp.any(aux["in_light"])), None

    (acc, lit), _ = jax.lax.scan(
        body, (jnp.zeros((cfg.width * cfg.height, 3), F32), jnp.bool_(False)),
        jnp.arange(spp))
    return (acc / spp).reshape(cfg.height, cfg.width, 3), lit


@partial(jax.jit, static_argnames=("cfg", "spp"))
def render(scene: SceneData, cfg: RenderConfig, key, spp: int = 1):
    """Average spp samples -> [H, W, 3] radiance image."""
    def body(acc, i):
        return acc + render_sample(scene, cfg, jax.random.fold_in(key, i)), None

    acc, _ = jax.lax.scan(body, jnp.zeros((cfg.width * cfg.height, 3), F32),
                          jnp.arange(spp))
    return (acc / spp).reshape(cfg.height, cfg.width, 3)


def _tile_shape(cfg: RenderConfig):
    """(tile_h, tile_w) for cfg.ray_order == "tile", else (None, None)."""
    if cfg.ray_order != "tile" or cfg.width % 128 != 0:
        return None, None
    return 8, 128


def _band_radiance(scene: SceneData, cfg: RenderConfig, key, row0, rows: int,
                   spp: int):
    """spp-averaged radiance for `rows` scanlines starting at traced row0
    (an int32 scalar).  Rows past the image bottom are clamped to the last
    scanline — cheap waste that keeps every band identically shaped.

    ray_order "tile": rays are GENERATED in 8x128-pixel-tile order (pure
    index arithmetic, no gather) so each traversal block covers a
    spatially-compact tile instead of part of a scanline, and the radiance
    is un-tiled afterwards with one reshape/transpose (a layout copy).
    A block runs until its slowest ray is done, so compact tiles cut the
    lockstep tail of every traversal pass of every bounce."""
    th, tw = _tile_shape(cfg)
    if th is None:
        x = jnp.arange(cfg.width, dtype=F32)
        y = jnp.arange(rows, dtype=F32) + row0.astype(F32)
        y = jnp.minimum(y, cfg.height - 1)
        px, py = jnp.meshgrid(x, y)
        px, py = px.reshape(-1), py.reshape(-1)
        rows_p = rows
    else:
        rows_p = -(-rows // th) * th  # <=7 clamped waste rows per band
        ntx = cfg.width // tw
        i = jnp.arange(rows_p * cfg.width, dtype=jnp.int32)
        tile, rem = i // (th * tw), i % (th * tw)
        ty, tx = tile // ntx, tile % ntx
        iy, ix = rem // tw, rem % tw
        px = (tx * tw + ix).astype(F32)
        y = (ty * th + iy).astype(F32) + row0.astype(F32)
        py = jnp.minimum(y, cfg.height - 1)

    def body(acc, i):
        k = jax.random.fold_in(jax.random.fold_in(key, i), row0)
        return acc + _sample_pixels(scene, cfg, k, px, py), None

    acc, _ = jax.lax.scan(body, jnp.zeros((rows_p * cfg.width, 3), F32),
                          jnp.arange(spp))
    acc = acc / spp
    if th is not None:
        acc = acc.reshape(rows_p // th, ntx, th, tw, 3)
        acc = acc.transpose(0, 2, 1, 3, 4).reshape(rows_p, cfg.width, 3)
        acc = acc[:rows].reshape(rows * cfg.width, 3)
    return acc


@partial(jax.jit, static_argnames=("cfg", "spp", "rows"))
def _render_band(scene: SceneData, cfg: RenderConfig, key, row0, rows: int,
                 spp: int):
    return _band_radiance(scene, cfg, key, row0.astype(jnp.int32), rows, spp)


@partial(jax.jit, static_argnames=("cfg", "spp", "tiles"))
def _render_banded(scene: SceneData, cfg: RenderConfig, key, spp: int,
                   tiles: int):
    """ONE dispatch for the whole frame: lax.scan over row bands.

    Banding bounds peak memory (the XLA traversal's [V, N] state grows
    with the band) and shortens the lockstep loop (a band's worst-case
    ray governs only its own band), and the whole frame is still one
    dispatch."""
    h, w = cfg.height, cfg.width
    rows = -(-h // tiles)

    def band(_, b):
        return None, _band_radiance(scene, cfg, key, b * rows, rows, spp)

    _, bands = jax.lax.scan(band, None, jnp.arange(tiles, dtype=jnp.int32))
    return bands.reshape(tiles * rows, w, 3)[:h]


def render_tiled(scene: SceneData, cfg: RenderConfig, key, spp: int = 1,
                 tiles: int = 8):
    """Render in row bands (single fused dispatch) -> np [H, W, 3]."""
    import numpy as np

    return np.asarray(_render_banded(scene, cfg, key, spp, tiles))
