"""Temporal reprojection ("static camera" mode) — SURVEY.md §2 #15.

Two-pass pipeline (reference: renderer.cpp:1997-2101):
  pass 1  trace_reproject(): the decomposed integrator — per pixel returns
          {albedo, illumination} with final color = albedo * illumination,
          plus the first-hit G-buffer (point/normal/t/material).  NOTE the
          reference's reproject estimator differs from Trace(): non-metals
          always take the diffuse branch (no Schlick split) and the albedo
          multiplies the whole sub-path (TraceNonMetal, renderer.cpp:
          1342-1357) — replicated.
  pass 2  resolve(): reproject first-hit points into the previous camera
          (frustum-plane PointToUV, camera.h:34-49), validate with an
          occlusion ray from the previous camera (renderer.cpp:767-774),
          bilinear-sample history (renderer.cpp:777-830), clamp in YCoCg
          mean±0.75σ of the 3x3 neighborhood (renderer.cpp:856-910), blend
          with per-material weights (renderer.cpp:2050-2084).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from voxtracer.config import RenderConfig
from voxtracer.core import mathx
from voxtracer.core.sampling import (
    lambertian_dir,
    positive_octant_dir,
    sphere_sample,
    uniform_hemisphere_dir,
)
from voxtracer.core.types import (
    EMISSIVE,
    GLASS,
    MAT_NONE,
    METAL_HIGH,
    METAL_LOW,
    SMOKE_LOW_DENSITY,
    SMOKE_PLAYER,
    Camera,
    SceneData,
)
from voxtracer.kernels import dda
from voxtracer.render.integrator import (
    _albedo,
    _pixel_grid,
    _unit,
    cstack,
    find_nearest_world,
    illumination,
    is_occluded_world,
    material_exit_world,
)
from voxtracer.render.sky import sample_sky
from voxtracer.render.tonemap import tonemap

F32 = jnp.float32


# ---------------------------------------------------------------------------
# Frustum-plane reprojection math (camera.h:28-66)
# ---------------------------------------------------------------------------

def frustum_normals(cam: Camera, aspect: float):
    """SetFrustumNormals (camera.h:53-66), left-handed convention."""
    left_dir = 2.0 * cam.ahead - aspect * cam.right
    right_dir = 2.0 * cam.ahead + aspect * cam.right
    top_dir = 2.0 * cam.ahead + cam.up
    bottom_dir = 2.0 * cam.ahead - cam.up
    return (jnp.cross(cam.up, left_dir), jnp.cross(right_dir, cam.up),
            jnp.cross(cam.right, top_dir), jnp.cross(bottom_dir, cam.right))


def point_to_uv(cam: Camera, aspect: float, points):
    """PointToUV (camera.h:34-49): frustum-plane distance ratios."""
    ln, rn, tn, bn = frustum_normals(cam, aspect)
    delta = points - cam.pos
    hi = jax.lax.Precision.HIGHEST
    ld = jnp.dot(delta, ln, precision=hi)
    rd = jnp.dot(delta, rn, precision=hi)
    td = jnp.dot(delta, tn, precision=hi)
    bd = jnp.dot(delta, bn, precision=hi)
    return jnp.stack([ld / (ld + rd), td / (td + bd)], axis=-1)


# ---------------------------------------------------------------------------
# Pass 1: decomposed wavefront integrator
# ---------------------------------------------------------------------------

def trace_reproject(scene: SceneData, cfg: RenderConfig, o, d, key):
    """Returns (albedo0 [N,3], illum [N,3], point [N,3], normal [N,3],
    t [N], mat [N])."""
    n = o.shape[0]
    state = dict(
        o=o, d=d,
        throughput=jnp.ones((n, 3), F32),
        radiance=jnp.zeros((n, 3), F32),
        in_glass=jnp.zeros(n, bool),
        active=jnp.ones(n, bool),
        albedo0=jnp.ones((n, 3), F32),
        p0=jnp.zeros((n, 3), F32),
        n0=jnp.zeros((n, 3), F32),
        t0=jnp.zeros(n, F32),
        m0=jnp.full(n, MAT_NONE, jnp.int32),
        sky_tp=jnp.zeros((n, 3), F32),
        sky_d=d,
    )

    def bounce(carry):
        st, depth = carry
        bkey = jax.random.fold_in(key, depth)
        first = depth == 0
        o, d, active = st["o"], st["d"], st["active"]
        rec = find_nearest_world(scene, o, d, active)
        t, mat, nrm, vol = rec["t"], rec["mat"], rec["normal"], rec["vol"]
        in_glass = jnp.where(rec["prim_adopt"], rec["prim_inside"], st["in_glass"])

        # one [256, 6] row lookup instead of four per-property takes
        mtab = jnp.concatenate(
            [scene.materials.albedo,
             scene.materials.roughness[:, None],
             scene.materials.emissive[:, None],
             scene.materials.ior[:, None]], axis=1)
        mrow = jnp.take(mtab, mat, axis=0, mode="clip")
        alb = mrow[:, 0:3]
        rough, emis, ior = mrow[:, 3], mrow[:, 4], mrow[:, 5]

        is_metal = (mat >= METAL_HIGH) & (mat <= METAL_LOW)
        is_nonmetal = mat < METAL_HIGH
        is_glass_m = mat == GLASS
        is_smoke = (mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER)
        is_emissive = mat == EMISSIVE
        is_model = (mat > EMISSIVE) & (mat != MAT_NONE)
        miss = active & (mat == MAT_NONE)

        # medium march (glass/smoke entered rays)
        march = active & in_glass & (is_glass_m | is_smoke) & (vol >= 0)
        mode_code = jnp.where(is_glass_m, dda.EXIT_GLASS, dda.EXIT_SMOKE)
        in_vol, t_exit, nrm_exit = jax.lax.cond(
            jnp.any(march),
            lambda a: material_exit_world(scene, *a),
            lambda a: (jnp.zeros(n, bool), jnp.zeros(n, F32),
                       (jnp.zeros(n, F32),) * 3),
            (o, d, vol, mode_code, march))
        t = jnp.where(march, t_exit, t)
        nrm = jnp.where((march & in_vol)[:, None], cstack(nrm_exit), nrm)
        fell = march & ~in_vol
        o = jnp.where(fell[:, None], o + t[:, None] * d, o)
        t = jnp.where(fell, 0.0, t)
        p_hit = o + t[:, None] * d

        # smoke scatter + absorption (TraceSmoke, renderer.cpp:1472-1481)
        intensity = jnp.where(in_glass & is_smoke, emis, 0.0)
        dist = jnp.where(march, t, 0.0)
        u_s = jax.random.uniform(jax.random.fold_in(bkey, 6), (n, 2), F32)
        g_oct = jax.random.normal(jax.random.fold_in(bkey, 8), (n, 3), F32)
        scatter = active & is_smoke & (u_s[:, 1] * dist > u_s[:, 0] * 100.0 - intensity)
        scat_t = t * 0.45 + u_s[:, 0] * (t - t * 0.45)
        o = jnp.where(scatter[:, None], o + d * scat_t[:, None], o)
        d = jnp.where(scatter[:, None], positive_octant_dir(g_oct, jnp), d)
        t = jnp.where(scatter, 0.0, t)
        p_hit = o + t[:, None] * d
        smoke_trans = mathx.absorption(alb, intensity, dist, jnp)

        # per-lobe "albedo" factor (the decomposed component).  The sky
        # take is DEFERRED to one per-frame texture read: a ray misses at
        # most once, so (throughput, direction) recorded at the miss
        # reproduces the per-bounce sum bit-for-value (trace_path's
        # round-3 lesson); the first-level miss albedo0 resolves
        # post-loop from the primary directions.
        glass_color = jnp.where(in_glass[:, None], alb, 1.0)
        lobe_albedo = alb
        lobe_albedo = jnp.where(is_glass_m[:, None], glass_color, lobe_albedo)
        lobe_albedo = jnp.where(is_smoke[:, None], smoke_trans, lobe_albedo)
        lobe_albedo = jnp.where(is_emissive[:, None],
                                alb * emis[:, None], lobe_albedo)

        # first hit: record G-buffer + pull albedo out of the path product
        albedo0 = jnp.where((first & active)[:, None], lobe_albedo, st["albedo0"])
        p0 = jnp.where((first & active)[:, None], p_hit, st["p0"])
        n0 = jnp.where((first & active)[:, None], nrm, st["n0"])
        t0 = jnp.where(first & active, t, st["t0"])
        m0 = jnp.where(first & active, mat, st["m0"])

        tp = st["throughput"]
        radiance = st["radiance"]

        # terminal lobes: illumination 1 at the first (decomposed) level,
        # T * lobe_albedo (GetColor) when reached deeper in the path.
        # Deep misses defer their tp * sky to the per-frame take.
        term = active & (is_emissive | miss)
        radiance = radiance + jnp.where(
            term[:, None],
            jnp.where(first, jnp.ones((n, 3), F32),
                      jnp.where(miss[:, None], 0.0, tp * lobe_albedo)),
            0.0)
        sky_tp = jnp.where((miss & ~first)[:, None], tp, st["sky_tp"])
        sky_d = jnp.where(miss[:, None], d, st["sky_d"])
        active = active & ~term

        # NEE for diffuse lobes (nonmetal has NO spec split in reproject
        # mode, renderer.cpp:1342-1357)
        nee_mask = active & (is_nonmetal | is_model)
        inc = cstack(illumination(scene, cfg, p_hit, nrm, mat, nee_mask,
                                  jax.random.fold_in(bkey, 2)))
        # illumination bucket gets inc WITHOUT the lobe albedo; the albedo
        # multiplies at GetColor per level — except the first level where
        # it is the decomposed output
        eff_alb = jnp.where(first, jnp.ones((n, 3), F32), lobe_albedo)
        radiance = radiance + jnp.where(nee_mask[:, None], tp * eff_alb * inc, 0.0)

        # continuation directions
        u_sph = jax.random.uniform(jax.random.fold_in(bkey, 3), (n, 3), F32)
        g_hemi = jax.random.normal(jax.random.fold_in(bkey, 4), (n, 3), F32)
        refl = mathx.reflect(d, nrm)
        spec_dir = refl + rough[:, None] * sphere_sample(u_sph, jnp)
        diff_dir = lambertian_dir(nrm, u_sph, jnp)
        model_dir = uniform_hemisphere_dir(nrm, g_hemi, jnp)

        ratio = jnp.where(in_glass, ior, 1.0 / ior)
        cos_g = jnp.minimum((-d * nrm).sum(-1), 1.0)
        sin_g = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_g * cos_g))
        cannot_refract = ratio * sin_g > 1.0
        u_f = jax.random.uniform(jax.random.fold_in(bkey, 5), (n,), F32)
        do_reflect = cannot_refract | (mathx.schlick(cos_g, ratio, jnp) > u_f)
        refr_dir = mathx.refract(d, nrm, ratio, jnp)
        glass_dir = jnp.where(do_reflect[:, None], refl, refr_dir)
        glass_norm = jnp.where(do_reflect[:, None], nrm, -nrm)
        glass_flip = active & is_glass_m & ~do_reflect

        new_d = jnp.where(is_metal[:, None], spec_dir, d)
        new_d = jnp.where(is_nonmetal[:, None], diff_dir, new_d)
        new_d = jnp.where(is_glass_m[:, None], glass_dir, new_d)
        new_d = jnp.where(is_model[:, None], model_dir, new_d)
        new_d = _unit(new_d)

        off_n = nrm
        off_n = jnp.where(is_glass_m[:, None], glass_norm, off_n)
        off_n = jnp.where(is_smoke[:, None], -nrm, off_n)
        new_o = mathx.offset_ray(p_hit, off_n, jnp)

        tp = jnp.where(active[:, None], tp * eff_alb, tp)

        new_in_glass = jnp.where(glass_flip | (active & is_smoke),
                                 ~in_glass, in_glass)

        st = dict(
            o=jnp.where(active[:, None], new_o, o),
            d=jnp.where(active[:, None], new_d, d),
            throughput=tp, radiance=radiance, in_glass=new_in_glass,
            active=active, albedo0=albedo0, p0=p0, n0=n0, t0=t0, m0=m0,
            sky_tp=sky_tp, sky_d=sky_d,
        )
        return st, depth + 1

    def cond(carry):
        st, depth = carry
        return (depth < cfg.max_bounces + 1) & jnp.any(st["active"])

    st, _ = jax.lax.while_loop(cond, bounce, (state, jnp.int32(0)))
    # the ONE deferred sky take: deep-miss radiance + first-miss albedo0
    sky_end = sample_sky(scene.sky, st["sky_d"], cfg.activate_sky,
                         cfg.sky_fallback)
    radiance = st["radiance"] + st["sky_tp"] * sky_end
    albedo0 = jnp.where((st["m0"] == MAT_NONE)[:, None],
                        sample_sky(scene.sky, d, cfg.activate_sky,
                                   cfg.sky_fallback), st["albedo0"])
    return (albedo0, radiance, st["p0"], st["n0"], st["t0"],
            st["m0"])


# ---------------------------------------------------------------------------
# Pass 2: history resolve
# ---------------------------------------------------------------------------

_BLEND_W = None


def _material_blend_weight(mat):
    """renderer.cpp:2050-2084: per-class history weights."""
    w = jnp.full(mat.shape, 0.9, F32)
    w = jnp.where(mat < METAL_HIGH, 0.8, w)
    w = jnp.where((mat >= METAL_HIGH) & (mat <= GLASS), 0.5, w)
    w = jnp.where((mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER), 0.9, w)
    w = jnp.where(mat == EMISSIVE, 0.0, w)
    return w


def _sample_history(history, uv, width, height):
    """SampleHistory bilinear with validity weights (renderer.cpp:777-830).
    history: [H, W, 3]; uv: [N, 2]."""
    u = uv[:, 0] - 0.5 / width
    v = uv[:, 1] - 0.5 / height
    px = u * width
    py = v * height
    x0 = px.astype(jnp.int32)
    y0 = py.astype(jnp.int32)
    fx = px - x0
    fy = py - y0
    flat = history.reshape(-1, 3)

    def tap(xi, yi, wgt):
        valid = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        idx = jnp.clip(yi, 0, height - 1) * width + jnp.clip(xi, 0, width - 1)
        w = jnp.where(valid, wgt, 0.0)
        return jnp.take(flat, idx, axis=0) * w[:, None], w

    c1, w1 = tap(x0, y0, (1 - fx) * (1 - fy))
    c2, w2 = tap(x0 + 1, y0, fx * (1 - fy))
    c3, w3 = tap(x0, y0 + 1, (1 - fx) * fy)
    c4, w4 = tap(x0 + 1, y0 + 1, fx * fy)
    tot = w1 + w2 + w3 + w4
    return (c1 + c2 + c3 + c4) / jnp.maximum(tot, 1e-8)[:, None]


def _clamp_history(history, new_img):
    """ClampHistory (renderer.cpp:856-910): YCoCg mean±0.75σ over the valid
    3x3 neighborhood of the current illumination image.
    history/new_img: [H, W, 3]."""
    ycc_new = mathx.rgb_to_ycocg(new_img, jnp)
    ycc_hist = mathx.rgb_to_ycocg(history, jnp)
    h, w = new_img.shape[:2]

    acc = ycc_new
    acc2 = ycc_new * ycc_new
    count = jnp.ones((h, w, 1), F32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            shifted = jnp.roll(ycc_new, (-dy, -dx), axis=(0, 1))
            valid = jnp.ones((h, w), bool)
            if dy == -1:
                valid = valid & (jnp.arange(h)[:, None] > 0)
            if dy == 1:
                valid = valid & (jnp.arange(h)[:, None] < h - 1)
            if dx == -1:
                valid = valid & (jnp.arange(w)[None, :] > 0)
            if dx == 1:
                valid = valid & (jnp.arange(w)[None, :] < w - 1)
            vm = valid[..., None]
            acc = acc + jnp.where(vm, shifted, 0.0)
            acc2 = acc2 + jnp.where(vm, shifted * shifted, 0.0)
            count = count + vm
    mean = acc / count
    var = acc2 / count - mean * mean
    sigma = jnp.sqrt(jnp.maximum(var, 0.0))
    lo = mean - 0.75 * sigma
    hi = mean + 0.75 * sigma
    clamped = jnp.clip(ycc_hist, lo, hi)
    return jnp.maximum(mathx.ycocg_to_rgb(clamped, jnp), 0.0)


def resolve(scene: SceneData, cfg: RenderConfig, prev_camera: Camera,
            albedo, illum, p0, m0, hit_mask, history):
    """Pass 2 -> (tonemapped [H, W, 3], new illumination history)."""
    h, w = cfg.height, cfg.width
    aspect = w / h
    n = h * w
    uv = point_to_uv(prev_camera, aspect, p0) + jnp.asarray(
        [0.5 / w, 0.5 / h], F32)
    uv_ok = ((uv[:, 0] >= 0) & (uv[:, 0] < 1)
             & (uv[:, 1] >= 0) & (uv[:, 1] < 1))

    # IsOccludedPrevFrame (renderer.cpp:767-774)
    to_p = p0 - prev_camera.pos
    dist = jnp.sqrt((to_p * to_p).sum(-1))
    dirn = to_p / jnp.maximum(dist, 1e-8)[:, None]
    back = mathx.offset_ray(p0, -dirn, jnp)
    t_occ = jnp.sqrt(((back - prev_camera.pos) ** 2).sum(-1))
    occluded = is_occluded_world(
        scene, jnp.broadcast_to(prev_camera.pos, p0.shape), dirn, t_occ,
        uv_ok & hit_mask)

    valid = uv_ok & ~occluded & hit_mask
    hist_sample = _sample_history(history, uv, w, h)
    new_img = illum.reshape(h, w, 3)
    clamped = _clamp_history(hist_sample.reshape(h, w, 3), new_img)
    wgt = _material_blend_weight(m0).reshape(h, w)
    final = jnp.where(valid.reshape(h, w, 1),
                      new_img * (1 - wgt[..., None]) + clamped * wgt[..., None],
                      new_img)
    color = tonemap(albedo.reshape(h, w, 3) * final)
    return color, final


def render_reproject_frame(scene: SceneData, cfg: RenderConfig,
                           prev_camera: Camera, history, key):
    """Full static-camera frame: pass 1 + pass 2.
    Returns (tonemapped image, new history, aux G-buffer dict).

    Rays are generated in 8x128-pixel-tile order when cfg.ray_order
    allows (the same lockstep-tail cut every other frame path gets) and
    the G-buffer un-tiles with one
    reshape/transpose per array before the resolve pass."""
    from voxtracer.render.camera import primary_rays

    h, w = cfg.height, cfg.width
    tiled = cfg.ray_order == "tile" and w % 128 == 0 and h % 8 == 0
    if tiled:
        ntx = w // 128
        i = jnp.arange(h * w, dtype=jnp.int32)
        tile, rem = i // (8 * 128), i % (8 * 128)
        ty, tx = tile // ntx, tile % ntx
        iy, ix = rem // 128, rem % 128
        px = (tx * 128 + ix).astype(F32)
        py = (ty * 8 + iy).astype(F32)
    else:
        px, py = _pixel_grid(cfg)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py, None, jnp)
    albedo, illum, p0, n0, t0, m0 = trace_reproject(scene, cfg, o, d, key)
    if tiled:
        def untile(a):
            c = a.shape[1:] if a.ndim > 1 else ()
            x = a.reshape(h // 8, ntx, 8, 128, *c)
            return x.transpose(0, 2, 1, 3, *range(4, 4 + len(c))).reshape(
                h * w, *c)

        albedo, illum, p0, n0 = (untile(albedo), untile(illum), untile(p0),
                                 untile(n0))
        t0, m0 = untile(t0), untile(m0)
    hit_mask = m0 != MAT_NONE
    img, new_hist = resolve(scene, cfg, prev_camera, albedo, illum, p0, m0,
                            hit_mask, history)
    return img, new_hist, dict(p0=p0, n0=n0, t0=t0, m0=m0)


# jitted entry for surfaces (CLI --mode reproject, game static-camera branch)
render_reproject_frame_jit = jax.jit(render_reproject_frame,
                                     static_argnames=("cfg",))
