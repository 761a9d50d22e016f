"""Differentiability tests (SURVEY.md §4 item 4): finite-difference vs
autodiff for voxel density + albedo, and relaxed/hard integrator
consistency (BASELINE metric "image+pixel-grad allclose")."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxtracer.config import RenderConfig
from voxtracer.diff.volumetric import DiffParams, mse_loss, params_from_scene, render_diff
from voxtracer.render.integrator import render
from voxtracer.scene import presets

# minutes-scale on a 2-vCPU box (golden renders, multi-second jit
# compiles): long-lane only, the fast CI gate runs `-m 'not slow'`
# (pyproject.toml marker)
pytestmark = pytest.mark.slow

# image-quality bar of the bench march settings against the 48-step
# reference on the seeded monu scene (readings in
# test_bench_settings_psnr_guard)
PSNR_BAR_DB = 19.0


@pytest.fixture(scope="module")
def teapot_small():
    scene, cfg = presets.teapot_primary(width=32, height=32, gridsize=64)
    cfg = dataclasses.replace(cfg, width=32, height=32)
    return scene, cfg


def test_relaxed_matches_hard_primary(teapot_small):
    """High-density relaxed render converges to the hard primary image away
    from silhouettes."""
    scene, cfg = teapot_small
    hard = np.asarray(render(scene, cfg, jax.random.PRNGKey(0), 1))
    params = params_from_scene(scene, occupied_logit=12.0, empty_logit=-12.0)
    soft = np.asarray(render_diff(params, scene, cfg, jax.random.PRNGKey(0),
                                  n_steps=384, density_scale=4096.0))
    diff = np.abs(hard - soft).max(-1)
    # interior pixels agree; only silhouette pixels may differ
    assert (diff < 0.05).mean() > 0.9, f"relaxed!=hard on {(diff >= 0.05).mean():.1%}"
    assert np.median(diff) < 5e-3


def test_density_gradients_match_finite_difference(teapot_small):
    scene, cfg = teapot_small
    params = params_from_scene(scene, occupied_logit=1.5, empty_logit=-1.5)
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    n_steps = 64

    g = jax.grad(mse_loss)(params, scene, cfg, target, key, n_steps)
    gd = np.asarray(g.density_logits)
    assert np.isfinite(gd).all() and (np.abs(gd) > 0).any()

    # FD check on the 3 largest-|grad| density entries
    flat_idx = np.argsort(np.abs(gd).ravel())[-3:]
    eps = 1e-2
    base = float(mse_loss(params, scene, cfg, target, key, n_steps))
    for fi in flat_idx:
        vi, xi, yi, zi = np.unravel_index(fi, gd.shape)
        dl = np.asarray(params.density_logits).copy()
        dl[vi, xi, yi, zi] += eps
        lp = float(mse_loss(params.replace(density_logits=jnp.asarray(dl)),
                            scene, cfg, target, key, n_steps))
        fd = (lp - base) / eps
        ad = gd[vi, xi, yi, zi]
        assert abs(fd - ad) < 0.1 * max(abs(fd), abs(ad), 1e-4), (fd, ad)


def test_albedo_gradients_match_finite_difference(teapot_small):
    scene, cfg = teapot_small
    params = params_from_scene(scene)
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    g = jax.grad(mse_loss)(params, scene, cfg, target, key, 64)
    ga = np.asarray(g.albedo_table)
    assert np.isfinite(ga).all()
    fi = np.abs(ga).ravel().argmax()
    mi, ci = np.unravel_index(fi, ga.shape)
    eps = 1e-3
    base = float(mse_loss(params, scene, cfg, target, key, 64))
    at = np.asarray(params.albedo_table).copy()
    at[mi, ci] += eps
    lp = float(mse_loss(params.replace(albedo_table=jnp.asarray(at)),
                        scene, cfg, target, key, 64))
    fd = (lp - base) / eps
    assert abs(fd - ga[mi, ci]) < 0.05 * max(abs(fd), abs(ga[mi, ci])), (fd, ga[mi, ci])


def test_hard_renderer_albedo_gradients(teapot_small):
    """The wavefront hard renderer is differentiable w.r.t. material params
    (traversal stop_gradient'ed, shading differentiable)."""
    scene, cfg = teapot_small

    def loss(albedo):
        s = scene.replace(materials=scene.materials.replace(albedo=albedo))
        img = render(s, cfg, jax.random.PRNGKey(0), 1)
        return jnp.mean(img)

    alb0 = jnp.asarray(scene.materials.albedo)
    g = np.asarray(jax.grad(loss)(alb0))
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
    # FD on the largest entry
    fi = np.abs(g).ravel().argmax()
    mi, ci = np.unravel_index(fi, g.shape)
    eps = 1e-3
    base = float(loss(alb0))
    a2 = np.asarray(alb0).copy()
    a2[mi, ci] += eps
    fd = (float(loss(jnp.asarray(a2))) - base) / eps
    assert abs(fd - g[mi, ci]) < 0.05 * max(abs(fd), abs(g[mi, ci]), 1e-6), (fd, g[mi, ci])


def test_pair_compaction_exact():
    """k-compacted march == dense march when k >= max AABB crossings."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from voxtracer.diff.volumetric import (max_aabb_crossings, params_from_scene,
                                           render_diff)
    from voxtracer.scene.presets import monu_path

    scene, cfg = monu_path(width=64, height=36, gridsize=32, which=(1, 2),
                           bounces=1)
    scene = jax.tree.map(jnp.asarray, scene)
    params = params_from_scene(scene)
    key = jax.random.PRNGKey(0)
    kmax = max_aabb_crossings(scene, cfg)
    assert 1 <= kmax <= scene.volumes.n
    dense = np.asarray(render_diff(params, scene, cfg, key, 24))
    comp = np.asarray(render_diff(params, scene, cfg, key, 24, k=kmax))
    np.testing.assert_allclose(dense, comp, rtol=1e-5, atol=1e-6)


def test_span_march_matches_dense_forward(teapot_small):
    """Occupancy-span tightening (span_steps>0) is a quadrature change,
    not a scene change: with saturated densities both marches converge to
    the same (hard) image."""
    scene, cfg = teapot_small
    params = params_from_scene(scene, occupied_logit=12.0, empty_logit=-12.0)
    key = jax.random.PRNGKey(0)
    dense = np.asarray(render_diff(params, scene, cfg, key, n_steps=256,
                                   density_scale=4096.0))
    span = np.asarray(render_diff(params, scene, cfg, key, n_steps=96,
                                  density_scale=4096.0, span_steps=4))
    diff = np.abs(dense - span).max(-1)
    assert (diff < 0.05).mean() > 0.9, f"{(diff >= 0.05).mean():.1%} differ"
    assert np.median(diff) < 5e-3


def test_span_march_fd_gradients(teapot_small):
    """Autodiff of the span-tightened march is exact for ITS forward."""
    scene, cfg = teapot_small
    params = params_from_scene(scene, occupied_logit=1.5, empty_logit=-1.5)
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    kw = dict(n_steps=32, span_steps=4)

    g = jax.grad(mse_loss)(params, scene, cfg, target, key, **kw)
    gd = np.asarray(g.density_logits)
    assert np.isfinite(gd).all() and (np.abs(gd) > 0).any()
    flat_idx = np.argsort(np.abs(gd).ravel())[-3:]
    eps = 1e-2
    base = float(mse_loss(params, scene, cfg, target, key, **kw))
    for fi in flat_idx:
        vi, xi, yi, zi = np.unravel_index(fi, gd.shape)
        dl = np.asarray(params.density_logits).copy()
        dl[vi, xi, yi, zi] += eps
        lp = float(mse_loss(params.replace(density_logits=jnp.asarray(dl)),
                            scene, cfg, target, key, **kw))
        fd = (lp - base) / eps
        ad = gd[vi, xi, yi, zi]
        assert abs(fd - ad) < 0.1 * max(abs(fd), abs(ad), 1e-4), (fd, ad)
    # empty-space gradients flow through the per-brick mean (dense adjoint)
    grids = np.asarray(scene.volumes.grids)
    empty_grad = gd[grids == 255]
    assert (np.abs(empty_grad) > 0).any()


def test_span_march_compaction_exact(teapot_small):
    scene, cfg = teapot_small
    params = params_from_scene(scene)
    key = jax.random.PRNGKey(0)
    dense = np.asarray(render_diff(params, scene, cfg, key, 24,
                                   span_steps=4))
    comp = np.asarray(render_diff(params, scene, cfg, key, 24, k=1,
                                  span_steps=4))
    np.testing.assert_allclose(dense, comp, atol=1e-6)


def test_span_march_bench_settings_consistency(teapot_small):
    """The BENCH settings (n_steps=12, span_steps=1 — bench.py) must still
    converge to the hard image at saturation; guards against quality-gaming
    the fwd+bwd headline number.  (The transmittance-bounded clamp makes
    12 steps statistically identical to 14 — median diff 0.0069 vs 0.0068,
    measured; the bad-frac threshold reflects silhouette pixels at 32^2.)"""
    scene, cfg = teapot_small
    params = params_from_scene(scene, occupied_logit=12.0, empty_logit=-12.0)
    key = jax.random.PRNGKey(0)
    from voxtracer.render.integrator import render as hard_render
    hard = np.asarray(hard_render(scene, cfg, key, 1))
    soft = np.asarray(render_diff(params, scene, cfg, key, n_steps=12,
                                  density_scale=4096.0, span_steps=1))
    diff = np.abs(hard - soft).max(-1)
    assert (diff < 0.08).mean() > 0.83, f"{(diff >= 0.08).mean():.1%} differ"
    assert np.median(diff) < 1e-2


@pytest.mark.slow
def test_bench_settings_psnr_guard():
    """Image-level quality guard at the BENCH march settings (steps=12,
    span=1 — bench.py) on the bench scene (monu, 1080p aspect, reduced
    res): PSNR vs a 4x-supersampled high-step march must stay high, so a
    future step-count tuning can't silently trade image quality for the
    headline throughput number."""
    scene, cfg = presets.monu_path(width=96, height=54, gridsize=64,
                                   which=(1,), bounces=4)
    params = params_from_scene(scene, occupied_logit=12.0, empty_logit=-12.0)
    key = jax.random.PRNGKey(2)
    bench = np.asarray(render_diff(params, scene, cfg, key, n_steps=12,
                                   density_scale=4096.0, span_steps=1))
    ref = np.asarray(render_diff(params, scene, cfg, key, n_steps=48,
                                 density_scale=4096.0, span_steps=4))
    mse = float(np.mean((bench - ref) ** 2))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
    # PSNR_BAR_DB: readings on the seeded scene (median |diff| exactly 0,
    # the mismatch confined to silhouette pixels where the sample grids
    # differ): steps=12/span=1 20.12 dB; the reference vs its own 2x
    # refinement (96/4) 22.56; 1 step/span=1 19.98 (at saturation the
    # first sample in a span decides the pixel); the control without span
    # tightening (12/span=0) 17.65.  The bar sits between the sound
    # readings and that control.
    assert psnr > PSNR_BAR_DB, f"bench-settings PSNR {psnr:.2f} dB"
    assert float(np.median(np.abs(bench - ref))) == 0.0


def test_inverse_demo_micro(teapot_small):
    """Micro version of scripts/demo_inverse.py: a few optimization steps
    reduce the loss (the differentiable path drives real optimization)."""
    import optax

    scene, cfg = teapot_small
    key = jax.random.PRNGKey(0)
    true_params = params_from_scene(scene)
    target = render_diff(true_params, scene, cfg, key, n_steps=16)
    init = DiffParams(
        density_logits=jnp.full_like(true_params.density_logits, -2.0),
        albedo_table=jnp.full_like(true_params.albedo_table, 0.5))
    opt = optax.adam(5e-2)

    @jax.jit
    def step(params, opt_state):
        loss, g = jax.value_and_grad(mse_loss)(params, scene, cfg, target,
                                               key, 16)
        upd, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state, loss

    params, opt_state = init, opt.init(init)
    losses = []
    for _ in range(40):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]


@pytest.mark.slow
def test_bench_binned_settings_psnr_guard():
    """Quality guard for the BINNED bench march (span-length bins 2/10
    steps at edge 4 cells, span=1 — bench.py): the combined
    per-bin image must hold the PSNR bar of the uniform 12-step march,
    AND the binned gradient must stay aligned with a 48-step/span-4
    reference gradient (global cosine >= 0.80 here; the bench-scale
    parity test additionally asserts PER-VOLUME alignment — cheaper bin
    settings can hold the GLOBAL cosine while the fine volumes' cosines
    collapse, because the floor volume's large components dominate the
    dot product)."""
    from voxtracer.diff.volumetric import span_cells_bins

    scene, cfg = presets.monu_path(width=96, height=54, gridsize=64,
                                   which=(1,), bounces=4)
    params = params_from_scene(scene, occupied_logit=12.0, empty_logit=-12.0)
    key = jax.random.PRNGKey(2)
    ref = np.asarray(render_diff(params, scene, cfg, key, n_steps=48,
                                 density_scale=4096.0, span_steps=4))
    bins = span_cells_bins(scene, cfg, rows=cfg.height, edges=(4.0,))
    combined = None
    n = cfg.width * cfg.height
    for bi, p, ip, na in bins:
        steps = (2, 10)[bi]
        img_b = np.asarray(render_diff(
            params, scene, cfg, key, n_steps=steps, density_scale=4096.0,
            span_steps=1, perm=jnp.asarray(p), inv_perm=jnp.asarray(ip),
            n_active=na, row0=jnp.float32(0), rows=cfg.height))
        if combined is None:
            combined = img_b.copy()
        nap = min(-(-na // 1024) * 1024, n)
        mask = np.zeros(n, bool)
        mask[p[:nap]] = True
        combined.reshape(-1, 3)[mask] = img_b.reshape(-1, 3)[mask]
    mse = float(np.mean((combined - ref) ** 2))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
    # reads 20.12 dB on the seeded scene, as the uniform march does
    assert psnr > PSNR_BAR_DB, f"binned bench-settings PSNR {psnr:.2f} dB"
    assert float(np.median(np.abs(combined - ref))) == 0.0

    # gradient-fidelity leg: binned grad vs the high-step reference
    from voxtracer.diff.volumetric import max_aabb_crossings, mse_loss

    params_t = params_from_scene(scene)  # trainable-regime logits
    kk = min(max_aabb_crossings(scene, cfg), scene.volumes.n)
    tgt = jnp.asarray(np.random.RandomState(1).rand(
        cfg.height, cfg.width, 3).astype(np.float32))

    def binned_grad(steps_pair, span):
        tot = None
        for bi, p, ip, na in bins:
            steps = steps_pair[bi]
            g = jax.grad(mse_loss)(params_t, scene, cfg, tgt,
                                   jax.random.PRNGKey(2), steps,
                                   row0=jnp.float32(0), rows=cfg.height,
                                   k=kk, span_steps=span,
                                   perm=jnp.asarray(p),
                                   inv_perm=jnp.asarray(ip), n_active=na)
            tot = g if tot is None else jax.tree.map(jnp.add, tot, g)
        return tot

    g_ref = binned_grad((48, 48), 4)
    g_b = binned_grad((2, 10), 1)
    a = np.asarray(g_b.density_logits).ravel()
    r = np.asarray(g_ref.density_logits).ravel()
    cos = float(np.dot(a, r)
                / (np.linalg.norm(a) * np.linalg.norm(r) + 1e-30))
    # readings on the seeded scene: (2,10) 0.8140; fewer steps in the long
    # bin (2,8) 0.7705, (2,6) 0.7593, (1,2) 0.7802; no span tightening
    # (2,10)/span 0 0.1132.  The 48-step reference is itself unconverged
    # here (0.9476 against 192 steps), and (2,16) reads 0.9074.
    assert cos >= 0.80, f"binned density-grad cosine {cos:.4f} < 0.80"


@pytest.mark.slow
def test_grad_parity_artifact_recorded():
    """Bench-scale gradient parity, computed here on the seeded monu scene
    (256x144, all three models): the bench's fast bins ((2,10) steps at
    edge 4 cells, span 1) against reference settings (48 steps, span 4) —
    global cosine AND per-volume cosines (the global one is dominated by
    the floor volume's large components) — the reference against a
    2x-refined one (96 steps) as convergence evidence, and the reference
    gradient against central finite differences of its own loss (one
    direction per volume), which ties the chain to the truth."""
    from voxtracer.diff.volumetric import max_aabb_crossings, span_cells_bins

    scene, cfg = presets.monu_path(width=256, height=144)
    scene = jax.tree.map(jnp.asarray, scene)
    params = params_from_scene(scene)
    kk = min(max_aabb_crossings(scene, cfg), scene.volumes.n)
    tgt = jnp.asarray(np.random.RandomState(1).rand(
        cfg.height, cfg.width, 3).astype(np.float32))
    bins = span_cells_bins(scene, cfg, rows=cfg.height, edges=(4.0,))

    def binned_loss(p_, steps_pair, span):
        tot = 0.0
        for bi, p, ip, na in bins:
            tot = tot + mse_loss(p_, scene, cfg, tgt, jax.random.PRNGKey(2),
                                 steps_pair[bi], row0=jnp.float32(0),
                                 rows=cfg.height, k=kk, span_steps=span,
                                 perm=jnp.asarray(p),
                                 inv_perm=jnp.asarray(ip), n_active=na)
        return tot

    def binned_grad(steps_pair, span):
        return np.asarray(jax.grad(binned_loss)(
            params, steps_pair, span).density_logits)

    def cos(a, b):
        a, b = a.ravel(), b.ravel()
        return float(np.dot(a, b)
                     / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))

    g_fast = binned_grad((2, 10), 1)
    g_ref = binned_grad((48, 48), 4)
    g_ref2 = binned_grad((96, 96), 4)
    assert cos(g_fast, g_ref) >= 0.97
    for vi in range(g_fast.shape[0]):
        assert cos(g_fast[vi], g_ref[vi]) >= 0.45, vi
    assert cos(g_ref, g_ref2) >= 0.99

    # directional FD at the reference settings, along the reference
    # gradient restricted to one volume (unit norm): it sums thousands of
    # cells too small to resolve one by one into a derivative far above
    # float32 noise, and must equal <g_ref, v>.  The loss is the pixel SUM
    # (the mean sits at f32 resolution), and the step a = 0.2 spreads over
    # 2a both the sum's rounding and the step of the stop-gradient'd
    # transmittance-clamp margin, which a downward move of the shared
    # occupied logit shifts (at a = 0.05 the floor volume reads rel 0.39;
    # at 0.2 every volume is within 0.12 on this scene).
    denom = float(cfg.height * cfg.width * 3)
    ref_sum = jax.jit(lambda dl: denom * binned_loss(
        params.replace(density_logits=dl), (48, 48), 4))
    base = np.asarray(params.density_logits)
    a = 0.2
    for vi in range(g_ref.shape[0]):
        v = np.zeros_like(g_ref)
        v[vi] = g_ref[vi] / np.linalg.norm(g_ref[vi])
        fd = (float(ref_sum(jnp.asarray(base + a * v)))
              - float(ref_sum(jnp.asarray(base - a * v)))) / (2 * a)
        ad = denom * float((g_ref * v).sum())
        assert abs(fd - ad) <= 0.25 * abs(ad), (vi, fd, ad)


def _multi_volume_scene(nvol=66, gridsize=16, seed=5):
    """Many small randomly placed and rotated volumes (box fills of
    diffuse, metal, glass and smoke materials)."""
    from voxtracer.core.types import MAT_NONE
    from voxtracer.render.camera import make_camera
    from voxtracer.scene.instances import VolumeSpec, build_volumes
    from voxtracer.scene.materials import default_materials

    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(nvol):
        g = np.full((gridsize,) * 3, MAT_NONE, np.uint8)
        for _ in range(3):
            lo = rng.integers(0, gridsize - 4, 3)
            hi = lo + rng.integers(2, 8, 3)
            g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = int(
                rng.choice([1, 2, 7, 8, 10]))
        specs.append(VolumeSpec(
            position=tuple(rng.uniform(-2.0, 2.0, 3)),
            gridsize=gridsize, grid=g,
            rotation=tuple(rng.uniform(-0.4, 0.4, 3)),
            scale=tuple(rng.uniform(0.5, 1.2, 3))))
    cam = make_camera(pos=(0.0, 0.5, -4.0), target=(0.0, 0.0, 0.0))
    return presets._assemble(build_volumes(specs), default_materials(),
                             camera=cam)


def test_importance_march_fd_gradients():
    """Autodiff of the importance-placed march (volumetric importance=P:
    inverse-CDF node placement over the union core's inside-profile) is
    exact for ITS forward.  Node positions/widths are stop-gradient'd, so
    this is variable-node quadrature of the same integral — FD must match
    AD.  Measured at bench scale the lever lost to plain uniform steps
    (PERF.md, negative results); this test keeps the priced-negative path
    correct and reproducible.  Uses a multi-volume scene so the union
    core contains a real inter-volume gap (single-volume scenes degrade
    to the uniform grid)."""
    scene = _multi_volume_scene(seed=7)
    cfg = RenderConfig(width=24, height=24, max_bounces=0)
    params = params_from_scene(scene, occupied_logit=1.5, empty_logit=-1.5)
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    kw = dict(n_steps=10, span_steps=1, k=2, importance=8)

    g = jax.grad(mse_loss)(params, scene, cfg, target, key, **kw)
    gd = np.asarray(g.density_logits)
    assert np.isfinite(gd).all() and (np.abs(gd) > 0).any()
    flat_idx = np.argsort(np.abs(gd).ravel())[-3:]
    eps = 1e-2
    base = float(mse_loss(params, scene, cfg, target, key, **kw))
    for fi in flat_idx:
        vi, xi, yi, zi = np.unravel_index(fi, gd.shape)
        dl = np.asarray(params.density_logits).copy()
        dl[vi, xi, yi, zi] += eps
        lp = float(mse_loss(params.replace(density_logits=jnp.asarray(dl)),
                            scene, cfg, target, key, **kw))
        fd = (lp - base) / eps
        ad = gd[vi, xi, yi, zi]
        assert abs(fd - ad) < 0.1 * max(abs(fd), abs(ad), 1e-4), (fd, ad)
