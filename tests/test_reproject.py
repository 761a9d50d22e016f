"""Temporal reprojection tests (SURVEY.md §2 #15)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from voxtracer.render.camera import make_camera, primary_rays
from voxtracer.render.integrator import _pixel_grid
from voxtracer.render.reproject import (
    point_to_uv,
    render_reproject_frame,
    trace_reproject,
)
from voxtracer.scene import presets

# minutes-scale on a 2-vCPU box (golden renders, multi-second jit
# compiles): long-lane only, the fast CI gate runs `-m 'not slow'`
# (pyproject.toml marker)
pytestmark = pytest.mark.slow


def test_point_to_uv_roundtrip():
    """Points along primary rays must reproject to their own pixel uv."""
    cam = make_camera(pos=(0.2, 0.4, -1.5), target=(0.1, 0.0, 0.5), aspect=1.0)
    w = h = 32
    px, py = jnp.meshgrid(jnp.arange(w, dtype=jnp.float32),
                          jnp.arange(h, dtype=jnp.float32))
    px, py = px.reshape(-1), py.reshape(-1)
    o, d = primary_rays(cam, w, h, px, py, None, jnp)
    pts = o + 1.7 * d
    uv = np.asarray(point_to_uv(cam, 1.0, pts))
    np.testing.assert_allclose(uv[:, 0], np.asarray(px) / w, atol=2e-3)
    np.testing.assert_allclose(uv[:, 1], np.asarray(py) / h, atol=2e-3)


def test_trace_reproject_decomposition():
    """albedo * illumination must reproduce a full color image: for a
    primary-visible diffuse surface the product is finite and positive
    where lit; G-buffer fields are populated."""
    scene, cfg = presets.glass_sphere_box(24, 24)
    cfg = dataclasses.replace(cfg, mode="path", max_bounces=2,
                              deterministic_lights=True)
    px, py = _pixel_grid(cfg)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py, None, jnp)
    alb, illum, p0, n0, t0, m0 = trace_reproject(
        scene, cfg, o, d, jax.random.PRNGKey(0))
    alb, illum = np.asarray(alb), np.asarray(illum)
    assert np.isfinite(alb).all() and np.isfinite(illum).all()
    assert (alb >= 0).all()
    hit = np.asarray(m0) != 255
    assert hit.any()
    # hit points lie at o + t*d
    pts = np.asarray(o) + np.asarray(t0)[:, None] * np.asarray(d)
    np.testing.assert_allclose(np.asarray(p0)[hit], pts[hit], atol=1e-4)
    # normals are unit where hit
    nl = np.linalg.norm(np.asarray(n0)[hit], axis=-1)
    np.testing.assert_allclose(nl, 1.0, atol=1e-4)


def test_render_reproject_frame_runs_and_blends():
    scene, cfg = presets.glass_sphere_box(24, 24)
    cfg = dataclasses.replace(cfg, mode="path", max_bounces=2,
                              deterministic_lights=True)
    history = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    img1, hist1, aux = render_reproject_frame(scene, cfg, scene.camera,
                                              history, jax.random.PRNGKey(0))
    img2, hist2, _ = render_reproject_frame(scene, cfg, scene.camera,
                                            hist1, jax.random.PRNGKey(1))
    for x in (img1, hist1, img2, hist2):
        assert np.isfinite(np.asarray(x)).all()
    # history actually integrates (changes between frames, stays bounded)
    assert not np.allclose(np.asarray(hist1), np.asarray(hist2))
    assert np.asarray(img2).max() <= 50.0


def test_reproject_reduces_variance_vs_single_sample():
    """VERDICT item 6 'done' criterion: a static-camera reprojected
    sequence has lower illumination variance than independent 1-sample
    frames (history blending integrates over time)."""
    scene, cfg = presets.glass_sphere_box(24, 24)
    cfg = dataclasses.replace(cfg, mode="path", max_bounces=2)

    from voxtracer.render.reproject import render_reproject_frame_jit

    # independent single-sample illumination estimates (no history)
    singles = []
    reprojected = []
    history = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    zero = jnp.zeros_like(history)
    for i in range(8):
        key = jax.random.PRNGKey(100 + i)
        _, single_hist, _ = render_reproject_frame_jit(
            scene, cfg, scene.camera, zero, key)
        singles.append(np.asarray(single_hist))
        _, history, _ = render_reproject_frame_jit(scene, cfg, scene.camera,
                                                   history, key)
        reprojected.append(np.asarray(history))

    # frame-to-frame variance over the last frames (after history warms);
    # the YCoCg neighborhood clamp intentionally limits reuse, so the
    # reduction is moderate, not 1/N
    var_single = np.var(np.stack(singles[3:]), axis=0).mean()
    var_reproj = np.var(np.stack(reprojected[3:]), axis=0).mean()
    assert np.isfinite(var_single) and np.isfinite(var_reproj)
    assert var_reproj < var_single * 0.9, (var_reproj, var_single)


def _oracle_reproject_cached(name, scene, cfg, spp, seed):
    """Cached oracle pass-1 (same policy as tests/test_golden.py:_oracle_image:
    the scalar oracle is minutes-slow; scripts/regen_goldens.py refreshes)."""
    import os
    import pathlib

    from voxtracer.ref.cpu_renderer import Oracle

    path = pathlib.Path(__file__).parent / "goldens" / f"{name}.npz"
    if path.exists() and not os.environ.get("VOXTRACER_LIVE_ORACLE"):
        d = np.load(path)
        return d["alb"], d["ill"]
    o = Oracle(scene, cfg, np.random.default_rng(seed))
    alb, ill, _, _ = o.render_reproject(spp)
    if os.environ.get("VOXTRACER_WRITE_GOLDENS"):
        path.parent.mkdir(exist_ok=True)
        np.savez_compressed(path, alb=alb, ill=ill)
    return alb, ill


def test_reproject_pass1_converged_matches_oracle():
    """VERDICT r2 missing #4: value-check the decomposed estimator against
    the oracle's TraceReproject transcription (renderer.cpp:1330-1585).
    Stochastic estimators share distributions, not sequences — compare
    converged decomposed products."""
    scene, cfg = presets.glass_sphere_box(12, 12)
    cfg = dataclasses.replace(cfg, mode="path", max_bounces=3,
                              deterministic_lights=True)
    spp = 96
    ref_alb, ref_ill = _oracle_reproject_cached("reproject_glassbox_12",
                                                scene, cfg, spp, seed=3)
    px, py = _pixel_grid(cfg)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py, None,
                        jnp)
    acc_a = np.zeros((cfg.height * cfg.width, 3), np.float32)
    acc_i = np.zeros_like(acc_a)
    reps = spp // 16
    tr = jax.jit(lambda k: trace_reproject(scene, cfg, o, d, k)[:2],
                 static_argnames=())
    for s in range(reps * 16):
        alb, illum = tr(jax.random.PRNGKey(50 + s))
        acc_a += np.asarray(alb)
        acc_i += np.asarray(illum)
    n = reps * 16
    img = (acc_a / n) * (acc_i / n)
    ref = (ref_alb * ref_ill).reshape(-1, 3)
    a = img / (1.0 + img)
    b = ref / (1.0 + ref)
    diff = np.abs(a - b).mean()
    assert diff < 0.03, f"converged reproject means differ: {diff}"


def test_resolve_matches_oracle_numpy():
    """Value-level pass-2 check (VERDICT r2 missing #4): JAX resolve() vs
    the scalar NumPy resolve (UV reprojection, occlusion validation,
    bilinear history, YCoCg clamp, per-material blend) on identical
    inputs.  Both pipelines are f32 with boundary-unstable occlusion rays,
    so a small bad-pixel fraction is tolerated (test_golden policy)."""
    from voxtracer.ref.cpu_renderer import Oracle
    from voxtracer.render.reproject import resolve

    scene, cfg = presets.glass_sphere_box(16, 16)
    cfg = dataclasses.replace(cfg, mode="path", max_bounces=2,
                              deterministic_lights=True)
    h, w = cfg.height, cfg.width
    # deterministic G-buffer from pass 1
    px, py = _pixel_grid(cfg)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py, None,
                        jnp)
    alb, illum, p0, n0, t0, m0 = trace_reproject(scene, cfg, o, d,
                                                 jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    history = rng.random((h, w, 3), np.float32) * 2.0
    # previous camera slightly moved so UVs shift sub-pixel
    prev_cam = make_camera(pos=np.asarray(scene.camera.pos) + 0.02,
                           target=(0.5, 0.5, 0.5), aspect=w / h)
    hit_mask = jnp.asarray(np.asarray(m0) != 255)
    img_j, hist_j = resolve(scene, cfg, prev_cam, alb, illum, p0, m0,
                            hit_mask, jnp.asarray(history))
    oracle = Oracle(scene, cfg)
    img_o, hist_o = oracle.resolve_reproject(
        prev_cam, np.asarray(alb).reshape(h, w, 3),
        np.asarray(illum).reshape(h, w, 3),
        np.asarray(p0).reshape(h, w, 3), np.asarray(m0).reshape(h, w),
        history)
    for jx, ox in ((img_j, img_o), (hist_j, hist_o)):
        diff = np.abs(np.asarray(jx) - ox).max(-1)
        bad = (diff > 1e-3).mean()
        assert bad <= 0.02, f"{bad:.3%} resolve pixels differ (max {diff.max()})"


def test_cli_render_reproject_mode(tmp_path):
    """--mode reproject renders a 2-frame static-camera sequence."""
    from voxtracer.cli import main

    out = tmp_path / "rp.png"
    main(["render", "--preset", "glassbox", "--mode", "reproject",
          "--width", "24", "--height", "24", "--frames", "2",
          "--output", str(out)])
    assert out.exists() and out.stat().st_size > 100
