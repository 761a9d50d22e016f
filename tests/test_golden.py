"""Golden-image tests: jitted integrators vs the NumPy oracle
(SURVEY.md §4 item 3; BASELINE metric "image allclose vs CPU ref").

Comparison policy: both pipelines are float32 with intentionally unstable
boundary decisions (self-intersection epsilons, voxel-face ties — the
reference has the same instabilities, tmpl8math.cpp:473-487), so golden
tests assert that ALL BUT a small fraction of pixels match tightly rather
than bitwise-equal images."""

import dataclasses
import os
import pathlib

import numpy as np
import jax
import pytest

from voxtracer.ref.cpu_renderer import Oracle
from voxtracer.render.integrator import render
from voxtracer.scene import presets

# minutes-scale on a 2-vCPU box (golden renders, multi-second jit
# compiles): long-lane only, the fast CI gate runs `-m 'not slow'`
# (pyproject.toml marker)
pytestmark = pytest.mark.slow

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"


def _oracle_image(name, scene, cfg, spp, seed):
    """Oracle output, served from the committed cache so the suite gates in
    minutes (the scalar oracle needs >9 min per room config — VERDICT r1).
    VOXTRACER_LIVE_ORACLE=1 forces a live run; scripts/regen_goldens.py
    refreshes the cache (it sets VOXTRACER_WRITE_GOLDENS)."""
    path = GOLDEN_DIR / f"{name}.npz"
    live = os.environ.get("VOXTRACER_LIVE_ORACLE")
    if path.exists() and not live:
        return np.load(path)["ref"]
    ref = Oracle(scene, cfg, np.random.default_rng(seed)).render(spp)
    if os.environ.get("VOXTRACER_WRITE_GOLDENS"):
        GOLDEN_DIR.mkdir(exist_ok=True)
        np.savez_compressed(path, ref=ref)
    return ref


def _compare(scene, cfg, tol=1e-3, max_bad_frac=0.02, spp=1, seed=0,
             cache=None):
    img = np.asarray(render(scene, cfg, jax.random.PRNGKey(seed), spp))
    if cache:
        ref = _oracle_image(cache, scene, cfg, spp, seed)
    else:
        ref = Oracle(scene, cfg, np.random.default_rng(seed)).render(spp)
    diff = np.abs(img - ref).max(-1)
    bad_frac = (diff > tol).mean()
    assert bad_frac <= max_bad_frac, (
        f"{bad_frac:.3%} pixels differ by more than {tol} (max {diff.max()})")
    return img, ref


def test_primary_teapot_matches_oracle(assets_dir):
    scene, cfg = presets.teapot_primary(width=48, height=48)
    img, ref = _compare(scene, cfg, max_bad_frac=0.005, cache="teapot_48")
    # and the image actually contains the model
    fallback = np.array(cfg.sky_fallback, np.float32)
    hit_frac = 1.0 - np.all(np.isclose(img, fallback), axis=-1).mean()
    assert 0.05 < hit_frac < 0.9


def test_whitted_glassbox_matches_oracle():
    # glass refraction amplifies 1-ulp ray differences between the two
    # float32 pipelines; ~3% boundary pixels flip (see _compare policy)
    scene, cfg = presets.glass_sphere_box(32, 32)
    cfg = dataclasses.replace(cfg, max_bounces=3)
    _compare(scene, cfg, max_bad_frac=0.04, cache="glassbox_32")


def test_brickmap_matches_flat_traversal():
    """Two-level and single-level traversal must produce identical images
    (the macro level only skips provably-uniform bricks)."""
    import jax as _jax
    import numpy as _np

    from voxtracer.render import integrator as I

    scene, cfg = presets.glass_sphere_box(32, 32)
    cfg = dataclasses.replace(cfg, max_bounces=3)
    orig = I._brick_kwargs
    try:
        I._brick_kwargs = lambda scene: {}
        flat = _np.asarray(render(scene, cfg, _jax.random.PRNGKey(0), 1))
    finally:
        I._brick_kwargs = orig
    brick = _np.asarray(render(scene, cfg, _jax.random.PRNGKey(0), 1))
    _np.testing.assert_allclose(brick, flat, atol=1e-5)


def test_whitted_room_matches_oracle(assets_dir):
    scene, cfg = presets.room_whitted(width=40, height=40, gridsize=128)
    cfg = dataclasses.replace(cfg, max_bounces=2)
    _compare(scene, cfg, max_bad_frac=0.02, cache="room_40")


def test_whitted_roomglass_matches_oracle(assets_dir):
    """Config 3: dielectrics via the model palette's GLASS slot."""
    scene, cfg = presets.room_whitted(width=32, height=32, gridsize=128,
                                      glass=True)
    cfg = dataclasses.replace(cfg, max_bounces=2)
    _compare(scene, cfg, max_bad_frac=0.04, cache="roomglass_32")


@pytest.mark.slow
def test_path_converged_mean_matches_oracle():
    """Stochastic estimators share distributions, not sequences — compare
    converged means (SURVEY.md §7 'RNG parity')."""
    scene, cfg = presets.glass_sphere_box(12, 12)
    cfg = dataclasses.replace(cfg, mode="path", max_bounces=4,
                              deterministic_lights=False)
    spp = 196
    img = np.asarray(render(scene, cfg, jax.random.PRNGKey(1), spp))
    ref = Oracle(scene, cfg, np.random.default_rng(2)).render(spp)
    # tonemap-ish compression to bound outlier influence
    a = img / (1.0 + img)
    b = ref / (1.0 + ref)
    diff = np.abs(a - b).mean()
    assert diff < 0.03, f"converged path means differ: {diff}"


def test_primary_monu_matches_oracle():
    """BASELINE config 4 scene (seeded monuments, reduced res, primary
    visibility)."""
    scene, cfg = presets.monu_path(width=32, height=32, gridsize=64,
                                   which=(1, 2, 3), bounces=2)
    cfg = dataclasses.replace(cfg, mode="primary")
    _compare(scene, cfg, max_bad_frac=0.02, cache="monu_primary_32")


def test_primary_city_matches_oracle(assets_dir):
    """BASELINE config 5 scene (17 instances, reduced res)."""
    scene, cfg = presets.city_path(width=24, height=24, gridsize=64,
                                   nx=4, nz=4, bounces=2)
    cfg = dataclasses.replace(cfg, mode="primary")
    _compare(scene, cfg, max_bad_frac=0.02, cache="city_primary_24")


def test_whitted_iterative_matches_recursive():
    """The branch-stack whitted (compiles ONE body) reproduces the
    recursive 3^depth-tree estimator to float rounding."""
    import jax.numpy as jnp

    from voxtracer.render.integrator import (_pixel_grid, trace_whitted,
                                             trace_whitted_iter)
    from voxtracer.render.camera import primary_rays

    scene, cfg = presets.glass_sphere_box(24, 24)
    # cull_eps=0: the recursive tree carries no path weight to cull by, so
    # exact-parity comparison needs the full branch tree on both sides
    cfg = dataclasses.replace(cfg, max_bounces=3, whitted_cull_eps=0.0)
    scene = jax.tree.map(jnp.asarray, scene)
    px, py = _pixel_grid(cfg)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py, None,
                        jnp)
    rec = np.asarray(trace_whitted(scene, cfg, o, d, cfg.max_bounces))
    it = np.asarray(trace_whitted_iter(scene, cfg, o, d, cfg.max_bounces))
    # two separately-compiled programs contract FMAs differently; the
    # ULP-offset shadow epsilon flips a few boundary pixels (same policy
    # as the oracle goldens)
    diff = np.abs(it - rec).max(-1)
    assert (diff > 1e-4).mean() < 0.01, f"{(diff > 1e-4).mean():.2%}"
    assert np.median(diff) < 1e-6
