"""Active (precomputed, span-binned) replay gradients vs the full replay
estimator and finite differences (diff/replay_active.py); these are the
small-scale structural guards."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxtracer.diff.path_replay import render_diff_replay
from voxtracer.diff.replay_active import (make_replay_grad_fn,
                                          render_replay_active,
                                          replay_precompute, split_pre)
from voxtracer.diff.volumetric import params_from_scene
from voxtracer.scene import presets

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def setup(assets_dir):
    scene, cfg = presets.monu_path(width=64, height=36, gridsize=64,
                                   which=(1,), bounces=2)
    scene = jax.tree.map(jnp.asarray, scene)
    params = params_from_scene(scene)
    key = jax.random.PRNGKey(0)
    pre = replay_precompute(scene, cfg, key)
    return scene, cfg, params, key, pre


def test_active_matches_replay_estimator(setup):
    """The active path replays the SAME frozen paths (shared jax.random
    draws) with span-clamped quadrature; images on non-media hit lanes
    must agree to quadrature tolerance."""
    scene, cfg, params, key, pre = setup
    img_a = np.asarray(render_replay_active(params, scene, cfg,
                                            *split_pre(pre)))
    ref = np.asarray(render_diff_replay(params, scene, cfg, key,
                                        n_steps=48, seg_steps=24))
    sel = np.asarray(pre["sel"])
    hitm = np.asarray(pre["hit"])
    d = np.abs(img_a - ref.reshape(-1, 3)[sel])[hitm]
    assert np.isfinite(img_a).all()
    assert d.mean() < 0.03, d.mean()
    assert np.percentile(d, 95) < 0.15, np.percentile(d, 95)


def test_active_grad_fd(setup):
    """Autodiff vs central differences of the active loss at its own
    bench-style settings, on the strongest density cell."""
    scene, cfg, params, key, pre = setup
    tgt = jnp.zeros((pre["n_c"], 3), jnp.float32)
    denom = float(cfg.width * cfg.height * 3)
    gfn, lfn = make_replay_grad_fn(scene, cfg, pre, tgt, denom)
    g = gfn(params)
    gd = np.asarray(g.density_logits)
    assert np.isfinite(gd).all() and np.abs(gd).max() > 0.0
    fi = int(np.abs(gd).ravel().argmax())
    vi, xi, yi, zi = np.unravel_index(fi, gd.shape)
    eps = 2e-2
    vals = []
    for s in (+1.0, -1.0):
        dl = np.asarray(params.density_logits).copy()
        dl[vi, xi, yi, zi] += s * eps
        vals.append(float(lfn(dataclasses.replace(
            params, density_logits=jnp.asarray(dl)))))
    fd = (vals[0] - vals[1]) / (2 * eps)
    ad = float(gd[vi, xi, yi, zi])
    assert abs(fd - ad) < 0.05 * max(abs(fd), abs(ad)) + 1e-9, (fd, ad)
