"""Fast-gate smoke coverage: one tiny render + one tiny gradient.

The heavy suites (golden oracles, gradient parity,
multi-second whitted/path compiles) are all `slow`-marked for the long
lane; this module keeps the fast gate (`-m "not slow"`, target <120 s on
2 vCPUs) exercising the integrator and the differentiable march at all —
primary mode only (no while-loop compiles).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from voxtracer.diff.volumetric import params_from_scene, render_diff
from voxtracer.render.integrator import render_tiled
from voxtracer.scene.presets import monu_path


def _tiny():
    scene, cfg = monu_path(width=128, height=32, gridsize=16, which=(1,),
                           bounces=1)
    return jax.tree.map(jnp.asarray, scene), cfg


def test_primary_render_smoke():
    scene, cfg = _tiny()
    cfg = dataclasses.replace(cfg, mode="primary")
    img = render_tiled(scene, cfg, jax.random.PRNGKey(0), 1, 1)
    assert img.shape == (32, 128, 3)
    assert np.isfinite(img).all()
    # sky above, model below — both present
    assert 0.02 < img.mean() < 0.98
    assert img.std() > 0.01


def test_tile_order_matches_scanline_primary():
    """ray_order is pure dispatch order: deterministic modes bit-identical."""
    scene, cfg = _tiny()
    base = dataclasses.replace(cfg, mode="primary")
    a = render_tiled(scene, dataclasses.replace(base, ray_order="scanline"),
                     jax.random.PRNGKey(0), 1, 2)
    b = render_tiled(scene, dataclasses.replace(base, ray_order="tile"),
                     jax.random.PRNGKey(0), 1, 2)
    assert np.array_equal(a, b)


def test_diff_grad_smoke():
    scene, cfg = _tiny()
    params = params_from_scene(scene)

    def loss(p):
        img = render_diff(p, scene, cfg, jax.random.PRNGKey(0), 8)
        return jnp.mean(img ** 2)

    g = jax.grad(loss)(params)
    gd = np.asarray(g.density_logits)
    ga = np.asarray(g.albedo_table)
    assert np.isfinite(gd).all() and np.isfinite(ga).all()
    assert np.abs(gd).max() > 0 and np.abs(ga).max() > 0
