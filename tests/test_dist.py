"""Distribution tests on the simulated 8-device CPU mesh (SURVEY.md §4
item 5): sharded rendering equivalence + sharded training step."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxtracer.dist.mesh import make_mesh, render_sharded
from voxtracer.dist.train import make_mesh_2d, shard_params, train_demo
from voxtracer.diff.volumetric import params_from_scene
from voxtracer.render.integrator import render
from voxtracer.scene import presets

# minutes-scale on a 2-vCPU box (golden renders, multi-second jit
# compiles): long-lane only, the fast CI gate runs `-m 'not slow'`
# (pyproject.toml marker)
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def small_scene():
    scene, cfg = presets.glass_sphere_box(16, 16)
    cfg = dataclasses.replace(cfg, max_bounces=2)
    return scene, cfg


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single_device(small_scene):
    scene, cfg = small_scene
    mesh = make_mesh()
    img_sharded = np.asarray(render_sharded(scene, cfg, jax.random.PRNGKey(0),
                                            1, mesh))
    img_single = np.asarray(render(scene, cfg, jax.random.PRNGKey(0), 1))
    np.testing.assert_allclose(img_sharded, img_single, atol=1e-5)


def test_sharded_render_uneven_pixel_count(small_scene):
    scene, cfg = small_scene
    cfg = dataclasses.replace(cfg, width=13, height=11)  # 143 % 8 != 0
    mesh = make_mesh()
    img = np.asarray(render_sharded(scene, cfg, jax.random.PRNGKey(0), 1, mesh))
    assert img.shape == (11, 13, 3)
    assert np.isfinite(img).all()


def test_param_sharding_layout(small_scene):
    scene, _ = small_scene
    mesh = make_mesh_2d(8)
    assert mesh.devices.shape == (4, 2)
    params = shard_params(params_from_scene(scene), mesh)
    spec = params.density_logits.sharding.spec
    assert tuple(spec) == (None, "model", None, None)


def test_sharded_train_step_decreases_loss(small_scene):
    scene, cfg = small_scene
    cfg = dataclasses.replace(cfg, mode="path")
    mesh = make_mesh_2d(8)
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    _, loss1 = train_demo(scene, cfg, target, mesh, iters=1, n_steps=16,
                          lr=5e-2)
    _, loss5 = train_demo(scene, cfg, target, mesh, iters=5, n_steps=16,
                          lr=5e-2)
    assert np.isfinite(loss1) and np.isfinite(loss5)
    assert loss5 < loss1  # optimizing toward black reduces MSE
