"""Per-bounce wavefront re-clustering (_trace_path_reordered) and its
live-prefix chunked dispatch (cfg.reorder_compact_chunks) are pure
DISPATCH-order changes: the morton sort permutes lanes and the chunk loop
slices the packed state, but every per-lane estimator is unchanged — only
the counter-hash sampler's lane->jitter assignment moves (same
distributions).  These tests pin that contract statistically: the image
MEAN under plain / reorder / reorder+chunking must agree within
Monte-Carlo noise, and the final un-permutation must restore pixel order
(reference behavior: renderer.cpp:1076-1328's estimator does not depend
on ray processing order).

The chunked dispatch itself measured net-negative on city-XL where it
was first tried (PERF.md, negative results) and defaults OFF; these tests
keep the negative result reproducible.

Scene stays small (8 volumes; bounce_reorder="always" forces the
re-clustered loop): a 66-volume scene compiles for minutes under the
8-virtual-device conftest, far past the slow-lane budget."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxtracer.config import RenderConfig
from voxtracer.core.types import MAT_NONE
from voxtracer.render.integrator import trace_path
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer.scene.materials import default_materials
from voxtracer.scene.presets import _assemble
from voxtracer.render.camera import make_camera

pytestmark = pytest.mark.slow

W = H = 32


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    specs = []
    for _ in range(8):
        g = np.full((16,) * 3, MAT_NONE, np.uint8)
        for _ in range(3):
            lo = rng.integers(0, 12, 3)
            hi = lo + rng.integers(2, 8, 3)
            g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = int(
                rng.choice([1, 2, 7, 8, 10]))
        specs.append(VolumeSpec(
            position=tuple(rng.uniform(-2.0, 2.0, 3)),
            gridsize=16, grid=g,
            rotation=tuple(rng.uniform(-0.4, 0.4, 3)),
            scale=tuple(rng.uniform(0.5, 1.2, 3))))
    cam = make_camera(pos=(0.0, 0.5, -4.0), target=(0.0, 0.0, 0.0))
    return _assemble(build_volumes(specs), default_materials(), camera=cam)


def _cam_rays(scene, w=W, h=H):
    from voxtracer.render.camera import primary_rays

    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) + 0.5,
                          jnp.arange(w, dtype=jnp.float32) + 0.5,
                          indexing="ij")
    o, d = primary_rays(scene.camera, w, h, xx, yy, None, jnp)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _mean2(scene, cfg):
    o, d = _cam_rays(scene)
    imgs = [np.asarray(trace_path(scene, cfg, o, d, jax.random.PRNGKey(s)))
            for s in range(2)]
    for im in imgs:
        assert np.isfinite(im).all() and (im >= 0).all()
    return np.mean([im.mean() for im in imgs])


def test_reorder_and_chunked_means_match_plain(scene):
    base = RenderConfig(width=W, height=H, max_bounces=1,
                        bounce_reorder="none", compact_min=1)
    reo = dataclasses.replace(base, bounce_reorder="always",
                              bounce_reorder_period=1)
    chunked = dataclasses.replace(reo, reorder_compact_chunks=4)
    m0 = _mean2(scene, base)
    m1 = _mean2(scene, reo)
    m2 = _mean2(scene, chunked)
    # same estimator family; only lane->jitter assignment differs.
    # 2 keys x 1024 rays x 3 channels -> mean sigma ~2%; 8% = ~4 sigma
    assert abs(m1 - m0) <= 0.08 * max(abs(m0), 1e-3), (m0, m1)
    assert abs(m2 - m1) <= 0.08 * max(abs(m1), 1e-3), (m1, m2)


def test_chunked_indivisible_falls_back(scene):
    # 32*31 rays not divisible by 5 -> chunking silently disabled
    o, d = _cam_rays(scene, 32, 31)
    cfg = RenderConfig(width=32, height=31, max_bounces=0,
                       bounce_reorder="always", bounce_reorder_period=1,
                       compact_min=1, reorder_compact_chunks=5)
    rad = trace_path(scene, cfg, o, d, jax.random.PRNGKey(0))
    assert np.isfinite(np.asarray(rad)).all()
