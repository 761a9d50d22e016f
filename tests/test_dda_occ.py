"""Parity: occupancy-bitmask traversal (kernels/dda_occ.py) vs the v1
per-cell brick traversal (kernels/dda.py) — same semantics, different
memory access strategy.  Exercises all three modes over randomized
multi-volume scenes with transforms, glass and smoke content."""

import numpy as np
import jax.numpy as jnp
import pytest

from voxtracer.core.types import GLASS, MAT_NONE, SMOKE_MID_DENSITY
from voxtracer.kernels import dda, dda_occ
from voxtracer.scene.instances import VolumeSpec, build_volumes

# minutes-scale on a 2-vCPU box (golden renders, multi-second jit
# compiles): long-lane only, the fast CI gate runs `-m 'not slow'`
# (pyproject.toml marker)
pytestmark = pytest.mark.slow


def _rand_scene(rng, nvol=3, gridsize=32):
    specs = []
    for i in range(nvol):
        g = np.full((gridsize,) * 3, MAT_NONE, np.uint8)
        # a few solid boxes of mixed materials (incl. glass + smoke)
        for _ in range(4):
            lo = rng.integers(0, gridsize - 4, 3)
            hi = lo + rng.integers(2, 10, 3)
            mat = int(rng.choice([1, 2, 7, GLASS, SMOKE_MID_DENSITY, 15]))
            g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = mat
        specs.append(VolumeSpec(
            position=tuple(rng.uniform(-1.2, 1.2, 3)),
            gridsize=gridsize, grid=g,
            rotation=tuple(rng.uniform(-0.5, 0.5, 3)),
            scale=tuple(rng.uniform(0.6, 1.5, 3)),
        ))
    return build_volumes(specs)


def _rand_rays(rng, n=512):
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _args(vols):
    return (vols.grids.reshape(-1), jnp.asarray(vols.gridsize),
            jnp.asarray(vols.inv), jnp.asarray(vols.fwd),
            jnp.asarray(vols.cube_min))


@pytest.mark.parametrize("seed,topk", [(0, 0), (1, 0), (2, 0),
                                       (0, 1), (1, 2), (2, 2), (7, 2)])
def test_nearest_parity(seed, topk):
    rng = np.random.default_rng(seed)
    vols = _rand_scene(rng, nvol=4 if topk else 3)
    o, d = _rand_rays(rng)
    n = o.shape[0]
    act = jnp.ones(n, bool)
    tl = jnp.full(n, dda.BIG, jnp.float32)
    ven = jnp.ones(vols.n, bool)

    ref = dda.traverse(*_args(vols), o, d, tl, act, ven,
                       jnp.int32(1), jnp.int32(0), mode="nearest",
                       bricks_flat=jnp.asarray(vols.bricks.reshape(-1)),
                       bricksize=jnp.asarray(vols.bricksize))
    if topk:
        new = dda_occ.traverse_occ_topk(*_args(vols), o, d, tl, act, ven,
                                        occ=jnp.asarray(vols.occ),
                                        bricksize=jnp.asarray(vols.bricksize),
                                        mode="nearest", k=topk)
    else:
        new = dda_occ.traverse_occ(*_args(vols), o, d, tl, act, ven,
                                   occ=jnp.asarray(vols.occ),
                                   bricksize=jnp.asarray(vols.bricksize),
                                   mode="nearest")
    np.testing.assert_array_equal(np.asarray(ref["hit"]), np.asarray(new["hit"]))
    h = np.asarray(ref["hit"])
    np.testing.assert_allclose(np.asarray(ref["t"])[h], np.asarray(new["t"])[h],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ref["cell"])[h],
                                  np.asarray(new["cell"])[h])
    np.testing.assert_array_equal(np.asarray(ref["vol"])[h],
                                  np.asarray(new["vol"])[h])
    for c in ("nx", "ny", "nz"):
        np.testing.assert_allclose(np.asarray(ref[c])[h], np.asarray(new[c])[h],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,topk", [(3, 0), (4, 0), (3, 2), (4, 1)])
def test_occluded_parity(seed, topk):
    rng = np.random.default_rng(seed)
    vols = _rand_scene(rng, nvol=4 if topk else 3)
    o, d = _rand_rays(rng)
    n = o.shape[0]
    act = jnp.ones(n, bool)
    tl = jnp.asarray(rng.uniform(0.5, 4.0, n).astype(np.float32))
    ven = jnp.ones(vols.n, bool)

    ref = dda.traverse(*_args(vols), o, d, tl, act, ven,
                       jnp.int32(1), jnp.int32(0), mode="occluded",
                       bricks_flat=jnp.asarray(vols.bricks.reshape(-1)),
                       bricksize=jnp.asarray(vols.bricksize))
    if topk:
        new = dda_occ.traverse_occ_topk(*_args(vols), o, d, tl, act, ven,
                                        occ=jnp.asarray(vols.occ),
                                        bricksize=jnp.asarray(vols.bricksize),
                                        mode="occluded", k=topk)
    else:
        new = dda_occ.traverse_occ(*_args(vols), o, d, tl, act, ven,
                                   occ=jnp.asarray(vols.occ),
                                   bricksize=jnp.asarray(vols.bricksize),
                                   mode="occluded")
    np.testing.assert_array_equal(np.asarray(ref["hit"]), np.asarray(new["hit"]))


@pytest.mark.parametrize("seed", [5, 6])
def test_exit_parity(seed):
    """March rays dropped inside glass/smoke content out of their medium."""
    rng = np.random.default_rng(seed)
    vols = _rand_scene(rng)
    # rays starting at random points near the volumes, random directions
    o, d = _rand_rays(rng, n=256)
    o = o * 0.4  # keep origins near volume interiors
    n = o.shape[0]
    vol_idx = jnp.asarray(rng.integers(0, vols.n, n).astype(np.int32))
    mode_code = jnp.asarray(rng.integers(0, 2, n).astype(np.int32))
    mask = jnp.ones(n, bool)

    ref = dda.traverse(*_args(vols), o, d, jnp.full(n, dda.BIG, jnp.float32),
                       mask, jnp.ones(vols.n, bool),
                       jnp.int32(1), jnp.int32(0), mode="exit",
                       mode_code=mode_code, vol_match=vol_idx,
                       bricks_flat=jnp.asarray(vols.bricks.reshape(-1)),
                       bricksize=jnp.asarray(vols.bricksize))
    new = dda_occ.traverse_occ(*_args(vols), o, d,
                               jnp.full(n, dda.BIG, jnp.float32), mask,
                               jnp.ones(vols.n, bool),
                               occ=jnp.asarray(vols.occ),
                               bricksize=jnp.asarray(vols.bricksize),
                               mode="exit", mode_code=mode_code,
                               vol_match=vol_idx)
    np.testing.assert_array_equal(np.asarray(ref["in_vol"]),
                                  np.asarray(new["in_vol"]))
    np.testing.assert_allclose(np.asarray(ref["t"]), np.asarray(new["t"]),
                               rtol=1e-6, atol=1e-6)
    iv = np.asarray(ref["in_vol"])
    np.testing.assert_array_equal(np.asarray(ref["cell"])[iv],
                                  np.asarray(new["cell"])[iv])
    for c in ("nx", "ny", "nz"):
        np.testing.assert_allclose(np.asarray(ref[c])[iv],
                                   np.asarray(new[c])[iv],
                                   rtol=1e-5, atol=1e-5)
