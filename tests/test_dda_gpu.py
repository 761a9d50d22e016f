"""The GPU traversal kernel (kernels/dda_gpu.py) against the XLA loop
(kernels/dda_occ.py) it stands in for.

On the CPU the kernel runs through the Pallas interpreter; the compiled
kernel is compared with the reference at real widths on the card
(`test_compiled_kernel_matches_xla`, marked `gpu`, and chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from voxtracer.core.types import GLASS, MAT_NONE, SMOKE_MID_DENSITY
from voxtracer.kernels import dda, dda_gpu, dda_occ
from voxtracer.render import integrator
from voxtracer.scene.instances import VolumeSpec, build_volumes

G = 16


def _grid(rng):
    g = np.full((G,) * 3, MAT_NONE, np.uint8)
    for mat in (1, 7, GLASS, SMOKE_MID_DENSITY, 20):
        lo = rng.integers(0, G - 5, 3)
        hi = lo + rng.integers(2, 6, 3)
        g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = mat
    return g


def _volumes(seed=3):
    """Four 16^3 volumes: two rotated/scaled, plus an exact duplicate of
    volume 0 (every hit on it ties in t, and the lower id must win)."""
    rng = np.random.default_rng(seed)
    g0, g1, g2 = _grid(rng), _grid(rng), _grid(rng)
    specs = [
        VolumeSpec(position=(0.0, 0.0, 0.0), gridsize=G, grid=g0),
        VolumeSpec(position=(0.4, 0.2, 0.3), gridsize=G, grid=g1,
                   rotation=(0.2, 0.5, -0.1), scale=(0.8, 1.1, 0.9)),
        VolumeSpec(position=(-0.6, -0.3, 0.5), gridsize=G, grid=g2,
                   rotation=(-0.3, 0.1, 0.25)),
        VolumeSpec(position=(0.0, 0.0, 0.0), gridsize=G, grid=g0),
    ]
    return jax.tree.map(jnp.asarray, build_volumes(specs))


def _args(vols):
    return (vols.grids.reshape(-1), vols.gridsize, vols.inv, vols.fwd,
            vols.cube_min)


def _rays(n, seed=11):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 2.5, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.3, 1.3, (n, 3)).astype(np.float32)
    d = tgt - o
    d[: n // 8, 1:] = 0.0  # axis-parallel rays: the NaN axis-pick path
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _reference(vols, o, d, tl, act, mode, mode_code=None, vol_match=None):
    ven = jnp.ones(vols.n, bool)
    kw = dict(occ=vols.occ, bricksize=vols.bricksize)
    if mode == "exit":
        return dda_occ.traverse_occ(*_args(vols), o, d, tl, act, ven, **kw,
                                    mode="exit", mode_code=mode_code,
                                    vol_match=vol_match)
    return dda_occ.traverse_occ_topk(*_args(vols), o, d, tl, act, ven, **kw,
                                     mode=mode, k=2)


def _kernel(vols, o, d, tl, act, mode, **kw):
    return dda_gpu.traverse(*_args(vols), o, d, tl, act,
                            jnp.ones(vols.n, bool), vols.occ,
                            vols.bricksize, mode=mode, interpret=True, **kw)


def _assert_same(got, ref, mask):
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a[mask], b[mask], err_msg=k)


@pytest.mark.parametrize("mode", ["nearest", "occluded", "exit"])
def test_kernel_matches_xla(mode):
    vols = _volumes()
    n = 256
    o, d = _rays(n)
    rng = np.random.default_rng(5)
    act = jnp.asarray(rng.random(n) < 0.9)
    if mode == "occluded":
        tl = jnp.asarray(rng.uniform(0.2, 3.0, n).astype(np.float32))
    else:
        tl = jnp.full(n, dda.BIG, jnp.float32)
    kw = {}
    if mode == "exit":
        # march out of whatever each ray hit first, in its own volume
        first = _reference(vols, o, d, tl, act, "nearest")
        act = first["hit"]
        o = o + (first["t"] + 1e-4)[:, None] * d * act[:, None]
        kw = dict(mode_code=jnp.where(first["cell"] == GLASS, dda.EXIT_GLASS,
                                      dda.EXIT_SMOKE),
                  vol_match=jnp.maximum(first["vol"], 0))
    ref = _reference(vols, o, d, tl, act, mode, **kw)
    got = _kernel(vols, o, d, tl, act, mode, **kw)
    _assert_same(got, ref, np.asarray(act))
    if mode == "nearest":
        hit = np.asarray(ref["hit"])
        assert hit.sum() > 40, "too few hits to test anything"
        # the duplicate volume 3 ties volume 0 exactly and must never win
        assert not (np.asarray(got["vol"]) == 3).any()
        assert (np.asarray(got["vol"])[hit] == 0).any()


def test_padding_to_block():
    """A ray count that is not a multiple of the block pads with inactive
    rays and slices back; results do not depend on the block size."""
    vols = _volumes()
    n = 300
    o, d = _rays(n, seed=2)
    tl = jnp.full(n, dda.BIG, jnp.float32)
    act = jnp.ones(n, bool)
    a = _kernel(vols, o, d, tl, act, "nearest", block=128)
    b = _kernel(vols, o, d, tl, act, "nearest", block=32)
    ref = _reference(vols, o, d, tl, act, "nearest")
    for k in ref:
        assert a[k].shape == (n,)
    _assert_same(a, ref, np.ones(n, bool))
    _assert_same(b, ref, np.ones(n, bool))


def test_kernel_under_ray_sharding():
    """Inside `ray_sharding` the kernel runs per ray shard (shard_map over
    the rays axis) with the same results as the single-device call."""
    vols = _volumes()
    n = 200
    o, d = _rays(n, seed=4)
    tl = jnp.full(n, dda.BIG, jnp.float32)
    act = jnp.ones(n, bool)
    mesh = Mesh(np.array(jax.devices()[:4]), ("rays",))
    with dda_gpu.ray_sharding(mesh, "rays"):
        got = jax.jit(lambda o, d: _kernel(vols, o, d, tl, act, "nearest",
                                           block=32))(o, d)
    _assert_same(got, _reference(vols, o, d, tl, act, "nearest"),
                 np.ones(n, bool))


def test_dispatch_picks_xla_on_cpu(monkeypatch):
    """The traversal follows the device platform alone: XLA on the CPU,
    whatever the environment says."""
    for var in ("VOXTRACER_PALLAS", "VOXTRACER_TRAVERSAL"):
        monkeypatch.setenv(var, "1")
    assert integrator.traversal_backend() == "xla"


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the compiled kernel has no CPU form")


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu):
    """The Triton-compiled kernel against the XLA loop on the seeded monu
    scene's primary rays at 1280x720."""
    from voxtracer.render.camera import primary_rays
    from voxtracer.scene.presets import monu_path

    scene, cfg = monu_path(width=1280, height=720)
    vols = jax.tree.map(jnp.asarray, scene.volumes)
    px, py = integrator._pixel_grid(cfg)
    o, d = primary_rays(jax.tree.map(jnp.asarray, scene.camera), cfg.width,
                        cfg.height, px, py, None, jnp)
    n = o.shape[0]
    tl = jnp.full(n, dda.BIG, jnp.float32)
    act = jnp.ones(n, bool)
    ref = _reference(vols, o, d, tl, act, "nearest")
    got = dda_gpu.traverse(*_args(vols), o, d, tl, act,
                           jnp.ones(vols.n, bool), vols.occ, vols.bricksize)
    same = (np.asarray(got["hit"]) == np.asarray(ref["hit"])) & (
        np.asarray(got["cell"]) == np.asarray(ref["cell"]))
    assert same.mean() >= 0.9999


@pytest.mark.parametrize("v", [1, 4, 5, 19, 111])
def test_candidate_order_matches_lax_sort(v):
    """The compare-exchange network orders candidates exactly like a
    lexicographic (entry t, volume id) sort, ties and misses included, at
    any volume count (111: the city-XL scene's)."""
    rng = np.random.default_rng(v)
    t0 = rng.choice([0.25, 0.5, 1.0, dda.BIG], size=(v, 64)).astype(
        np.float32)
    t0[:, :8] = rng.random((v, 8))
    ts, ids = dda_gpu._sort_candidates(jnp.asarray(t0))
    ref_ids = np.lexsort((np.broadcast_to(np.arange(v)[:, None], t0.shape),
                          t0), axis=0)
    np.testing.assert_array_equal(np.asarray(ids), ref_ids.T)
    np.testing.assert_array_equal(np.asarray(ts),
                                  np.take_along_axis(t0, ref_ids, 0).T)
