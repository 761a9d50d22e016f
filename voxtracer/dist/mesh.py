"""Device meshes + sharded rendering (SURVEY.md §2 #17, §5).

The reference's only parallelism is a scanline `for_each(par)` + AVX2
packets (renderer.cpp:1662-1673).  Here:

 * **rays** axis (data parallel): the pixel/ray batch shards across all
   devices — each device traces its rows; the scene (grids, materials,
   lights, sky) is replicated.  No collective is needed in the forward
   pass because pixels are disjoint (tile sharding, SURVEY.md §5).  The
   traversal kernel runs per ray shard (kernels/dda_gpu.ray_sharding).
 * **grid** axis (tensor-parallel analogue): for worlds larger than one
   device's memory the volume batch dimension V can shard; forward
   gathers go through XLA's SPMD partitioner.
 * gradients: with replicated parameters and sharded rays, XLA inserts the
   `psum` all-reduce over parameter gradients automatically in the backward
   of a sharded-jit loss (dist/train.py).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "rays") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def render_sharded(scene, cfg, key, spp: int, mesh: Mesh):
    """Data-parallel render: pixels sharded over the mesh's rays axis.

    Returns the full [H, W, 3] radiance image (device-sharded array)."""
    import jax.numpy as jnp

    from voxtracer.render.camera import primary_rays
    from voxtracer.render.integrator import (
        _albedo, _pixel_grid, find_nearest_world, render_sample,
        trace_path, trace_whitted_iter)
    from voxtracer.render.sky import sample_sky

    n_dev = mesh.devices.size
    h, w = cfg.height, cfg.width
    n = h * w
    n_pad = pad_to_multiple(n, n_dev)

    px, py = _pixel_grid(cfg)
    px = jnp.pad(px, (0, n_pad - n))
    py = jnp.pad(py, (0, n_pad - n))

    ray_sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    repl = NamedSharding(mesh, P())
    px = jax.device_put(px, ray_sharding)
    py = jax.device_put(py, ray_sharding)
    scene = jax.device_put(scene, repl)

    @partial(jax.jit, static_argnames=("spp",), out_shardings=ray_sharding)
    def run(scene, px, py, key, spp):
        def one(acc, i):
            k = jax.random.fold_in(key, i)
            deterministic = cfg.mode in ("primary", "whitted")
            pxj, pyj = px, py
            if not deterministic:
                u = jax.random.uniform(jax.random.fold_in(k, 100), (px.shape[0], 2))
                pxj = px + u[:, 0] * cfg.aa_strength
                pyj = py + u[:, 1] * cfg.aa_strength
            lens = (jax.random.uniform(jax.random.fold_in(k, 101), (px.shape[0], 2))
                    if (cfg.use_dof and not deterministic) else None)
            o, d = primary_rays(scene.camera, w, h, pxj, pyj, lens, jnp)
            if cfg.mode == "primary":
                rec = find_nearest_world(scene, o, d, jnp.ones(o.shape[0], bool))
                sky = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
                val = jnp.where(rec["hit"][:, None], _albedo(scene, rec["mat"]), sky)
            elif cfg.mode == "whitted":
                val = trace_whitted_iter(scene, cfg, o, d, cfg.max_bounces)
            else:
                val = trace_path(scene, cfg, o, d, k)
            return acc + val, None

        acc, _ = jax.lax.scan(one, jnp.zeros((px.shape[0], 3), jnp.float32),
                              jnp.arange(spp))
        return acc / spp

    from voxtracer.kernels.dda_gpu import ray_sharding

    with ray_sharding(mesh, mesh.axis_names[0]):
        flat = run(scene, px, py, key, spp)
    return flat[:n].reshape(h, w, 3)
