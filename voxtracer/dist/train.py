"""Sharded differentiable-rendering train step.

Parallelism layout (SURVEY.md §2 #17):
  * 'data' axis — rays/pixels sharded (the reference's scanline for_each
    becomes mesh data-parallelism);
  * 'model' axis — voxel density grids spatially sharded (the TP-analogue
    for worlds larger than one device's memory).
Parameters replicated across 'data'; XLA inserts the gradient psum
all-reduce automatically in the backward pass of the sharded jit —
the reference has no distributed backend at all (SURVEY.md §5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from voxtracer.diff.volumetric import DiffParams, render_diff
from voxtracer.kernels.dda_gpu import ray_sharding


def make_mesh_2d(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    model = 2 if n % 2 == 0 and n > 1 else 1
    return Mesh(np.array(devs).reshape(n // model, model), ("data", "model"))


def shard_params(params: DiffParams, mesh: Mesh) -> DiffParams:
    """Density grids shard spatially (x-dim) over 'model'; the albedo table
    is tiny and replicates."""
    dens_sh = NamedSharding(mesh, P(None, "model", None, None))
    repl = NamedSharding(mesh, P())
    return DiffParams(
        density_logits=jax.device_put(params.density_logits, dens_sh),
        albedo_table=jax.device_put(params.albedo_table, repl),
    )


def make_train_step(cfg, mesh: Mesh, n_steps: int = 64, lr: float = 1e-2):
    """Returns (step_fn, init_opt_state).  step_fn: (params, opt_state,
    scene, target, key) -> (params, opt_state, loss)."""
    opt = optax.adam(lr)
    data_sh = NamedSharding(mesh, P("data", None, None))

    def loss_fn(params, scene, target, key):
        img = render_diff(params, scene, cfg, key, n_steps)
        img = jax.lax.with_sharding_constraint(img, data_sh)
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def sharded_step(params, opt_state, scene, target, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, target, key)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def step(*args):
        # any traversal kernel in the step runs per 'data' shard of rays
        with ray_sharding(mesh, "data"):
            return sharded_step(*args)

    def init(params):
        return opt.init(params)

    return step, init


def train_demo(scene, cfg, target, mesh: Mesh, iters: int = 1, n_steps: int = 64,
               lr: float = 1e-2):
    """One-call training driver used by tests and the multichip dryrun."""
    from voxtracer.diff.volumetric import params_from_scene

    params = shard_params(params_from_scene(scene), mesh)
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    target = jax.device_put(jnp.asarray(target, jnp.float32),
                            NamedSharding(mesh, P("data", None, None)))
    step, init = make_train_step(cfg, mesh, n_steps, lr)
    opt_state = init(params)
    loss = None
    for i in range(iters):
        params, opt_state, loss = step(params, opt_state, scene, target,
                                       jax.random.PRNGKey(i))
    jax.block_until_ready(loss)
    return params, float(loss)
