#!/usr/bin/env python
"""End-to-end inverse rendering demo: recover voxel density from a target
image by gradient descent through the relaxed march (diff/volumetric.py).

Renders a target (teapot, primary visibility), re-initializes the density
field to a solid block, and optimizes density logits + albedo table with
Adam until the render matches.  Saves before/target/after PNGs into
artifacts/ — evidence the differentiable path drives real optimization,
not just a gradient bench.

Runs on the attached GPU (or CPU with JAX_PLATFORMS=cpu, slower).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from voxtracer.diff.volumetric import (DiffParams, mse_loss,
                                       params_from_scene, render_diff)
from voxtracer.io.image import write_png
from voxtracer.scene import presets

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts")
os.makedirs(ART, exist_ok=True)


def to_png(img, name):
    rgb = (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)
    write_png(os.path.join(ART, name), rgb)


def main(size=96, steps=2000, n_march=48):
    scene, cfg = presets.teapot_primary(width=size, height=size, gridsize=64)
    import dataclasses

    cfg = dataclasses.replace(cfg, width=size, height=size)
    scene = jax.tree.map(jnp.asarray, scene)
    key = jax.random.PRNGKey(0)

    # target: the true scene through the SAME relaxed renderer
    true_params = params_from_scene(scene, occupied_logit=6.0,
                                    empty_logit=-6.0)
    target = render_diff(true_params, scene, cfg, key, n_steps=n_march,
                         density_scale=512.0)
    to_png(target, "inverse_target.png")

    # init: a fog block (uniform mid logits) — no knowledge of the teapot.
    # NOTE: spans/occupancy derive from the ORIGINAL grids, so optimization
    # is free to carve density anywhere inside them (the demo carves a
    # teapot out of fog — the occupancy-grid-refresh caveat in README
    # applies to GROWING density outside the original surfaces).
    init = DiffParams(
        density_logits=jnp.full_like(true_params.density_logits, -2.0),
        albedo_table=jnp.full_like(true_params.albedo_table, 0.5))
    to_png(render_diff(init, scene, cfg, key, n_steps=n_march,
                       density_scale=512.0), "inverse_init.png")

    sched = optax.cosine_decay_schedule(5e-2, steps, alpha=0.05)
    opt = optax.adam(sched)

    @jax.jit
    def step(params, opt_state):
        loss, g = jax.value_and_grad(mse_loss)(params, scene, cfg, target,
                                               key, n_march)
        upd, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state, loss

    params, opt_state = init, opt.init(init)
    t0 = time.time()
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state)
        if i % 250 == 0 or i == steps - 1:
            print(f"iter {i:4d}  loss {float(loss):.6f}  "
                  f"({time.time()-t0:.0f}s)", flush=True)
    final_loss = float(loss)

    out = render_diff(params, scene, cfg, key, n_steps=n_march,
                      density_scale=512.0)
    to_png(out, "inverse_recovered.png")
    err = float(jnp.abs(out - target).mean())
    print(f"final loss {final_loss:.6f}; mean |recovered - target| = "
          f"{err:.4f}", flush=True)
    assert final_loss < 5e-3, "optimization did not converge"


if __name__ == "__main__":
    main()
