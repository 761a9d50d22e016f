#!/usr/bin/env python
"""Benchmark: the monu scene at 1920x1080 on one accelerator.

Measures one path-traced forward frame (4 bounces) and the fused training
step: that frame PLUS the gradient of the differentiable integrator
(union-span relaxed march) wrt density logits and the albedo table, in one
dispatch.  Every time is a median over BENCH_REPS runs after warm-up, each
ended by `jax.block_until_ready`.  Diagnostics go to stderr; stdout
carries one JSON line naming the device.

    python bench.py            # BENCH_WIDTH / BENCH_HEIGHT / BENCH_REPS
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WIDTH = int(os.environ.get("BENCH_WIDTH", 1920))
HEIGHT = int(os.environ.get("BENCH_HEIGHT", 1080))
REPS = int(os.environ.get("BENCH_REPS", 5))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_time(fn, reps):
    """Median wall time of `fn()` over `reps` runs after one warm-up."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(0))
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i + 1))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def build_train_step(scene, cfg, tiles=1, tiles_bwd=2, span_steps=1,
                     bin_steps=(2, 10), bin_edges=(4.0,), log=log):
    """The fused forward + gradient step of the benchmark.

    Returns (step, data): `step(key, data)` renders the frame through
    `render_tiled`'s banded program and returns (image mean, DiffParams
    gradient).  Everything camera-derived (the active rays of each
    span-length bin, their sky, target and occupied spans) is computed
    here once, outside the step: it does not depend on the parameters.
    Bin `bi` marches `bin_steps[bi]` samples; bins above 0 run the
    transmittance-clamp nearest pass."""
    import jax
    import jax.numpy as jnp

    from voxtracer.diff.volumetric import (max_aabb_crossings,
                                           mse_loss_active, params_from_scene,
                                           span_cells_bins, spans_for_rays)
    from voxtracer.render.camera import primary_rays
    from voxtracer.render.integrator import _render_banded
    from voxtracer.render.sky import sample_sky

    width, height = cfg.width, cfg.height
    params = params_from_scene(scene)
    rows = -(-height // tiles_bwd)
    diff_k = min(max_aabb_crossings(scene, cfg), scene.volumes.n)
    denom = float(rows * width * 3)
    log(f"diff pair compaction k={diff_k} of V={scene.volumes.n}")
    data, static = [], []
    for b in range(tiles_bwd):
        r0 = min(b * rows, height - rows)
        px, py = jnp.meshgrid(jnp.arange(width, dtype=jnp.float32),
                              jnp.arange(rows, dtype=jnp.float32) + r0)
        o, d = primary_rays(scene.camera, width, height, px.reshape(-1),
                            py.reshape(-1), None, jnp)
        bins = span_cells_bins(scene, cfg, row0=r0, rows=rows,
                               edges=bin_edges)
        log(f"band {b}: active bins "
            + " ".join(f"{na}@{bin_steps[bi]}st" for (bi, _, _, na) in bins))
        for bi, p, _, na in bins:
            nap = min(-(-na // 1024) * 1024, o.shape[0])
            sel = jnp.asarray(p[:nap])
            oc = jnp.take(o, sel, axis=0)
            dc = jnp.take(d, sel, axis=0)
            data.append(dict(
                oc=oc, dc=dc,
                bg=sample_sky(scene.sky, dc, cfg.activate_sky,
                              cfg.sky_fallback),
                t_act=jnp.zeros((nap, 3), jnp.float32),
                sp=spans_for_rays(scene, oc, dc)))
            static.append((bin_steps[bi], bi > 0, na))

    def grads(bd):
        total = None
        for arrs, (steps, clamp, na) in zip(bd, static):
            g = jax.grad(mse_loss_active)(
                params, scene, cfg, arrs["oc"], arrs["dc"], arrs["bg"],
                arrs["t_act"], denom, steps, k=diff_k, span_steps=span_steps,
                clamp=clamp, n_active=na, spans=arrs["sp"])
            total = g if total is None else jax.tree.map(jnp.add, total, g)
        return total

    @jax.jit
    def step(key, bd):
        img_mean = jnp.mean(_render_banded(scene, cfg, key, 1, tiles))
        return img_mean, grads(bd)

    return step, data


def main():
    import jax
    import jax.numpy as jnp

    from voxtracer.render.integrator import _render_banded
    from voxtracer.scene.presets import monu_path
    from voxtracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {dev.platform}")
    log("devices:", jax.devices())
    scene, cfg = monu_path(width=WIDTH, height=HEIGHT)
    scene = jax.tree.map(jnp.asarray, scene)
    key = jax.random.PRNGKey(0)
    n_rays = WIDTH * HEIGHT

    def fwd(i):
        return _render_banded(scene, cfg, jax.random.fold_in(key, i), 1, 1)

    fwd_s = median_time(fwd, REPS)
    log(f"forward: {fwd_s * 1e3:.3f} ms")
    step, data = build_train_step(scene, cfg)
    both_s = median_time(
        lambda i: step(jax.random.fold_in(key, i), data), REPS)
    log(f"fused fwd+bwd: {both_s * 1e3:.3f} ms")
    print(json.dumps({
        "metric": "rays/s fwd+bwd at 1080p (path fwd + diff bwd)",
        "value": n_rays / both_s,
        "unit": "rays/s",
        "forward_s": fwd_s,
        "fused_step_s": both_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
