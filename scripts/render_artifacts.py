#!/usr/bin/env python
"""Render the five BASELINE config images at their declared resolutions
into artifacts/.  One process, so compiled programs are shared."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts")
os.makedirs(ART, exist_ok=True)


def main():
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from voxtracer.io.image import write_png
    from voxtracer.render.integrator import render_tiled
    from voxtracer.render.tonemap import to_rgb8
    from voxtracer.scene import presets

    jobs = [
        ("teapot_primary_256.png",
         lambda: presets.teapot_primary(width=256, height=256), 1, {}),
        ("room_whitted_512.png",
         lambda: presets.room_whitted(width=512, height=512), 1, {}),
        ("roomglass_whitted_512.png",
         lambda: presets.room_whitted(width=512, height=512, glass=True), 1,
         {}),
        ("monu_path_1080p.png",
         lambda: presets.monu_path(width=1920, height=1080, gridsize=64,
                                   which=(1, 2, 3), bounces=4), 64, {}),
        ("city_path_1080p.png",
         lambda: presets.city_path(width=1920, height=1080, gridsize=64,
                                   nx=4, nz=4, bounces=4), 64, {}),
    ]
    for name, mk, spp, over in jobs:
        scene, cfg = mk()
        if over:
            cfg = dataclasses.replace(cfg, **over)
        scene = jax.tree.map(jnp.asarray, scene)
        t0 = time.time()
        img = render_tiled(scene, cfg, jax.random.PRNGKey(0), spp,
                           1 if cfg.width < 1920 else 2)
        rgb = np.asarray(to_rgb8(jnp.asarray(img)))
        write_png(os.path.join(ART, name), rgb)
        print(f"{name}: {cfg.width}x{cfg.height} spp={spp} "
              f"mode={cfg.mode} in {time.time()-t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
