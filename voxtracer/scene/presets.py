"""Benchmark scene presets (BASELINE.json configs 1-5).

Each builder returns ``(SceneData, RenderConfig)`` with NumPy arrays —
feed directly to the oracle or let JAX device-put them.
"""

from __future__ import annotations

import os

import numpy as np

from voxtracer.config import RenderConfig
from voxtracer.core.types import GLASS, SceneData, Sky
from voxtracer.io.hdr import procedural_sky
from voxtracer.io.vox import load_vox
from voxtracer.render.camera import make_camera
from voxtracer.scene.instances import VolumeSpec, build_volumes, make_spheres, make_triangles
from voxtracer.scene.lights import make_lights
from voxtracer.scene.materials import apply_palette_updates, default_materials
from voxtracer.scene.procgen import monument_grid
from voxtracer.scene.volume import grid_from_vox, solid_grid

ASSET_DIR = os.environ.get("VOX_ASSETS", "/root/reference/assets")


def _sky(width=512, height=256, contribution=1.0) -> Sky:
    return Sky(pixels=procedural_sky(width, height), contribution=np.float32(contribution))


def _assemble(volumes, materials, lights=None, spheres=None, triangles=None,
              sky=None, camera=None) -> SceneData:
    return SceneData(
        volumes=volumes,
        materials=materials,
        lights=lights if lights is not None else make_lights(point=()),
        spheres=spheres if spheres is not None else make_spheres(),
        triangles=triangles if triangles is not None else make_triangles(),
        sky=sky if sky is not None else _sky(),
        camera=camera if camera is not None else make_camera(),
    )


def _load_grid(name: str, gridsize: int, updates: dict | None = None) -> np.ndarray:
    return grid_from_vox(load_vox(os.path.join(ASSET_DIR, name)), gridsize,
                         material_updates=updates)


def teapot_primary(width=256, height=256, gridsize=128):
    """Config 1: teapot.vox, primary rays only, flat albedo, pinhole."""
    mats = default_materials()
    updates: dict = {}
    grid = _load_grid("teapot.vox", gridsize, updates)
    mats = apply_palette_updates(mats, updates)
    vols = build_volumes([VolumeSpec(position=(0, 0, 0), gridsize=gridsize, grid=grid)])
    cam = make_camera(pos=(0.5, 0.55, -1.1), target=(0.5, 0.3, 0.5), aspect=width / height)
    scene = _assemble(vols, mats, camera=cam)
    cfg = RenderConfig(width=width, height=height, mode="primary", max_bounces=1,
                       activate_sky=False)
    return scene, cfg


def room_whitted(width=512, height=512, gridsize=128, glass=False):
    """Config 2/3: room[Glass].vox — point lights, hard shadows, mirrors
    (and dielectrics for roomGlass)."""
    mats = default_materials()
    updates: dict = {}
    name = "roomGlass.vox" if glass else "room.vox"
    grid = _load_grid(name, gridsize, updates)
    mats = apply_palette_updates(mats, updates)
    vols = build_volumes([VolumeSpec(position=(0, 0, 0), gridsize=gridsize, grid=grid)])
    lights = make_lights(
        point=((0.5, 0.85, 0.5, 4.0, 4.0, 4.0), (0.15, 0.6, 0.2, 1.5, 1.5, 1.8)),
    )
    # interior corner view (a camera OUTSIDE the room photographs an
    # unlit exterior wall)
    cam = make_camera(pos=(0.15, 0.3, 0.15), target=(0.6, 0.1, 0.6),
                      aspect=width / height)
    scene = _assemble(vols, mats, lights=lights, camera=cam)
    cfg = RenderConfig(width=width, height=height, mode="whitted",
                       max_bounces=3 if glass else 5,
                       activate_sky=False, deterministic_lights=True,
                       # BOTH room palettes map slot 8 (GLASS) — room.vox
                       # uses it for the floor (palette index = material id,
                       # scene.cpp:516); without the split those pixels
                       # compile to black
                       whitted_glass_split=True)
    return scene, cfg


MONU_SEED = 1729


def monu_path(width=1920, height=1080, gridsize=64, which=(1, 2, 3), bounces=4,
              spp=1):
    """Config 4: three monuments path traced with HDR sky.

    A seeded stand-in for monu1-3.vox: each model volume is generated by
    scene.procgen.monument_grid from MONU_SEED = 1729 (model `m` uses seed
    1729 + 101 * m) at `gridsize`^3, so the scene needs no file from
    outside the repository.  Positions, floor slab, light, camera, sky and
    RenderConfig are those of the .vox configuration."""
    mats = default_materials()
    updates: dict = {}
    specs = []
    for i, m in enumerate(which):
        grid = monument_grid(gridsize, m, MONU_SEED, updates)
        specs.append(VolumeSpec(position=(float(i) * 0.75 - 0.75, 0.0, 0.0),
                                gridsize=gridsize, grid=grid))
    # floor slab
    specs.append(VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1,
                            scale=(8.0, 0.02, 8.0), grid=solid_grid(1, 7)))
    mats = apply_palette_updates(mats, updates)
    vols = build_volumes(specs)
    lights = make_lights(point=((0.0, 3.0, -2.0, 6.0, 6.0, 6.0),))
    cam = make_camera(pos=(0.1, 1.1, -2.6), target=(0.2, 0.5, 0.5), aspect=width / height)
    scene = _assemble(vols, mats, lights=lights, sky=_sky(), camera=cam)
    cfg = RenderConfig(width=width, height=height, mode="path", max_bounces=bounces,
                       spp=spp, activate_sky=True)
    return scene, cfg


def city_path(width=1920, height=1080, gridsize=64, nx=4, nz=4, bounces=4,
              spp=1, vary_scale=False):
    """Config 5: grid of Small/Tall buildings — the TLAS/multi-instance
    stress scene."""
    mats = default_materials()
    updates: dict = {}
    names = ["SmallBuilding01.vox", "SmallBuilding02.vox", "TallBuilding01.vox"]
    grids = [_load_grid(n, gridsize, updates) for n in names]
    mats = apply_palette_updates(mats, updates)
    specs = []
    rng = np.random.default_rng(7)
    for ix in range(nx):
        for iz in range(nz):
            g = grids[int(rng.integers(0, len(grids)))]
            s = float(rng.uniform(0.7, 1.3)) if vary_scale else 1.0
            specs.append(VolumeSpec(
                position=(ix * 0.6 - nx * 0.3, 0.0, iz * 0.6 - nz * 0.3),
                gridsize=gridsize, grid=g, scale=(s, s, s),
                rotation=(0.0, float(rng.integers(0, 4)) * np.pi / 2.0, 0.0)))
    specs.append(VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1,
                            scale=(12.0, 0.02, 12.0), grid=solid_grid(1, 0)))
    vols = build_volumes(specs)
    lights = make_lights(point=((0.0, 5.0, -4.0, 20.0, 20.0, 18.0),))
    cam = make_camera(pos=(-1.5, 1.6, -3.2), target=(0.0, 0.3, 0.0), aspect=width / height)
    scene = _assemble(vols, mats, lights=lights, sky=_sky(), camera=cam)
    cfg = RenderConfig(width=width, height=height, mode="path", max_bounces=bounces,
                       spp=spp, activate_sky=True)
    return scene, cfg


def city_xl_path(width=1920, height=1080, gridsize=64, bounces=4, spp=1):
    """Config 5 at its BLUEPRINT scale (BASELINE.md "full city"): an
    11x10 block grid = 110 building instances (all three models, 4
    rotations, varied scales) + floor = 111 volumes; the camera pulls
    back to frame the full grid.  Reference scale anchor:
    renderer.h:213 runs 13-21 live volumes — this is the scale the
    reference's dormant BVH (renderer.h:220) was meant for."""
    scene, cfg = city_path(width=width, height=height, gridsize=gridsize,
                           nx=11, nz=10, bounces=bounces, spp=spp,
                           vary_scale=True)
    cam = make_camera(pos=(-3.4, 2.6, -5.6), target=(0.0, 0.2, 0.0),
                      aspect=width / height)
    return scene.replace(camera=cam), cfg


def glass_sphere_box(width=64, height=64):
    """Small deterministic dielectric test scene: a glass voxel block in a
    lit box with a mirror wall (exercises all whitted branches).

    Geometry is deliberately NOT axis-aligned (rotations, off-axis light,
    irrational-ish camera): golden tests compare two float32 pipelines, and
    grazing/axis-aligned layouts make hit/shadow decisions 1-ulp unstable."""
    mats = default_materials()
    block = solid_grid(8, GLASS)
    specs = [
        VolumeSpec(position=(0, 0, 0), gridsize=8, grid=block,
                   scale=(0.5, 0.5, 0.5), rotation=(0.13, 0.41, 0.07)),
        VolumeSpec(position=(0.0, -0.6, 0.0), gridsize=1, scale=(4.0, 0.3, 4.0),
                   grid=solid_grid(1, 1), rotation=(0.02, 0.11, 0.015)),  # red floor
        VolumeSpec(position=(0.0, 0.0, 0.8), gridsize=1, scale=(3.0, 3.0, 0.2),
                   grid=solid_grid(1, 7), rotation=(0.06, -0.09, 0.03)),  # mirror
    ]
    vols = build_volumes(specs)
    lights = make_lights(point=((0.83, 1.57, -1.21, 2.0, 2.0, 2.0),))
    cam = make_camera(pos=(0.517, 0.703, -1.59), target=(0.49, 0.41, 0.5),
                      aspect=width / height)
    scene = _assemble(vols, mats, lights=lights, camera=cam)
    cfg = RenderConfig(width=width, height=height, mode="whitted", max_bounces=5,
                       activate_sky=False, deterministic_lights=True)
    return scene, cfg
