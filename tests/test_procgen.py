"""Procedural generation tests (SURVEY.md §2 #5)."""

import numpy as np

from voxtracer.core.types import MAT_NONE, SMOKE_HIGH_DENSITY, SMOKE_LOW_DENSITY
from voxtracer.scene.procgen import generate_noise_grid, generate_smoke_grid, perlin3


def test_perlin_range_and_determinism():
    a = perlin3((16, 16, 16), 0.05, seed=1)
    b = perlin3((16, 16, 16), 0.05, seed=1)
    c = perlin3((16, 16, 16), 0.05, seed=2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= -1.6 and a.max() <= 1.6  # gradient noise bounds-ish
    assert a.std() > 0.05  # actually varies


def test_noise_grid_materials():
    g = generate_noise_grid(32, 0.03, seed=0)
    vals = np.unique(g)
    assert MAT_NONE in vals
    assert (g != MAT_NONE).any()
    # only legal material bands appear
    legal = set(range(0, 16)) | {MAT_NONE}
    assert set(int(v) for v in vals) <= legal


def test_smoke_grid_is_smoke_only_ellipsoid():
    g = generate_smoke_grid(32, 0.167, seed=0)
    vals = set(int(v) for v in np.unique(g))
    assert vals <= set(range(SMOKE_LOW_DENSITY, SMOKE_HIGH_DENSITY + 1)) | {MAT_NONE}
    assert (g != MAT_NONE).sum() > 50  # some smoke exists
    # corners empty (outside the ellipsoid)
    assert g[0, 0, 0] == MAT_NONE and g[-1, -1, -1] == MAT_NONE


def test_monu_scene_is_seeded_and_complete():
    """The flagship scene comes from the in-repo generator: same seed, same
    voxels; three 64^3 models plus the 1-cell floor slab; and every model
    holds diffuse palette stone, metal, glass, smoke and emissive voxels."""
    from voxtracer.core.types import EMISSIVE, GLASS, METAL_HIGH, METAL_LOW
    from voxtracer.scene.presets import monu_path

    a, cfg = monu_path(width=64, height=36)
    b, _ = monu_path(width=64, height=36)
    grids = np.asarray(a.volumes.grids)
    np.testing.assert_array_equal(grids, np.asarray(b.volumes.grids))
    assert grids.shape == (4, 64, 64, 64)
    assert list(np.asarray(a.volumes.gridsize)) == [64, 64, 64, 1]
    assert grids[3, 0, 0, 0] == METAL_LOW  # floor slab
    assert cfg.mode == "path" and cfg.max_bounces == 4
    albedo = np.asarray(a.materials.albedo)
    for m in range(3):
        g = grids[m]
        assert (g == GLASS).any() and (g == EMISSIVE).any()
        assert ((g >= SMOKE_LOW_DENSITY) & (g <= SMOKE_HIGH_DENSITY)).any()
        assert ((g >= METAL_HIGH) & (g <= METAL_LOW)).any()
        stone = np.unique(g[(g > EMISSIVE) & (g != MAT_NONE)])
        assert len(stone) == 4
        assert not np.allclose(albedo[stone], 1.0)  # palette applied
        assert 0.05 < (g != MAT_NONE).mean() < 0.5  # a mass, not a fill
