"""Procedural volume generation — SURVEY.md §2 #5.

Reference: Scene::GenerateSomeNoise / GenerateSomeSmoke /
CreateEmmisiveSphere (scene.cpp:226-356, 685-711) built on FastNoise2
Perlin.  Here: a classic seeded 3D gradient-noise (Perlin) in vectorized
NumPy — equivalent statistics, not bit-identical to FastNoise2 (documented
deviation) — with the reference's exact threshold tables, including the
dead `n < 0.17` branch (scene.cpp:262-265) which we preserve as a comment,
not as code, since it is unreachable.
"""

from __future__ import annotations

import numpy as np

from voxtracer.core.types import (
    EMISSIVE,
    GLASS,
    MAT_NONE,
    METAL_HIGH,
    METAL_LOW,
    METAL_MID,
    NON_METAL_RED,
    SMOKE_HIGH_DENSITY,
    SMOKE_LOW2_DENSITY,
    SMOKE_LOW_DENSITY,
    SMOKE_MID2_DENSITY,
    SMOKE_MID_DENSITY,
)


def _perm(rng: np.random.Generator) -> np.ndarray:
    p = rng.permutation(256).astype(np.int32)
    return np.concatenate([p, p])


_GRADS = np.array(
    [[1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
     [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
     [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
     [1, 1, 0], [0, -1, 1], [-1, 1, 0], [0, -1, -1]], np.float32)


def perlin3(shape, frequency: float, seed: int = 0) -> np.ndarray:
    """Classic Perlin gradient noise on a lattice; output roughly [-1, 1]."""
    rng = np.random.default_rng(seed)
    perm = _perm(rng)
    gx, gy, gz = shape
    coords = np.stack(np.meshgrid(
        np.arange(gx, dtype=np.float32),
        np.arange(gy, dtype=np.float32),
        np.arange(gz, dtype=np.float32), indexing="ij"), axis=-1)
    p = coords * frequency * 16.0  # scale so small freqs still vary per cell
    pi = np.floor(p).astype(np.int32)
    pf = p - pi

    def grad_dot(ox, oy, oz):
        h = perm[perm[perm[(pi[..., 0] + ox) & 255] + ((pi[..., 1] + oy) & 255)]
                 + ((pi[..., 2] + oz) & 255)] & 15
        g = _GRADS[h]
        d = pf - np.array([ox, oy, oz], np.float32)
        return (g * d).sum(-1)

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    u, v, w = fade(pf[..., 0]), fade(pf[..., 1]), fade(pf[..., 2])

    def lerp(a, b, t):
        return a + t * (b - a)

    x00 = lerp(grad_dot(0, 0, 0), grad_dot(1, 0, 0), u)
    x10 = lerp(grad_dot(0, 1, 0), grad_dot(1, 1, 0), u)
    x01 = lerp(grad_dot(0, 0, 1), grad_dot(1, 0, 1), u)
    x11 = lerp(grad_dot(0, 1, 1), grad_dot(1, 1, 1), u)
    y0 = lerp(x00, x10, v)
    y1 = lerp(x01, x11, v)
    return lerp(y0, y1, w).astype(np.float32)


def generate_noise_grid(gridsize: int, frequency: float = 0.03,
                        seed: int = 0) -> np.ndarray:
    """GenerateSomeNoise (scene.cpp:226-282): threshold table verbatim
    (the n<0.17 white branch is dead — shadowed by n<0.2)."""
    rng = np.random.default_rng(seed)
    n = perlin3((gridsize,) * 3, frequency, seed)
    out = np.full(n.shape, MAT_NONE, np.uint8)
    rand_mat = rng.integers(0, GLASS, size=n.shape).astype(np.uint8)
    out = np.where(n <= 0.04, MAT_NONE, out)
    band = (n > 0.04) & (n < 0.08)
    out = np.where(band, rand_mat, out)
    out = np.where((n >= 0.08) & (n < 0.2), NON_METAL_RED, out)
    out = np.where((n >= 0.2) & (n < 0.3), EMISSIVE, out)
    out = np.where((n >= 0.3) & (n < 0.5), METAL_HIGH, out)
    out = np.where((n >= 0.5) & (n < 0.7), METAL_MID, out)
    out = np.where((n >= 0.7) & (n < 0.9), METAL_LOW, out)
    return out


def monument_grid(gridsize: int, which: int, seed: int,
                  updates: dict | None = None) -> np.ndarray:
    """A seeded voxel monument: stepped plinth, a carved body whose
    silhouette depends on `which` (1 obelisk, 2 gate, 3 domed drum), and a
    material mix that drives every traversal mode of a path-traced frame —
    diffuse palette stone (ids 16+), METAL_* trim from the noise table,
    a GLASS band (material exits), a SMOKE_* pocket open to the front
    (smoke exits) and an EMISSIVE orb on top.

    `updates` collects the palette albedos of the stone entries, like
    grid_from_vox's material-table mutation (apply them with
    scene.materials.apply_palette_updates).  Grid axes are [x, y, z] with
    y up; the front face is low z."""
    from voxtracer.scene.volume import emissive_sphere, solid_grid

    g = gridsize
    s = seed + 101 * which
    rng = np.random.default_rng(s)
    c = (np.arange(g, dtype=np.float32) + 0.5) / g
    u, v, w = np.meshgrid(c, c, c, indexing="ij")
    dx, dz = u - 0.5, w - 0.5
    ring = np.maximum(np.abs(dx), np.abs(dz))
    plinth = ((v < 0.12) & (ring < 0.46)) | ((v < 0.22) & (ring < 0.36))
    kind = (which - 1) % 3
    if kind == 0:  # tapered obelisk with a pyramidion
        half = 0.22 - 0.16 * np.clip((v - 0.22) / 0.6, 0.0, 1.0)
        body = (v < 0.82) & (ring < half)
        cap = (v >= 0.82) & (ring < 0.06 + (0.92 - v) * 0.6) & (v < 0.92)
        top = 0.95
    elif kind == 1:  # gate: two pillars under a lintel
        pillar = (np.abs(np.abs(dx) - 0.24) < 0.09) & (np.abs(dz) < 0.12)
        body = (v < 0.72) & pillar
        body |= (v >= 0.62) & (v < 0.76) & (np.abs(dx) < 0.36) & (
            np.abs(dz) < 0.14)
        cap = (v >= 0.76) & (v < 0.80) & (np.abs(dx) < 0.30) & (
            np.abs(dz) < 0.10)
        top = 0.84
    else:  # drum under a hemispherical dome
        r = np.sqrt(dx * dx + dz * dz)
        body = (v < 0.55) & (r < 0.3)
        cap = (v >= 0.55) & ((r * r + (v - 0.55) ** 2) < 0.3 ** 2)
        top = 0.88
    solid = plinth | body | cap

    # carve windows and hollows into the upper mass (never the plinth)
    n = perlin3((g,) * 3, 0.02, seed=s)
    solid &= ~((n > 0.3) & (v > 0.25))

    # stone: four palette entries per model, banded by height and noise
    base_id = 16 + 4 * (which - 1)
    stone = rng.uniform(0.35, 0.85, (4, 1)) * np.array(
        [[1.0, 0.93, 0.8]], np.float32) + rng.uniform(-0.05, 0.05, (4, 3))
    if updates is not None:
        for k in range(4):
            updates[base_id + k] = np.clip(stone[k], 0.0, 1.0).astype(
                np.float32)
    band = (np.floor(v * 7.0 + n * 3.0).astype(np.int32) % 4)
    out = np.where(solid, base_id + band, MAT_NONE).astype(np.uint8)

    # metal trim: the noise table's METAL_* cells on the plinth and cap
    noise = generate_noise_grid(g, 0.03, seed=s)
    metal = (noise >= METAL_HIGH) & (noise <= METAL_LOW)
    trim = solid & (plinth & (v >= 0.1) | cap) & metal
    out = np.where(trim, noise, out)
    out = np.where(solid & cap & ~metal, METAL_LOW, out)

    # glass band through the body
    out = np.where(solid & body & (v >= 0.44) & (v < 0.52), GLASS, out)

    # smoke pocket cut into the front of the body, filled from the smoke
    # generator (densest cells kept, a low-density floor elsewhere)
    pocket = ((dx * dx + (v - 0.36) ** 2 + (w - 0.28) ** 2) < 0.13 ** 2) & (
        v > 0.22)
    smoke = generate_smoke_grid(g, 0.167, seed=s)
    smoke = np.where(smoke == MAT_NONE, SMOKE_LOW_DENSITY, smoke)
    out = np.where(pocket, smoke, out)

    # emissive orb above the summit
    rad = max(1.5, 0.07 * g)
    orb = emissive_sphere(solid_grid(g, MAT_NONE), EMISSIVE, rad) == EMISSIVE
    shift = min(int(round((top - 0.5) * g)), int(g / 2 - 1 - rad))
    orb = np.roll(orb, shift, axis=1)
    out = np.where(orb, EMISSIVE, out)
    return out.astype(np.uint8)


def generate_smoke_grid(gridsize: int, frequency: float = 0.167,
                        seed: int = 0) -> np.ndarray:
    """GenerateSomeSmoke (scene.cpp:285-356): ellipsoid falloff with the
    reference's *per-voxel random* ellipsoid dimensions quirk, density
    bands verbatim."""
    rng = np.random.default_rng(seed)
    g = gridsize
    n = perlin3((g,) * 3, frequency, seed)
    coords = np.stack(np.meshgrid(*([np.arange(g, dtype=np.float32)] * 3),
                                  indexing="ij"), axis=-1)
    center = g / 2.0
    rand_x = g / 2.0 + rng.uniform(-g / 4.0, g / 2.0, size=n.shape).astype(np.float32)
    rand_z = g / 2.0 + rng.uniform(-g / 4.0, g / 2.0, size=n.shape).astype(np.float32)
    dims = np.stack([rand_x, np.full_like(rand_x, g / 3.0), rand_z], axis=-1)
    dist = (coords - center) / dims
    d2 = (dist * dist).sum(-1)

    out = np.full(n.shape, MAT_NONE, np.uint8)
    out = np.where(n < 1.0, SMOKE_LOW_DENSITY, out)
    out = np.where(n < 0.7, SMOKE_LOW2_DENSITY, out)
    out = np.where(n < 0.6, SMOKE_MID_DENSITY, out)
    out = np.where(n < 0.4, SMOKE_MID2_DENSITY, out)
    out = np.where(n < 0.3, SMOKE_HIGH_DENSITY, out)
    out = np.where((n - d2 < 0.04) | (d2 > 1.5), MAT_NONE, out)
    return out
