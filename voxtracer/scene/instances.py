"""Instance (TLAS-input) assembly: volume specs -> batched VoxVolumes.

The reference keeps `vector<Scene> voxelVolumes` and brute-force loops it
per ray (renderer.cpp:946-1018).  Here every instance is batched into one
[V, G, G, G] grid array + [V,4,4] transform stack, so one traversal walks
all instances for the whole ray wavefront (kernels/dda_occ.py,
kernels/dda_gpu.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from voxtracer.core.transforms import volume_transforms
from voxtracer.core.types import MAT_NONE, Spheres, Triangles, VoxVolumes
from voxtracer.scene.volume import empty_grid


@dataclass
class VolumeSpec:
    """Host-side description of one voxel volume instance
    (mirrors reference Scene fields: scene.h:252-266)."""

    position: tuple = (0.0, 0.0, 0.0)
    gridsize: int = 64
    scale: tuple = (1.0, 1.0, 1.0)
    rotation: tuple = (0.0, 0.0, 0.0)
    rot_mat4: np.ndarray | None = None  # overrides rotation (player transform)
    grid: np.ndarray | None = None  # [g, g, g] uint8; None = empty

    def build_grid(self) -> np.ndarray:
        if self.grid is None:
            return empty_grid(self.gridsize)
        assert self.grid.shape == (self.gridsize,) * 3
        return self.grid


BRICK = 8
BRICK_MIXED = -1


def build_bricks(grid: np.ndarray, gridsize: int) -> np.ndarray:
    """Uniform-brick macro grid for one padded instance grid [G, G, G]:
    value = the single cell value if the 8^3 brick (clipped to the logical
    gridsize) is uniform, else BRICK_MIXED.  Prefers the C++ builder
    (native/voxio.cpp, bit-identical) for large grids."""
    try:
        from voxtracer.native import build_bricks_native

        out = build_bricks_native(np.ascontiguousarray(grid, np.uint8), gridsize)
        if out is not None:
            return out
    except Exception:
        pass
    m = max(1, -(-gridsize // BRICK))
    out = np.full((m, m, m), BRICK_MIXED, np.int32)
    for bx in range(m):
        for by in range(m):
            for bz in range(m):
                sub = grid[bx * BRICK:min((bx + 1) * BRICK, gridsize),
                           by * BRICK:min((by + 1) * BRICK, gridsize),
                           bz * BRICK:min((bz + 1) * BRICK, gridsize)]
                lo, hi = sub.min(), sub.max()
                out[bx, by, bz] = int(lo) if lo == hi else BRICK_MIXED
    return out


def pack_occupancy(pred: np.ndarray, mside: int) -> np.ndarray:
    """[G8, G8, G8] bool (G8 = mside*8) -> [mside^3, 16] int32 brick bitmasks.

    Bit b = (fx*8+fy)*8+fz of brick word b>>5, LSB-first — the layout the
    traversal's register bit tests assume (kernels/dda_occ.py)."""
    g8 = mside * BRICK
    assert pred.shape == (g8, g8, g8)
    p = (pred.reshape(mside, BRICK, mside, BRICK, mside, BRICK)
         .transpose(0, 2, 4, 1, 3, 5)
         .reshape(mside * mside * mside, BRICK ** 3))
    bytes_ = np.packbits(p, axis=1, bitorder="little")  # [m^3, 64] u8
    return bytes_.view("<u4").astype(np.int64).astype(np.int32).reshape(-1, 16)


def build_occupancy(grids: np.ndarray) -> np.ndarray:
    """[V, G, G, G] int grids -> [3, V, M^3, 16] int32 occupancy planes."""
    from voxtracer.core.types import GLASS, SMOKE_LOW_DENSITY, SMOKE_PLAYER

    v, g = grids.shape[0], grids.shape[1]
    mside = max(1, -(-g // BRICK))
    g8 = mside * BRICK
    padded = np.full((v, g8, g8, g8), MAT_NONE, grids.dtype)
    padded[:, :g, :g, :g] = grids
    out = np.zeros((3, v, mside ** 3, 16), np.int32)
    preds = (
        padded != MAT_NONE,                                   # OCC_ANY
        padded != GLASS,                                      # OCC_EXIT_GLASS
        (padded < SMOKE_LOW_DENSITY) | (padded > SMOKE_PLAYER),  # OCC_EXIT_SMOKE
    )
    for k, pred in enumerate(preds):
        for i in range(v):
            out[k, i] = pack_occupancy(pred[i], mside)
    return out


def build_volumes(specs: list[VolumeSpec], pad_size: int | None = None) -> VoxVolumes:
    """Pad every instance grid to one static size and stack transforms."""
    if not specs:
        raise ValueError("scene needs at least one voxel volume")
    gmax = pad_size or max(s.gridsize for s in specs)
    mmax = max(1, -(-gmax // BRICK))
    v = len(specs)
    grids = np.full((v, gmax, gmax, gmax), MAT_NONE, dtype=np.uint8)
    bricks = np.full((v, mmax, mmax, mmax), BRICK_MIXED, dtype=np.int32)
    gridsize = np.zeros(v, np.int32)
    bricksize = np.zeros(v, np.int32)
    fwd = np.zeros((v, 4, 4), np.float32)
    inv = np.zeros((v, 4, 4), np.float32)
    cube_min = np.zeros((v, 3), np.float32)
    for i, s in enumerate(specs):
        g = s.gridsize
        grids[i, :g, :g, :g] = s.build_grid()
        gridsize[i] = g
        bsz = max(1, -(-g // BRICK))
        bricksize[i] = bsz
        bricks[i, :bsz, :bsz, :bsz] = build_bricks(grids[i, :g, :g, :g], g)
        f, iv = volume_transforms(s.position, s.scale, s.rotation, s.rot_mat4)
        fwd[i], inv[i] = f, iv
        cube_min[i] = np.asarray(s.position, np.float32)
    return VoxVolumes(
        grids=grids.astype(np.int32),
        gridsize=gridsize,
        inv=inv,
        fwd=fwd,
        cube_min=cube_min,
        bricks=bricks,
        bricksize=bricksize,
        occ=build_occupancy(grids),
    )


def instance_world_aabbs(volumes: VoxVolumes):
    """World-space AABB per instance: the 8 object-space cube corners
    [cube_min, cube_min+1] pushed through the fwd transform."""
    v = volumes.n
    lo = np.zeros((v, 3), np.float32)
    hi = np.zeros((v, 3), np.float32)
    for i in range(v):
        b0 = np.asarray(volumes.cube_min[i], np.float32)
        corners = np.array([[b0[0] + x, b0[1] + y, b0[2] + z]
                            for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                           np.float32)
        m = np.asarray(volumes.fwd[i], np.float32)
        world = corners @ m[:3, :3].T + m[:3, 3]
        lo[i] = world.min(axis=0)
        hi[i] = world.max(axis=0)
    return lo, hi


def make_spheres(items=()) -> Spheres:
    """items: iterable of (cx,cy,cz, radius, material)."""
    a = np.asarray(items, np.float32).reshape(-1, 5)
    return Spheres(
        center=np.ascontiguousarray(a[:, 0:3]),
        radius=np.ascontiguousarray(a[:, 3]),
        material=a[:, 4].astype(np.int32),
    )


# Reference triangle construction (src/BVH/Shapes.cpp): a unit triangle
# scaled+positioned.  Shapes.cpp defines vertex0..2 via rand or fixed pattern;
# CreateTrianglePattern uses Triangle(mat, pos, scale).
def make_triangles(items=()) -> Triangles:
    """items: iterable of dicts or tuples (v0, v1, v2, position, material)."""
    n = len(items)
    v0 = np.zeros((n, 3), np.float32)
    v1 = np.zeros((n, 3), np.float32)
    v2 = np.zeros((n, 3), np.float32)
    pos = np.zeros((n, 3), np.float32)
    mat = np.zeros(n, np.int32)
    for i, (a, b, c, p, m) in enumerate(items):
        v0[i], v1[i], v2[i], pos[i], mat[i] = a, b, c, p, m
    return Triangles(v0=v0, v1=v1, v2=v2, position=pos, material=mat)
