"""Scene pytrees — SoA arrays.

The reference keeps scenes as C++ object graphs (shared_ptr<Material>
tables, vector<Scene> volumes, renderer.h:160-246); here everything is a
flat struct-of-arrays pytree so a single jitted function closes over the
whole world and XLA sees static shapes.

All "counts" are carried in array shapes; jit specializes per scene shape.
Material tables are always 256 entries (reference pads to MatType::NONE,
renderer.cpp:434-442); entry 255 is the empty/NONE slot.
"""

from __future__ import annotations

import numpy as np

from voxtracer.core import pytree

MAT_NONE = 255

# Material class ranges (reference enum, scene.h:38-57)
NON_METAL_WHITE = 0
NON_METAL_RED = 1
NON_METAL_BLUE = 2
NON_METAL_GREEN = 3
NON_METAL_PINK = 4
METAL_HIGH = 5
METAL_MID = 6
METAL_LOW = 7
GLASS = 8
SMOKE_LOW_DENSITY = 9
SMOKE_LOW2_DENSITY = 10
SMOKE_MID_DENSITY = 11
SMOKE_MID2_DENSITY = 12
SMOKE_HIGH_DENSITY = 13
SMOKE_PLAYER = 14
EMISSIVE = 15


@pytree.dataclass
class Materials:
    """SoA material bank — the differentiable parameter set.

    Reference: flat Material {albedo, roughness, emissiveStrength, IOR}
    (src/Materials/Material.h) indexed by voxel value."""

    albedo: np.ndarray  # [256, 3] f32
    roughness: np.ndarray  # [256] f32
    emissive: np.ndarray  # [256] f32
    ior: np.ndarray  # [256] f32


@pytree.dataclass
class Lights:
    """All light banks; the single directional light always exists
    (reference: renderer.cpp:2290-2296 counts it unconditionally)."""

    point_pos: np.ndarray  # [P, 3]
    point_color: np.ndarray  # [P, 3]
    spot_pos: np.ndarray  # [S, 3]
    spot_dir: np.ndarray  # [S, 3]
    spot_color: np.ndarray  # [S, 3]
    spot_cos_angle: np.ndarray  # [S]
    area_pos: np.ndarray  # [A, 3]
    area_color: np.ndarray  # [A, 3]
    area_mult: np.ndarray  # [A]
    area_radius: np.ndarray  # [A]
    dir_direction: np.ndarray  # [3]
    dir_color: np.ndarray  # [3]

    @property
    def n_point(self) -> int:
        return self.point_pos.shape[0]

    @property
    def n_spot(self) -> int:
        return self.spot_pos.shape[0]

    @property
    def n_area(self) -> int:
        return self.area_pos.shape[0]

    @property
    def count(self) -> int:
        # +1 directional (reference: renderer.cpp:2295)
        return self.n_point + self.n_spot + self.n_area + 1


@pytree.dataclass
class Spheres:
    center: np.ndarray  # [N, 3]
    radius: np.ndarray  # [N]
    material: np.ndarray  # [N] i32


@pytree.dataclass
class Triangles:
    """Positioned triangles (reference: src/BVH/Shapes.h:71-145)."""

    v0: np.ndarray  # [N, 3]
    v1: np.ndarray  # [N, 3]
    v2: np.ndarray  # [N, 3]
    position: np.ndarray  # [N, 3]
    material: np.ndarray  # [N] i32


@pytree.dataclass
class VoxVolumes:
    """Batched voxel-volume instances.

    Every instance's dense grid is padded to one static cube size G so the
    whole set is a single [V, G, G, G] array (one gather table);
    per-instance logical gridsize masks traversal.  Object space is the unit
    cube [cube_min, cube_min+1] (reference: scene.cpp:213-217); rays are
    taken world->object by `inv`, normals object->world by `fwd`
    (reference: renderer.cpp:946-993)."""

    grids: np.ndarray  # [V, G, G, G] int32 material ids, MAT_NONE = empty
    gridsize: np.ndarray  # [V] i32 logical size (1..G)
    inv: np.ndarray  # [V, 4, 4] world -> object
    fwd: np.ndarray  # [V, 4, 4] object -> world (normals/linear part)
    cube_min: np.ndarray  # [V, 3] object-space cube lower corner
    # two-level acceleration (the reference's dormant TWOLEVEL TODO,
    # scene.h:9 + scene.cpp:805-810, made real): per 8^3 brick, the uniform
    # cell value if the brick is uniform, else BRICK_MIXED (-1)
    bricks: np.ndarray  # [V, M, M, M] int32, M = ceil(G/8)
    bricksize: np.ndarray  # [V] i32 logical macro size (ceil(gridsize/8))
    # bit-packed per-brick occupancy: 512 bits (one per 8^3 cell) in 16
    # int32 words, LSB-first, bit index b = (fx*8+fy)*8+fz for the local
    # cell (fx,fy,fz).  Three predicate planes (OCC_* indices below): the
    # traversal reads one row per brick crossing and then steps
    # cell-by-cell with bit tests.
    occ: np.ndarray  # [3, V, M^3, 16] int32

    @property
    def n(self) -> int:
        return self.grids.shape[0]

    @property
    def pad_size(self) -> int:
        return self.grids.shape[1]


# occ predicate planes
OCC_ANY = 0          # cell != MAT_NONE            (nearest / occluded)
OCC_EXIT_GLASS = 1   # cell != GLASS               (FindMaterialExit leave)
OCC_EXIT_SMOKE = 2   # cell outside smoke range    (FindSmokeExit leave)


@pytree.dataclass
class Sky:
    """Equirect HDR dome + scale (reference: renderer.cpp:2308-2326)."""

    pixels: np.ndarray  # [H, W, 3] f32
    contribution: np.ndarray  # scalar f32 (HDRLightContribution)


@pytree.dataclass
class Camera:
    """Frustum-corner pinhole + thin lens (reference: template/camera.h)."""

    pos: np.ndarray  # [3]
    top_left: np.ndarray  # [3]
    top_right: np.ndarray  # [3]
    bottom_left: np.ndarray  # [3]
    right: np.ndarray  # [3]
    up: np.ndarray  # [3]
    ahead: np.ndarray  # [3]
    focal_distance: np.ndarray  # scalar
    defocus_jitter: np.ndarray  # scalar


@pytree.dataclass
class SceneData:
    """The complete world handed to integrators (JAX or oracle)."""

    volumes: VoxVolumes
    materials: Materials
    lights: Lights
    spheres: Spheres
    triangles: Triangles
    sky: Sky
    camera: Camera
