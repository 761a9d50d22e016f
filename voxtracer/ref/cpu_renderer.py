"""NumPy golden oracle — slow, scalar, obviously-correct renderer.

This is the test oracle the reference never had (SURVEY.md §4): a direct
scalar transcription of the reference's light transport in float32 NumPy.
The jitted integrators must allclose against it (exactly for the
deterministic modes, statistically for path tracing).

Structure mirrors the reference call tree:
  trace()            <- Renderer::Trace           renderer.cpp:1076-1328
  find_nearest()     <- Renderer::FindNearest     renderer.cpp:946-1018
  is_occluded()      <- Renderer::IsOccluded      renderer.cpp:209-243
  Volume DDA         <- Scene::FindNearest etc.   scene.cpp:719-1047
  illumination()     <- Renderer::Illumination    renderer.cpp:738-764
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from voxtracer.config import RenderConfig
from voxtracer.core import mathx
from voxtracer.core.sampling import (
    lambertian_dir,
    point_in_circle,
    positive_octant_dir,
    sphere_sample,
    uniform_hemisphere_dir,
)
from voxtracer.core.types import (
    EMISSIVE,
    GLASS,
    MAT_NONE,
    METAL_HIGH,
    METAL_LOW,
    SMOKE_LOW_DENSITY,
    SMOKE_PLAYER,
    SceneData,
)

F = np.float32
BIG = F(1e34)


def _f3(*args) -> np.ndarray:
    if len(args) == 1:
        return np.asarray(args[0], F).copy()
    return np.array(args, F)


def normalize(v):
    return v / F(np.sqrt(float(v @ v)))


@dataclass
class ORay:
    O: np.ndarray
    D: np.ndarray
    rD: np.ndarray = None  # type: ignore[assignment]
    dsign: np.ndarray = None  # type: ignore[assignment]
    t: F = BIG
    normal: np.ndarray = field(default_factory=lambda: np.zeros(3, F))
    mat: int = MAT_NONE
    in_glass: bool = False

    def __post_init__(self):
        self.O = _f3(self.O)
        self.D = normalize(_f3(self.D))
        self._derive()

    def _derive(self):
        with np.errstate(divide="ignore"):
            self.rD = (F(1.0) / self.D).astype(F)
        # reference ComputeDsign uses the IEEE sign bit (scene.cpp:49-57)
        self.dsign = np.signbit(self.D).astype(F)

    def point(self) -> np.ndarray:
        return self.O + self.t * self.D


@dataclass
class DDAState:
    step: np.ndarray
    P: np.ndarray
    t: F
    tdelta: np.ndarray
    tmax: np.ndarray


class Oracle:
    def __init__(self, scene: SceneData, cfg: RenderConfig, rng: np.random.Generator | None = None):
        self.s = scene
        self.cfg = cfg
        self.rng = rng or np.random.default_rng(0)
        v = scene.volumes
        self.n_vol = v.n
        self.grids = np.asarray(v.grids)
        self.gridsize = np.asarray(v.gridsize)
        self.inv = np.asarray(v.inv)
        self.fwd = np.asarray(v.fwd)
        self.cube_min = np.asarray(v.cube_min, F)

    # ---------- RNG (distribution-parity with reference thread RNG) ----------
    def _u(self) -> F:
        return F(self.rng.random())

    # ---------- object-space volume traversal (scene.cpp:719-1047) ----------
    def _cube_intersect(self, b0, b1, o, d, rd):
        """Cube::Intersect slab test (scene.cpp:166-202)."""
        sign = d < 0
        lo = np.where(sign, b1, b0)
        hi = np.where(sign, b0, b1)
        tmin = (lo - o) * rd
        tmax = (hi - o) * rd
        if tmin[0] > tmax[1] or tmin[1] > tmax[0]:
            return BIG
        t0 = max(tmin[0], tmin[1])
        t1 = min(tmax[0], tmax[1])
        if t0 > tmax[2] or tmin[2] > t1:
            return BIG
        t0 = max(t0, tmin[2])
        return F(t0) if t0 > 0 else BIG

    def _setup_dda(self, vi, o, d, rd, dsign) -> DDAState | None:
        """Scene::Setup3DDDA (scene.cpp:719-749)."""
        b0 = self.cube_min[vi]
        b1 = b0 + F(1.0)
        t = F(0.0)
        if not (np.all(o >= b0) and np.all(o <= b1)):
            t = self._cube_intersect(b0, b1, o, d, rd)
            if t > F(1e33):
                return None
        g = int(self.gridsize[vi])
        gf = F(g)
        cell = F(1.0) / gf
        step = (1 - dsign * 2).astype(np.int32)
        pos_in_grid = gf * ((o - b0) + (t + F(0.00005)) * d)
        grid_planes = (np.ceil(pos_in_grid) - dsign) * cell
        P = np.clip(pos_in_grid.astype(np.int32), 0, g - 1)
        with np.errstate(invalid="ignore"):  # 0 * inf on axis-parallel rays -> NaN,
            # which the step branches treat as "never this axis" (reference quirk)
            tdelta = cell * step.astype(F) * rd
            tmax = (grid_planes - (o - b0)) * rd
        return DDAState(step=step, P=P, t=t, tdelta=tdelta, tmax=tmax.astype(F))

    def _dda_step(self, s: DDAState, g: int) -> bool:
        """One Amanatides-Woo step; False when leaving the grid
        (scene.cpp:773-802 — unsigned wraparound handles negative exits)."""
        # exact branch structure of the reference (NaN tmax components —
        # from 0 * inf on axis-parallel rays — must lose all comparisons)
        if s.tmax[0] < s.tmax[1]:
            a = 0 if s.tmax[0] < s.tmax[2] else 2
        else:
            a = 1 if s.tmax[1] < s.tmax[2] else 2
        s.t = F(s.tmax[a])
        s.P[a] += s.step[a]
        if s.P[a] < 0 or s.P[a] >= g:
            return False
        s.tmax[a] += s.tdelta[a]
        return True

    def _cell(self, vi, P) -> int:
        return int(self.grids[vi, P[0], P[1], P[2]])

    def _normal_voxel(self, vi, o, d, t, dsign) -> np.ndarray:
        """Ray::GetNormalVoxel (scene.cpp:121-148), object-space inputs."""
        ws = F(self.gridsize[vi])
        i1 = (o + t * d) * ws
        fg = i1 - np.floor(i1)
        dist = np.minimum(fg, F(1.0) - fg)
        mind = dist.min()
        sign = dsign * 2 - 1
        n = np.where(dist == mind, sign, F(0.0)).astype(F)
        n = self.fwd[vi][:3, :3] @ n
        return normalize(n)

    def _vol_find_nearest(self, vi, o, d, rd, dsign, ray: ORay, lo=None, hi=None) -> bool:
        """Scene::FindNearest / FindNearestExcept (scene.cpp:751-873)."""
        s = self._setup_dda(vi, o, d, rd, dsign)
        if s is None:
            return False
        g = int(self.gridsize[vi])
        while s.t < ray.t:
            cell = self._cell(vi, s.P)
            skip = lo is not None and lo <= cell <= hi
            if cell != MAT_NONE and s.t < ray.t and not skip:
                ray.t = F(s.t)
                ray.normal = self._normal_voxel(vi, o, d, ray.t, dsign)
                ray.mat = cell
                return True
            if not self._dda_step(s, g):
                break
        return False

    def _vol_exit(self, vi, o, d, rd, dsign, ray: ORay, *, mat=None, smoke=False):
        """Scene::FindMaterialExit / FindSmokeExit (scene.cpp:875-1006).
        Returns True if the exit is into another cell inside the volume."""
        s = self._setup_dda(vi, o, d, rd, dsign)
        if s is None:
            return False
        g = int(self.gridsize[vi])
        while True:
            cell = self._cell(vi, s.P)
            if smoke:
                leave = cell > SMOKE_PLAYER or cell < SMOKE_LOW_DENSITY
            else:
                leave = cell != mat
            if leave:
                ray.t = F(s.t)
                ray.normal = self._normal_voxel(vi, o, d, ray.t, dsign)
                ray.mat = cell
                return True
            if not self._dda_step(s, g):
                break
        ray.t = F(s.t)
        return False

    def _vol_occluded(self, vi, o, d, rd, dsign, tmax) -> bool:
        """Scene::IsOccluded (scene.cpp:1009-1047): ANY non-NONE cell."""
        s = self._setup_dda(vi, o, d, rd, dsign)
        if s is None:
            return False
        g = int(self.gridsize[vi])
        while s.t < tmax:
            if self._cell(vi, s.P) != MAT_NONE:
                return s.t < tmax
            if not self._dda_step(s, g):
                return False
        return False

    # ---------- world-space scene intersection (renderer.cpp:946-1018) ----------
    def _to_object(self, vi, ray: ORay):
        inv = self.inv[vi]
        o = inv[:3, :3] @ ray.O + inv[:3, 3]
        d = inv[:3, :3] @ ray.D
        with np.errstate(divide="ignore"):
            rd = (F(1.0) / d).astype(F)
        return o.astype(F), d.astype(F), rd, np.signbit(d).astype(F)

    def find_nearest(self, ray: ORay, skip_first=False, skip_smoke=False) -> int:
        vox_index = -2
        for vi in range(1 if skip_first else 0, self.n_vol):
            o, d, rd, ds = self._to_object(vi, ray)
            if skip_smoke:
                hit = self._vol_find_nearest(vi, o, d, rd, ds, ray,
                                             lo=SMOKE_LOW_DENSITY, hi=SMOKE_PLAYER)
            else:
                hit = self._vol_find_nearest(vi, o, d, rd, ds, ray)
            if hit:
                vox_index = vi
        # spheres + triangles on a fresh ray, then min-merge (renderer.cpp:996-1016)
        sray = ORay(ray.O.copy(), ray.D.copy())
        for i in range(self.s.spheres.center.shape[0]):
            self._sphere_hit(i, sray)
        for i in range(self.s.triangles.v0.shape[0]):
            self._triangle_hit(i, sray)
        if ray.t > sray.t:
            ray.t = sray.t
            ray.mat = sray.mat
            ray.normal = sray.normal
            ray.in_glass = sray.in_glass
            vox_index = -1
        return vox_index

    def is_occluded(self, ray: ORay) -> bool:
        for vi in range(self.n_vol):
            o, d, rd, ds = self._to_object(vi, ray)
            if self._vol_occluded(vi, o, d, rd, ds, ray.t):
                return True
        for i in range(self.s.spheres.center.shape[0]):
            if self._sphere_is_hit(i, ray):
                return True
        for i in range(self.s.triangles.v0.shape[0]):
            if self._triangle_is_hit(i, ray):
                return True
        return False

    # ---------- analytic primitives (src/BVH/Shapes.h) ----------
    def _sphere_hit(self, i, ray: ORay):
        c = self.s.spheres.center[i]
        r = F(self.s.spheres.radius[i])
        to_ray = ray.O - c
        b = F(to_ray @ ray.D)
        cc = F(to_ray @ to_ray - r * r)
        disc = b * b - cc
        if (cc > 0 and b > 0) or disc < 0:
            return
        t = F(-b - np.sqrt(disc))
        if t > ray.t or t < 0:
            return
        p = ray.O + t * ray.D
        n = (p - c) / r
        outside = float(ray.D @ n) < 0
        ray.normal = n if outside else -n
        ray.in_glass = not outside
        ray.t = t
        ray.mat = int(self.s.spheres.material[i])

    def _sphere_is_hit(self, i, ray: ORay) -> bool:
        c = self.s.spheres.center[i]
        r = F(self.s.spheres.radius[i])
        to_ray = ray.O - c
        b = F(to_ray @ ray.D)
        cc = F(to_ray @ to_ray - r * r)
        disc = b * b - cc
        if (cc > 0 and b > 0) or disc < 0:
            return False
        t = F(-b - np.sqrt(disc))
        return 0 <= t <= ray.t

    def _tri_geom(self, i):
        t = self.s.triangles
        p = t.position[i]
        return p + t.v0[i], p + t.v1[i], p + t.v2[i]

    def _triangle_hit(self, i, ray: ORay):
        p1, p2, p3 = self._tri_geom(i)
        e1, e2 = p2 - p1, p3 - p1
        h = np.cross(ray.D, e2)
        a = F(e1 @ h)
        if -1e-4 < a < 1e-4:
            return
        f = F(1.0) / a
        sv = ray.O - p1
        u = f * F(sv @ h)
        if u < 0 or u > 1:
            return
        q = np.cross(sv, e1)
        v = f * F(ray.D @ q)
        if v < 0 or u + v > 1:
            return
        t = f * F(e2 @ q)
        if t > 1e-4 and ray.t > t:
            ray.t = F(t)
            ray.mat = int(self.s.triangles.material[i])
            n = normalize(np.cross(e1, e2))
            ray.normal = n if float(ray.D @ n) < 0 else -n

    def _triangle_is_hit(self, i, ray: ORay) -> bool:
        p1, p2, p3 = self._tri_geom(i)
        e1, e2 = p2 - p1, p3 - p1
        h = np.cross(ray.D, e2)
        a = F(e1 @ h)
        if -1e-4 < a < 1e-4:
            return False
        f = F(1.0) / a
        sv = ray.O - p1
        u = f * F(sv @ h)
        if u < 0 or u > 1:
            return False
        q = np.cross(sv, e1)
        v = f * F(ray.D @ q)
        if v < 0 or u + v > 1:
            return False
        t = f * F(e2 @ q)
        return t >= 1e-4 and t <= ray.t

    # ---------- materials ----------
    def albedo(self, m):
        return self.s.materials.albedo[m].astype(F)

    def rough(self, m):
        return F(self.s.materials.roughness[m])

    def emis(self, m):
        return F(self.s.materials.emissive[m])

    def ior(self, m):
        return F(self.s.materials.ior[m])

    # ---------- lights (renderer.cpp:102-207, 315-338, 738-764) ----------
    def _shadowed(self, origin, dirn, dist) -> bool:
        sr = ORay(origin, dirn)
        sr.t = F(dist)
        return self.is_occluded(sr)

    def _point_eval(self, ray: ORay, pos, color):
        p = ray.point()
        dirv = pos - p
        dst = F(np.sqrt(float(dirv @ dirv)))
        dirn = dirv / dst
        cos_t = F(dirn @ ray.normal)
        if cos_t <= 0:
            return np.zeros(3, F)
        intensity = cos_t * color / (dst * dst)
        origin = mathx.offset_ray(p, ray.normal, np)
        if self._shadowed(origin, dirn, dst):
            return np.zeros(3, F)
        return intensity * self.albedo(ray.mat)

    def _spot_eval(self, ray: ORay, pos, sdir, color, cos_angle):
        p = ray.point()
        dirv = pos - p
        dst = F(np.sqrt(float(dirv @ dirv)))
        dirn = dirv / dst
        cos_t = F(dirn @ sdir)
        if cos_t <= cos_angle:
            return np.zeros(3, F)
        alpha = F(1.0) - (F(1.0) - cos_t) / (F(1.0) - cos_angle)
        intensity = cos_t * color / (dst * dst)
        origin = mathx.offset_ray(p, ray.normal, np)
        if self._shadowed(origin, dirn, dst):
            return np.zeros(3, F)
        return intensity * self.albedo(ray.mat) * alpha

    def _dir_eval(self, ray: ORay, ddir, color):
        dirn = -np.asarray(ddir, F)
        cos_t = F(dirn @ ray.normal)
        if cos_t <= 0:
            return np.zeros(3, F)
        origin = mathx.offset_ray(ray.point(), ray.normal, np)
        sr = ORay(origin, dirn)
        if self.is_occluded(sr):
            return np.zeros(3, F)
        return cos_t * color * self.albedo(ray.mat)

    def _area_eval(self, ray: ORay, pos, color, mult, radius):
        p = ray.point()
        origin = mathx.offset_ray(p, ray.normal, np)
        acc = np.zeros(3, F)
        n = self.cfg.num_area_samples
        for _ in range(n):
            rnd = positive_octant_dir(self.rng.standard_normal(3).astype(F), np)
            target = rnd * radius + pos
            dirv = target - p
            dst = F(np.sqrt(float(dirv @ dirv)))
            dirn = dirv / dst
            cos_t = F(dirn @ ray.normal)
            if cos_t <= 0:
                continue
            if self._shadowed(origin, dirn, dst):
                continue
            acc += cos_t * color * mult * (radius * radius) * F(4 * np.pi) / (dst * dst)
        return acc / F(n) * self.albedo(ray.mat)

    def illumination(self, ray: ORay) -> np.ndarray:
        """One-random-light estimator x lightCount (renderer.cpp:738-764),
        or deterministic sum over all lights (same expectation)."""
        L = self.s.lights
        evals = []
        for i in range(L.n_point):
            evals.append(lambda i=i: self._point_eval(ray, L.point_pos[i], L.point_color[i]))
        for i in range(L.n_area):
            evals.append(lambda i=i: self._area_eval(
                ray, L.area_pos[i], L.area_color[i], F(L.area_mult[i]), F(L.area_radius[i])))
        for i in range(L.n_spot):
            evals.append(lambda i=i: self._spot_eval(
                ray, L.spot_pos[i], L.spot_dir[i], L.spot_color[i], F(L.spot_cos_angle[i])))
        evals.append(lambda: self._dir_eval(ray, L.dir_direction, L.dir_color))
        if self.cfg.deterministic_lights:
            return np.sum([e() for e in evals], axis=0).astype(F)
        idx = int(self._u() * len(evals))
        idx = min(idx, len(evals) - 1)
        return evals[idx]() * F(len(evals))

    # ---------- sky (renderer.cpp:2308-2326) ----------
    def sample_sky(self, d) -> np.ndarray:
        if not self.cfg.activate_sky:
            return np.asarray(self.cfg.sky_fallback, F)
        sky = self.s.sky.pixels
        h, w = sky.shape[:2]
        u = int(F(w) * mathx.atan2_fast(F(d[2]), F(d[0]), np) * F(mathx.INV_2PI) - F(0.5))
        v = int(F(h) * mathx.acos_fast(F(d[1]), np) * F(mathx.INV_PI) - F(0.5))
        idx = max(0, u + v * w)
        iy, ix = divmod(idx, w)
        iy = min(iy, h - 1)
        return F(self.s.sky.contribution) * sky[iy, ix].astype(F)

    # ---------- light transport (renderer.cpp:1076-1328) ----------
    def trace(self, ray: ORay, depth: int) -> np.ndarray:
        if depth < 0:
            return np.zeros(3, F)
        vox_index = self.find_nearest(ray)
        if ray.mat == MAT_NONE:
            return self.sample_sky(ray.D)
        mode = self.cfg.mode
        if mode == "primary":
            return self.albedo(ray.mat)
        m = ray.mat
        if METAL_HIGH <= m <= METAL_LOW:
            return self._trace_metal(ray, depth)
        if m < METAL_HIGH:
            return self._trace_nonmetal(ray, depth)
        if m == GLASS:
            return self._trace_glass(ray, depth, vox_index)
        if SMOKE_LOW_DENSITY <= m <= SMOKE_PLAYER:
            return self._trace_smoke(ray, depth, vox_index)
        if m == EMISSIVE:
            return self.albedo(m) * self.emis(m)
        return self._trace_model_default(ray, depth)

    def _perturbed_reflect(self, ray: ORay) -> np.ndarray:
        r = mathx.reflect(ray.D, ray.normal)
        if self.cfg.mode == "whitted":
            return r
        u = np.array([self._u(), self._u(), self._u()], F)
        return r + self.rough(ray.mat) * sphere_sample(u, np)

    def _trace_metal(self, ray: ORay, depth):
        new = ORay(mathx.offset_ray(ray.point(), ray.normal, np), self._perturbed_reflect(ray))
        return self.trace(new, depth - 1) * self.albedo(ray.mat)

    def _trace_nonmetal(self, ray: ORay, depth):
        if self.cfg.mode == "whitted":
            return self.illumination(ray)  # NEE only, no indirect
        cos_in = F(-ray.D @ ray.normal)
        if self._u() > mathx.schlick_nonmetal(cos_in):
            u = np.array([self._u(), self._u(), self._u()], F)
            rand_dir = lambertian_dir(ray.normal, u, np)
            inc = self.illumination(ray)
            new = ORay(mathx.offset_ray(ray.point(), ray.normal, np), rand_dir)
            return inc + self.trace(new, depth - 1) * self.albedo(ray.mat)
        new = ORay(mathx.offset_ray(ray.point(), ray.normal, np), self._perturbed_reflect(ray))
        return self.trace(new, depth - 1)

    def _glass_march(self, ray: ORay, vox_index: int, smoke: bool):
        """Transform to object space and march to the material/smoke exit
        (renderer.cpp:1160-1179, 1265-1280).  Mutates ray.{t, normal, mat};
        returns in_volume flag."""
        o, d, rd, ds = self._to_object(vox_index, ray)
        if smoke:
            return self._vol_exit(vox_index, o, d, rd, ds, ray, smoke=True)
        return self._vol_exit(vox_index, o, d, rd, ds, ray, mat=GLASS)

    def _trace_glass(self, ray: ORay, depth, vox_index):
        color = np.ones(3, F)
        in_glass = ray.in_glass
        ior_mat = self.ior(ray.mat)
        ratio = ior_mat if in_glass else F(1.0) / ior_mat
        in_volume = True
        if in_glass:
            color = self.albedo(ray.mat)
            if vox_index >= 0:
                in_volume = self._glass_march(ray, vox_index, smoke=False)
        if not in_volume:
            ray.O = ray.O + ray.D * ray.t
            ray.t = F(0.0)
        cos_t = F(min(float(-ray.D @ ray.normal), 1.0))
        sin_t = F(np.sqrt(max(0.0, 1.0 - cos_t * cos_t)))
        cannot_refract = ratio * sin_t > 1.0
        if self.cfg.mode == "whitted" and not self.cfg.whitted_glass_split:
            return np.zeros(3, F)
        if self.cfg.mode == "whitted":
            # deterministic Fresnel split
            refl_d = mathx.reflect(ray.D, ray.normal)
            refl = ORay(mathx.offset_ray(ray.point(), ray.normal, np), refl_d)
            refl.in_glass = in_glass
            if cannot_refract:
                return self.trace(refl, depth - 1) * color
            r = mathx.schlick(cos_t, ratio, np)
            refr_d = mathx.refract(ray.D, ray.normal, ratio, np)
            refr = ORay(mathx.offset_ray(ray.point(), -ray.normal, np), refr_d)
            refr.in_glass = not in_glass
            return (self.trace(refl, depth - 1) * r + self.trace(refr, depth - 1) * (1 - r)) * color
        if cannot_refract or mathx.schlick(cos_t, ratio, np) > self._u():
            out_d = mathx.reflect(ray.D, ray.normal)
            out_n = ray.normal
        else:
            out_d = mathx.refract(ray.D, ray.normal, ratio, np)
            in_glass = not in_glass
            out_n = -ray.normal
        new = ORay(mathx.offset_ray(ray.point(), out_n, np), out_d)
        new.in_glass = in_glass
        return self.trace(new, depth - 1) * color

    def _trace_smoke(self, ray: ORay, depth, vox_index):
        if self.cfg.mode == "whitted" and not self.cfg.whitted_glass_split:
            return np.zeros(3, F)
        color = np.ones(3, F)
        in_glass = ray.in_glass
        intensity = F(0.0)
        dist = F(0.0)
        in_volume = True
        if in_glass:
            intensity = self.emis(ray.mat)
            color = self.albedo(ray.mat)
            if vox_index >= 0:
                in_volume = self._glass_march(ray, vox_index, smoke=True)
            dist = F(ray.t)
        if self.cfg.mode != "whitted":
            # stochastic in-scatter (renderer.cpp:1282-1289)
            threshold = self._u() * F(100.0) - intensity
            if self._u() * dist > threshold:
                lo = ray.t * F(0.45)
                ray.O = ray.O + ray.D * (lo + self._u() * (ray.t - lo))
                ray.D = positive_octant_dir(self.rng.standard_normal(3).astype(F), np)
                ray._derive()
                ray.t = F(0.0)
        color = mathx.absorption(color, intensity, dist, np)
        if not in_volume:
            ray.O = ray.O + ray.D * ray.t
            ray.t = F(0.0)
        out_d = mathx.refract(ray.D, ray.normal, F(1.0), np)
        new = ORay(mathx.offset_ray(ray.point(), -ray.normal, np), out_d)
        new.in_glass = not in_glass
        return self.trace(new, depth - 1) * color

    def _trace_model_default(self, ray: ORay, depth):
        inc = self.illumination(ray)
        if self.cfg.mode == "whitted":
            return inc  # NEE only
        rand_dir = uniform_hemisphere_dir(ray.normal, self.rng.standard_normal(3).astype(F), np)
        new = ORay(mathx.offset_ray(ray.point(), ray.normal, np), rand_dir)
        return (self.trace(new, depth - 1) + inc) * self.albedo(ray.mat)

    # ---------- frame (renderer.cpp:1646-1891) ----------
    def render(self, spp: int | None = None) -> np.ndarray:
        cfg = self.cfg
        spp = spp or cfg.spp
        img = np.zeros((cfg.height, cfg.width, 3), F)
        cam = self.s.camera
        deterministic = cfg.mode in ("primary", "whitted")
        for y in range(cfg.height):
            for x in range(cfg.width):
                acc = np.zeros(3, F)
                for _ in range(spp):
                    if deterministic:
                        px, py = F(x), F(y)
                        lens = None
                    else:
                        px = F(x) + self._u() * F(cfg.aa_strength)
                        py = F(y) + self._u() * F(cfg.aa_strength)
                        lens = np.array([self._u(), self._u()], F) if cfg.use_dof else None
                    o, d = self._primary(cam, px, py, lens)
                    ray = ORay(o, d)
                    depth = 1 if cfg.mode == "primary" else cfg.max_bounces
                    acc += self.trace(ray, depth)
                img[y, x] = acc / F(spp)
        return img

    def _primary(self, cam, px, py, lens):
        u = px / F(self.cfg.width)
        v = py / F(self.cfg.height)
        p = cam.top_left + u * (cam.top_right - cam.top_left) + v * (cam.bottom_left - cam.top_left)
        if lens is None:
            return _f3(cam.pos), (p - cam.pos).astype(F)
        jitter = point_in_circle(lens, np) * F(cam.defocus_jitter) / F(self.cfg.width)
        focal = cam.pos + F(cam.focal_distance) * normalize((p - cam.pos).astype(F))
        origin = cam.pos + jitter[0] * cam.right + jitter[1] * cam.up
        return origin.astype(F), (focal - origin).astype(F)

    # ---------- reprojection pass 1 (renderer.cpp:1330-1585) ----------
    # TraceReproject returns the DECOMPOSED {albedo, illumination} pair with
    # GetColor() = albedo * illumination (renderer.h:10-18).  By design it
    # deviates from Trace(): non-metals always take the diffuse branch (no
    # Schlick split, TraceNonMetal renderer.cpp:1342-1357) and Illumination's
    # value — which already includes albedo — lands in the illumination
    # bucket, so the resolved pixel carries albedo^2 on the NEE term exactly
    # as the reference does.

    def trace_reproject(self, ray: ORay, depth: int):
        """-> (albedo[3], illumination[3]); pixel = albedo * illumination."""
        zero = np.zeros(3, F)
        if depth < 0:
            return zero, zero
        vox_index = self.find_nearest(ray)
        if ray.mat == MAT_NONE:
            return self.sample_sky(ray.D), np.ones(3, F)
        m = ray.mat
        if METAL_HIGH <= m <= METAL_LOW:
            new = ORay(mathx.offset_ray(ray.point(), ray.normal, np),
                       self._perturbed_reflect(ray))
            a, i = self.trace_reproject(new, depth - 1)
            return self.albedo(m), a * i
        if m < METAL_HIGH or m > EMISSIVE:  # nonmetal / model palette
            if m < METAL_HIGH:
                u = np.array([self._u(), self._u(), self._u()], F)
                rand_dir = lambertian_dir(ray.normal, u, np)
            else:
                rand_dir = uniform_hemisphere_dir(
                    ray.normal, self.rng.standard_normal(3).astype(F), np)
            inc = self.illumination(ray)
            new = ORay(mathx.offset_ray(ray.point(), ray.normal, np), rand_dir)
            a, i = self.trace_reproject(new, depth - 1)
            return self.albedo(m), inc + a * i
        if m == GLASS:
            return self._trace_glass_reproject(ray, depth, vox_index)
        if SMOKE_LOW_DENSITY <= m <= SMOKE_PLAYER:
            return self._trace_smoke_reproject(ray, depth, vox_index)
        # EMISSIVE (renderer.cpp:1505-1508)
        return self.albedo(m) * self.emis(m), np.ones(3, F)

    def _trace_glass_reproject(self, ray: ORay, depth, vox_index):
        """TraceDialectric (renderer.cpp:1359-1423): stochastic Schlick
        reflect/refract, decomposed return {beer-color, sub GetColor}."""
        color = np.ones(3, F)
        in_glass = ray.in_glass
        ratio = self.ior(ray.mat) if in_glass else F(1.0) / self.ior(ray.mat)
        in_volume = True
        if in_glass:
            color = self.albedo(ray.mat)
            if vox_index >= 0:
                in_volume = self._glass_march(ray, vox_index, smoke=False)
        if not in_volume:
            ray.O = ray.O + ray.D * ray.t
            ray.t = F(0.0)
        cos_t = F(min(float(-ray.D @ ray.normal), 1.0))
        sin_t = F(np.sqrt(max(0.0, 1.0 - cos_t * cos_t)))
        if ratio * sin_t > 1.0 or mathx.schlick(cos_t, ratio, np) > self._u():
            out_d = mathx.reflect(ray.D, ray.normal)
            out_n = ray.normal
        else:
            out_d = mathx.refract(ray.D, ray.normal, ratio, np)
            in_glass = not in_glass
            out_n = -ray.normal
        new = ORay(mathx.offset_ray(ray.point(), out_n, np), out_d)
        new.in_glass = in_glass
        a, i = self.trace_reproject(new, depth - 1)
        return color, a * i

    def _trace_smoke_reproject(self, ray: ORay, depth, vox_index):
        """TraceSmoke reproject variant (renderer.cpp:1425-1503)."""
        color = np.ones(3, F)
        in_glass = ray.in_glass
        intensity = F(0.0)
        dist = F(0.0)
        in_volume = True
        if in_glass:
            intensity = self.emis(ray.mat)
            color = self.albedo(ray.mat)
            if vox_index >= 0:
                in_volume = self._glass_march(ray, vox_index, smoke=True)
            dist = F(ray.t)
        threshold = self._u() * F(100.0) - intensity
        if self._u() * dist > threshold:
            lo = ray.t * F(0.45)
            ray.O = ray.O + ray.D * (lo + self._u() * (ray.t - lo))
            ray.D = positive_octant_dir(self.rng.standard_normal(3).astype(F), np)
            ray._derive()
            ray.t = F(0.0)
        color = mathx.absorption(color, intensity, dist, np)
        if not in_volume:
            ray.O = ray.O + ray.D * ray.t
            ray.t = F(0.0)
        out_d = mathx.refract(ray.D, ray.normal, F(1.0), np)
        new = ORay(mathx.offset_ray(ray.point(), -ray.normal, np), out_d)
        new.in_glass = not in_glass
        a, i = self.trace_reproject(new, depth - 1)
        return color, a * i

    def render_reproject(self, spp: int | None = None):
        """Pass-1 frame (renderer.cpp:1997-2020): deterministic center
        primaries (GetPrimaryRayNoDOF), returns (albedo, illum, p0, m0)
        images averaged over spp (G-buffer from the last sample — it is
        deterministic for fixed primaries)."""
        cfg = self.cfg
        spp = spp or cfg.spp
        alb_img = np.zeros((cfg.height, cfg.width, 3), F)
        ill_img = np.zeros((cfg.height, cfg.width, 3), F)
        p0_img = np.zeros((cfg.height, cfg.width, 3), F)
        m0_img = np.full((cfg.height, cfg.width), MAT_NONE, np.int32)
        cam = self.s.camera
        for y in range(cfg.height):
            for x in range(cfg.width):
                acc_a = np.zeros(3, F)
                acc_i = np.zeros(3, F)
                for _ in range(spp):
                    o, d = self._primary(cam, F(x), F(y), None)
                    ray = ORay(o, d)
                    a, i = self.trace_reproject(ray, cfg.max_bounces)
                    acc_a += a
                    acc_i += i
                    p0_img[y, x] = ray.point()
                    m0_img[y, x] = ray.mat
                alb_img[y, x] = acc_a / F(spp)
                ill_img[y, x] = acc_i / F(spp)
        return alb_img, ill_img, p0_img, m0_img

    # ---------- reprojection pass 2 (renderer.cpp:1997-2101, scalar) ----------
    def resolve_reproject(self, prev_camera, albedo, illum, p0, m0, history):
        """Scalar resolve: PointToUV (camera.h:34-49), prev-frame occlusion
        validation (renderer.cpp:767-774), validity-weighted bilinear history
        (renderer.cpp:777-830), YCoCg 3x3 mean±0.75σ clamp
        (renderer.cpp:856-910), per-material blend (renderer.cpp:2050-2084).
        Returns (tonemapped image, new illumination history)."""
        cfg = self.cfg
        h, w = cfg.height, cfg.width
        aspect = F(w / h)
        cam = prev_camera
        ahead = np.asarray(cam.ahead, F)
        right = np.asarray(cam.right, F)
        up = np.asarray(cam.up, F)
        pos = np.asarray(cam.pos, F)
        left_n = np.cross(up, F(2.0) * ahead - aspect * right).astype(F)
        right_n = np.cross(F(2.0) * ahead + aspect * right, up).astype(F)
        top_n = np.cross(right, F(2.0) * ahead + up).astype(F)
        bot_n = np.cross(F(2.0) * ahead - up, right).astype(F)

        ycc_new = np.stack([mathx.rgb_to_ycocg(illum[y, x], np)
                            for y in range(h) for x in range(w)]).reshape(h, w, 3)
        final = illum.copy()
        for y in range(h):
            for x in range(w):
                if m0[y, x] == MAT_NONE:
                    continue
                delta = p0[y, x] - pos
                ld, rd_ = F(delta @ left_n), F(delta @ right_n)
                td, bd = F(delta @ top_n), F(delta @ bot_n)
                u = ld / (ld + rd_) + F(0.5) / F(w)
                v = td / (td + bd) + F(0.5) / F(h)
                if not (0 <= u < 1 and 0 <= v < 1):
                    continue
                # IsOccludedPrevFrame
                to_p = p0[y, x] - pos
                dist = F(np.sqrt(float(to_p @ to_p)))
                dirn = to_p / dist
                back = mathx.offset_ray(p0[y, x], -dirn, np)
                t_occ = F(np.sqrt(float((back - pos) @ (back - pos))))
                sr = ORay(pos, dirn)
                sr.t = t_occ
                if self.is_occluded(sr):
                    continue
                # bilinear validity-weighted history sample
                px = (u - F(0.5) / F(w)) * F(w)
                py = (v - F(0.5) / F(h)) * F(h)
                x0, y0 = int(px), int(py)
                fx, fy = F(px - x0), F(py - y0)
                acc = np.zeros(3, F)
                wacc = F(0.0)
                for (xi, yi, wgt) in ((x0, y0, (1 - fx) * (1 - fy)),
                                      (x0 + 1, y0, fx * (1 - fy)),
                                      (x0, y0 + 1, (1 - fx) * fy),
                                      (x0 + 1, y0 + 1, fx * fy)):
                    if 0 <= xi < w and 0 <= yi < h:
                        acc += history[yi, xi] * F(wgt)
                        wacc += F(wgt)
                hist = acc / max(wacc, F(1e-8))
                # YCoCg 3x3 mean±0.75σ clamp against the NEW illumination
                s1 = np.zeros(3, F)
                s2 = np.zeros(3, F)
                cnt = 0
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        yy, xx = y + dy, x + dx
                        if 0 <= yy < h and 0 <= xx < w:
                            c = ycc_new[yy, xx]
                            s1 += c
                            s2 += c * c
                            cnt += 1
                mean = s1 / F(cnt)
                var = np.maximum(s2 / F(cnt) - mean * mean, 0.0)
                sig = np.sqrt(var).astype(F)
                ycc_h = mathx.rgb_to_ycocg(hist, np)
                clamped = np.clip(ycc_h, mean - F(0.75) * sig,
                                  mean + F(0.75) * sig)
                hist_c = np.maximum(mathx.ycocg_to_rgb(clamped, np), 0.0)
                m = int(m0[y, x])
                if m == EMISSIVE:
                    wgt_m = F(0.0)
                elif METAL_HIGH <= m <= GLASS:
                    wgt_m = F(0.5)
                elif m < METAL_HIGH:
                    wgt_m = F(0.8)
                else:
                    wgt_m = F(0.9)
                final[y, x] = illum[y, x] * (1 - wgt_m) + hist_c * wgt_m
        color = np.zeros((h, w, 3), F)
        for y in range(h):
            for x in range(w):
                color[y, x] = mathx.reinhard_jodie(albedo[y, x] * final[y, x], np)
        return color, final
