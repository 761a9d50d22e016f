"""Differentiable (relaxed) voxel rendering — the adjoint-capable twin of the
hard DDA renderer.

The hard forward (kernels/dda.py) is piecewise-constant in voxel occupancy:
first-hit geometry has zero/undefined gradients (SURVEY.md §7 "adjoint of a
discrete traversal").  This module renders the SAME voxel worlds through an
exp-transmittance ray march:

    T_k = exp(-sum_{j<k} sigma_j dt),  C = sum_k T_k (1-exp(-sigma_k dt)) c_k
          + T_final * background

with sigma = softplus(density_logits) * scale.  As scale -> inf and logits
saturate, C converges to the hard primary-hit image — golden tests check
that consistency.  Gradients flow to per-voxel density logits AND the
256-entry material albedo table (the differentiable parameter set of
BASELINE.json).

The bounce/shading path of the hard renderer is separately differentiable
w.r.t. material parameters (traversal outputs are stop_gradient'ed there);
this module supplies the geometry gradients the reference never had.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from voxtracer.core import pytree
from voxtracer.core.types import MAT_NONE, SceneData
from voxtracer.render.sky import sample_sky

F32 = jnp.float32
BIG = 1e34

# rematerialize the march in backward: less device memory for one extra
# forward of compute — including a SECOND per-sample cell-row gather.
# Applies to the DENSE scan path only (span_steps == 0); the step-batched
# span march bounds its activations by chunking over step sub-segments
# (_SEG_CHUNK) instead.  At band sizes whose stored activations fit, the
# default (OFF) skips that re-gather; flip on via VOXTRACER_DIFF_REMAT=1
# when optimizing at full-frame band sizes.
import os as _os

_REMAT = _os.environ.get("VOXTRACER_DIFF_REMAT", "0") == "1"


@pytree.dataclass
class DiffParams:
    """The trainable leaves."""

    density_logits: jnp.ndarray  # [V, G, G, G] f32
    albedo_table: jnp.ndarray  # [256, 3] f32


def params_from_scene(scene: SceneData, occupied_logit=6.0, empty_logit=-6.0) -> DiffParams:
    occ = scene.volumes.grids != MAT_NONE
    logits = jnp.where(occ, occupied_logit, empty_logit).astype(F32)
    return DiffParams(density_logits=logits,
                      albedo_table=jnp.asarray(scene.materials.albedo, F32))


@jax.custom_vjp
def _rows(table, idx):
    """Row gather whose table-cotangent is a one-hot matrix product
    instead of a scatter.

    The natural adjoint of take(axis=0) into a tiny [256, 3] table is a
    scatter-add with nearly every index colliding; the one-hot product
    accumulates the same sums with no atomics.  Forward is XLA's take,
    which fuses into its consumer."""
    return jnp.take(table, idx, axis=0, mode="clip")


def _rows_fwd(table, idx):
    return _rows(table, idx), (idx, table.shape[0])


def _rows_bwd(res, ct):
    idx, t = res
    # bf16 one-hot + cotangent with f32 accumulation: the one-hot is exact
    # in bf16 (0/1) and the [rows, 256] materialization moves half the
    # bytes; ct rounds to 2^-8 relative — table-gradient noise well under
    # the FD test tolerances (tests/test_rows_grad.py)
    oh = (idx[:, None] == jnp.arange(t, dtype=idx.dtype)[None, :]).astype(
        jnp.bfloat16)
    return jnp.dot(oh.T, ct.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32).astype(ct.dtype), None


_rows.defvjp(_rows_fwd, _rows_bwd)


@jax.custom_vjp
def _bsig_rows(bsig, idx):
    """Per-brick mean-sigma gather [V*M^3] -> [N]: XLA take forward,
    one-hot product backward in place of the duplicate-heavy scatter
    (see _rows)."""
    return jnp.take(bsig, idx, mode="clip")


def _bsig_rows_fwd(bsig, idx):
    return _bsig_rows(bsig, idx), (idx, bsig.shape[0])


def _bsig_rows_bwd(res, ct):
    idx, t = res
    # bf16 one-hot, f32 accumulate (see _rows_bwd)
    oh = (idx[:, None] == jnp.arange(t, dtype=idx.dtype)[None, :]).astype(
        jnp.bfloat16)
    return jnp.dot(oh.T, ct[:, None].astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)[:, 0].astype(
        ct.dtype), None


_bsig_rows.defvjp(_bsig_rows_fwd, _bsig_rows_bwd)


@jax.custom_vjp
def _perm_rows(x, idx, inv_idx):
    """Row gather by a PERMUTATION (the active-ray un-compaction).

    XLA cannot see that idx is bijective, so the autodiff adjoint of
    take(x, idx) is a [N,3] row scatter-add.  The adjoint of a bijective
    gather is just the gather by the inverse permutation:
    y_i = x[idx_i]  =>  dx = ct[inv_idx]."""
    return jnp.take(x, idx, axis=0)


def _perm_rows_fwd(x, idx, inv_idx):
    return jnp.take(x, idx, axis=0), (inv_idx,)


def _perm_rows_bwd(res, ct):
    (inv_idx,) = res
    return jnp.take(ct, inv_idx, axis=0), None, None


_perm_rows.defvjp(_perm_rows_fwd, _perm_rows_bwd)


@jax.custom_vjp
def _cell_fetch(dens_flat, cell_tab, idx):
    """[T,2] row gather (density, material) whose density-adjoint is a 1-D
    scalar scatter instead of a [N,2]-row scatter-add; the material column
    never needs a gradient."""
    return jnp.take(cell_tab, idx, axis=0, mode="clip")


def _cell_fetch_fwd(dens_flat, cell_tab, idx):
    return _cell_fetch(dens_flat, cell_tab, idx), (idx, dens_flat.shape[0])


def _cell_fetch_bwd(res, ct):
    idx, t = res
    ci = jnp.clip(idx, 0, t - 1)
    d_dens = jnp.zeros((t,), ct.dtype).at[ci].add(ct[:, 0])
    return d_dens, None, None


_cell_fetch.defvjp(_cell_fetch_fwd, _cell_fetch_bwd)


def _ray_aabb(cube_min, o, d):
    """Entry/exit of the object-space unit cube; (t0, t1) with t0<t1 if hit."""
    rd = 1.0 / d
    a = (cube_min - o) * rd
    b = (cube_min + 1.0 - o) * rd
    tmin = jnp.minimum(a, b).max(axis=-1)
    tmax = jnp.maximum(a, b).min(axis=-1)
    t0 = jnp.maximum(tmin, 0.0)
    return t0, tmax, tmax > t0


def _occupied_spans(scene: SceneData, vox, voy, voz, vdx, vdy, vdz):
    """Per-pair [V, N] (s0, s1): the t-range of OCCUPIED-brick crossings
    along each object-space ray, via slab tests against MACRO GROUPS of
    bricks (2x2x2 bricks per group -> 64 tight AABBs per 8^3 brick grid
    instead of 512 per-brick tests: the [N, chunk] slab rows are this
    pass's memory traffic, and grouping cuts them 8x).  Each group's AABB
    is tight around its OCCUPIED bricks (per-axis min/max), so spans only widen by intra-group gaps (<=1
    brick) vs the exact per-brick test; wider spans stay CORRECT — the
    core march just covers a few more statically-empty cells — and the
    transmittance clamp bounds the tail regardless.

    This is the NeRF-style occupancy-grid acceleration for the relaxed
    march: outside [s0, s1] every cell is (statically) empty, so those
    segments integrate against the per-BRICK mean sigma in closed
    quadrature with a DENSE adjoint — no per-cell gather/scatter rows.
    Spans derive from the INITIAL grids; callers optimizing density far
    from the original surfaces should refresh scene.volumes.occ
    periodically (standard occupancy-grid practice)."""
    vols = scene.volumes
    v = vols.n
    n = vox.shape[1]
    m3 = vols.occ.shape[2]
    mside = round(m3 ** (1.0 / 3.0))
    occ_any = jnp.any(vols.occ[0] != 0, axis=-1)  # [V, M3]
    gs_f = vols.gridsize.astype(F32)  # [V]
    cb = vols.cube_min  # [V, 3]

    gf = 2 if mside % 2 == 0 else 1  # bricks per group edge
    gsd = mside // gf
    g3 = gsd ** 3
    occ7 = occ_any.reshape(v, gsd, gf, gsd, gf, gsd, gf)
    bxc = jnp.arange(mside, dtype=F32).reshape(1, gsd, gf, 1, 1, 1, 1)
    byc = jnp.arange(mside, dtype=F32).reshape(1, 1, 1, gsd, gf, 1, 1)
    bzc = jnp.arange(mside, dtype=F32).reshape(1, 1, 1, 1, 1, gsd, gf)
    inf = jnp.float32(1e9)
    off = (2, 4, 6)

    def mn(c):
        return jnp.min(jnp.where(occ7, c, inf), axis=off).reshape(v, g3)

    def mx(c):
        return jnp.max(jnp.where(occ7, c + 1.0, -inf),
                       axis=off).reshape(v, g3)

    lo_b = (mn(bxc), mn(byc), mn(bzc))  # group AABB in brick units
    hi_b = (mx(bxc), mx(byc), mx(bzc))
    occ_g = jnp.any(occ7, axis=off).reshape(v, g3)

    s0 = jnp.full((v, n), BIG, F32)
    s1 = jnp.full((v, n), -BIG, F32)
    big = jnp.float32(BIG)
    for vi in range(v):
        bs = 8.0 / gs_f[vi]  # brick extent in object units
        rd3 = (1.0 / vdx[vi], 1.0 / vdy[vi], 1.0 / vdz[vi])
        o3 = (vox[vi], voy[vi], voz[vi])
        tmin = jnp.full((n, 1), -BIG, F32)
        tmax = jnp.full((n, 1), BIG, F32)
        for ax in range(3):
            lo = (cb[vi, ax] + lo_b[ax][vi] * bs)[None, :]  # [1, G3]
            hi = (cb[vi, ax] + hi_b[ax][vi] * bs)[None, :]
            a = (lo - o3[ax][:, None]) * rd3[ax][:, None]
            b = (hi - o3[ax][:, None]) * rd3[ax][:, None]
            ta = jnp.minimum(a, b)
            tb = jnp.maximum(a, b)
            ta = jnp.where(jnp.isnan(ta), -big, ta)
            tb = jnp.where(jnp.isnan(tb), big, tb)
            tmin = jnp.maximum(tmin, ta)
            tmax = jnp.minimum(tmax, tb)
        tmin = jnp.maximum(tmin, 0.0)
        hitb = (tmax >= tmin) & occ_g[vi][None, :]
        s0 = s0.at[vi].set(jnp.min(jnp.where(hitb, tmin, big), axis=1))
        s1 = s1.at[vi].set(jnp.max(jnp.where(hitb, tmax, -big), axis=1))
    return jax.lax.stop_gradient(s0), jax.lax.stop_gradient(s1)


def _brick_mean_sigma(params: DiffParams, scene: SceneData,
                      density_scale: float):
    """[V * M^3] per-brick mean sigma — a dense reshape-reduce whose
    adjoint is a broadcast (NO scatter).  Edge bricks of non-multiple-of-8
    grids average a few padding cells; the bench grids are 64^3 (exact)."""
    vols = scene.volumes
    v = vols.n
    g = vols.pad_size
    mside = round(vols.occ.shape[2] ** (1.0 / 3.0))
    g8 = mside * 8
    sig = jax.nn.softplus(params.density_logits) * density_scale
    if g8 != g:
        sig = jnp.pad(sig, ((0, 0), (0, g8 - g), (0, g8 - g), (0, g8 - g)))
    b = sig.reshape(v, mside, 8, mside, 8, mside, 8)
    return b.mean(axis=(2, 4, 6)).reshape(-1)  # [V * M^3]


def active_ray_permutation(scene: SceneData, cfg, row0: int = 0,
                           rows: int = 0):
    """HOST-side: stable permutation putting rays that cross ANY instance
    AABB first.  Rays outside every AABB render exactly the background, so
    the march (cell gathers, scatters, lead/tail brick scans, clamp pass —
    ALL of which cost per-row) runs only on the active prefix: the diff
    march's cost is per sampled row, so rows are the lever, and on monu
    the sky rays drop out.  Derived from camera +
    instance transforms only — loop-invariant across optimizer steps
    (like the occupancy spans); recompute when the camera moves.

    Returns (perm int32 [N], inv_perm int32 [N], n_active int)."""
    import numpy as np

    from voxtracer.render.camera import primary_rays

    h = rows or cfg.height
    x = np.arange(cfg.width, dtype=np.float32)
    y = np.arange(h, dtype=np.float32) + row0
    px, py = np.meshgrid(x, y)
    cam = jax.tree.map(np.asarray, scene.camera)
    o, d = primary_rays(cam, cfg.width, cfg.height, px.reshape(-1),
                        py.reshape(-1), None, np)
    inv = np.asarray(scene.volumes.inv)
    cb = np.asarray(scene.volumes.cube_min)
    valid = np.zeros(o.shape[0], bool)
    for i in range(inv.shape[0]):
        oo = o @ inv[i, :3, :3].T + inv[i, :3, 3]
        dd = d @ inv[i, :3, :3].T
        with np.errstate(divide="ignore", invalid="ignore"):
            rd = 1.0 / dd
            a = (cb[i] - oo) * rd
            b = (cb[i] + 1.0 - oo) * rd
        t0 = np.maximum(np.nanmax(np.minimum(a, b), axis=1), 0.0)
        t1 = np.nanmin(np.maximum(a, b), axis=1)
        valid |= t1 > t0
    # secondary key: 8x128-pixel tile id, so the active prefix lands in
    # spatially-compact traversal blocks for the in-march transmittance-clamp
    # nearest pass (same lockstep-tail cut as cfg.ray_order="tile")
    if cfg.width % 128 == 0:
        yi, xi = py.reshape(-1).astype(np.int64), px.reshape(-1).astype(np.int64)
        tile_key = (((yi // 8) * (cfg.width // 128) + xi // 128) * 1024
                    + (yi % 8) * 128 + xi % 128)
        perm = np.lexsort((tile_key, ~valid)).astype(np.int32)
    else:
        perm = np.argsort(~valid, kind="stable").astype(np.int32)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return perm, inv_perm, int(valid.sum())


def span_cells_bins(scene: SceneData, cfg, row0: int = 0, rows: int = 0,
                    edges=(4.0, 32.0)):
    """HOST-side: split the ACTIVE rays of a band into span-length bins.

    The clamped core span is strongly bimodal at bench settings (floor
    hits under a cell vs rays grazing whole model boxes), so a fixed
    n_steps oversamples half the rays and pays their gather/scatter rows
    for nothing: rows = n_steps x active rays is the backward's dominant
    cost.  Binning by a
    cheap span ESTIMATE (sum over volumes of the occupied-AABB crossing
    length in cells — NumPy slab tests, camera-derived, loop-invariant)
    lets each bin march with a step count proportional to its spans.

    Returns a list of (bin_index, perm, inv_perm, n_active) tuples — one
    per NON-EMPTY bin, shortest spans first; each perm puts that bin's
    rays in the prefix (in 8x128-tile order, see active_ray_permutation)
    so the existing compaction path applies unchanged.  Callers MUST key
    step counts / clamp off bin_index, not list position: empty bins are
    skipped, so position alone would mis-assign settings.
    Gradients of the per-bin renders SUM to the full-band gradient:
    excluded-active rays render as background in the other bins' calls
    and contribute zero parameter gradient there."""
    import numpy as np

    from voxtracer.render.camera import primary_rays

    h = rows or cfg.height
    x = np.arange(cfg.width, dtype=np.float32)
    y = np.arange(h, dtype=np.float32) + row0
    px, py = np.meshgrid(x, y)
    cam = jax.tree.map(np.asarray, scene.camera)
    o, d = primary_rays(cam, cfg.width, cfg.height, px.reshape(-1),
                        py.reshape(-1), None, np)
    vols = scene.volumes
    inv = np.asarray(vols.inv)
    cb = np.asarray(vols.cube_min)
    gs = np.asarray(vols.gridsize).astype(np.float32)
    occ_any = np.asarray(jnp.any(vols.occ[0] != 0, axis=-1))  # [V, M3]
    m3 = occ_any.shape[1]
    mside = round(m3 ** (1.0 / 3.0))
    n = o.shape[0]
    span_cells = np.zeros(n, np.float32)
    valid = np.zeros(n, bool)
    for i in range(inv.shape[0]):
        # tight AABB of this volume's occupied bricks, in object units
        occ3 = occ_any[i].reshape(mside, mside, mside)
        if not occ3.any():
            continue
        bs = 8.0 / gs[i]
        idx = np.nonzero(occ3)
        lo = cb[i] + np.array([a.min() for a in idx], np.float32) * bs
        hi = cb[i] + np.array([a.max() + 1 for a in idx], np.float32) * bs
        oo = o @ inv[i, :3, :3].T + inv[i, :3, 3]
        dd = d @ inv[i, :3, :3].T
        with np.errstate(divide="ignore", invalid="ignore"):
            rd = 1.0 / dd
            a = (lo - oo) * rd
            b = (hi - oo) * rd
        t0 = np.maximum(np.nanmax(np.minimum(a, b), axis=1), 0.0)
        t1 = np.nanmin(np.maximum(a, b), axis=1)
        cross = np.maximum(t1 - t0, 0.0)
        span_cells += cross * gs[i]
        # keep active = crosses-any-instance-AABB (the march's own
        # validity test), not just occupied boxes
        ao = (cb[i] - oo) * rd
        bo = (cb[i] + 1.0 - oo) * rd
        at0 = np.maximum(np.nanmax(np.minimum(ao, bo), axis=1), 0.0)
        at1 = np.nanmin(np.maximum(ao, bo), axis=1)
        valid |= at1 > at0
    # bin id: 0..len(edges) by span estimate, actives only
    bin_id = np.searchsorted(np.asarray(edges, np.float32), span_cells)
    if cfg.width % 128 == 0:
        yi = py.reshape(-1).astype(np.int64)
        xi = px.reshape(-1).astype(np.int64)
        tile_key = (((yi // 8) * (cfg.width // 128) + xi // 128) * 1024
                    + (yi % 8) * 128 + xi % 128)
    else:
        tile_key = np.arange(n, dtype=np.int64)
    out = []
    for b in range(len(edges) + 1):
        sel = valid & (bin_id == b)
        cnt = int(sel.sum())
        if cnt == 0:
            continue
        perm = np.lexsort((tile_key, ~sel)).astype(np.int32)
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(n, dtype=np.int32)
        out.append((b, perm, inv_perm, cnt))
    return out


@partial(jax.jit, static_argnames=("n_steps", "cfg", "rows", "k",
                                   "span_steps", "n_active", "clamp",
                                   "importance"))
def render_diff(params: DiffParams, scene: SceneData, cfg, key, n_steps: int = 192,
                density_scale: float = 512.0, row0=None, rows: int = 0,
                k: int = 0, span_steps: int = 0, perm=None, inv_perm=None,
                n_active: int = 0, clamp: bool = True, importance: int = 0):
    """Primary-visibility differentiable render -> [H, W, 3] (or
    [rows, W, 3] when a row band is given — used to bound memory at 1080p).

    Each ray x volume pair marches its own AABB interval with n_steps
    samples; segments composite front-to-back by entry t (exact for
    instance AABBs disjoint along the ray, entry-ordered approximation
    for overlaps).

    k > 0 compacts pairs to the k earliest-entry volumes per ray (march
    cost — gathers AND gradient scatters — scales with pairs).  EXACT only
    when no ray crosses more than k instance AABBs; callers verify that on
    the host (cheap slab tests) and fall back to k=0 (dense).

    span_steps > 0 enables occupancy-span tightening: the cell-level
    n_steps march covers only the ray's occupied-brick span [s0, s1]
    (_occupied_spans); the leading/trailing statically-empty segments
    march span_steps samples each at BRICK granularity against the
    per-brick mean sigma (_brick_mean_sigma, dense adjoint).  The sampled
    rows — the gather/scatter traffic that dominates fwd+bwd — drop by the
    span
    ratio at equal effective sampling density."""
    from voxtracer.render.camera import primary_rays
    from voxtracer.render.integrator import _pixel_grid

    if rows:
        x = jnp.arange(cfg.width, dtype=F32)
        y = jnp.arange(rows, dtype=F32) + row0
        px, py = jnp.meshgrid(x, y)
        px, py = px.reshape(-1), py.reshape(-1)
    else:
        px, py = _pixel_grid(cfg)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py, None, jnp)
    n_full = o.shape[0]
    compact = perm is not None and 0 < n_active < n_full
    if compact:
        # active-prefix compaction (active_ray_permutation): march only the
        # rays that cross an instance AABB; the inactive tail renders the
        # background exactly.  The pad rays past n_active are real inactive
        # rays whose in-march valid=False already yields bg — no masking.
        na = min(-(-n_active // 1024) * 1024, n_full)
        d_full = d
        o = jnp.take(o, perm[:na], axis=0)
        d = jnp.take(d, perm[:na], axis=0)
    color, t_total, valid = _march_color(params, scene, cfg, o, d, n_steps,
                                         density_scale, k, span_steps, clamp,
                                         importance=importance)
    bg = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
    img = color + t_total[:, None] * bg
    img = jnp.where(valid[:, None], img, bg)
    if compact:
        tail = sample_sky(scene.sky, jnp.take(d_full, perm[na:], axis=0),
                          cfg.activate_sky, cfg.sky_fallback)
        img = _perm_rows(jnp.concatenate([img, tail], axis=0), inv_perm,
                         perm)
    return img.reshape(rows or cfg.height, cfg.width, 3)


@partial(jax.jit, static_argnames=("n_steps", "cfg", "k", "span_steps",
                                   "clamp", "importance"))
def render_diff_active(params: DiffParams, scene: SceneData, cfg, o, d, bg,
                       n_steps: int, density_scale: float = 512.0,
                       k: int = 0, span_steps: int = 0, clamp: bool = True,
                       spans=None, importance: int = 0):
    """Compacted-ray differentiable render -> radiance [N, 3].

    The training-loop form of render_diff: o/d are the PRE-compacted
    active rays of a bin (span_cells_bins) and bg their pre-sampled sky —
    all camera-derived, loop-invariant across optimizer steps.  Keeping
    them outside the grad step removes the per-step un-compaction
    gathers, sky texture takes, and ray-compaction takes (the
    un-compacted image is a DISPLAY product, not a gradient dependency:
    every excluded pixel contributes a parameter-free constant to the
    loss)."""
    color, t_total, valid = _march_color(params, scene, cfg, o, d, n_steps,
                                         density_scale, k, span_steps, clamp,
                                         spans=spans, importance=importance)
    img = color + t_total[:, None] * bg
    return jnp.where(valid[:, None], img, bg)


def _march_color(params: DiffParams, scene: SceneData, cfg, o, d,
                 n_steps: int, density_scale: float, k: int,
                 span_steps: int, clamp: bool, spans=None,
                 importance: int = 0):
    """The relaxed march over given rays -> (color [N,3], t_total [N],
    valid [N]).  See render_diff for the estimator documentation."""
    n = o.shape[0]
    v = scene.volumes.n
    g = scene.volumes.pad_size

    # SoA component layout throughout the march (no trailing dim of 3)
    # + fused per-step gather over all volumes.
    inv = scene.volumes.inv  # [V, 4, 4]

    def tr(row, px_, py_, pz_, point):
        c = row[:, None, :]
        out = c[..., 0] * px_ + c[..., 1] * py_ + c[..., 2] * pz_
        return out + c[..., 3] if point else out

    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    vox = tr(inv[:, 0], ox, oy, oz, True)   # [V, N]
    voy = tr(inv[:, 1], ox, oy, oz, True)
    voz = tr(inv[:, 2], ox, oy, oz, True)
    vdx = tr(inv[:, 0], dx, dy, dz, False)
    vdy = tr(inv[:, 1], dx, dy, dz, False)
    vdz = tr(inv[:, 2], dx, dy, dz, False)

    cb = scene.volumes.cube_min  # [V, 3]
    bx, by, bz = cb[:, 0][:, None], cb[:, 1][:, None], cb[:, 2][:, None]

    def slab(b0, oc, dc):
        rd = 1.0 / dc
        a = (b0 - oc) * rd
        b = (b0 + 1.0 - oc) * rd
        return jnp.minimum(a, b), jnp.maximum(a, b)

    t0x, t1x = slab(bx, vox, vdx)
    t0y, t1y = slab(by, voy, vdy)
    t0z, t1z = slab(bz, voz, vdz)
    t0 = jnp.maximum(jnp.maximum(t0x, t0y), jnp.maximum(t0z, 0.0))
    t1 = jnp.minimum(jnp.minimum(t1x, t1y), t1z)
    hit = t1 > t0

    if span_steps:
        if spans is not None:
            # PRECOMPUTED [V, N] occupied spans: they derive from the
            # static occupancy + the (loop-invariant) compacted rays, so
            # training steps hoist the slab pass out of the grad
            # (bench.py; same hoist replay_active does)
            s0_all, s1_all = spans
        else:
            s0_all, s1_all = _occupied_spans(scene, vox, voy, voz, vdx, vdy,
                                             vdz)

    # Each pair marches its OWN [t0, t1] interval (n_steps samples per
    # volume crossing, not per union span): much finer effective sampling
    # for the same gather/scatter traffic, and rays wasting steps in the
    # gaps between instance AABBs vanish.  Volumes composite front-to-back
    # by entry t after the march (exact for AABBs disjoint along the ray —
    # overlap interleaving is approximated by entry order).
    valid = jnp.any(hit, axis=0)  # [N]

    gs_f = scene.volumes.gridsize.astype(F32)[:, None]  # [V, 1]
    gs_i = scene.volumes.gridsize[:, None]

    if k and k < v:
        # pair compaction: keep the k earliest-entry volumes per ray
        key_t = jnp.where(hit & ~jnp.isnan(t0), t0, 1e30)
        ids = jnp.broadcast_to(jnp.arange(v, dtype=jnp.int32)[:, None], (v, n))
        if span_steps:
            key_s, t1_s, hit_s, s0_s, s1_s, vid = jax.lax.sort(
                (key_t, jnp.where(hit, t1, 0.0), hit, s0_all, s1_all, ids),
                dimension=0, num_keys=1)
            s0_all = s0_s[:k]
            s1_all = s1_s[:k]
        else:
            key_s, t1_s, hit_s, vid = jax.lax.sort(
                (key_t, jnp.where(hit, t1, 0.0), hit, ids), dimension=0,
                num_keys=1)
        t0 = key_s[:k]
        t1 = t1_s[:k]
        hit = hit_s[:k]
        vid = vid[:k]  # [k, N]
        # per-pair volume constants (one [V,16] row gather per pair)
        vtab = jnp.concatenate([
            inv[:, :3, :].reshape(v, 12), cb,
            scene.volumes.gridsize.astype(F32)[:, None]], axis=1)
        rows16 = jnp.take(vtab, vid.reshape(-1), axis=0,
                          mode="clip").reshape(k, n, 16)
        iv = [rows16[..., i] for i in range(12)]
        bx, by, bz = rows16[..., 12], rows16[..., 13], rows16[..., 14]
        gs_f = rows16[..., 15]
        gs_i = gs_f.astype(jnp.int32)
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        vox = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3]
        voy = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7]
        voz = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11]
        vdx = iv[0] * dx + iv[1] * dy + iv[2] * dz
        vdy = iv[4] * dx + iv[5] * dy + iv[6] * dz
        vdz = iv[8] * dx + iv[9] * dy + iv[10] * dz
        vbase = vid * (g * g * g)
        vol_ids = vid
        v_eff = k
    else:
        vbase = (jnp.arange(v, dtype=jnp.int32) * g * g * g)[:, None]
        vol_ids = jnp.broadcast_to(jnp.arange(v, dtype=jnp.int32)[:, None],
                                   (v, n))
        v_eff = v

    t0p = jnp.where(hit, t0, 0.0)  # [v_eff, N]
    dt = jnp.where(hit, (t1 - t0) / n_steps, 0.0)  # [v_eff, N]
    if span_steps:
        # clamp the occupied span into the pair interval; pairs with no
        # occupied crossing collapse the core and tail to zero length
        s0c = jnp.clip(s0_all, t0, t1)
        s1c = jnp.clip(s1_all, s0c, t1)
        no_occ = s0_all > 1e33
        s0c = jnp.where(no_occ, t1, s0c)
        s1c = jnp.where(no_occ, t1, s1c)
        t0p = jnp.where(hit, s0c, 0.0)
        dt = jnp.where(hit, (s1c - s0c) / n_steps, 0.0)
    dens_flat = (jax.nn.softplus(params.density_logits).reshape(-1)
                 * density_scale)  # [V * G^3]
    # fuse per-cell fetches into ONE 2-D row gather instead of two 1-D
    # takes; column 0
    # carries the differentiable density, column 1 the material id (f32 —
    # exact for ids <= 255).  The VJP scatters rows back into the stack
    # and the material column's cotangent is discarded by the slice.
    cell_tab = jax.lax.stop_gradient(jnp.stack(
        [dens_flat, scene.volumes.grids.reshape(-1).astype(F32)], axis=1))
    # albedo as one [256, 3] row gather instead of 3 channel takes
    alb_tab = params.albedo_table  # [256, 3]

    def step(carry, ki):
        trans, cr, cg_, cb_ = carry  # all [V, N]
        t_mid = t0p + (ki + 0.5) * dt  # [V, N]
        lx = (vox + t_mid * vdx - bx) * gs_f
        ly = (voy + t_mid * vdy - by) * gs_f
        lz = (voz + t_mid * vdz - bz) * gs_f
        ix = jnp.clip(lx.astype(jnp.int32), 0, gs_i - 1)
        iy = jnp.clip(ly.astype(jnp.int32), 0, gs_i - 1)
        iz = jnp.clip(lz.astype(jnp.int32), 0, gs_i - 1)
        inside = ((lx >= 0.0) & (lx < gs_f) & (ly >= 0.0) & (ly < gs_f)
                  & (lz >= 0.0) & (lz < gs_f))
        flat = (ix * g + iy) * g + iz + vbase
        cells = _cell_fetch(dens_flat, cell_tab, flat.reshape(-1))
        s = jnp.where(inside, cells[:, 0].reshape(v_eff, n), 0.0)
        m = cells[:, 1].reshape(v_eff, n).astype(jnp.int32)
        alb = _rows(alb_tab, m.reshape(-1))
        alpha = 1.0 - jnp.exp(-s * dt)  # [V, N]
        wgt = trans * alpha
        cr = cr + wgt * alb[:, 0].reshape(v_eff, n)
        cg_ = cg_ + wgt * alb[:, 1].reshape(v_eff, n)
        cb_ = cb_ + wgt * alb[:, 2].reshape(v_eff, n)
        trans = trans * (1.0 - alpha)
        return (trans, cr, cg_, cb_), None

    init = (jnp.ones((v_eff, n), F32), jnp.zeros((v_eff, n), F32),
            jnp.zeros((v_eff, n), F32), jnp.zeros((v_eff, n), F32))
    step_fn = jax.checkpoint(step) if _REMAT else step

    if span_steps:
        # ---- UNION-SPAN march: ONE cell-level march per RAY over the
        # union of its pairs' occupied spans — halves the sampled rows vs
        # per-pair marching at k=2 AND makes cross-volume compositing
        # front-to-back EXACT (the per-pair path approximates overlap
        # interleaving by entry order).  The statically-empty lead/tail
        # segments of each pair march span_steps samples at BRICK
        # granularity against the per-brick mean sigma (dense adjoint).
        m3 = scene.volumes.occ.shape[2]
        msp = round(m3 ** (1.0 / 3.0))
        bsig = _brick_mean_sigma(params, scene, density_scale)
        alb_none = alb_tab[MAT_NONE]  # empty bricks carry no material

        u0 = jnp.min(jnp.where(hit, s0c, BIG), axis=0)  # [N]
        u1 = jnp.max(jnp.where(hit, s1c, -BIG), axis=0)

        # transmittance-bounded upper clamp: behind the hard first hit the
        # prefix transmittance is <= exp(-sigma_min_occupied * margin), so
        # samples past t_hit + margin carry ~1e-6 of the pixel — clamp the
        # core there (one volumes-only nearest pass).
        # margin derives from the CURRENT minimum occupied density
        # (stop-gradient), so unsaturated parameter states fall back
        # toward the full span gracefully.
        from voxtracer.render.integrator import _traverse

        occ_cells = scene.volumes.grids.reshape(-1) != MAT_NONE
        sig_min = jax.lax.stop_gradient(
            jnp.min(jnp.where(occ_cells,
                              jax.lax.stop_gradient(dens_flat), jnp.inf)))
        margin = 13.8 / jnp.maximum(sig_min, 1e-6) + 1e-3
        ven = jnp.ones(v, bool)
        tlim = jnp.full(n, BIG, F32)
        if not clamp:
            # clamp=False: short-span callers (span_cells_bins bin S) skip
            # the nearest pass — their spans are already a few cells wide
            rec = dict(hit=jnp.zeros(n, bool), t=tlim)
        else:
            rec = _traverse(scene, o, d, tlim, valid, ven, "nearest")
        t_bound = jnp.where(rec["hit"], rec["t"] + margin, BIG)
        u1 = jnp.minimum(u1, jnp.maximum(t_bound, u0))

        has_core = u1 > u0
        u0 = jnp.where(has_core, u0, BIG)  # no-core rays: leads cover all
        u1 = jnp.where(has_core, u1, BIG)
        dt_u = jnp.where(has_core, (u1 - u0) / n_steps, 0.0)

        def pairc(a, j):
            """Pair-j constant, broadcastable to [N] (dense mode keeps
            per-volume [1] columns)."""
            return a[j]

        imp = int(importance) if importance else 0
        if imp > 0:
            # ---- importance-placed core samples: march nodes land
            # proportionally to a P-segment brick-occupancy profile of
            # [u0, u1] instead of uniformly.  Node positions and widths
            # are parameter-free (stop-gradient'd brick means), so this
            # is deterministic variable-node quadrature of the SAME
            # integral: od_k = sigma(t_k) * dt_k with dt_k = (dt/dc) *
            # (total/S) — the inverse-CDF change of variables.  Why:
            # fine-structure voxels (thin walls at monu's g=64) fall
            # BETWEEN uniform nodes when the span is long, which lowers the
            # per-volume grad cosine vs the 48-step reference;
            # concentrating nodes in occupied bricks raises effective
            # resolution at unchanged row count.
            # Cost: 2 probe row-gathers per pair, forward-only.
            bsig_sg = jax.lax.stop_gradient(bsig)
            # threshold choice: empty cells still carry
            # softplus(empty_logit)*scale, so the 1e-6 threshold marks
            # every INSIDE probe occupied and the profile skips only
            # inter-volume gaps in the union core.  A relative threshold
            # (a multiple of the global brick minimum) additionally skips
            # intra-volume air but aligned worse with the reference: P=8
            # probes are too coarse to see thin-matter bricks and divert
            # nodes off them.
            thr = jnp.float32(1e-6)
            segl = (u1 - u0) / imp                       # [N]
            pj = (jnp.arange(imp, dtype=F32) + 0.5)[:, None]
            t_probe = u0[None] + pj * segl[None]         # [P, N]
            occ_p = jnp.zeros((imp, n), bool)
            for jj in range(v_eff):
                gsf = pairc(gs_f, jj)
                gsi = pairc(gs_i, jj)
                ms_i = (gsi + 7) // 8
                vbj = (vol_ids[jj] if vol_ids.ndim == 2
                       else vol_ids[jj, 0])
                lx = (vox[jj] + t_probe * vdx[jj] - pairc(bx, jj)) * gsf
                ly = (voy[jj] + t_probe * vdy[jj] - pairc(by, jj)) * gsf
                lz = (voz[jj] + t_probe * vdz[jj] - pairc(bz, jj)) * gsf
                ibx = jnp.clip((lx * 0.125).astype(jnp.int32), 0, ms_i - 1)
                iby = jnp.clip((ly * 0.125).astype(jnp.int32), 0, ms_i - 1)
                ibz = jnp.clip((lz * 0.125).astype(jnp.int32), 0, ms_i - 1)
                inside = ((lx >= 0.0) & (lx < gsf) & (ly >= 0.0)
                          & (ly < gsf) & (lz >= 0.0) & (lz < gsf))
                fb = jnp.broadcast_to(
                    vbj * m3 + (ibx * msp + iby) * msp + ibz, (imp, n))
                sb = jnp.take(bsig_sg, fb.reshape(-1),
                              mode="clip").reshape(imp, n)
                occ_p = occ_p | (inside & (sb > thr))
            # +0.1 floor: empty segments keep ~1/11 of the node budget so
            # cells the coarse probes miss still get sampled (graceful
            # degradation toward the uniform grid as occupancy saturates)
            w_p = occ_p.astype(F32) + 0.1                # [P, N]
            cdf = jnp.cumsum(w_p, axis=0)
            total = cdf[-1]
            cstep = ((jnp.arange(n_steps, dtype=F32) + 0.5)[:, None]
                     * (total[None] / n_steps))          # [S, N]
            t_tab = jnp.broadcast_to(u0[None], (n_steps, n))
            dt_tab = jnp.zeros((n_steps, n), F32)
            prev = jnp.zeros(n, F32)
            for j in range(imp):
                in_seg = (cstep >= prev[None]) & (cstep < cdf[j][None])
                frac = (cstep - prev[None]) / w_p[j][None]
                t_tab = jnp.where(in_seg,
                                  u0[None] + (j + frac) * segl[None], t_tab)
                dt_tab = jnp.where(
                    in_seg,
                    (total[None] / n_steps) * segl[None] / w_p[j][None],
                    dt_tab)
                prev = cdf[j]
            t_tab = jax.lax.stop_gradient(t_tab)
            dt_tab = jax.lax.stop_gradient(dt_tab)
        else:
            t_tab = dt_tab = None

        # STEP-BATCHED march: a sequential lax.scan over steps pays loop
        # and launch structure per step.  Front-to-back compositing is
        # order-free in log space: the prefix product of (1-alpha_j) =
        # exp(-sum_j od_j), so ONE exclusive cumsum over a [S, N] batch
        # replaces the scan, forward and backward both.
        def seg_composite(carry, od, ar, ag, ab_):
            """Composite a batched segment onto the carry.

            od: [S, N] per-step optical depth; ar/ag/ab_: per-step albedo
            ([S, N] or scalar).  Algebraically identical to the former
            per-step recurrence (alpha = 1-exp(-od), trans *= exp(-od))."""
            trans, cr, cg_, cb_ = carry
            cum = jnp.cumsum(od, axis=0)          # inclusive prefix
            t_ex = jnp.exp(od - cum)              # exclusive prefix product
            w = trans[None] * t_ex * (1.0 - jnp.exp(-od))  # [S, N]
            cr = cr + jnp.sum(w * ar, axis=0)
            cg_ = cg_ + jnp.sum(w * ag, axis=0)
            cb_ = cb_ + jnp.sum(w * ab_, axis=0)
            return (trans * jnp.exp(-cum[-1]), cr, cg_, cb_)

        # seg_composite composes associatively, so the batched march runs
        # in step chunks of <= _SEG_CHUNK: intermediates stay [C, N]
        # instead of [n_steps, N] (an n_steps=192 full-frame call would
        # otherwise materialize far more [S*N] gather rows than fit)
        _SEG_CHUNK = 32

        def core_chunk(carry, k0, ksteps):
            if imp > 0:
                t_mid = t_tab[k0:k0 + ksteps]  # [C, N]
                dtc = dt_tab[k0:k0 + ksteps]
            else:
                ki = (jnp.arange(ksteps, dtype=F32) + (k0 + 0.5))[:, None]
                t_mid = u0 + ki * dt_u  # [C, N]
                dtc = dt_u
            flat = jnp.zeros((ksteps, n), jnp.int32)
            inside_any = jnp.zeros((ksteps, n), bool)
            for j in range(v_eff):
                gsf = pairc(gs_f, j)
                gsi = pairc(gs_i, j)
                lx = (vox[j] + t_mid * vdx[j] - pairc(bx, j)) * gsf
                ly = (voy[j] + t_mid * vdy[j] - pairc(by, j)) * gsf
                lz = (voz[j] + t_mid * vdz[j] - pairc(bz, j)) * gsf
                ix = jnp.clip(lx.astype(jnp.int32), 0, gsi - 1)
                iy = jnp.clip(ly.astype(jnp.int32), 0, gsi - 1)
                iz = jnp.clip(lz.astype(jnp.int32), 0, gsi - 1)
                inside = (hit[j] & (lx >= 0.0) & (lx < gsf) & (ly >= 0.0)
                          & (ly < gsf) & (lz >= 0.0) & (lz < gsf))
                f = (ix * g + iy) * g + iz + pairc(vbase, j)
                flat = jnp.where(inside & ~inside_any, f, flat)
                inside_any = inside_any | inside
            cells = _cell_fetch(dens_flat, cell_tab, flat.reshape(-1))
            s = jnp.where(inside_any, cells[:, 0].reshape(ksteps, n), 0.0)
            m = cells[:, 1].astype(jnp.int32)
            alb = _rows(alb_tab, m)  # [C*N, 3]
            ar = jnp.where(inside_any, alb[:, 0].reshape(ksteps, n), 0.0)
            ag = jnp.where(inside_any, alb[:, 1].reshape(ksteps, n), 0.0)
            ab_ = jnp.where(inside_any, alb[:, 2].reshape(ksteps, n), 0.0)
            return seg_composite(carry, s * dtc, ar, ag, ab_)

        def core_seg(carry):
            for k0 in range(0, n_steps, _SEG_CHUNK):
                carry = core_chunk(carry, k0, min(_SEG_CHUNK, n_steps - k0))
            return carry

        def brick_seg(carry, j, t_start, dtp):
            """Pair-j lead/tail segment at brick granularity, batched."""
            gsf = pairc(gs_f, j)
            gsi = pairc(gs_i, j)
            ms_i = (gsi + 7) // 8
            vbj = (vol_ids[j] if vol_ids.ndim == 2 else vol_ids[j, 0])
            ki = (jnp.arange(span_steps, dtype=F32) + 0.5)[:, None]
            t_mid = t_start + ki * dtp  # [S, N]
            lx = (vox[j] + t_mid * vdx[j] - pairc(bx, j)) * gsf
            ly = (voy[j] + t_mid * vdy[j] - pairc(by, j)) * gsf
            lz = (voz[j] + t_mid * vdz[j] - pairc(bz, j)) * gsf
            ibx = jnp.clip((lx * 0.125).astype(jnp.int32), 0, ms_i - 1)
            iby = jnp.clip((ly * 0.125).astype(jnp.int32), 0, ms_i - 1)
            ibz = jnp.clip((lz * 0.125).astype(jnp.int32), 0, ms_i - 1)
            inside = ((lx >= 0.0) & (lx < gsf) & (ly >= 0.0)
                      & (ly < gsf) & (lz >= 0.0) & (lz < gsf))
            flat_b = (vbj * m3 + (ibx * msp + iby) * msp + ibz)
            flat_b = jnp.broadcast_to(flat_b, (span_steps, n))
            sb = jnp.where(inside,
                           _bsig_rows(bsig, flat_b.reshape(-1))
                           .reshape(span_steps, n), 0.0)
            return seg_composite(carry, sb * dtp, alb_none[0], alb_none[1],
                                 alb_none[2])

        carry = (jnp.ones(n, F32), jnp.zeros(n, F32), jnp.zeros(n, F32),
                 jnp.zeros(n, F32))
        for j in range(v_eff):  # leads (all precede the union core)
            lead_hi = jnp.minimum(u0, t1[j])
            dtp = jnp.where(hit[j],
                            jnp.maximum(lead_hi - t0[j], 0.0) / span_steps,
                            0.0)
            carry = brick_seg(carry, j, t0[j], dtp)
        carry = core_seg(carry)
        for j in range(v_eff):  # tails (all follow the union core)
            tail_lo = jnp.maximum(u1, t0[j])
            dtp = jnp.where(hit[j],
                            jnp.maximum(t1[j] - tail_lo, 0.0) / span_steps,
                            0.0)
            carry = brick_seg(carry, j, tail_lo, dtp)
        trans_n, out_r, out_g, out_b = carry
        t_total = trans_n
        color = jnp.stack([out_r, out_g, out_b], axis=-1)
    else:
        (trans, cr, cg_, cb_), _ = jax.lax.scan(
            step_fn, init, jnp.arange(n_steps, dtype=F32))

        # composite per-pair segments front-to-back by entry t (no sort:
        # the prefix transmittance of segment v is the product over
        # segments that start strictly earlier, index-ordered on ties)
        order = t0p + jnp.where(hit, 0.0, 1e30)
        idx_v = jnp.arange(v_eff)[:, None]
        out_r = jnp.zeros(n, F32)
        out_g = jnp.zeros(n, F32)
        out_b = jnp.zeros(n, F32)
        for vi in range(v_eff):
            before = ((order[vi] > order)
                      | ((order[vi] == order) & (vi > idx_v)))  # [V, N]
            pf = jnp.prod(jnp.where(before, trans, 1.0), axis=0)  # [N]
            out_r = out_r + pf * cr[vi]
            out_g = out_g + pf * cg_[vi]
            out_b = out_b + pf * cb_[vi]
        t_total = jnp.prod(trans, axis=0)
        color = jnp.stack([out_r, out_g, out_b], axis=-1)

    return color, t_total, valid


def mse_loss_active(params: DiffParams, scene: SceneData, cfg, o, d, bg,
                    target_active, denom: float, n_steps: int,
                    k: int = 0, span_steps: int = 0, clamp: bool = True,
                    n_active: int = 0, spans=None, importance: int = 0):
    """Sum of squared errors over the active rays / denom.

    With denom = full-band pixel-element count this has EXACTLY the
    gradient of the full-band image MSE: the excluded (inactive /
    other-bin) pixels render parameter-free background, so their loss
    terms are constants.  target_active = target rows gathered by the
    bin's perm prefix — loop-invariant, precomputed by the caller.

    n_active > 0 zero-masks rows >= n_active: callers pad the compacted
    prefix to a 1024 multiple, and the pad rows can be FOREIGN rays
    active in another bin — without the mask their gradient would be
    double-counted across bins."""
    img = render_diff_active(params, scene, cfg, o, d, bg, n_steps,
                             k=k, span_steps=span_steps, clamp=clamp,
                             spans=spans, importance=importance)
    err = jnp.sum((img - target_active) ** 2, axis=-1)
    if n_active and n_active < o.shape[0]:
        err = jnp.where(jnp.arange(o.shape[0]) < n_active, err, 0.0)
    return jnp.sum(err) / denom


def spans_for_rays(scene: SceneData, o, d):
    """Occupied-brick spans [V, N] (s0, s1) for arbitrary world rays —
    the precomputable input of render_diff_active(spans=...)."""
    inv = scene.volumes.inv
    hi = jax.lax.Precision.HIGHEST
    vo = (jnp.einsum("vij,nj->vni", inv[:, :3, :3], o, precision=hi)
          + inv[:, None, :3, 3])
    vd = jnp.einsum("vij,nj->vni", inv[:, :3, :3], d, precision=hi)
    return _occupied_spans(scene, vo[:, :, 0], vo[:, :, 1], vo[:, :, 2],
                           vd[:, :, 0], vd[:, :, 1], vd[:, :, 2])


def mse_loss(params: DiffParams, scene: SceneData, cfg, target, key,
             n_steps: int = 192, row0=None, rows: int = 0, k: int = 0,
             span_steps: int = 0, perm=None, inv_perm=None,
             n_active: int = 0, clamp: bool = True, importance: int = 0):
    img = render_diff(params, scene, cfg, key, n_steps, row0=row0, rows=rows,
                      k=k, span_steps=span_steps, perm=perm,
                      inv_perm=inv_perm, n_active=n_active, clamp=clamp,
                      importance=importance)
    return jnp.mean((img - target) ** 2)


grad_fn = jax.jit(jax.grad(mse_loss),
                  static_argnames=("cfg", "n_steps", "rows", "k",
                                   "span_steps", "n_active", "clamp",
                                   "importance"))


def max_aabb_crossings(scene: SceneData, cfg, row0: int = 0,
                       rows: int = 0) -> int:
    """HOST-side: the maximum number of instance AABBs any primary ray of
    this camera/band crosses — the smallest exact `k` for render_diff's
    pair compaction (cheap NumPy slab tests, no device work)."""
    import numpy as np

    from voxtracer.render.camera import primary_rays

    h = rows or cfg.height
    x = np.arange(cfg.width, dtype=np.float32)
    y = np.arange(h, dtype=np.float32) + row0
    px, py = np.meshgrid(x, y)
    cam = jax.tree.map(np.asarray, scene.camera)
    o, d = primary_rays(cam, cfg.width, cfg.height, px.reshape(-1),
                        py.reshape(-1), None, np)
    inv = np.asarray(scene.volumes.inv)
    cb = np.asarray(scene.volumes.cube_min)
    count = np.zeros(o.shape[0], np.int32)
    for i in range(inv.shape[0]):
        oo = o @ inv[i, :3, :3].T + inv[i, :3, 3]
        dd = d @ inv[i, :3, :3].T
        with np.errstate(divide="ignore", invalid="ignore"):
            rd = 1.0 / dd
            a = (cb[i] - oo) * rd
            b = (cb[i] + 1.0 - oo) * rd
        t0 = np.maximum(np.nanmax(np.minimum(a, b), axis=1), 0.0)
        t1 = np.nanmin(np.maximum(a, b), axis=1)
        count += (t1 > t0).astype(np.int32)
    return int(count.max())
