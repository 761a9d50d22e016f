"""Render configuration — one hashable dataclass instead of the reference's
#define forest + ImGui sliders (SURVEY.md §5 config).

Passed as a static argument to jitted entry points; changing it recompiles.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 212
    # integrator: "primary" (flat albedo first hit), "whitted"
    # (deterministic: NEE-sum + perfect mirrors + Fresnel-split glass),
    # "path" (full stochastic reference semantics, maxBounces default 14,
    # renderer.h:175)
    mode: str = "path"
    max_bounces: int = 14
    spp: int = 1
    aa_strength: float = 1.0  # renderer.h:183 antiAliasingStrength
    use_dof: bool = False
    activate_sky: bool = True
    sky_fallback: tuple = (0.392, 0.584, 0.829)  # renderer.cpp:2312
    num_area_samples: int = 3  # renderer.h:205 numCheckShadowsAreaLight
    # deterministic_lights: evaluate and sum ALL lights at NEE instead of the
    # reference's one-random-light x lightCount estimator — same expectation
    # (renderer.cpp:738-764), zero variance; used by golden tests.
    deterministic_lights: bool = False
    # whitted mode only: compile the Fresnel-split glass/smoke recursion.
    # The split doubles the compiled recursion tree per depth; scenes with
    # no dielectrics should disable it (the branches would be dead code the
    # compiler still pays for).
    whitted_glass_split: bool = True
    # branch-stack whitted: drop pending branches whose throughput weight
    # is below this (the Fresnel split otherwise pushes the FULL binary
    # tree — room.vox's glass floor at depth 5 ran 63 lockstep iterations,
    # most of them for branches contributing < 1e-3 of a pixel).  A culled
    # branch changes its pixel by at most eps * its radiance, below the
    # golden tolerance; set 0 for exact tree parity (the
    # iterative-vs-recursive test does).
    whitted_cull_eps: float = 1e-3
    # path mode wavefront compaction: between bounces, partition surviving
    # rays to a prefix (stable cumsum partition) and trace fixed-width
    # chunks of n // compact_chunks in a nested while_loop — terminated
    # rays stop paying lockstep traversal cost.  DEFAULT OFF: a per-tile
    # traversal kernel already stops work on finished tiles, and the
    # compaction permutation plus per-chunk dispatch cost more than they
    # saved where this was last measured.  Only applied when the ray
    # batch is >= compact_min and divisible by compact_chunks; sharded
    # multi-device renders should keep compact_min above their per-render
    # ray count (the partition would otherwise emit cross-device
    # collectives).
    compact_chunks: int = 1
    compact_min: int = 65536
    # game light-kill detection (renderer.cpp:1437-1450): when a path-mode
    # ray shades a SMOKE_PLAYER cell, evaluate direct illumination at the
    # hit; sqrLength > light_kill_threshold flags the ray.  The per-frame
    # OR of the flags feeds Game.tick's checkpoint revert
    # (renderer.cpp:2112-2118).  Off by default: it costs one extra fused
    # shadow pass per bounce and only the game consumes it.
    detect_light_kill: bool = False
    light_kill_threshold: float = 16.0
    # Sampler for the stochastic integrator streams: "hash" (counter-based
    # PCG hash, core/rng.py — the reference's xorshift-class cost,
    # deterministic, a few integer ops per value) or
    # "threefry" (jax.random; same estimators, different sample values —
    # kept for tests that pin jax.random streams).
    rng: str = "hash"
    # Secondary-ray reordering between path bounces: "auto" sorts the
    # wavefront by (terminated, origin-morton | direction-octant) before
    # each bounce >= 1 on scenes of more than 64 volumes — diffuse-bounced
    # rays are spatially incoherent, which defeats tile clustering and
    # makes a block's slowest ray set its cost; re-clustering restores
    # coherent blocks.  The 64-volume threshold is kept from the design
    # this was first measured in; no measurement on the GPU has set it
    # yet.  "always" forces it, "none" disables.
    # Pure dispatch order: per-lane estimators are unchanged; stochastic
    # streams reassign which lane draws which sample.
    bounce_reorder: str = "auto"
    # re-sort every k-th bounce (1 = every bounce).  The permute runs as
    # chunked <=8-column row gathers (integrator.take_rows).  Origins
    # drift slowly bounce-to-bounce, so clustering decays gently and
    # period 1's extra sorts bought less than they cost where this was
    # first measured.
    bounce_reorder_period: int = 2
    # live-prefix chunking of the REORDERED bounce loop: the morton key
    # already sorts terminated rays to the tail, so after each re-sort
    # the live rays are a prefix — with k > 1 each bounce dispatches
    # n/k-wide chunks and stops at the last live lane instead of walking
    # the full width, so late bounces traverse at a fraction of the
    # width.  Each chunk is one more dispatch; 1 = off.
    reorder_compact_chunks: int = 1
    # Whitted queue batch re-clustering: sort each iteration's [W] branch
    # batch by (live, origin-morton | direction-octant) before traversal.
    # The queue mixes branch generations after a few pops, which defeats
    # the lockstep blocks exactly like path bounces do.  Changes only
    # per-pixel radiance summation order (adds commute to rounding).
    whitted_sort_batch: bool = False
    # Ray dispatch order inside a render band: "scanline" (row-major) or
    # "tile" (8x128-pixel tiles).  A traversal block runs until its
    # slowest lane finishes; a block of consecutive rays then holds
    # neighbouring pixels, whose walks take similar trip counts, where a
    # scanline block would mix far-apart ones.  Pure dispatch
    # order: per-pixel estimators are unchanged (deterministic modes are
    # bit-identical; stochastic modes reassign which lane gets which
    # jitter sample).  Falls back to scanline when width % 128 != 0.
    ray_order: str = "tile"
