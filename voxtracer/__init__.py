"""voxtracer — a differentiable voxel ray/path tracer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the reference
CPU renderer (Tycro-Games/Raytracer-VoxPopuli): MagicaVoxel .vox scenes
become batched dense voxel grids traversed by 3D-DDA (Amanatides–Woo)
kernels — a Pallas kernel on the GPU, vectorized XLA on the CPU; the
recursive Trace/Illumination shading loop is a wavefront (iterative,
masked) megakernel under `jax.jit`; rays shard across device meshes via
`jax.sharding`; voxel-density/albedo gradients flow
through a relaxed transmittance integrator.

Layout (see SURVEY.md §7):
  core/     pytree types, RNG streams, transforms, sampling
  io/       .vox parser, HDR/PNG image IO
  scene/    volumes, instances (TLAS), procedural generation, presets
  kernels/  DDA traversal, AABB/primitive intersectors, Pallas kernels
  render/   camera, shading, sky, tonemap, integrators, accumulation
  diff/     differentiable (relaxed) integrator + adjoints
  dist/     device meshes, sharded rendering, multi-host
  game/     rolling-cube player, props, level/chunk logic
  ref/      NumPy golden oracle renderer
"""

__version__ = "0.1.0"
