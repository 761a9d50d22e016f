"""Multi-host initialization + cross-host rendering (SURVEY.md §5
"distributed communication backend" — the reference has none; its only
parallelism is OS threads).

On a multi-host cluster each host owns a subset of devices; `init()` wires
`jax.distributed`, and `host_tile_bounds` assigns each host a contiguous
row band of the image (tile sharding avoids any forward-pass collective —
pixels are disjoint; gradient psum in the backward crosses hosts via the
sharded train step, dist/train.py)."""

from __future__ import annotations

import os

import jax
import numpy as np


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None) -> dict:
    """Initialize jax.distributed when running multi-process; no-op for a
    single process.  Reads JAX_COORDINATOR / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID when args are omitted."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return dict(process_index=jax.process_index(),
                process_count=jax.process_count(),
                local_devices=jax.local_device_count(),
                global_devices=jax.device_count())


def global_mesh(axis: str = "rays"):
    """1D mesh over every chip of every host."""
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def host_tile_bounds(height: int) -> tuple[int, int]:
    """Contiguous scanline band owned by this host: [row0, row1)."""
    pc, pi = jax.process_count(), jax.process_index()
    rows = -(-height // pc)
    row0 = min(pi * rows, max(height - rows, 0))
    return row0, min(row0 + rows, height)


def gather_image(local_band, height: int):
    """Assemble the full image on host 0 from per-host bands via
    process_allgather (DCN); single-process returns the band as-is."""
    if jax.process_count() == 1:
        return np.asarray(local_band)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(local_band)
    return np.concatenate(list(gathered), axis=0)[:height]
