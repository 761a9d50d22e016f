"""Pure-NumPy MagicaVoxel ``.vox`` parser.

Pure-Python replacement for the reference's ogt_vox-based loader
(reference: scene.cpp:449-683 + lib/ogt_vox.h).  The output is a pair of
arrays — a dense color-index grid and a 256-entry RGBA palette — ready to be
turned into device arrays; no C++ object graph, no global mutation.

Behavioral parity notes (reference = ogt_vox semantics, which the reference
renderer relies on for material indices):

* Only chunk types needed by the renderer are interpreted: SIZE/XYZI pairs
  (models), RGBA (palette), IMAP (display-order index remap).  Scene-graph
  chunks (nTRN/nGRP/nSHP/LAYR/MATL/rCAM/rOBJ/NOTE) are skipped, exactly as
  the reference only ever reads ``models[0]`` + ``palette``
  (scene.cpp:474-475).
* IMAP remap (ogt_vox.h:2004-2037): voxel indices are rewritten to
  *display* order via ``v -> (1 + inverse_imap[v]) & 0xFF`` and the palette
  is reordered with ``palette[i] = old[(imap[i] + 255) & 0xFF]`` — including
  the quirky treatment of empty voxels, since the reference inherits it.
* Palette rotation (ogt_vox.h:2040-2047): after parsing, the palette is
  rotated so ``palette[color_index]`` is a direct lookup; entry 0 is
  transparent.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VoxModel:
    """One parsed .vox file: dense index grid + display-order palette.

    grid: uint8 array of shape (size_x, size_y, size_z), 0 = empty,
          otherwise a palette/material index (MagicaVoxel z is "up"; axis
          remap to the renderer's y-up convention happens at scene build).
    palette: float32 array (256, 4) of RGBA in [0, 1]; palette[0] is
          transparent.
    """

    grid: np.ndarray
    palette: np.ndarray

    @property
    def size(self) -> tuple[int, int, int]:
        return tuple(self.grid.shape)  # type: ignore[return-value]


def _iter_chunks(data: bytes, offset: int, end: int):
    """Yield (chunk_id, content_bytes) for a flat run of sibling chunks."""
    while offset + 12 <= end:
        cid = data[offset : offset + 4]
        content_size, children_size = struct.unpack_from("<ii", data, offset + 4)
        content_start = offset + 12
        yield cid, data[content_start : content_start + content_size], content_start + content_size, children_size
        offset = content_start + content_size + children_size


def parse_vox(data: bytes) -> list[VoxModel]:
    """Parse .vox bytes into a list of models (all sharing one palette)."""
    if data[:4] != b"VOX ":
        raise ValueError("not a MagicaVoxel file (missing 'VOX ' magic)")

    sizes: list[tuple[int, int, int]] = []
    voxels: list[np.ndarray] = []
    palette_raw: np.ndarray | None = None
    imap: np.ndarray | None = None

    def walk(offset: int, end: int) -> None:
        nonlocal palette_raw, imap
        for cid, content, child_off, child_size in _iter_chunks(data, offset, end):
            if cid == b"MAIN":
                walk(child_off, child_off + child_size)
            elif cid == b"SIZE":
                sizes.append(struct.unpack("<iii", content[:12]))
            elif cid == b"XYZI":
                (n,) = struct.unpack_from("<i", content, 0)
                voxels.append(
                    np.frombuffer(content, dtype=np.uint8, count=4 * n, offset=4).reshape(n, 4)
                )
            elif cid == b"RGBA":
                palette_raw = np.frombuffer(content, dtype=np.uint8, count=256 * 4).reshape(256, 4)
            elif cid == b"IMAP":
                imap = np.frombuffer(content, dtype=np.uint8, count=256)
            # all other chunk ids are metadata the renderer never reads

    walk(8, len(data))

    if palette_raw is None:
        # Old files without an RGBA chunk: grayscale ramp fallback (none of
        # the benchmark assets need this; ogt_vox ships MagicaVoxel's default
        # palette instead, which is editor-specific data we do not replicate).
        ramp = np.linspace(0, 255, 256, dtype=np.uint8)
        palette_raw = np.stack([ramp, ramp, ramp, np.full(256, 255, np.uint8)], axis=1)
    palette = palette_raw.astype(np.uint8).copy()

    models: list[VoxModel] = []
    remap: np.ndarray | None = None
    if imap is not None:
        # ogt_vox.h:2004-2037 — rewrite indices to display order.
        inverse = np.zeros(256, dtype=np.uint8)
        inverse[imap] = np.arange(256, dtype=np.uint8)
        remap = ((1 + inverse.astype(np.int32)) & 0xFF).astype(np.uint8)
        palette = palette[(imap.astype(np.int32) + 255) & 0xFF]

    # ogt_vox.h:2040-2047 — rotate palette so voxel indices index directly.
    palette = np.roll(palette, 1, axis=0)
    palette[0, 3] = 0

    palette_f = palette.astype(np.float32) / 255.0

    for (sx, sy, sz), xyzi in zip(sizes, voxels):
        grid = np.zeros((sx, sy, sz), dtype=np.uint8)
        if xyzi.size:
            x, y, z, ci = xyzi[:, 0], xyzi[:, 1], xyzi[:, 2], xyzi[:, 3]
            keep = (x < sx) & (y < sy) & (z < sz)
            grid[x[keep], y[keep], z[keep]] = ci[keep]
        if remap is not None:
            grid = remap[grid]
        models.append(VoxModel(grid=grid, palette=palette_f))

    return models


def load_vox(path: str, prefer_native: bool = True) -> VoxModel:
    """Load the first model of a .vox file (reference uses models[0] only).

    Uses the C++ parser (native/voxio.cpp) when built — bit-identical
    output, faster on large models — falling back to pure Python."""
    with open(path, "rb") as f:
        data = f.read()
    if prefer_native:
        try:
            from voxtracer.native import parse_vox_native

            out = parse_vox_native(data)
            if out is not None:
                return VoxModel(grid=out[0], palette=out[1])
        except Exception:
            pass
    return parse_vox(data)[0]
