"""K3, the sorted segment-sum kernel: its launch wrapper, and the host
block offsets of the JAX package's blocked layout.

``out[v] = Σ_{e: recv(e)=v} msgs[e]`` for receiver-sorted messages
``[E, D]`` (f32 or f64) — the dense ⊕-combine of the apply phase.  The
kernel is CUDA C++ for sm_90a in ``repro_torch/csrc/segment_sum_sorted.cu``;
it reads each row's message range through the row segment tables
(``kernels/csr.py``) and needs no block offsets.  At D <= ``TILE_SEGMENTS``
it walks tile tables of ``tile_shape(D, element size)``, built on the first
launch at that shape.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr import (SHORT_SEGMENT, TILE_SEGMENTS,
                                     RowSegments, TileShape)

ROW_BLOCK = 128
EDGE_BLOCK = 512
#: shared memory a K3 block stages messages in, at most (one chunk)
STAGE_BYTES = 32 * 1024


def tile_shape(d: int, itemsize: int) -> Tuple[TileShape, int]:
    """K3's tiles for ``d`` columns (``d <= TILE_SEGMENTS``) of
    ``itemsize``-byte messages, and the edges a block stages at once.

    A tile holds at most ``TILE_SEGMENTS // d`` segments, one thread a
    (segment, column) pair; a packed tile's segments (at most ``short``
    edges each, starting in one window) span at most the staged edges, so
    it is read in one chunk; a longer segment is a tile alone and streams
    through the stage in chunks."""
    stage = STAGE_BYTES // (itemsize * d)
    short = max(1, min(SHORT_SEGMENT, stage // 4))
    return TileShape(segments=TILE_SEGMENTS // d, short=short,
                     window=stage - short + 1), stage


def block_offsets(receivers: np.ndarray, n_rows: int,
                  n_edges: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side: per output row block, (first edge block, #edge blocks),
    clamped to the real edge-block range (a row block beginning past the
    last edge, with ``n_edges`` an exact ``EDGE_BLOCK`` multiple, must not
    index one block past the end)."""
    n_edge_blocks = max(-(-n_edges // EDGE_BLOCK), 1)
    n_row_blocks = -(-n_rows // ROW_BLOCK)
    bounds = np.arange(n_row_blocks + 1) * ROW_BLOCK
    edge_pos = np.searchsorted(receivers, bounds)
    start = np.minimum(edge_pos[:-1] // EDGE_BLOCK, n_edge_blocks - 1)
    end = np.minimum(np.maximum(-(-edge_pos[1:] // EDGE_BLOCK), start + 1),
                     n_edge_blocks)
    n_eblk = np.maximum(end - start, 1).astype(np.int32)
    return start.astype(np.int32), n_eblk, int(n_eblk.max(initial=1))


def segment_sum_sorted_cuda(msgs: torch.Tensor,
                            segments: RowSegments) -> torch.Tensor:
    """Launches K3: msgs ``[E, D]`` (f32 or f64) with its receivers' segment
    tables → ``[n_rows, D]`` of the same dtype.  At D <= ``TILE_SEGMENTS``
    it reads ``segments.tiles_for(tile_shape(D, element size))``.  Counts
    each launch in ``.launches``."""
    dev = msgs.device
    if msgs.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"msgs: expected float32 or float64, got "
                         f"{msgs.dtype}")
    build.require("msgs", msgs, msgs.dtype, dev, (None, None))
    build.require_segments(segments, dev)
    build.require_edges("msgs", msgs, segments)
    n_rows, d = segments.n_rows, msgs.shape[1]
    out = torch.empty((n_rows, d), dtype=msgs.dtype, device=dev)
    if n_rows == 0 or d == 0:
        return out
    if d <= TILE_SEGMENTS:
        shape, stage = tile_shape(d, msgs.element_size())
        tiles = segments.tiles_for(shape)   # built on the first launch
        tables = (tiles.tile_beg, tiles.tile_end, tiles.multi_rows)
        counts = (tiles.n_tiles, tiles.n_partial, tiles.n_multi,
                  min(stage, tiles.tile_cap), tiles.tile_segs)
        n_partial = segments.n_segments if tiles.n_partial else 0
    else:
        tables, counts = (None,) * 3, (0,) * 5
        n_partial = segments.n_segments
    partial = torch.empty((n_partial, d), dtype=msgs.dtype, device=dev)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    rc = build.library().segment_sum_sorted(
        msgs.data_ptr(), segments.row_ids.data_ptr(),
        segments.row_seg.data_ptr(), segments.seg_beg.data_ptr(),
        segments.seg_row.data_ptr(), *map(ptr, tables), ptr(partial),
        out.data_ptr(), n_rows, segments.n_listed, segments.n_segments, d,
        int(msgs.dtype == torch.float64), *counts, build.stream_ptr(dev))
    build.check(rc, "segment_sum_sorted")
    segment_sum_sorted_cuda.launches += 1
    return out


segment_sum_sorted_cuda.launches = 0
