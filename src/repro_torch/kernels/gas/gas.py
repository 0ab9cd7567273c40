"""K1, the fused gather⊕combine kernel: its launch wrapper.

``acc[v] = Σ_{u→v} w_e · feat[u]`` over receiver-sorted CSR rows (cut into
segments, ``kernels/csr.py``), the gather of every fused apply phase.  The
kernel is CUDA C++ for sm_90a in ``repro_torch/csrc/gas_gather_combine.cu``
(its note says what it replaces and what bounds it); this module checks the
tensors, allocates the output and scratch, and launches it on PyTorch's
current stream.

``ROW_BLOCK`` and ``EDGE_BLOCK`` are the block sizes of the JAX package's
kernels.  The CUDA kernels need neither, but the port keeps them: the
active-row-block bitmap is per ``ROW_BLOCK`` rows, ``EdgeSet`` keeps the
same padding, and the edges-touched accounting counts per row block.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr import ColumnItems, RowSegments

ROW_BLOCK = 128
EDGE_BLOCK = 512


def gas_gather_combine_cuda(
    feat: torch.Tensor,          # [N_src, D] f32 source features
    weights: torch.Tensor,       # [>= E] f32 per-edge scalars
    senders: torch.Tensor,       # [>= E] i32, receiver-sorted edge order
    segments: RowSegments,       # the rows' segment tables, N = n_rows
    block_active: Optional[torch.Tensor] = None,  # [n_row_blocks] i32
) -> torch.Tensor:
    """Launches K1 → ``[n_rows, D]`` f32.  ``feat`` may hold more rows than
    the output (the distributed engines' senders index a stacked
    ``[own; ghost]`` table) and may start at any row of a larger table.
    Rows of inactive row blocks, and rows that own no edge of
    ``segments``, come back as exact zeros.  At D = 1 it reads
    ``segments.tiles``, at D >= 2 ``segments.column_items(D)``
    (each built on the first launch at that width).  Counts each launch
    in ``.launches``."""
    dev = feat.device
    n_rows = segments.n_rows
    build.require("feat", feat, torch.float32, dev, (None, None))
    d = feat.shape[1]
    build.require("weights", weights, torch.float32, dev, (None,))
    build.require("senders", senders, torch.int32, dev, (None,))
    build.require_segments(segments, dev)
    build.require_edges("weights", weights, segments)
    build.require_edges("senders", senders, segments)
    if block_active is not None:
        build.require("block_active", block_active, torch.int32, dev,
                      (max(-(-n_rows // ROW_BLOCK), 1),))
    if n_rows == 0 or d == 0:
        return torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    if d == 1:
        out = _launch_d1(feat, weights, senders, segments, block_active)
    else:
        out = launch_cols(feat, weights, senders, segments, block_active,
                          segments.column_items(d))
    gas_gather_combine_cuda.launches += 1
    return out


gas_gather_combine_cuda.launches = 0


def _ptr(t):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _launch_d1(feat, weights, senders, segments, block_active):
    tiles = segments.tiles              # built on the first D = 1 launch
    out = torch.empty((segments.n_rows, 1), dtype=torch.float32,
                      device=feat.device)
    partial = torch.empty((segments.n_segments if tiles.n_partial else 0,),
                          dtype=torch.float32, device=feat.device)
    rc = build.library().gas_gather_combine(
        feat.data_ptr(), weights.data_ptr(), senders.data_ptr(),
        segments.row_ids.data_ptr(), segments.row_seg.data_ptr(),
        segments.seg_beg.data_ptr(), segments.seg_row.data_ptr(),
        _ptr(block_active), _ptr(tiles.tile_beg), _ptr(tiles.tile_end),
        _ptr(tiles.multi_rows), _ptr(partial), out.data_ptr(),
        segments.n_rows, ROW_BLOCK, tiles.n_tiles, tiles.n_partial,
        tiles.n_multi, tiles.tile_cap, tiles.tile_segs, build.stream_ptr(
            feat.device))
    build.check(rc, "gas_gather_combine")
    return out


def launch_cols(feat, weights, senders, segments: RowSegments, block_active,
                items: ColumnItems, copy: int = -1) -> torch.Tensor:
    """K1's D >= 2 kernel over the column items ``items`` of
    ``segments`` (the wrapper's checks already made; not counted).
    ``copy`` -1 lets the kernel choose how it gathers from the shape (0:
    ``cp.async.bulk``, 1: 16-byte ``cp.async``, rows of at most 128
    bytes, 2: 4-byte ``cp.async``).  ``chip_smoke.py`` calls it with items
    of a forced slice width and with ``cp.async.bulk`` forced at D 20."""
    d = feat.shape[1]
    out = torch.empty((segments.n_rows, d), dtype=torch.float32,
                      device=feat.device)
    partial = torch.empty((segments.n_segments * d if items.n_multi else 0,),
                          dtype=torch.float32, device=feat.device)
    counter = torch.empty((1,), dtype=torch.int32, device=feat.device)
    rc = build.library().gas_gather_combine_cols(
        feat.data_ptr(), weights.data_ptr(), senders.data_ptr(),
        segments.row_ids.data_ptr(), segments.row_seg.data_ptr(),
        segments.seg_beg.data_ptr(), segments.seg_row.data_ptr(),
        _ptr(block_active), _ptr(items.items), _ptr(items.multi_rows),
        _ptr(partial), counter.data_ptr(), out.data_ptr(), segments.n_rows,
        segments.n_segments, d, ROW_BLOCK, items.n_items, items.n_multi,
        items.stage_floats, copy, build.stream_ptr(feat.device))
    build.check(rc, "gas_gather_combine_cols")
    return out
