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
from repro_torch.kernels.csr import RowSegments

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
    ``[own; ghost]`` table).  Rows of inactive row blocks, and rows that own
    no edge of ``segments``, come back as exact zeros.  At D = 1 it reads
    ``segments.tiles`` (built on the first such launch).  Counts each launch
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
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    if n_rows == 0 or d == 0:
        return out
    if d == 1:
        tiles = segments.tiles              # built on the first D = 1 launch
        tables = (tiles.tile_beg, tiles.tile_end, tiles.multi_rows)
        counts = (tiles.n_tiles, tiles.n_partial, tiles.n_multi,
                  tiles.tile_cap, tiles.tile_segs)
        n_partial = segments.n_segments if tiles.n_partial else 0
    else:
        tables, counts = (None,) * 3, (0,) * 5
        n_partial = segments.n_segments * d
    partial = torch.empty((n_partial,), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    rc = build.library().gas_gather_combine(
        feat.data_ptr(), weights.data_ptr(), senders.data_ptr(),
        segments.row_ids.data_ptr(), segments.row_seg.data_ptr(),
        segments.seg_beg.data_ptr(), segments.seg_row.data_ptr(),
        ptr(block_active), *map(ptr, tables), ptr(partial), out.data_ptr(),
        n_rows, segments.n_listed, segments.n_segments, d, ROW_BLOCK, *counts,
        build.stream_ptr(dev))
    build.check(rc, "gas_gather_combine")
    gas_gather_combine_cuda.launches += 1
    return out


gas_gather_combine_cuda.launches = 0
