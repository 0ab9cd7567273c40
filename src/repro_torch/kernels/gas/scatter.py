"""K2, the fused scatter/reschedule kernel: its launch wrapper.

``out[v] = where(consume[v], 0, prio[v]) + Σ_{u→v} w_e · contrib[u]`` over
receiver-sorted CSR rows (cut into segments, ``kernels/csr.py``) — the
scheduler update ``T ← (T \\ executed) ∪ T'`` of every phase of a fused
engine.  The kernel is CUDA C++ for sm_90a in
``repro_torch/csrc/gas_scatter_reschedule.cu``; it walks K1's D = 1 tile
tables (``segments.tiles``), built on the set's first launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr import RowSegments


def gas_scatter_reschedule_cuda(
    contrib: torch.Tensor,       # [N_src] f32 per-source contributions
    prio: torch.Tensor,          # [n_rows] f32 current priorities
    consume: torch.Tensor,       # [n_rows] bool — executed this phase
    senders: torch.Tensor,       # [>= E] i32 into contrib
    segments: RowSegments,       # the rows' segment tables
    weights: Optional[torch.Tensor] = None,  # [>= E] f32; None = all 1
) -> torch.Tensor:
    """Launches K2 → ``[n_rows]`` f32.  Reads ``segments.tiles`` (built on
    the first launch over these segments).  Counts each launch in
    ``.launches``."""
    dev = contrib.device
    n_rows = segments.n_rows
    build.require("contrib", contrib, torch.float32, dev, (None,))
    build.require("prio", prio, torch.float32, dev, (n_rows,))
    build.require("consume", consume, torch.bool, dev, (n_rows,))
    build.require("senders", senders, torch.int32, dev, (None,))
    build.require_segments(segments, dev)
    build.require_edges("senders", senders, segments)
    if weights is not None:
        build.require("weights", weights, torch.float32, dev, (None,))
        build.require_edges("weights", weights, segments)
    out = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_rows == 0:
        return out
    tiles = segments.tiles              # built on the first launch
    partial = torch.empty(segments.n_segments if tiles.n_partial else 0,
                          dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    rc = build.library().gas_scatter_reschedule(
        contrib.data_ptr(), prio.data_ptr(), consume.data_ptr(),
        ptr(weights), senders.data_ptr(), segments.row_ids.data_ptr(),
        segments.row_seg.data_ptr(), segments.seg_beg.data_ptr(),
        segments.seg_row.data_ptr(), ptr(tiles.tile_beg),
        ptr(tiles.tile_end), ptr(tiles.multi_rows), ptr(partial),
        out.data_ptr(), n_rows, tiles.n_tiles, tiles.n_partial,
        tiles.n_multi, tiles.tile_cap, tiles.tile_segs,
        build.stream_ptr(dev))
    build.check(rc, "gas_scatter_reschedule")
    gas_scatter_reschedule_cuda.launches += 1
    return out


gas_scatter_reschedule_cuda.launches = 0
