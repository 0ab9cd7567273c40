"""K3, the sorted segment-sum kernel: its launch wrapper, and the host
block offsets of the JAX package's blocked layout.

``out[v] = Σ_{e: recv(e)=v} msgs[e]`` for receiver-sorted messages
``[E, D]`` (f32 or f64) — the dense ⊕-combine of the apply phase.  The
kernel is CUDA C++ for sm_90a in ``repro_torch/csrc/segment_sum_sorted.cu``;
it reads each row's message range through the row segment tables
(``kernels/csr.py``) and needs no block offsets.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr import RowSegments

ROW_BLOCK = 128
EDGE_BLOCK = 512


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
    tables → ``[n_rows, D]`` of the same dtype.  Counts each launch in
    ``.launches``."""
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
    partial = torch.empty((segments.n_segments, d), dtype=msgs.dtype,
                          device=dev)
    rc = build.library().segment_sum_sorted(
        msgs.data_ptr(), segments.row_ids.data_ptr(),
        segments.row_seg.data_ptr(), segments.seg_beg.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n_rows, segments.n_listed,
        segments.n_segments, d, int(msgs.dtype == torch.float64),
        build.stream_ptr(dev))
    build.check(rc, "segment_sum_sorted")
    segment_sum_sorted_cuda.launches += 1
    return out


segment_sum_sorted_cuda.launches = 0
