"""Dispatch for the sorted segment-sum kernel (K3): CUDA tensor → the
hand-written kernel (or raise); CPU tensor → the plain version (ref.py)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.csr import RowSegments, row_segments_of
from repro_torch.kernels.segsum.ref import segment_sum_sorted_ref
from repro_torch.kernels.segsum.segsum import segment_sum_sorted_cuda


def segment_sum_sorted(
    msgs: torch.Tensor,
    receivers: torch.Tensor,
    n_rows: int,
    segments: Optional[RowSegments] = None,
) -> torch.Tensor:
    """msgs [E, D] with sorted receivers [E] (entries >= n_rows are padding)
    -> [n_rows, D].  ``segments`` (the receivers' row segments) is built on
    the host from ``receivers`` when the caller does not hold it."""
    if segments is None:
        segments = row_segments_of(receivers, n_rows)
    if not msgs.is_cuda:
        return segment_sum_sorted_ref(msgs, receivers, n_rows, segments)
    return segment_sum_sorted_cuda(msgs.contiguous(), segments)
