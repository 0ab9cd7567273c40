"""Plain PyTorch version of the sorted segment-sum kernel (K3)."""
from typing import Optional

import torch

from repro_torch.kernels.csr import (RowSegments, n_real_edges,
                                     segmented_row_sum)


def segment_sum_sorted_ref(msgs: torch.Tensor, receivers: torch.Tensor,
                           n_rows: int,
                           segments: Optional[RowSegments] = None
                           ) -> torch.Tensor:
    """msgs [E, D], receivers [E] sorted (entries >= n_rows are padding and
    dropped) -> [n_rows, D], summed in the segment order of
    ``kernels/csr.py`` (``segments``: the receivers' tables, if held).
    Pads sort last and are cut off before the sum: ``index_add_`` raises
    where ``jax.ops.segment_sum`` drops."""
    e = n_real_edges(receivers, n_rows)
    return segmented_row_sum(msgs[:e], receivers[:e], n_rows, segments)
