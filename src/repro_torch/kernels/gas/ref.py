"""Plain PyTorch versions of the fused gather⊕combine (K1) and
scatter/reschedule (K2) kernels.

They are the CPU production path and the versions each kernel is held
against.  They materialize the per-edge messages — what the kernels avoid —
and sum each row in the segment order of ``kernels/csr.py`` with
sequential ``index_add_``: the order and rounding the kernels reproduce.
Pad edges (receiver ``>= n_rows``) are dropped before the sum, since
``index_add_`` raises on an out-of-range index where
``jax.ops.segment_sum`` drops it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.csr import (RowSegments, n_real_edges,
                                     segmented_row_sum)
from repro_torch.kernels.gas.gas import ROW_BLOCK


def gather_combine_ref(
    feat: torch.Tensor,          # [N, D] per-vertex source features
    weights: torch.Tensor,       # [E] per-edge scalar (pad rows 0)
    senders: torch.Tensor,       # [E] (pad rows 0)
    receivers: torch.Tensor,     # [E] sorted; entries >= n_rows are padding
    n_rows: int,
    block_active: Optional[torch.Tensor] = None,  # [n_row_blocks] bitmap
    row_block: int = ROW_BLOCK,
    segments: Optional[RowSegments] = None,  # the receivers' row segments
) -> torch.Tensor:
    """acc[v] = Σ_{e: recv(e)=v} w_e · feat[send(e)], f32 accumulation;
    rows of inactive row blocks are zero."""
    e = n_real_edges(receivers, n_rows)
    msgs = weights[:e, None].to(torch.float32) \
        * feat[senders[:e].long()].to(torch.float32)            # the [E, D]
    acc = segmented_row_sum(msgs, receivers[:e], n_rows, segments)
    if block_active is not None:
        act = torch.repeat_interleave(block_active.bool(), row_block)[:n_rows]
        acc = torch.where(act[:, None], acc, torch.zeros_like(acc))
    return acc.to(feat.dtype)


def scatter_reschedule_ref(
    contrib: torch.Tensor,       # [N_src] per-source priority contribution
    prio: torch.Tensor,          # [N] current priorities
    consume: torch.Tensor,       # [N] bool — executed this phase
    weights: torch.Tensor,       # [E] per-edge scalar (pad rows 0)
    senders: torch.Tensor,       # [E] into contrib (pad rows 0)
    receivers: torch.Tensor,     # [E] sorted; entries >= n are padding
    n_rows: int,
    segments: Optional[RowSegments] = None,  # the receivers' row segments
) -> torch.Tensor:
    """T ← (T \\ executed) ∪ T': executed rows consume their priority, each
    edge deposits ``w_e · contrib[send(e)]`` at its receiver."""
    e = n_real_edges(receivers, n_rows)
    bump = segmented_row_sum(
        weights[:e].to(torch.float32)
        * contrib[senders[:e].long()].to(torch.float32),
        receivers[:e], n_rows, segments)
    keep = torch.where(consume.bool(), torch.zeros_like(bump),
                       prio.to(torch.float32))
    return keep + bump
