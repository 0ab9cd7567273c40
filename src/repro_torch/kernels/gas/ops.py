"""Dispatch layer for the fused gather⊕combine (K1) and scatter/reschedule
(K2) kernels.

``EdgeSet`` packages a (possibly color-restricted) receiver-sorted edge
subset with its device arrays and its CSR rows cut into segments
(``kernels/csr.py``); engines build them once per structure (or once per
color: by receiver color for the gather, by sender color for the
scatter) on the host.  ``gather_combine`` and
``scatter_reschedule`` then dispatch on where the tensors lie:

    CUDA tensor → the hand-written kernel (or raise)
    CPU tensor  → the plain PyTorch version (ref.py)

The active-block bitmap (``active_row_blocks`` of the scheduler mask) is
honored identically by both: inactive row blocks give exact zeros, and the
kernel reads none of their edges.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.csr import RowSegments
from repro_torch.kernels.gas.gas import (EDGE_BLOCK, ROW_BLOCK,
                                         gas_gather_combine_cuda)
from repro_torch.kernels.gas.ref import (gather_combine_ref,
                                         scatter_reschedule_ref)
from repro_torch.kernels.gas.scatter import gas_scatter_reschedule_cuda


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeSet:
    """A receiver-sorted edge subset prepared for the GAS kernels.

    Padded to a multiple of ``EDGE_BLOCK`` (always >= one block, so E == 0
    degenerates to one all-padding block): pad senders are 0, pad receivers
    ``n_vertices + ROW_BLOCK`` (outside every row block) — the JAX
    package's convention, kept so both packages hold the same arrays.  The
    CUDA kernels read the real edges through ``segments`` (the rows that own
    an edge, cut into segments, on the device: tables of the subset's size,
    so a color's subset costs nothing per vertex) and never touch the pads.
    A subset built with ``cuts`` (the full set's segment of each of its
    edges) is cut at the full set's segment boundaries, so a scatter over
    it adds in the full set's order.
    ``row_ptr`` gives the CSR offsets [N+1] on the host, on first use.
    ``eblk_start``/``n_eblk``/``max_eblk`` are the JAX kernels' block
    offsets (host numpy; no CUDA kernel needs them).  ``perm`` maps the
    subset back into the *full* edge arrays.  ``block_counts[i]`` is the
    number of real subset edges whose receiver lies in row block i — the
    edges-touched accounting unit.
    """

    n_vertices: int
    n_edges: int                      # real (unpadded) subset size
    senders: torch.Tensor             # [E_pad] i32
    receivers: torch.Tensor           # [E_pad] i32, non-decreasing
    segments: RowSegments             # row segments on the device
    eblk_start: np.ndarray            # [n_row_blocks] i32
    n_eblk: np.ndarray                # [n_row_blocks] i32 (>= 1)
    max_eblk: int
    block_counts: torch.Tensor        # [n_row_blocks] i64
    perm: Optional[torch.Tensor] = None   # [E] i64 into full edge arrays

    @property
    def n_row_blocks(self) -> int:
        return max(-(-self.n_vertices // ROW_BLOCK), 1)

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @functools.cached_property
    def row_ptr(self) -> np.ndarray:
        """[N+1] i32 CSR offsets of the real edges (host)."""
        recv = self.receivers[:self.n_edges].cpu().numpy()
        return np.searchsorted(recv, np.arange(self.n_vertices + 1)).astype(
            np.int32)

    @staticmethod
    def build(
        senders: np.ndarray,
        receivers: np.ndarray,
        n_vertices: int,
        perm: Optional[np.ndarray] = None,
        *,
        cuts: Optional[np.ndarray] = None,
        device: DeviceLike = "cuda",
    ) -> "EdgeSet":
        from repro_torch.core.graph import csr_block_offsets

        dev = resolve_device(device)
        senders = np.asarray(senders, np.int32)
        receivers = np.asarray(receivers, np.int32)
        if senders.shape != receivers.shape or senders.ndim != 1:
            raise ValueError("senders/receivers must be equal-length 1D")
        if receivers.size and not (np.diff(receivers) >= 0).all():
            raise ValueError("receivers must be sorted")
        E = int(senders.size)
        e_pad = max(-(-E // EDGE_BLOCK), 1) * EDGE_BLOCK
        if e_pad >= 2 ** 31:
            raise ValueError(f"{E} edges exceed the kernels' int32 offsets")
        pad_r = np.int32(n_vertices + ROW_BLOCK)
        s = np.concatenate([senders, np.zeros(e_pad - E, np.int32)])
        r = np.concatenate([receivers, np.full(e_pad - E, pad_r, np.int32)])
        start, n_eblk, max_eblk = csr_block_offsets(
            r, n_vertices, ROW_BLOCK, EDGE_BLOCK)
        nblk = start.shape[0]
        counts = np.bincount(
            np.minimum(receivers // ROW_BLOCK, nblk - 1), minlength=nblk
        ) if E else np.zeros(nblk)
        segments = RowSegments.build(receivers, n_vertices, dev, cuts)

        def t(a, dtype):
            return torch.from_numpy(np.asarray(a, dtype)).to(dev)

        return EdgeSet(
            n_vertices=int(n_vertices), n_edges=E,
            senders=t(s, np.int32), receivers=t(r, np.int32),
            segments=segments,
            eblk_start=start, n_eblk=n_eblk, max_eblk=max_eblk,
            block_counts=t(counts, np.int64),
            perm=None if perm is None else t(perm, np.int64))


def active_row_blocks(mask: torch.Tensor,
                      row_block: int = ROW_BLOCK) -> torch.Tensor:
    """[N] scheduler mask → [n_row_blocks] i32 bitmap (1 ⇔ any active)."""
    n = mask.shape[0]
    nblk = max(-(-n // row_block), 1)
    m = torch.nn.functional.pad(mask.to(torch.int32),
                                (0, nblk * row_block - n))
    return m.reshape(nblk, row_block).amax(dim=1)


def _padded(w: torch.Tensor, e_pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(w, (0, e_pad - w.shape[0]))


def gather_combine(
    feat: torch.Tensor,             # [N, D] per-vertex source features
    weights: torch.Tensor,          # [E] or [E_pad] per-edge scalars
    edges: EdgeSet,
    *,
    block_active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused ``acc[v] = Σ_{u→v} w_e · feat[u]`` over ``edges`` → [N, D]."""
    if feat.ndim != 2:
        raise ValueError(f"feat must be [N, D], got {tuple(feat.shape)}")
    e_pad = edges.senders.shape[0]
    if weights.shape[0] not in (edges.n_edges, e_pad):
        raise ValueError(f"weights have {weights.shape[0]} rows for "
                         f"{edges.n_edges} edges")
    w = weights.to(torch.float32)
    if feat.is_cuda:
        return gas_gather_combine_cuda(
            feat.to(torch.float32).contiguous(), w.contiguous(),
            edges.senders, edges.segments,
            None if block_active is None
            else block_active.to(torch.int32).contiguous())
    return gather_combine_ref(
        feat, _padded(w, e_pad), edges.senders, edges.receivers,
        edges.n_vertices, block_active, segments=edges.segments)


@dataclasses.dataclass(frozen=True, eq=False)
class ScatterCtx:
    """How an engine wants one phase's reschedule scatter fused: the
    prepared edge set and optional per-edge weights (None means all real
    edges weigh 1; a subset's weights are the full set's ``[perm]``).

    The set must hold every edge whose sender can contribute a nonzero
    term: the full out-edge structure in general.  Subsets by *receiver*
    color would drop deposits; a subset by *sender* color, cut at the full
    set's segments (``EdgeSet.build(..., cuts=...)``), drops only the exact
    ``+0`` terms of senders outside the phase's color, and its sums equal
    the full set's to the bit (``ChromaticEngine``)."""

    edges: EdgeSet
    weights: Optional[torch.Tensor] = None   # [E] or [E_pad]; None = ones


def scatter_reschedule(
    contrib: torch.Tensor,          # [N_src] per-source contribution
    prio: torch.Tensor,             # [N] current priorities
    consume: torch.Tensor,          # [N] bool — executed this phase
    edges: EdgeSet,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused ``where(consume, 0, prio) + Σ_{u→v} w_e · contrib[u]`` → [N]:
    the scheduler update of a GAS phase without the per-edge float gather
    and the dense scatter-add temp."""
    e_pad = edges.senders.shape[0]
    if contrib.is_cuda:
        return gas_scatter_reschedule_cuda(
            contrib.to(torch.float32).contiguous(),
            prio.to(torch.float32).contiguous(),
            consume.to(torch.bool).contiguous(), edges.senders,
            edges.segments,
            None if weights is None
            else weights.to(torch.float32).contiguous())
    w = torch.ones(e_pad, dtype=torch.float32) if weights is None \
        else _padded(weights.to(torch.float32), e_pad)
    return scatter_reschedule_ref(contrib, prio, consume, w, edges.senders,
                                  edges.receivers, edges.n_vertices,
                                  segments=edges.segments)
