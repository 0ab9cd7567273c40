"""The wire of the versioned ghost exchange: the seed's f32 rows.

The JAX package's wire module also carries bf16 and int8 row codecs with
error feedback and top-k deferral (its DESIGN §3.14).  The port has only
the default wire so far: every shipped row is the f32 (or stored-dtype)
row itself.  ``WireConfig`` accepts exactly that configuration and raises
on any other, naming the queue item that ports the rest (ROADMAP A9).

``payload_row_nbytes`` prices a shipped row so ``DistState.traffic_bytes_*``
can account bytes, not rows.  Arbitration ranks (``dist/locking.py``) are
exact small integers ``slot * S + machine``; ``encode_rank`` and
``decode_rank`` narrow them losslessly to int16 with +inf mapped to a
sentinel (a narrowed-rank wire is a non-default wire, so the port's
locking engine ships f32 ranks; the codec is here for the wire to come).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves

Pytree = Any

#: row codecs the port ships; the JAX package's bf16 and int8 are ROADMAP A9
CODECS = ("f32",)

# int16 rank sentinel for +inf (an unselected vertex / empty neighborhood)
RANK_INF = np.int16(32767)


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """Per-engine wire protocol selection (the JAX package's fields).

    Only the default, ``codec="f32"`` with ``top_k=None``, exists in the
    port: it ships each changed row as it is stored.  Any other codec or a
    ``top_k`` raises."""

    codec: str = "f32"
    top_k: Optional[int] = None
    error_feedback: bool = True
    wire_tol: Optional[float] = None

    def __post_init__(self):
        if self.codec not in CODECS or self.top_k is not None:
            raise NotImplementedError(
                f"wire codec={self.codec!r}, top_k={self.top_k!r}: the port "
                f"ships only the default f32 wire; the quantized wire "
                f"(bf16/int8 rows, error feedback, top-k) is ROADMAP A9")

def payload_row_nbytes(tree: Pytree) -> int:
    """Bytes per shipped row of a payload pytree — itemsize x trailing
    components, summed over leaves.  The 1-bit ship bitmap the exchange
    sends alongside (``recv_changed``) is not counted, matching the row
    counters which never counted it either."""
    total = 0
    for leaf in tree_leaves(tree):
        trailing = 1
        for d in leaf.shape[1:]:
            trailing *= int(d)
        total += leaf.element_size() * trailing
    return int(total)


# -- arbitration rank narrowing (lossless) ---------------------------------

def rank_codec_fits(max_rank: int) -> bool:
    """True iff every finite rank is strictly below the int16 sentinel."""
    return int(max_rank) < int(RANK_INF)


def encode_rank(rank: torch.Tensor) -> torch.Tensor:
    """f32 ranks (small exact integers or +inf) -> int16, inf -> sentinel."""
    return torch.where(torch.isfinite(rank), rank,
                       torch.full_like(rank, float(RANK_INF))).to(torch.int16)


def decode_rank(q: torch.Tensor) -> torch.Tensor:
    """int16 -> f32 ranks, sentinel -> +inf.  Exact: ranks are integers
    below 2**15, far inside f32 integer precision."""
    return torch.where(q == int(RANK_INF),
                       torch.full(q.shape, torch.inf, device=q.device),
                       q.to(torch.float32))
