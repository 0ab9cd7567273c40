"""The collectives of the distributed engines, behind one interface.

The JAX package runs each machine as one slice of a device mesh under
``shard_map`` and exchanges ghost rows with ``lax.all_to_all`` and sync-op
partials with ``lax.psum``.  The port writes its engines over *the machines
held here* and asks an ``Exchange`` for those two collectives:

  ``all_to_all(rows, budget)``  rows ``[M·S·B, ...]``, machine-major: held
                                machine m's slab for destination d, slot b,
                                at ``(m·S + d)·B + b``.  Returns the rows
                                each held machine receives, in the same
                                layout with source and destination swapped
                                — exactly a ghost cache ``[M·(S·B), ...]``.
  ``psum(x)``                   ``x [M, ...]``, one partial a held machine
                                → the sum over every machine of the
                                cluster, the same on each.

State stays machine-major, as the JAX package's global arrays under
``P("data")`` are: ``[S·n_loc, ...]`` own rows, ``[S·S·B, ...]`` ghosts.

``InProcessExchange`` holds all S machines in one process (on one card or
on the CPU): ``all_to_all`` is a swap of the source and destination axes of
``[S, S, B, ...]`` and ``psum`` a sum over the machine axis.  A
process-group backend (one machine a rank, ``all_to_all_single`` and
``all_reduce``) implements the same two calls with ``machines = (rank,)``;
the engines do not change.
"""
from __future__ import annotations

from typing import Sequence

import torch


class Exchange:
    """The interface: a cluster of ``n_machines`` machines, of which this
    process holds ``machines`` (ascending ids)."""

    n_machines: int
    machines: Sequence[int]

    @property
    def n_held(self) -> int:
        return len(self.machines)

    def all_to_all(self, rows: torch.Tensor, budget: int) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class InProcessExchange(Exchange):
    """All S machines in this process: the collectives are tensor moves."""

    def __init__(self, n_machines: int):
        if int(n_machines) < 1:
            raise ValueError(f"n_machines must be >= 1, got {n_machines}")
        self.n_machines = int(n_machines)
        self.machines = tuple(range(self.n_machines))

    def all_to_all(self, rows: torch.Tensor, budget: int) -> torch.Tensor:
        S = self.n_machines
        trailing = rows.shape[1:]
        x = rows.reshape((S, S, budget) + trailing).transpose(0, 1)
        return x.reshape((S * S * budget,) + trailing)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x, dim=0)

    def __repr__(self) -> str:
        return f"InProcessExchange(n_machines={self.n_machines})"
