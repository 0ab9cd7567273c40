"""The sync operation (paper Sec. 3.5): global aggregates.

``Z = Finalize( ⊕_{v∈V} Map(S_v) )`` — an associative-commutative sum over
all vertex scopes with a finalization phase (e.g. normalization), unlike
Pregel aggregates which lack Finalize.

The sync runs at engine-step barriers, which is always "consistent" in the
paper's terminology.  The "inconsistent" mode evaluates on the *previous*
step's data (stale reads), which is what a background sync racing with
updates observes.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.tree import tree_map

Pytree = Any


class SyncOp:
    """Subclass and override ``map_fn``/``finalize``; ⊕ is a tree-sum."""

    name: str = "sync"
    consistent: bool = True

    def map_fn(self, vertex_data: Pytree) -> Pytree:
        """Batched over the vertex axis: [N, ...] in, [N, ...] out."""
        raise NotImplementedError

    def finalize(self, z: Pytree, n_vertices: int) -> Pytree:
        return z

    def __call__(self, vertex_data: Pytree, n_vertices: int) -> Pytree:
        mapped = self.map_fn(vertex_data)
        z = tree_map(lambda m: torch.sum(m, dim=0), mapped)
        return self.finalize(z, n_vertices)


class FnSyncOp(SyncOp):
    """Convenience wrapper from plain callables."""

    def __init__(
        self,
        map_fn: Callable[[Pytree], Pytree],
        finalize: Optional[Callable[[Pytree, int], Pytree]] = None,
        name: str = "sync",
        consistent: bool = True,
    ):
        self._map = map_fn
        self._fin = finalize
        self.name = name
        self.consistent = consistent

    def map_fn(self, vertex_data):
        return self._map(vertex_data)

    def finalize(self, z, n_vertices):
        return self._fin(z, n_vertices) if self._fin is not None else z


def run_syncs(sync_ops, vertex_data, prev_vertex_data, n_vertices):
    """Evaluates all sync ops; inconsistent ones see the stale (previous
    barrier) data, reproducing a background sync racing with updates."""
    out = {}
    for op in sync_ops:
        data = vertex_data if op.consistent else prev_vertex_data
        out[op.name] = op(data, n_vertices)
    return out
