"""Update functions (paper Sec. 3.2) in gather/apply/scatter form.

A GraphLab update function ``f(v, S_v) -> (S_v, T)`` reads the scope of a
vertex, writes its own vertex data and adjacent edge data, and schedules
future work.  It is decomposed structurally:

  gather   : per-edge message from (edge data, src vertex, dst vertex)
  combine  : ⊕ over in-edges (segment op)
  apply    : new vertex data + a scalar *residual* from (vertex, accumulator)
  edge_out : optional — new data for adjacent edges (LBP messages live here)
  priority : residual -> priority contribution scattered to neighbors (T')

The decomposition *enforces* the edge consistency model: writes are limited
to the central vertex and adjacent edges, reads to the scope.  Programs that
need full consistency declare it via ``consistency`` and the engines run
them under a distance-2 coloring / distance-2 exclusion instead.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.consistency import Consistency
from repro_torch.core.tree import tree_flatten, tree_map

Pytree = Any


# ---------------------------------------------------------------------------
# Fuseable gather registry
# ---------------------------------------------------------------------------

#: The gather shapes the fused gather⊕combine kernel computes.  Every kind
#: reduces to ``acc[v] = Σ_{u→v} w_e · feature(u)`` for a per-vertex feature
#: table and a per-edge scalar weight — the [E, D] messages never exist:
#:   weighted_src_sum      w_e = ``weight(edge_data)``
#:   src_copy              w_e = 1
#:   degree_normalized_src w_e = 1 / max(out_degree(u), 1)
FUSED_GATHER_KINDS = ("weighted_src_sum", "src_copy", "degree_normalized_src")


class FusedGather(NamedTuple):
    """Declares one ``gather`` output leaf as a registry op.

    ``feature`` maps vertex data to a per-vertex tensor ``[N, ...]`` (any
    trailing shape — flattened for the kernel, restored on the accumulator);
    ``weight`` maps edge data to a per-edge scalar ``[E]``
    (``weighted_src_sum`` only).  The declaration must compute exactly what
    ``gather`` computes — engines fuse it, tests cross-check the two.
    """

    kind: str
    feature: Callable[[Pytree], torch.Tensor]
    weight: Optional[Callable[[Pytree], torch.Tensor]] = None


def fused_gather_leaves(program) -> Optional[Tuple[list, Any]]:
    """Flattens ``program.fused_gather()`` into (leaves, treedef), validating
    each leaf against the registry; None when the program stays dense."""
    spec = program.fused_gather()
    if spec is None:
        return None
    leaves, treedef = tree_flatten(
        spec, is_leaf=lambda x: isinstance(x, FusedGather))
    for leaf in leaves:
        if not isinstance(leaf, FusedGather):
            raise TypeError(f"fused_gather leaves must be FusedGather, "
                            f"got {type(leaf).__name__}")
        if leaf.kind not in FUSED_GATHER_KINDS:
            raise ValueError(f"unknown fused gather kind {leaf.kind!r} "
                             f"(registry: {FUSED_GATHER_KINDS})")
        if leaf.kind == "weighted_src_sum" and leaf.weight is None:
            raise ValueError("weighted_src_sum needs a weight fn")
    return leaves, treedef


def supports_fused_gather(program) -> bool:
    """The fallback rule: a program runs the fused GAS path iff it declares
    registry gathers, ⊕ is sum, and it never writes adjacent edges."""
    return (program.combiner == "sum" and not program.has_edge_out
            and program.fused_gather() is not None)


def fused_edge_weight(leaf: FusedGather, edge_data: Pytree, n_edges: int,
                      src_deg: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
    """Per-edge scalar weight [E] (f32) for a registry leaf.

    ``src_deg`` (out-degree of each edge's source) is only consulted by
    ``degree_normalized_src``."""
    if leaf.kind == "weighted_src_sum":
        return leaf.weight(edge_data).to(torch.float32)
    if leaf.kind == "src_copy":
        return torch.ones(n_edges, dtype=torch.float32, device=device)
    if leaf.kind == "degree_normalized_src":
        if src_deg is None:
            raise ValueError("degree_normalized_src needs src_deg")
        return 1.0 / torch.clamp(src_deg.to(torch.float32), min=1.0)
    raise ValueError(leaf.kind)


class EdgeCtx:
    """Per-edge context handed to ``gather`` / ``edge_out``.

    Fields: ``edata`` (this directed edge's data), ``rev_edata`` (the
    reverse edge's data, zeros where it is absent), ``src`` / ``dst`` (the
    source / destination vertex data), ``src_deg`` ([E] out-degree of the
    source) and ``dst_deg`` ([E] in-degree of the destination).  Each view
    is gathered on first read: PyTorch runs eagerly, so a view no program
    reads would otherwise cost a full [E, ...] gather.
    """

    def __init__(self, graph):
        self._graph = graph
        self._t = graph.structure.device_arrays()

    @property
    def edata(self) -> Pytree:
        return self._graph.edge_data

    @functools.cached_property
    def rev_edata(self) -> Pytree:
        rp = self._t["reverse_perm"]
        rp_safe = torch.clamp(rp, min=0)
        has_rev = rp >= 0

        def _rev(x):
            y = x[rp_safe]
            mask = has_rev.reshape((-1,) + (1,) * (y.ndim - 1))
            return torch.where(mask, y, torch.zeros_like(y))

        return tree_map(_rev, self._graph.edge_data)

    @functools.cached_property
    def src(self) -> Pytree:
        s = self._t["senders"]
        return tree_map(lambda x: x[s], self._graph.vertex_data)

    @functools.cached_property
    def dst(self) -> Pytree:
        r = self._t["receivers"]
        return tree_map(lambda x: x[r], self._graph.vertex_data)

    @functools.cached_property
    def src_deg(self) -> torch.Tensor:
        return self._t["out_degree"][self._t["senders"]]

    @functools.cached_property
    def dst_deg(self) -> torch.Tensor:
        return self._t["in_degree"][self._t["receivers"]]


class FixedEdgeCtx(NamedTuple):
    """An ``EdgeCtx`` whose views are given, not gathered from a graph:
    the distributed engines' per-machine edge rows and the sequential
    engine's one scope.  Same fields as ``EdgeCtx``."""

    edata: Pytree
    rev_edata: Pytree
    src: Pytree
    dst: Pytree
    src_deg: torch.Tensor
    dst_deg: torch.Tensor


class ApplyOut(NamedTuple):
    vertex_data: Pytree     # new data for the central vertex
    residual: torch.Tensor  # [N] — drives adaptive scheduling (|ΔR| etc.)


class VertexProgram:
    """Base class for GraphLab programs.  All methods are batched over
    tensors.  ``combiner`` is the ⊕ of the paper's sync/gather semantics."""

    combiner: str = "sum"
    consistency: Consistency = Consistency.EDGE
    # When True the engines scatter each vertex's residual to its neighbors'
    # priorities (the adaptive "schedule neighbors on big change" pattern of
    # Alg. 1).
    schedule_neighbors: bool = True

    # -- gather ---------------------------------------------------------------
    def gather(self, ctx: EdgeCtx) -> Pytree:
        """Per-edge message; combined with ``combiner`` into acc[dst]."""
        raise NotImplementedError

    def fused_gather(self) -> Optional[Pytree]:
        """Optional: declare ``gather`` as a pytree of ``FusedGather``
        registry ops (same tree structure as the gather output).  Engines
        then run the fused gather⊕combine kernel instead of materializing
        ``edge_ctx``.  None (default) keeps the dense path."""
        return None

    def zero_acc(self, vertex_data: Pytree) -> Pytree:
        """Accumulator for isolated vertices (segment-sum default: zeros)."""
        return None

    # -- apply ---------------------------------------------------------------
    def apply(self, vertex_data: Pytree, acc: Pytree,
              glob: Pytree = None) -> ApplyOut:
        """``glob`` carries the sync operation's global values (Sec. 3.5):
        update functions may *read* globals; only sync ops write them."""
        raise NotImplementedError

    # -- optional edge writes (adjacent-edge mutation, e.g. BP messages) -----
    has_edge_out: bool = False

    # Whether gather/edge_out read ``ctx.rev_edata``; None means "if
    # has_edge_out".  Shared-memory engines always supply real rev_edata.
    reads_rev_edata: Optional[bool] = None

    def edge_out(self, ctx: EdgeCtx, new_src: Pytree,
                 src_acc: Pytree) -> Pytree:
        """New data for edge (src -> dst), given src's freshly applied data
        and src's accumulator.  Only edges whose *source* vertex was updated
        are written back (the update at v owns its adjacent edges)."""
        raise NotImplementedError

    # -- scheduling -----------------------------------------------------------
    def priority(self, residual: torch.Tensor) -> torch.Tensor:
        """Priority contribution scattered to neighbors of updated vertices."""
        return residual

    # -- init -----------------------------------------------------------------
    def initial_priority(self, n_vertices: int,
                         device=None) -> torch.Tensor:
        return torch.ones(n_vertices, dtype=torch.float32, device=device)


def edge_ctx(graph) -> EdgeCtx:
    """Builds the per-edge context from a DataGraph (reads only)."""
    return EdgeCtx(graph)


def masked_update(old: Pytree, new: Pytree, mask: torch.Tensor) -> Pytree:
    """where(mask, new, old) broadcast over trailing dims of each leaf."""

    def _one(o, n):
        m = mask.reshape((-1,) + (1,) * (o.ndim - 1))
        return torch.where(m, n.to(o.dtype), o)

    return tree_map(_one, old, new)
