"""The Chromatic Engine (paper Sec. 4.2.1).

Given a proper coloring of the data graph, executing all scheduled vertices
of one color simultaneously satisfies the edge consistency model; the sweep
over colors is a sequence of **color-steps** (the paper's analogy to BSP
super-steps).  Full consistency uses a distance-2 coloring, vertex
consistency a single color.  Within a step, updates read the freshest data
(Gauss-Seidel across colors), which buys the asynchronous convergence of
Fig. 1(a) relative to the Jacobi BSP engine.

Fused path: for fuseable programs each color owns two **per-color edge
subsets**, prepared on the host, so a color-step reads only E_c edges in
each (Σ_c E_c = E per sweep):

- the gather reads the receiver-sorted edges whose *receiver* has that
  color (whole rows), and the active-block bitmap prunes further as T
  drains;
- the reschedule scatter reads the edges whose *sender* has that color.
  Only the phase's color executes, so every other sender contributes an
  exact ``+0``; the subset is cut at the full edge set's segment
  boundaries, so it adds the full set's nonzero terms in the full set's
  order and its output equals the full set's to the bit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.coloring import coloring_for, verify_coloring
from repro_torch.core.engine_base import Engine
from repro_torch.core.graph import DataGraph
from repro_torch.core.scheduler import SweepScheduler
from repro_torch.core.sync_op import SyncOp
from repro_torch.core.update import VertexProgram
from repro_torch.kernels.csr import edge_segments
from repro_torch.kernels.gas.ops import EdgeSet, ScatterCtx


class ChromaticEngine(Engine):
    """One engine step = one sweep, one ``SweepScheduler`` phase per color
    (paper: T is drained color by color; the sync operation runs safely
    between color-steps)."""

    def __init__(
        self,
        program: VertexProgram,
        graph: DataGraph,
        colors: Optional[np.ndarray] = None,
        tolerance: float = 1e-3,
        sync_ops: Sequence[SyncOp] = (),
        *,
        use_fused: Optional[bool] = None,
        device="cuda",
    ):
        if colors is None:
            colors = coloring_for(graph.structure, program.consistency)
        colors = np.asarray(colors, dtype=np.int32)
        radius = program.consistency.exclusion_radius
        if radius >= 1 and not verify_coloring(graph.structure, colors,
                                               radius):
            raise ValueError(
                f"coloring does not satisfy {program.consistency} "
                f"(radius {radius})")
        super().__init__(
            program, graph, tolerance, sync_ops,
            scheduler=SweepScheduler(program, graph.structure, tolerance,
                                     colors),
            use_fused=use_fused, device=device)
        self.colors = self.scheduler.colors
        self.num_colors = self.scheduler.num_phases

        self._color_edges: Optional[list] = None
        self._scatter_edges: Optional[list] = None
        if self.use_fused:
            st = graph.structure
            self._color_edges = self._subsets(colors[st.receivers])
            if program.schedule_neighbors:
                self._scatter_edges = self._subsets(
                    colors[st.senders], cuts=edge_segments(st.receivers))

    def _subsets(self, edge_color: np.ndarray,
                 cuts: Optional[np.ndarray] = None) -> list:
        """One EdgeSet a color: the edges of that ``edge_color``.  One
        stable sort gives every color's edge indices, ascending (so still
        receiver-sorted); ``cuts`` (the full set's segment of each edge)
        cut each subset at the full set's segment boundaries."""
        st = self.structure
        by_color = np.argsort(edge_color, kind="stable").astype(np.int32)
        bounds = np.concatenate([[0], np.cumsum(np.bincount(
            edge_color, minlength=self.num_colors))])
        out = []
        for c in range(self.num_colors):
            idx = by_color[bounds[c]:bounds[c + 1]]
            out.append(EdgeSet.build(
                st.senders[idx], st.receivers[idx], st.n_vertices, perm=idx,
                cuts=None if cuts is None else cuts[idx], device=st.device))
        return out

    def _phase_edges(self, phase: int) -> Optional[EdgeSet]:
        """Per-color edge range: a color-step gathers only the
        receiver-sorted edges whose receiver has that color."""
        return self._color_edges[phase] if self._color_edges else None

    def _scatter_ctx(self, phase: int) -> Optional[ScatterCtx]:
        """A color-step scatters only the edges whose sender has that
        color: the other senders were not executed and contribute ``+0``.
        None off the fused path or where the program schedules no
        neighbors.  (No engine here passes scatter weights; a weighted
        scatter would take the full set's ``weights[perm]``.)"""
        if self._scatter_edges is None:
            return None
        return ScatterCtx(edges=self._scatter_edges[phase])
