"""The Chromatic Engine (paper Sec. 4.2.1).

Given a proper coloring of the data graph, executing all scheduled vertices
of one color simultaneously satisfies the edge consistency model; the sweep
over colors is a sequence of **color-steps** (the paper's analogy to BSP
super-steps).  Full consistency uses a distance-2 coloring, vertex
consistency a single color.  Within a step, updates read the freshest data
(Gauss-Seidel across colors), which buys the asynchronous convergence of
Fig. 1(a) relative to the Jacobi BSP engine.

Fused path: for fuseable programs each color owns a **per-color edge
range** — the receiver-sorted edges whose receiver has that color,
prepared on the host — so a color-step reads only E_c edges (Σ_c E_c = E
per sweep), and the active-block bitmap prunes further as T drains.
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
from repro_torch.kernels.gas.ops import EdgeSet


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
        if self.use_fused:
            st = graph.structure
            # one stable sort by receiver color gives every color's edge
            # indices, ascending (so still receiver-sorted)
            recv_color = colors[st.receivers]
            by_color = np.argsort(recv_color, kind="stable").astype(np.int32)
            bounds = np.concatenate([[0], np.cumsum(np.bincount(
                recv_color, minlength=self.num_colors))])
            self._color_edges = []
            for c in range(self.num_colors):
                idx = by_color[bounds[c]:bounds[c + 1]]
                self._color_edges.append(EdgeSet.build(
                    st.senders[idx], st.receivers[idx], st.n_vertices,
                    perm=idx, device=st.device))

    def _phase_edges(self, phase: int) -> Optional[EdgeSet]:
        """Per-color edge range: a color-step reads only the receiver-sorted
        edges whose receiver has that color."""
        return self._color_edges[phase] if self._color_edges else None
