"""The Dynamic (locking) engine (paper Sec. 4.2.2).

The distributed locking engine gives GraphLab (a) **dynamically
prioritized** scheduling and (b) latency hiding through a **pipeline** of
in-flight lock requests of depth p.  The mechanism is adapted in bulk
while the observable semantics stay:

  - The priority queue is a priority tensor; each step executes the
    ``pipeline_length`` highest-priority scheduled vertices as one parallel
    step.  k = 1 is exact serial priority order; large k trades strict
    priority order for machine efficiency (Fig. 3(b)/8(b)).
  - Serializability: lock acquisition in canonical order collapses to one
    round of neighborhood arbitration — a selected vertex executes iff it
    holds the best rank in its exclusion neighborhood; losers keep their
    priority and retry next step, like a lock request still queued.
    ``serializable=False`` skips arbitration and races (Fig. 1(d)).

The machinery lives in ``core/scheduler.py`` as the ``PriorityScheduler``;
this engine binds it to the shared phase loop.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.engine_base import Engine, EngineState
from repro_torch.core.graph import DataGraph
from repro_torch.core.scheduler import PriorityScheduler
from repro_torch.core.sync_op import SyncOp
from repro_torch.core.tree import tree_leaves
from repro_torch.core.update import VertexProgram


class DynamicEngine(Engine):
    def __init__(
        self,
        program: VertexProgram,
        graph: DataGraph,
        pipeline_length: int = 1024,
        serializable: bool = True,
        tolerance: float = 1e-3,
        sync_ops: Sequence[SyncOp] = (),
        *,
        use_fused: Optional[bool] = None,
        device="cuda",
    ):
        super().__init__(
            program, graph, tolerance, sync_ops,
            scheduler=PriorityScheduler(program, graph.structure, tolerance,
                                        pipeline_length, serializable),
            use_fused=use_fused, device=device)
        self.pipeline_length = self.scheduler.pipeline_length
        self.serializable = self.scheduler.serializable

    def _select(self, prio: torch.Tensor) -> torch.Tensor:
        """Top-k scheduled vertices, then lock arbitration (if
        serializable)."""
        return self.scheduler.select((), prio)[0]

    def active_gather_bytes(self, state: EngineState) -> torch.Tensor:
        """Bytes a distributed run would move this step: only the *modified*
        vertices' data crosses the network ("each machine receives each
        modified vertex data at most once", Sec. 5.1) — value+index pairs of
        the active set, vs the BSP engine's per-edge emission."""
        mask = self._select(state.prio)
        vbytes = sum(x.element_size() * (x.numel() // x.shape[0])
                     for x in tree_leaves(state.graph.vertex_data))
        return torch.sum(mask) * (vbytes + 4)
