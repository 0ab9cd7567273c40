"""BSP / Pregel-style baseline engine (paper Sec. 2, Table 1, Sec. 5).

Runs the *same* VertexProgram Jacobi-style: every scheduled vertex updates
simultaneously from the **previous** superstep's values, and the message
volume it accounts is O(Σ deg(active)) — each active vertex ships its value
down every out-edge, the inefficiency the paper attributes to the
message-passing model (Sec. 5.1).  It exists so the paper's claims are
measured against the abstraction they were made against (Fig. 1(a)/9(a)).
"""
from __future__ import annotations

import torch

from repro_torch.core.engine_base import Engine, EngineState
from repro_torch.core.tree import tree_leaves


class BSPEngine(Engine):
    """Synchronous Jacobi execution of a VertexProgram: the scheduler is a
    single-color sweep (``Engine``'s default), so every scheduled vertex
    updates simultaneously against the previous barrier's data.

    BSP is *not* serializable for programs whose correctness needs edge
    consistency (paper Fig. 1(d)); it is the vertex consistency model with
    stale reads.  That is the point.
    """

    def message_bytes_per_step(self, state: EngineState) -> torch.Tensor:
        """Pregel-model traffic: every active vertex emits its vertex data
        along each out-edge (O(|E|) state expansion, paper Sec. 5)."""
        active = state.prio > self.tolerance
        vbytes = sum(x.element_size() * (x.numel() // x.shape[0])
                     for x in tree_leaves(state.graph.vertex_data))
        deg = self.structure.device_arrays()["out_degree"]
        return torch.sum(torch.where(active, deg, torch.zeros_like(deg))
                         ) * vbytes
