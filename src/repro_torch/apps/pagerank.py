"""PageRank as a GraphLab program (paper Ex. 1-3, Alg. 1).

    R(v) = alpha/n + (1 - alpha) * sum_{u->v} w_{u,v} R(u)

Vertex data: rank R(v).  Edge data: weight w_{u,v} (out-normalized).  The
update is adaptive exactly as Alg. 1: neighbors are scheduled only when the
rank changes by more than the tolerance — which produces the Fig. 1(b)
update-count skew (most vertices converge after one update).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.consistency import Consistency
from repro_torch.core.graph import DataGraph, GraphStructure
from repro_torch.core.update import (ApplyOut, EdgeCtx, FusedGather,
                                     VertexProgram)


class PageRankProgram(VertexProgram):
    combiner = "sum"
    consistency = Consistency.EDGE  # Eq. 1 needs read-only neighbor access
    schedule_neighbors = True

    def __init__(self, alpha: float = 0.15, n_vertices: int = 1):
        self.alpha = float(alpha)
        self.n = int(n_vertices)

    def gather(self, ctx: EdgeCtx):
        # w_{u,v} * R(u)
        return ctx.edata["w"] * ctx.src["rank"]

    def fused_gather(self):
        # the same message, computed inside the gather⊕combine kernel
        return FusedGather("weighted_src_sum",
                           feature=lambda v: v["rank"],
                           weight=lambda e: e["w"])

    def apply(self, vertex_data, acc, glob=None) -> ApplyOut:
        new_rank = self.alpha / self.n + (1.0 - self.alpha) * acc
        residual = torch.abs(new_rank - vertex_data["rank"])
        return ApplyOut({"rank": new_rank}, residual)


def make_pagerank_graph(structure: GraphStructure,
                        dtype=torch.float32) -> DataGraph:
    """Out-degree-normalized weights; uniform initial rank.  The graph
    lives on the structure's device."""
    n = structure.n_vertices
    out_deg = np.maximum(structure.out_degree[structure.senders], 1)
    w = (1.0 / out_deg).astype(np.float32)
    vdata = {"rank": torch.full((n,), 1.0 / n, dtype=dtype)}
    edata = {"w": torch.from_numpy(w).to(dtype)}
    return DataGraph.build(structure, vdata, edata)


def exact_pagerank(structure: GraphStructure, alpha: float = 0.15,
                   iters: int = 200) -> np.ndarray:
    """Dense power-iteration oracle (float64, host) for L1-error traces
    (Fig. 1(a))."""
    n = structure.n_vertices
    w = 1.0 / np.maximum(structure.out_degree[structure.senders], 1)
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        acc = np.zeros(n)
        np.add.at(acc, structure.receivers, w * r[structure.senders])
        r = alpha / n + (1 - alpha) * acc
    return r
