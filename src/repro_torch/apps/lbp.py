"""Loopy Belief Propagation on a pairwise MRF (paper Secs. 4.2.2, 5.2).

The paper's synthetic evaluation: a 26-connected 3D grid interpreted as an
MRF; CoSeg uses K-state LBP with the residual-prioritized schedule of
Elidan et al. [11] on the locking engine.

Representation (log domain):
  vertex data: unary [K] (log potential), belief [K]
  edge data:   message [K] — m_{u->v} lives on directed edge u->v

Update at v (classic BP, all within the scope S_v):
  gather : incoming messages m_{u->v}                       (sum over in-edges)
  apply  : belief_v = normalize(unary_v + acc)
  edge_out (for out-edge v->u):
           m'_{v->u}[j] = logsumexp_i(pairwise[i,j] + unary_v[i]
                                      + acc_v[i] - m_{u->v}[i])
  (the cavity term m_{u->v} is read from the reverse edge — this is why the
  data graph carries ``reverse_perm``).

Writing outgoing messages is an adjacent-edge write, so LBP never fuses: it
always takes the dense apply phase (and the sorted segment-sum kernel).
"""
from __future__ import annotations

from itertools import product

import numpy as np
import torch

from repro_torch.core.consistency import Consistency
from repro_torch.core.graph import DataGraph, GraphStructure
from repro_torch.core.update import ApplyOut, EdgeCtx, VertexProgram


def _normalize_log(x: torch.Tensor) -> torch.Tensor:
    return x - torch.logsumexp(x, dim=-1, keepdim=True)


class LoopyBPProgram(VertexProgram):
    combiner = "sum"
    consistency = Consistency.EDGE
    schedule_neighbors = True
    has_edge_out = True

    def __init__(self, n_states: int, smoothing: float = 2.0):
        self.k = int(n_states)
        # Potts pairwise potential: log phi(i,j) = -smoothing * [i != j]
        self.pairwise = -smoothing * (1.0 - np.eye(self.k, dtype=np.float32))

    def gather(self, ctx: EdgeCtx):
        return ctx.edata["msg"]  # [E, K] incoming message sum

    def apply(self, vertex_data, acc, glob=None) -> ApplyOut:
        belief = _normalize_log(vertex_data["unary"] + acc)
        residual = torch.sum(torch.abs(belief - vertex_data["belief"]),
                             dim=-1)
        return ApplyOut(
            {"unary": vertex_data["unary"], "belief": belief}, residual)

    def edge_out(self, ctx: EdgeCtx, new_src, src_acc):
        # cavity: all incoming to src except the reverse of this edge
        cavity = new_src["unary"] + src_acc - ctx.rev_edata["msg"]  # [E, K]
        pw = torch.as_tensor(self.pairwise, dtype=cavity.dtype,
                             device=cavity.device)                  # [K, K]
        m = torch.logsumexp(cavity[:, :, None] + pw[None, :, :],
                            dim=1)                                  # [E, K]
        return {"msg": _normalize_log(m)}


def make_mrf_graph(
    structure: GraphStructure,
    n_states: int = 2,
    unary_strength: float = 1.0,
    seed: int = 0,
    dtype=torch.float32,
) -> DataGraph:
    """Random-unary MRF over any symmetric structure (paper: the 3D grid),
    on the structure's device."""
    if not structure.is_symmetric():
        raise ValueError("LBP needs reverse edges (messages)")
    rng = np.random.default_rng(seed)
    n, e, k = structure.n_vertices, structure.n_edges, n_states
    unary = rng.normal(0, unary_strength, size=(n, k)).astype(np.float32)
    unary -= unary.max(axis=1, keepdims=True)
    belief = unary - np.log(np.exp(unary).sum(1, keepdims=True))
    vdata = {"unary": torch.from_numpy(unary).to(dtype),
             "belief": torch.from_numpy(belief).to(dtype)}
    edata = {"msg": torch.zeros((e, k), dtype=dtype)}
    return DataGraph.build(structure, vdata, edata)


def lbp_map_labels(graph: DataGraph) -> np.ndarray:
    return torch.argmax(graph.vertex_data["belief"], dim=-1).cpu().numpy()


def exact_marginals_chain(unary: np.ndarray, pairwise: np.ndarray):
    """Brute-force chain/tree oracle for tests (small K^N enumeration)."""
    n, k = unary.shape
    if n > 12:
        raise ValueError("exact_marginals_chain enumerates K^N; keep N <= 12")
    logp = []
    for assign in product(range(k), repeat=n):
        lp = sum(unary[i, assign[i]] for i in range(n))
        lp += sum(pairwise[assign[i], assign[i + 1]] for i in range(n - 1))
        logp.append(lp)
    logp = np.asarray(logp).reshape((k,) * n)
    p = np.exp(logp - logp.max())
    p /= p.sum()
    marginals = np.zeros((n, k))
    for i in range(n):
        axes = tuple(j for j in range(n) if j != i)
        marginals[i] = p.sum(axis=axes)
    return marginals
