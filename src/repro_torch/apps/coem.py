"""CoEM for Named Entity Recognition (paper Sec. 5.3).

Bipartite graph: noun-phrases <-> contexts, edge weight = co-occurrence
count.  Starting from a small labeled seed set, CoEM alternates between
estimating each noun-phrase's type distribution from its contexts and each
context's distribution from its noun-phrases:

    p_v = normalize( sum_{u in N(v)} w_uv * p_u )        (v not a seed)

Vertex data: type distribution [K] + seed flag (seeds never change — in the
paper they anchor the labels).  The paper stresses this app's profile:
**very light compute per byte** (5.7x fewer cycles/byte than ALS at d=5),
large vertex data (816 B = 204 f32 types), dense bipartite structure, random
partitioning — the communication-bound worst case of Fig. 6(b).  The
per-update FLOP count here is O(deg * K), matching that profile.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.consistency import Consistency
from repro_torch.core.graph import DataGraph, GraphStructure
from repro_torch.core.keysort import unique_counts
from repro_torch.core.update import (ApplyOut, EdgeCtx, FusedGather,
                                     VertexProgram)
from repro_torch.device import DeviceLike, resolve_device


class CoEMProgram(VertexProgram):
    combiner = "sum"
    consistency = Consistency.EDGE
    schedule_neighbors = True

    def __init__(self, n_types: int):
        self.k = int(n_types)

    def gather(self, ctx: EdgeCtx):
        return ctx.edata["w"][:, None] * ctx.src["p"]  # [E, K]

    def fused_gather(self):
        # the [E, K] messages of the paper's communication-bound worst case
        # (816 B vertex data) are never made: one gather⊕combine at D = K
        return FusedGather("weighted_src_sum",
                           feature=lambda v: v["p"],
                           weight=lambda e: e["w"])

    def apply(self, vertex_data, acc, glob=None) -> ApplyOut:
        total = torch.sum(acc, dim=-1, keepdim=True)
        new_p = acc / torch.clamp(total, min=1e-12)
        seed = vertex_data["seed"][:, None]
        new_p = torch.where(seed > 0.5, vertex_data["p"], new_p)
        residual = torch.sum(torch.abs(new_p - vertex_data["p"]), dim=-1)
        return ApplyOut({"p": new_p, "seed": vertex_data["seed"]}, residual)


def make_coem_graph(
    n_nps: int,
    n_contexts: int,
    n_cooccurrences: int,
    n_types: int,
    n_seeds_per_type: int = 5,
    seed: int = 0,
    dtype=torch.float32,
    *,
    device: DeviceLike = "cuda",
) -> Tuple[DataGraph, dict]:
    """Synthetic NELL-like corpus with planted type clusters: noun-phrases
    of type t co-occur mostly with contexts of type t, so CoEM's propagated
    labels can be scored against ground truth.

    The JAX package draws each co-occurrence's context in a Python loop;
    here one ``integers(0, highs)`` call over an array of bounds makes the
    same draws (an array of bounds consumes the stream as the scalar calls
    do), so the arrays are equal for the same seed."""
    rng = np.random.default_rng(seed)
    true_np = rng.integers(0, n_types, size=n_nps)
    true_ctx = rng.integers(0, n_types, size=n_contexts)

    # biased co-occurrence sampling: 80% within-type
    n_within = int(0.8 * n_cooccurrences)
    u_all = rng.integers(0, n_nps, size=n_cooccurrences)
    # the contexts of each type, ascending: pool t is by_type[beg[t]:...]
    by_type = np.argsort(true_ctx, kind="stable")
    beg = np.concatenate([[0], np.cumsum(np.bincount(true_ctx,
                                                     minlength=n_types))])
    t_u = true_np[u_all[:n_within]]
    pool_size = beg[t_u + 1] - beg[t_u]
    highs = np.full(n_cooccurrences, n_contexts, np.int64)
    highs[:n_within] = np.where(pool_size > 0, pool_size, n_contexts)
    draw = rng.integers(0, highs)
    vs = draw.copy()
    in_pool = np.flatnonzero(pool_size > 0)
    vs[in_pool] = by_type[beg[t_u[in_pool]] + draw[in_pool]]
    key = u_all.astype(np.int64) * n_contexts + vs
    uniq, counts = unique_counts(key, resolve_device(device))
    us, vs = uniq // n_contexts, uniq % n_contexts

    st, perm = GraphStructure.undirected(us, vs + n_nps, n_nps + n_contexts,
                                         device=device)
    # per-directed-edge weight from the pair counts: stored edge j is input
    # edge perm[j] of [np→ctx ; ctx→np], whose pair is perm[j] mod the pair
    # count (the pairs are the sorted unique keys)
    w = counts[np.asarray(perm, np.int64) % max(uniq.size, 1)].astype(
        np.float32)

    n = st.n_vertices
    p = np.full((n, n_types), 1.0 / n_types, np.float32)
    seeds = np.zeros(n, np.float32)
    np_by_type = np.argsort(true_np, kind="stable")
    np_beg = np.concatenate([[0], np.cumsum(np.bincount(true_np,
                                                        minlength=n_types))])
    for t in range(n_types):
        pool = np_by_type[np_beg[t]:np_beg[t + 1]]
        chosen = pool[rng.permutation(pool.size)[:n_seeds_per_type]]
        seeds[chosen] = 1.0
        p[chosen] = 0.0
        p[chosen, t] = 1.0

    g = DataGraph.build(
        st,
        {"p": torch.from_numpy(p).to(dtype),
         "seed": torch.from_numpy(seeds).to(dtype)},
        {"w": torch.from_numpy(w).to(dtype)},
    )
    info = {"true_np": true_np, "true_ctx": true_ctx, "n_nps": n_nps}
    return g, info


def coem_accuracy(graph: DataGraph, info: dict) -> float:
    """Fraction of non-seed noun-phrases whose argmax type is correct."""
    n_nps = info["n_nps"]
    p = graph.vertex_data["p"][:n_nps]
    seeds = (graph.vertex_data["seed"][:n_nps] > 0.5).cpu().numpy()
    pred = torch.argmax(p, dim=1).cpu().numpy()
    mask = ~seeds
    return float((pred[mask] == info["true_np"][mask]).mean())
