"""Alternating Least Squares collaborative filtering (paper Sec. 5.1).

Netflix: sparse ratings matrix R ~ U V^T over the bipartite user-movie
graph.  Vertex data: the d-dim latent factor.  Edge data: the rating (and a
train/test flag for the Fig. 9(a) test-error curves).  The update recomputes
the least-squares solution for one vertex from its neighbors' factors:

    x_v = (sum_u x_u x_u^T + lambda I)^{-1} (sum_u r_uv x_u)

Because the graph is bipartite (2-colorable) and edge consistency suffices,
the chromatic engine runs it exactly as the paper does.

The update complexity O(d^3 + deg·d^2) is the paper's computation-
communication knob (Fig. 6(c)): sweep ``d``.  On the fused path the two
gather leaves go through the gather⊕combine kernel at D = d² (the derived
``x xᵀ`` feature) and D = d; apply is a batched ``torch.linalg.solve``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.consistency import Consistency
from repro_torch.core.graph import DataGraph
from repro_torch.core.update import (ApplyOut, EdgeCtx, FusedGather,
                                     VertexProgram)
from repro_torch.device import DeviceLike
from repro_torch.graphs.generators import bipartite_graph

#: edges per chunk when ``make_als_graph`` computes the planted ratings
#: (the [E, d] float64 factor gathers would take 32 GB each at Netflix
#: scale; a chunk takes 640 MB at d = 20)
RATING_CHUNK = 1 << 22


class ALSProgram(VertexProgram):
    combiner = "sum"
    consistency = Consistency.EDGE
    schedule_neighbors = True

    def __init__(self, d: int, reg: float = 0.05):
        self.d = int(d)
        self.reg = float(reg)

    def gather(self, ctx: EdgeCtx):
        x = ctx.src["factor"]                      # [E, d]
        w = ctx.edata["train"][:, None]            # test edges excluded
        return {
            "xxt": w[..., None] * x[:, :, None] * x[:, None, :],  # [E, d, d]
            "rx": w * ctx.edata["rating"][:, None] * x,           # [E, d]
        }

    def fused_gather(self):
        # Both leaves are weighted-src-sums of *derived* per-vertex
        # features: the x xᵀ outer product is an [N, d, d] vertex table
        # (N ≪ E), so the [E, d, d] per-edge messages never exist.
        return {
            "xxt": FusedGather(
                "weighted_src_sum",
                feature=lambda v: v["factor"][:, :, None]
                * v["factor"][:, None, :],
                weight=lambda e: e["train"]),
            "rx": FusedGather(
                "weighted_src_sum",
                feature=lambda v: v["factor"],
                weight=lambda e: e["train"] * e["rating"]),
        }

    def apply(self, vertex_data, acc, glob=None) -> ApplyOut:
        d = self.d
        eye = torch.eye(d, dtype=acc["xxt"].dtype, device=acc["xxt"].device)
        A = acc["xxt"] + self.reg * eye
        b = acc["rx"]
        new = torch.linalg.solve(A, b[..., None])[..., 0]
        residual = torch.sum(torch.abs(new - vertex_data["factor"]), dim=-1)
        return ApplyOut({"factor": new}, residual)


def make_als_graph(
    n_users: int,
    n_movies: int,
    n_ratings: int,
    d: int,
    seed: int = 0,
    test_frac: float = 0.2,
    noise: float = 0.1,
    dtype=torch.float32,
    *,
    device: DeviceLike = "cuda",
) -> Tuple[DataGraph, dict]:
    """Synthetic low-rank ratings with planted factors (so test RMSE is a
    real generalization signal, not memorization).

    The same numpy draws in the same order as the JAX package's builder, so
    the arrays are equal for the same seed; the planted ratings are summed
    ``RATING_CHUNK`` edges at a time, and the pair of each edge is read off
    the generator's edge permutation instead of a sort of all E keys."""
    rng = np.random.default_rng(seed)
    st, perm = bipartite_graph(n_users, n_movies, n_ratings, seed=seed,
                               device=device)

    u_true = rng.normal(0, 1.0 / np.sqrt(d), size=(n_users, d))
    m_true = rng.normal(0, 1.0 / np.sqrt(d), size=(n_movies, d))

    # edge (s -> r): rating of the (user, movie) pair; symmetric duplicate
    s, r = st.senders, st.receivers
    user_of = np.where(s < n_users, s, r)
    movie_of = np.where(s < n_users, r, s) - n_users
    rating = np.empty(st.n_edges, np.float64)
    for lo in range(0, st.n_edges, RATING_CHUNK):
        hi = min(lo + RATING_CHUNK, st.n_edges)
        rating[lo:hi] = np.einsum("ed,ed->e", u_true[user_of[lo:hi]],
                                  m_true[movie_of[lo:hi]])
    rating += rng.normal(0, noise, size=rating.shape)

    # train/test split per undirected pair (both directions agree).  The
    # generator's pairs are its deduplicated (user, movie) keys in sorted
    # order, and stored edge j is input edge perm[j] of [u→m ; m→u], so
    # its pair is perm[j] mod the pair count: the unique-key inverse.
    n_pairs = st.n_edges // 2
    inv = np.asarray(perm, np.int64) % max(n_pairs, 1)
    is_test_pair = rng.random(n_pairs) < test_frac
    train = (~is_test_pair[inv]).astype(rating.dtype)

    factors = rng.normal(0, 0.1, size=(st.n_vertices, d))
    vdata = {"factor": torch.from_numpy(factors).to(dtype)}
    edata = {"rating": torch.from_numpy(rating).to(dtype),
             "train": torch.from_numpy(train).to(dtype)}
    g = DataGraph.build(st, vdata, edata)
    info = {"n_users": n_users, "n_movies": n_movies,
            "user_of": user_of, "movie_of": movie_of}
    return g, info


def als_rmse(graph: DataGraph, train: bool,
             chunk: int = RATING_CHUNK) -> float:
    """Global RMSE over train or test edges (benchmark metric, Fig. 9(a)),
    on the graph's device, ``chunk`` edges at a time; the squared errors
    are summed in float64."""
    t = graph.structure.device_arrays()
    x = graph.vertex_data["factor"]
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    count = 0
    for lo in range(0, graph.n_edges, chunk):
        sl = slice(lo, min(lo + chunk, graph.n_edges))
        pred = torch.einsum("ed,ed->e", x[t["senders"][sl]],
                            x[t["receivers"][sl]])
        mask = graph.edge_data["train"][sl] > 0.5
        if not train:
            mask = ~mask
        err = pred[mask].double() - graph.edge_data["rating"][sl][mask]
        total = total + torch.sum(err * err)
        count += int(mask.sum())
    return float(torch.sqrt(total / count)) if count else 0.0
