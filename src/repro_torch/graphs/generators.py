"""Synthetic graph generators (paper Secs. 2, 4.2.2).

  power_law_graph : natural web graphs ("power-law degree distributions")
  grid3d_graph    : the paper's 26-connected synthetic MRF (Sec. 4.2.2)
  bipartite_graph : Netflix / NER bipartite graphs (Secs. 5.1, 5.3)

They make the same numpy RNG calls in the same order as the JAX package's
generators, so the same seed gives the same arrays in both packages; their
deduplicating sorts run on the requested device (``core/keysort.py``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.graph import GraphStructure
from repro_torch.core.keysort import unique_first
from repro_torch.device import DeviceLike, resolve_device


def power_law_graph(
    n: int, avg_degree: float = 8.0, alpha: float = 2.1, *, seed: int = 0,
    symmetric: bool = True, device: DeviceLike = "cuda",
) -> GraphStructure:
    """Chung-Lu style power-law graph: P(deg = d) ∝ d^-alpha."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(alpha - 1, size=n) + 1.0
    w *= avg_degree * n / w.sum()
    m = int(avg_degree * n / 2)
    p = w / w.sum()
    u = rng.choice(n, size=m, p=p)
    v = rng.choice(n, size=m, p=p)
    keep = u != v
    u, v = u[keep], v[keep]
    # dedupe on the canonical undirected pair (else symmetrizing (u,v) and
    # (v,u) draws would create duplicate directed edges — a multigraph)
    key = (np.minimum(u, v).astype(np.int64) * n + np.maximum(u, v))
    _, idx = unique_first(key, resolve_device(device))
    u, v = u[idx], v[idx]
    if symmetric:
        st, _ = GraphStructure.undirected(u, v, n, device=device)
    else:
        st, _ = GraphStructure.from_edges(u, v, n, device=device)
    return st


def connected_power_law_graph(n: int, *, seed: int = 0,
                              avg_degree: float = 6.0,
                              device: DeviceLike = "cuda") -> GraphStructure:
    """``power_law_graph`` with components stitched by an undirected path,
    so the graph is connected and symmetrized."""
    st = power_law_graph(n, avg_degree=avg_degree, seed=seed, device="cpu")
    u = np.arange(n - 1)
    v = np.arange(1, n)
    s = np.concatenate([st.senders, u, v])
    r = np.concatenate([st.receivers, v, u])
    key = np.minimum(s, r).astype(np.int64) * n + np.maximum(s, r)
    _, idx = np.unique(key, return_index=True)
    st2, _ = GraphStructure.undirected(s[idx], r[idx], n, device=device)
    return st2


def grid3d_graph(nx: int, ny: int, nz: int, connectivity: int = 26,
                 *, device: DeviceLike = "cuda") -> GraphStructure:
    """The paper's synthetic mesh: nx×ny×nz vertices, 6- or 26-connected."""
    if connectivity not in (6, 26):
        raise ValueError(f"connectivity must be 6 or 26, got {connectivity}")
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    us, vs = [], []
    if connectivity == 6:
        offsets = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    else:
        offsets = [(dx, dy, dz)
                   for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                   for dz in (-1, 0, 1)
                   if (dx, dy, dz) > (0, 0, 0)]  # half-space: dedupe pairs
    for dx, dy, dz in offsets:
        sl_a = idx[max(0, -dx):nx - max(0, dx) or None,
                   max(0, -dy):ny - max(0, dy) or None,
                   max(0, -dz):nz - max(0, dz) or None]
        sl_b = idx[max(0, dx):nx - max(0, -dx) or None,
                   max(0, dy):ny - max(0, -dy) or None,
                   max(0, dz):nz - max(0, -dz) or None]
        us.append(sl_a.ravel())
        vs.append(sl_b.ravel())
    u = np.concatenate(us)
    v = np.concatenate(vs)
    st, _ = GraphStructure.undirected(u, v, nx * ny * nz, device=device)
    return st


def bipartite_graph(
    n_left: int, n_right: int, n_ratings: int, seed: int = 0,
    right_popularity_alpha: float = 1.8, *, device: DeviceLike = "cuda",
) -> Tuple[GraphStructure, np.ndarray]:
    """Netflix/NER-style bipartite graph (left = users/noun-phrases, right =
    movies/contexts; right endpoints power-law popular — "Harry Potter
    connects to a very large number of users").

    Vertices [0, n_left) are left, [n_left, n_left+n_right) right.
    Returns (symmetric structure, pair perm) — edge data built over the
    (u→m ; m→u) concatenated order should be permuted with the perm.
    """
    rng = np.random.default_rng(seed)
    wr = rng.pareto(right_popularity_alpha, size=n_right) + 1.0
    pr = wr / wr.sum()
    users = rng.integers(0, n_left, size=n_ratings)
    movies = rng.choice(n_right, size=n_ratings, p=pr)
    key = users.astype(np.int64) * n_right + movies
    _, idx = unique_first(key, resolve_device(device))
    users, movies = users[idx], movies[idx]
    return GraphStructure.undirected(users, movies + n_left,
                                     n_left + n_right, device=device)
