"""Graph coloring for the chromatic engine (paper Sec. 4.2.1).

Greedy (largest-degree-first) proper coloring; distance-2 coloring for the
full consistency model; bipartite detection (the paper notes many MLDM
graphs — ALS, CoEM — are two-colorable "for free").  Host-side numpy: the
coloring is computed once at ingress.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.consistency import Consistency
from repro_torch.core.graph import GraphStructure


def _csr(structure: GraphStructure) -> Tuple[np.ndarray, np.ndarray]:
    """Receiver-sorted CSR view: (offsets[N+1], senders-as-neighbors[E])."""
    offsets = structure.receiver_offsets()
    return offsets, structure.senders


def greedy_coloring(
    structure: GraphStructure, order: Optional[np.ndarray] = None
) -> np.ndarray:
    """Greedy proper vertex coloring, largest-degree-first by default.

    Works on the symmetrized adjacency (a proper coloring must separate both
    edge directions).  Returns int32 colors [N].
    """
    n = structure.n_vertices
    deg = structure.in_degree + structure.out_degree
    if order is None:
        order = np.argsort(-deg, kind="stable")

    # adjacency as CSR over the symmetrized edge set
    s = np.concatenate([structure.senders, structure.receivers])
    r = np.concatenate([structure.receivers, structure.senders])
    sort = np.argsort(r, kind="stable")
    s, r = s[sort], r[sort]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])

    colors = np.full(n, -1, dtype=np.int32)
    for v in order:
        nbr_colors = colors[s[offsets[v]:offsets[v + 1]]]
        nbr_colors = nbr_colors[nbr_colors >= 0]
        if nbr_colors.size == 0:
            colors[v] = 0
            continue
        used = np.zeros(nbr_colors.max() + 2, dtype=bool)
        used[nbr_colors] = True
        colors[v] = int(np.argmin(used))
    return colors


def distance2_coloring(structure: GraphStructure) -> np.ndarray:
    """Greedy coloring of the square graph G² (full consistency model)."""
    n = structure.n_vertices
    s = np.concatenate([structure.senders, structure.receivers])
    r = np.concatenate([structure.receivers, structure.senders])
    sort = np.argsort(r, kind="stable")
    s, r = s[sort], r[sort]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])

    deg = structure.in_degree + structure.out_degree
    order = np.argsort(-deg, kind="stable")
    colors = np.full(n, -1, dtype=np.int32)
    for v in order:
        n1 = s[offsets[v]:offsets[v + 1]]
        # distance-2 neighborhood: neighbors + neighbors-of-neighbors
        chunks = [n1] + [s[offsets[u]:offsets[u + 1]] for u in n1]
        nbrs = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
        nbr_colors = colors[nbrs]
        nbr_colors = nbr_colors[nbr_colors >= 0]
        if nbr_colors.size == 0:
            colors[v] = 0
            continue
        used = np.zeros(nbr_colors.max() + 2, dtype=bool)
        used[nbr_colors] = True
        colors[v] = int(np.argmin(used))
    return colors


def bipartite_coloring(structure: GraphStructure) -> Optional[np.ndarray]:
    """BFS 2-coloring; returns None if the graph is not bipartite."""
    n = structure.n_vertices
    s = np.concatenate([structure.senders, structure.receivers])
    r = np.concatenate([structure.receivers, structure.senders])
    sort = np.argsort(r, kind="stable")
    s, r = s[sort], r[sort]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])

    colors = np.full(n, -1, dtype=np.int32)
    for root in range(n):
        if colors[root] >= 0:
            continue
        colors[root] = 0
        stack = [root]
        while stack:
            v = stack.pop()
            for u in s[offsets[v]:offsets[v + 1]]:
                if colors[u] < 0:
                    colors[u] = 1 - colors[v]
                    stack.append(int(u))
                elif colors[u] == colors[v]:
                    return None
    return colors


def coloring_for(
    structure: GraphStructure, consistency: Consistency
) -> np.ndarray:
    """Paper Sec. 4.2.1: pick the coloring that realizes a consistency model."""
    if consistency == Consistency.VERTEX:
        return np.zeros(structure.n_vertices, dtype=np.int32)
    if consistency == Consistency.EDGE:
        bip = bipartite_coloring(structure)
        return bip if bip is not None else greedy_coloring(structure)
    if consistency == Consistency.FULL:
        return distance2_coloring(structure)
    raise ValueError(consistency)


def verify_coloring(
    structure: GraphStructure, colors: np.ndarray, radius: int = 1
) -> bool:
    """Checks no two vertices within ``radius`` share a color.

    radius 0 (vertex consistency) imposes nothing; 1 = proper coloring;
    2 additionally separates two-hop pairs (full consistency)."""
    if radius < 1:
        return True
    s, r = structure.senders, structure.receivers
    mask = s != r
    if (colors[s[mask]] == colors[r[mask]]).any():
        return False
    if radius >= 2:
        n = structure.n_vertices
        # two-hop conflicts: for each vertex, all in-neighbors must have
        # pairwise distinct colors (they are distance 2 through it).
        offsets = structure.receiver_offsets()
        for v in range(n):
            nb = np.unique(s[offsets[v]:offsets[v + 1]])  # multigraph-safe
            nb = nb[nb != v]
            c = np.sort(colors[nb])
            if c.size > 1 and (c[1:] == c[:-1]).any():
                return False
    return True
