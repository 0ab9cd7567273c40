"""Two-phase "atom" partitioning and distributed ingress (paper Sec. 4.1).

Phase 1 (ingress): over-partition V into ``k_atoms ≫ n_machines`` parts.
Each **atom** is serialized as a journal of graph-generating commands
(AddVertex / AddEdge) plus its **ghost** boundary, stored as one file on the
DFS (here: ``.atom.npz`` journals on local disk — the format is the point,
not the filesystem; it is the JAX package's, byte for byte, so atoms written
by either package load into the other).  An **atom index** stores the meta-graph: one
meta-vertex per atom, meta-edges weighted by cut size.

Phase 2 (load): balance the meta-graph over the actual machine count and
replay each machine's journals into a local graph with ghost slots.  Because
phase 1 is independent of the machine count, the same atom set serves any
cluster size — the paper's elastic-scaling property, which we also use for
restart-after-shrink (checkpoint/).

Partitioning heuristics: ``hash`` (the paper's random placement; used for
Netflix/NER) and ``bfs`` (grown clusters — a stand-in for ParMetis, which is
unavailable; used for grid/planar graphs where locality matters, cf. CoSeg's
frame-block partitioning).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import DataGraph, GraphStructure
from repro_torch.core.keysort import unique_counts

Pytree = Any


def host_leaves(tree: Pytree) -> List[np.ndarray]:
    """The leaves of a data tree as host numpy arrays, in the JAX package's
    leaf order (dict keys sorted), so a journal's ``vdata_<i>`` names the
    same leaf in both packages."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in host_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in host_leaves(t)]
    if tree is None:
        return []
    if hasattr(tree, "detach"):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


# ---------------------------------------------------------------------------
# Phase 1: over-partitioning into atoms
# ---------------------------------------------------------------------------

def overpartition(
    structure: GraphStructure,
    k_atoms: int,
    method: str = "hash",
    seed: int = 0,
) -> np.ndarray:
    """Assigns every vertex to one of ``k_atoms`` atoms.  Returns int32 [N]."""
    n = structure.n_vertices
    if method == "hash":
        rng = np.random.default_rng(seed)
        # salted multiplicative hash — the paper's "Random Hashing"
        salt = rng.integers(1, 2**31 - 1)
        ids = np.arange(n, dtype=np.uint64)
        return ((ids * np.uint64(2654435761) + np.uint64(salt))
                % np.uint64(k_atoms)).astype(np.int32)
    if method == "bfs":
        return _bfs_partition(structure, k_atoms, seed)
    raise ValueError(f"unknown partition method {method!r}")


def _bfs_partition(structure: GraphStructure, k_atoms: int,
                   seed: int) -> np.ndarray:
    """Grows ``k_atoms`` balanced BFS clusters — a cheap locality-aware
    heuristic standing in for ParMetis (paper: "or by using a distributed
    graph partitioning heuristic")."""
    n = structure.n_vertices
    target = -(-n // k_atoms)
    s = np.concatenate([structure.senders, structure.receivers])
    r = np.concatenate([structure.receivers, structure.senders])
    sort = np.argsort(r, kind="stable")
    s, r = s[sort], r[sort]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])

    rng = np.random.default_rng(seed)
    atom = np.full(n, -1, dtype=np.int32)
    order = rng.permutation(n)
    cur, size = 0, 0
    from collections import deque
    queue: deque = deque()
    oi = 0
    while True:
        if not queue:
            while oi < n and atom[order[oi]] >= 0:
                oi += 1
            if oi >= n:
                break
            queue.append(order[oi])
            if atom[order[oi]] >= 0:
                continue
        v = queue.popleft()
        if atom[v] >= 0:
            continue
        atom[v] = cur
        size += 1
        if size >= target and cur < k_atoms - 1:
            cur, size = cur + 1, 0
            queue.clear()
            continue
        for u in s[offsets[v]:offsets[v + 1]]:
            if atom[u] < 0:
                queue.append(int(u))
    return atom


def _meta_edges(src_atom: np.ndarray, dst_atom: np.ndarray, k: int,
                device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Meta-edges (src atom, dst atom, cut edges between them) of the cut
    edges, lexicographically sorted: the JAX package's ``np.unique(pairs,
    axis=0, return_counts=True)``, from one int64 key a pair, sorted on
    ``device`` (core/keysort.py)."""
    cut = src_atom != dst_atom
    if not cut.any():
        return np.zeros(0, np.int32), np.zeros(0, np.int32), \
            np.zeros(0, np.int64)
    key = src_atom[cut].astype(np.int64) * k + dst_atom[cut]
    uniq, w = unique_counts(key, device)
    return ((uniq // k).astype(src_atom.dtype),
            (uniq % k).astype(src_atom.dtype), w.astype(np.int64))


# ---------------------------------------------------------------------------
# Atom journals + index (the on-DFS format)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AtomIndex:
    """The meta-graph (paper: "atom index file").  k meta-vertices, meta-edge
    (i, j) weighted by the number of cut edges between atoms i and j."""

    k_atoms: int
    n_vertices: int
    n_edges: int
    atom_nv: np.ndarray       # [k] vertices per atom
    atom_ne: np.ndarray       # [k] (owned) edges per atom
    meta_src: np.ndarray      # [M] meta-edges
    meta_dst: np.ndarray
    meta_weight: np.ndarray
    files: List[str]

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "k_atoms": self.k_atoms,
                "n_vertices": self.n_vertices,
                "n_edges": self.n_edges,
                "atom_nv": self.atom_nv.tolist(),
                "atom_ne": self.atom_ne.tolist(),
                "meta_src": self.meta_src.tolist(),
                "meta_dst": self.meta_dst.tolist(),
                "meta_weight": self.meta_weight.tolist(),
                "files": self.files,
            }, f)

    @staticmethod
    def load(path: str) -> "AtomIndex":
        with open(path) as f:
            d = json.load(f)
        return AtomIndex(
            k_atoms=d["k_atoms"], n_vertices=d["n_vertices"],
            n_edges=d["n_edges"],
            atom_nv=np.asarray(d["atom_nv"], np.int64),
            atom_ne=np.asarray(d["atom_ne"], np.int64),
            meta_src=np.asarray(d["meta_src"], np.int32),
            meta_dst=np.asarray(d["meta_dst"], np.int32),
            meta_weight=np.asarray(d["meta_weight"], np.int64),
            files=list(d["files"]))


def build_atoms(
    graph: DataGraph,
    atom_of: np.ndarray,
    out_dir: str,
) -> AtomIndex:
    """Serializes each atom as a journal file.

    An edge is *owned* by the atom of its receiver (the vertex whose update
    ⊕-combines over it).  An atom's journal contains:
      AddVertex for every owned vertex (id + data),
      AddVertex(ghost) for boundary vertices it reads but does not own,
      AddEdge for every owned edge (src may be a ghost).
    """
    os.makedirs(out_dir, exist_ok=True)
    st = graph.structure
    atom_of = np.asarray(atom_of, np.int32)
    k = int(atom_of.max()) + 1
    e_atom = atom_of[st.receivers]           # edge ownership
    src_atom = atom_of[st.senders]
    files: List[str] = []
    atom_nv = np.bincount(atom_of, minlength=k).astype(np.int64)
    atom_ne = np.bincount(e_atom, minlength=k).astype(np.int64)

    # meta-graph: cut edges between atoms
    meta_src, meta_dst, meta_w = _meta_edges(src_atom, e_atom, k, st.device)

    vleaves = host_leaves(graph.vertex_data)
    eleaves = host_leaves(graph.edge_data)

    for a in range(k):
        own_v = np.nonzero(atom_of == a)[0].astype(np.int32)
        own_e = np.nonzero(e_atom == a)[0].astype(np.int32)
        s, r = st.senders[own_e], st.receivers[own_e]
        # ghosts: boundary vertices read by this atom's edges, plus vertices
        # adjacent to the boundary in the other direction (scope writes to
        # out-edges owned elsewhere are synchronized through their owner).
        ghosts = np.setdiff1d(np.unique(s), own_v).astype(np.int32)
        payload = {
            "own_vertices": own_v,
            "ghost_vertices": ghosts,
            "edge_src": s,
            "edge_dst": r,
            "edge_ids": own_e,
        }
        for i, leaf in enumerate(vleaves):
            payload[f"vdata_{i}"] = leaf[own_v]
            payload[f"vdata_ghost_{i}"] = leaf[ghosts]
        for i, leaf in enumerate(eleaves):
            payload[f"edata_{i}"] = leaf[own_e]
        path = os.path.join(out_dir, f"atom_{a:05d}.atom.npz")
        np.savez_compressed(path, **payload)
        files.append(path)

    index = AtomIndex(
        k_atoms=k, n_vertices=st.n_vertices, n_edges=st.n_edges,
        atom_nv=atom_nv, atom_ne=atom_ne,
        meta_src=meta_src, meta_dst=meta_dst, meta_weight=meta_w,
        files=files)
    index.save(os.path.join(out_dir, "atom_index.json"))
    return index


# ---------------------------------------------------------------------------
# Phase 2: placement + load
# ---------------------------------------------------------------------------

def place_atoms(index: AtomIndex, n_machines: int) -> np.ndarray:
    """Balanced greedy placement of atoms onto machines (largest-first into
    least-loaded), weight = vertices + edges.  Returns machine_of_atom [k].

    This is the master's fast balanced partition of the meta-graph: a few
    thousand meta-vertices regardless of |V| — why the two-phase scheme
    loads quickly on any cluster size."""
    w = index.atom_nv + index.atom_ne
    order = np.argsort(-w, kind="stable")
    load = np.zeros(n_machines, np.int64)
    out = np.zeros(index.k_atoms, np.int32)
    # locality bonus: prefer the machine already holding the heaviest
    # meta-neighbor, if its load is within 12.5% of the minimum.
    nbr: Dict[int, List[Tuple[int, int]]] = {}
    for s, d, ww in zip(index.meta_src, index.meta_dst, index.meta_weight):
        nbr.setdefault(int(s), []).append((int(d), int(ww)))
        nbr.setdefault(int(d), []).append((int(s), int(ww)))
    placed = np.zeros(index.k_atoms, bool)
    for a in order:
        best = int(np.argmin(load))
        cand = {}
        for b, ww in nbr.get(int(a), ()):
            if placed[b]:
                cand[out[b]] = cand.get(out[b], 0) + ww
        if cand:
            m = max(cand, key=lambda mm: cand[mm])
            if load[m] <= load[best] + max(1, w.sum() // (8 * n_machines)):
                best = m
        out[a] = best
        load[best] += w[a]
        placed[a] = True
    return out


def atom_meta_index(st: GraphStructure, atom_of: np.ndarray) -> AtomIndex:
    """The meta-graph of an atom assignment built directly from the
    structure, without journal files: one meta-vertex per atom, meta-edges
    weighted by cut size.  This is the in-memory half of ``build_atoms``,
    shared by placement (``place_vertices``) and live rebalancing
    (``rebalance_placement``)."""
    atom_of = np.asarray(atom_of, np.int32)
    k = int(atom_of.max()) + 1
    nv = np.bincount(atom_of, minlength=k)
    e_atom = atom_of[st.receivers]
    ne = np.bincount(e_atom, minlength=k)
    src_atom = atom_of[st.senders]
    meta_src, meta_dst, meta_w = _meta_edges(src_atom, e_atom, k, st.device)
    return AtomIndex(
        k_atoms=k, n_vertices=st.n_vertices, n_edges=st.n_edges,
        atom_nv=nv.astype(np.int64), atom_ne=ne.astype(np.int64),
        meta_src=meta_src, meta_dst=meta_dst, meta_weight=meta_w,
        files=[""] * k)


def place_vertices(st: GraphStructure, atom_of: np.ndarray,
                   n_machines: int) -> np.ndarray:
    """Two-phase placement without journal files: builds the meta-graph of
    an atom assignment directly from the structure, places atoms with
    ``place_atoms``, and returns machine_of_vertex [N].

    Shared by the simulated cluster (core/distributed.py) and the
    distributed engines (dist/engine.py): both derive vertex placement — and
    therefore ghost sets — from the same two-phase partition.
    """
    atom_of = np.asarray(atom_of, np.int32)
    placement = place_atoms(atom_meta_index(st, atom_of), n_machines)
    return placement[atom_of]


def rebalance_placement(index: AtomIndex, placement: np.ndarray,
                        n_machines: int, *,
                        remove: Sequence[int] = ()) -> np.ndarray:
    """Incrementally repairs an atom placement after membership changes
    (dist/migrate.py; DESIGN §3.13) — the two-phase scheme's elasticity
    applied *live*: atoms move, machines never rebuild from scratch.

    Two phases: (1) evacuate — atoms on ``remove``d machines go
    largest-first to the least-loaded surviving machine; (2) smooth —
    while some machine exceeds the mean load, migrate its largest atom
    that still fits into the load gap toward the least-loaded machine.
    Phase 2 strictly decreases the sum of squared loads, so it
    terminates; atoms on untouched machines stay put (minimal movement,
    unlike a fresh ``place_atoms``).  Returns the new machine_of_atom [k]
    over machine ids ``0..n_machines-1`` minus ``remove``.
    """
    placement = np.asarray(placement, np.int32).copy()
    removed = set(int(m) for m in remove)
    alive = [m for m in range(int(n_machines)) if m not in removed]
    if not alive:
        raise ValueError("rebalance_placement: no machines left")
    w = (index.atom_nv + index.atom_ne).astype(np.int64)
    load = np.zeros(int(n_machines), np.int64)
    for a in range(index.k_atoms):
        if int(placement[a]) not in removed:
            load[placement[a]] += w[a]

    # phase 1: evacuate dead machines, largest atom first
    orphans = [a for a in range(index.k_atoms)
               if int(placement[a]) in removed]
    for a in sorted(orphans, key=lambda a: -int(w[a])):
        m = min(alive, key=lambda mm: load[mm])
        placement[a] = m
        load[m] += w[a]

    # phase 2: smooth overloads (covers join: a fresh machine enters with
    # zero load and pulls atoms until the mesh is balanced again)
    while True:
        hi = max(alive, key=lambda mm: load[mm])
        lo = min(alive, key=lambda mm: load[mm])
        gap = int(load[hi] - load[lo])
        movable = [a for a in range(index.k_atoms)
                   if placement[a] == hi and 0 < int(w[a]) < gap]
        if not movable:
            break
        a = max(movable, key=lambda a: int(w[a]))
        placement[a] = lo
        load[hi] -= w[a]
        load[lo] += w[a]
    return placement


@dataclasses.dataclass
class LocalGraph:
    """One machine's partition after journal replay (paper Fig. 5(b): "Local
    Graph Storage" + "Remote Graph Cache").

    Local vertex order: [owned vertices..., ghost vertices...].  Ghosts cache
    remote data; ``ghost_global`` names their true owners' global ids and
    ``ghost_version`` implements the paper's cache-coherence versioning —
    a ghost refresh is skipped when the owner's version is unchanged.
    """

    machine: int
    own_global: np.ndarray     # [n_own] global ids of owned vertices
    ghost_global: np.ndarray   # [n_ghost]
    vdata: Pytree              # [n_own + n_ghost, ...] replayed data
    edata: Pytree              # [n_local_e, ...]
    edge_src_local: np.ndarray
    edge_dst_local: np.ndarray  # always < n_own (edges owned by receiver)
    edge_ids: np.ndarray       # global edge ids
    ghost_version: np.ndarray  # [n_ghost] int64

    @property
    def n_own(self) -> int:
        return int(self.own_global.size)

    @property
    def n_ghost(self) -> int:
        return int(self.ghost_global.size)


def load_machine(
    index: AtomIndex, placement: np.ndarray, machine: int
) -> LocalGraph:
    """Replays this machine's atom journals into a LocalGraph."""
    mine = [a for a in range(index.k_atoms) if placement[a] == machine]
    own_list, ghost_list = [], []
    src_list, dst_list, eid_list = [], [], []
    vleaf_own: Optional[List[List[np.ndarray]]] = None
    vleaf_ghost: Optional[List[List[np.ndarray]]] = None
    eleaf: Optional[List[List[np.ndarray]]] = None

    for a in mine:
        z = np.load(index.files[a])
        own_list.append(z["own_vertices"])
        ghost_list.append(z["ghost_vertices"])
        src_list.append(z["edge_src"])
        dst_list.append(z["edge_dst"])
        eid_list.append(z["edge_ids"])
        nv = sum(1 for kk in z.files if kk.startswith("vdata_")
                 and not kk.startswith("vdata_ghost_"))
        ne = sum(1 for kk in z.files if kk.startswith("edata_"))
        if vleaf_own is None:
            vleaf_own = [[] for _ in range(nv)]
            vleaf_ghost = [[] for _ in range(nv)]
            eleaf = [[] for _ in range(ne)]
        for i in range(nv):
            vleaf_own[i].append(z[f"vdata_{i}"])
            vleaf_ghost[i].append(z[f"vdata_ghost_{i}"])
        for i in range(len(eleaf)):
            eleaf[i].append(z[f"edata_{i}"])

    if not mine:
        raise ValueError(f"machine {machine} was assigned no atoms")

    own = np.concatenate(own_list)
    ghost_all = np.concatenate(ghost_list) if ghost_list else np.zeros(0, np.int32)
    ghost = np.setdiff1d(np.unique(ghost_all), own).astype(np.int32)
    src = np.concatenate(src_list)
    dst = np.concatenate(dst_list)
    eids = np.concatenate(eid_list)

    # global -> local mapping: owned first, then ghosts
    local_of = {int(g): i for i, g in enumerate(own)}
    for i, g in enumerate(ghost):
        local_of[int(g)] = own.size + i
    src_local = np.asarray([local_of[int(g)] for g in src], np.int32)
    dst_local = np.asarray([local_of[int(g)] for g in dst], np.int32)

    # vertex data: stitch owned chunks, then one row per unique ghost
    own_set = set(own.tolist())
    first_occurrence: Dict[int, int] = {}
    for j, g in enumerate(ghost_all):
        gi = int(g)
        if gi not in first_occurrence and gi not in own_set:
            first_occurrence[gi] = j
    vleaves = []
    for i in range(len(vleaf_own)):
        own_rows = np.concatenate(vleaf_own[i])
        gcat = (np.concatenate(vleaf_ghost[i]) if vleaf_ghost[i]
                else own_rows[:0])
        ghost_rows = np.zeros((ghost.size,) + own_rows.shape[1:],
                              own_rows.dtype)
        for gi, g in enumerate(ghost):
            ghost_rows[gi] = gcat[first_occurrence[int(g)]]
        vleaves.append(np.concatenate([own_rows, ghost_rows], 0))
    eleaves = [np.concatenate(c) for c in eleaf] if eleaf else []

    return LocalGraph(
        machine=machine,
        own_global=own,
        ghost_global=ghost,
        vdata=vleaves,
        edata=eleaves,
        edge_src_local=src_local,
        edge_dst_local=dst_local,
        edge_ids=eids,
        ghost_version=np.zeros(ghost.size, np.int64),
    )


def load_cluster(index: AtomIndex, n_machines: int) -> List[LocalGraph]:
    placement = place_atoms(index, n_machines)
    return [load_machine(index, placement, m) for m in range(n_machines)]


def cut_edges(index: AtomIndex, placement: np.ndarray) -> int:
    """Number of graph edges crossing machines under a placement."""
    return int(sum(
        w for s, d, w in zip(index.meta_src, index.meta_dst, index.meta_weight)
        if placement[s] != placement[d]))
