"""The distributed vertex-program engines (paper Sec. 4.2, DESIGN §3.7).

Where ``core/distributed.py`` *models* the paper's cluster (real values,
simulated time), this module *is* the cluster: vertices are placed with the
two-phase atom partitioner (``core/partition.py``), each of S machines owns
a block of rows, and ghosts — boundary vertices a machine reads but does
not own — live in a versioned remote cache refreshed by explicit
``all_to_all`` exchanges (``dist/exchange.py``).

The engines are written over *the machines held here* (all S of them on one
card with ``InProcessExchange``).  State is machine-major, as the JAX
package's arrays under ``shard_map`` are: own rows ``[S·n_loc, ...]``, ghost
caches ``[S·(S·B), ...]``, edge rows ``[S·e_loc, ...]``.  Where the JAX
package runs each machine's local compute inside its own shard, the port
launches each kernel once over every held machine: the machines' local edge
sets are stacked into one block-diagonal set (receivers offset by
``m·n_loc``, senders by ``m·(n_loc + S·B)`` into the stacked ``[own; ghost]``
table).  A receiver's in-edges all live on its machine, in the global
receiver-sorted order, so one launch adds every row exactly as the
per-machine launches would.

``ShardEngineBase`` owns everything schedule-independent: the partition
layout, the versioned ghost exchange, and the **phase update** (local
gather⊕combine → apply → exchange → reschedule → adjacent-edge writes) for
one caller-supplied active mask.  The engines are scheduler choices over it:

  ``DistributedEngine``         chromatic sweep (Sec. 4.2.1): one step
                                sweeps the colors; same-color vertices are
                                non-adjacent, so the fixed point matches
                                ``ChromaticEngine`` to float tolerance.
  ``dist/locking.py``           the pipelined locking engine (Sec. 4.2.2).

Versioned ghost exchange (Sec. 5.1: "each machine receives each modified
vertex data at most once"): the send tables enumerate (owner row, caching
machine) pairs once; at each exchange a row ships only if its vertex
updated this phase.  Adjacent-edge writes (LBP messages) ride the same
machinery with an edge ghost cache.

Left out so far (ROADMAP A7–A11): snapshots, streaming, the quantized wire
(only the default f32 wire exists, ``dist/wire.py``), membership stalls
and telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.coloring import coloring_for, verify_coloring
from repro_torch.core.engine_base import drain_rows
from repro_torch.core.graph import DataGraph, csr_block_offsets, \
    segment_combine
from repro_torch.core.keysort import stable_argsort, unique_inverse
from repro_torch.core.partition import (atom_meta_index, overpartition,
                                        place_atoms)
from repro_torch.core.scheduler import sweep_mask
from repro_torch.core.sync_op import SyncOp, run_syncs
from repro_torch.core.tree import tree_map, tree_unflatten
from repro_torch.core.update import (FixedEdgeCtx, VertexProgram,
                                     fused_edge_weight, fused_gather_leaves,
                                     masked_update, supports_fused_gather)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.exchange import Exchange
from repro_torch.dist.wire import WireConfig, payload_row_nbytes
from repro_torch.kernels.csr import RowSegments
from repro_torch.kernels.gas.gas import EDGE_BLOCK, ROW_BLOCK
from repro_torch.kernels.gas.ops import (EdgeSet, active_row_blocks,
                                         gather_combine, scatter_reschedule)
from repro_torch.kernels.segsum.ops import segment_sum_sorted

Pytree = Any

#: the ``DistState`` fields the port carries (the JAX package's, less the
#: snapshot, heartbeat and quantized-wire ones)
DIST_STATE_FIELDS = ("vown", "vghost", "edata", "eghost", "prio",
                     "update_count", "traffic_v", "traffic_e", "traffic_r",
                     "traffic_bytes_v", "traffic_bytes_e", "traffic_bytes_r",
                     "step_index", "globals_")


@dataclasses.dataclass
class DistState:
    """Machine-major engine state over the machines held here: leading
    dims are ``M * per_machine`` blocks, held machine i owns block i."""

    vown: Pytree            # [M*n_loc, ...] owned vertex data (padded)
    vghost: Pytree          # [M*(S*B), ...] ghost vertex cache
    edata: Pytree           # [M*e_loc, ...] owned edge data
    eghost: Pytree          # [M*(S*EB), ...] ghost edge cache ({} if unused)
    prio: torch.Tensor      # [M*n_loc] scheduler T (pad rows 0)
    update_count: torch.Tensor     # [M*n_loc] i32
    traffic_v: torch.Tensor        # [M] i64 — ghost vertex rows shipped
    traffic_e: torch.Tensor        # [M] i64 — ghost edge rows shipped
    traffic_r: torch.Tensor        # [M] i64 — arbitration rank rows shipped
    traffic_bytes_v: torch.Tensor  # [M] i64 — payload bytes of those rows
    traffic_bytes_e: torch.Tensor  # [M] i64
    traffic_bytes_r: torch.Tensor  # [M] i64
    step_index: torch.Tensor       # scalar i64
    globals_: Pytree = ()          # sync-op outputs (replicated), §3.9

    def replace(self, **kw) -> "DistState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Layout:
    """Host-side partition layout: the static index tables of the step
    (the JAX package's ``_Layout``, the same arrays)."""

    n_machines: int
    n_loc: int          # owned vertex rows per machine (padded)
    budget: int         # ghost vertex rows per (machine, peer) pair
    e_loc: int          # edge rows per machine (padded)
    e_budget: int       # ghost edge rows per (machine, peer) pair
    has_rev: bool       # reverse-edge ghost machinery built?
    machine_of: np.ndarray   # [N]
    own_gid: np.ndarray      # [S*n_loc] global vertex id or -1
    row_of: np.ndarray       # [N] global row of each vertex
    erow_gid: np.ndarray     # [S*e_loc] global edge id or -1
    erow_of: np.ndarray      # [E] machine-major global row of each edge
    ghost_gid: np.ndarray    # [S*(S*B)] global vertex id cached here or -1
    eghost_gid: np.ndarray   # [S*(S*EB)] global edge id cached here or -1
    tables: Dict[str, np.ndarray]   # per-machine tables (see build_layout)


def slab_tables(dest: np.ndarray, owner: np.ndarray, gid: np.ndarray,
                S: int, row_in_owner: np.ndarray, domain: int,
                device="cpu"):
    """Ghost slab assignment, vectorized.

    Each unique (dest machine, owner machine, gid) triple gets a slot
    ``b < budget`` in dest's per-owner slab.  Returns ``(budget, slab_gid
    [S*S*budget], send_idx, send_mask, qslot)``, ``qslot`` the slot of each
    input triple (the JAX package looks those up again with a search; here
    the sort that finds the unique triples, on ``device``, gives them).
    """
    if dest.size == 0:
        z = np.zeros(S * S, np.int64)
        return (1, np.full(S * S, -1, np.int64), z, np.zeros(S * S, bool),
                np.zeros(0, np.int64))
    key = (dest.astype(np.int64) * S + owner) * domain + gid
    ukey, inv = unique_inverse(key, device)
    pair = ukey // domain                    # dest * S + owner, sorted
    ugid = ukey % domain
    starts = np.searchsorted(pair, np.arange(S * S))
    bslot = np.arange(ukey.size) - starts[pair]
    budget = max(int(bslot.max()) + 1, 1)
    d, o = pair // S, pair % S
    slab_gid = np.full(S * S * budget, -1, np.int64)
    slab_gid[d * (S * budget) + o * budget + bslot] = ugid
    send_idx = np.zeros(S * S * budget, np.int64)
    send_mask = np.zeros(S * S * budget, bool)
    # owner o ships its local row of gid to machine d's slab slot
    send_idx[o * (S * budget) + d * budget + bslot] = row_in_owner[ugid]
    send_mask[o * (S * budget) + d * budget + bslot] = True
    return budget, slab_gid, send_idx, send_mask, bslot[inv]


def build_layout(graph: DataGraph, machine_of: np.ndarray,
                 n_machines: int, build_rev: bool) -> Layout:
    """The partition layout of ``graph`` under ``machine_of`` (host numpy;
    the JAX package's ``_build_layout``, table for table)."""
    st = graph.structure
    N, S = st.n_vertices, int(n_machines)
    dev = st.device        # where the sorts of one key an edge run

    # --- owned vertex rows: [machine-major, id-minor], padded to n_loc ----
    counts = np.bincount(machine_of, minlength=S)
    n_loc = max(int(counts.max()), 1)
    order = np.argsort(machine_of, kind="stable")
    slot = np.zeros(N, np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    slot[order] = np.arange(N) - offs[machine_of[order]]
    row_of = machine_of.astype(np.int64) * n_loc + slot
    own_gid = np.full(S * n_loc, -1, np.int64)
    own_gid[row_of] = np.arange(N)

    # --- owned edge rows (an edge lives with its receiver's machine) ------
    E = st.n_edges
    e_machine = machine_of[st.receivers]
    ecounts = np.bincount(e_machine, minlength=S)
    e_loc = max(int(ecounts.max()), 1)
    eorder = stable_argsort(e_machine, dev)
    epos = np.zeros(E, np.int64)
    eoffs = np.concatenate([[0], np.cumsum(ecounts)])
    epos[eorder] = np.arange(E) - eoffs[e_machine[eorder]]
    erow_of = e_machine.astype(np.int64) * e_loc + epos
    erow_gid = np.full(S * e_loc, -1, np.int64)
    erow_gid[erow_of] = np.arange(E)

    # --- ghost vertex slabs: machine m ghosts v iff some edge it owns has
    # remote sender v; slot assignment is a vectorized group-rank ----------
    s_machine = machine_of[st.senders]
    cut = s_machine != e_machine
    budget, ghost_gid, send_idx, send_mask, gslot = slab_tables(
        e_machine[cut], s_machine[cut], st.senders[cut], S, slot, max(N, 1),
        dev)

    senders_local = np.zeros(S * e_loc, np.int64)
    senders_local[erow_of[~cut]] = slot[st.senders[~cut]]
    if cut.any():
        senders_local[erow_of[cut]] = \
            n_loc + s_machine[cut].astype(np.int64) * budget + gslot
    receivers_local = np.zeros(S * e_loc, np.int64)
    receivers_local[erow_of] = slot[st.receivers]
    edge_mask = np.zeros(S * e_loc, bool)
    edge_mask[erow_of] = True
    src_deg_e = np.zeros(S * e_loc, np.int32)
    src_deg_e[erow_of] = st.out_degree[st.senders]
    dst_deg_e = np.zeros(S * e_loc, np.int32)
    dst_deg_e[erow_of] = st.in_degree[st.receivers]

    # --- ghost edge slabs (reverse-edge reads: ctx.rev_edata) -------------
    e_budget = 1
    rev_local = np.full(S * e_loc, -1, np.int64)
    eghost_gid = np.full(S * S, -1, np.int64)
    esend_idx = np.zeros(S * S, np.int64)
    esend_mask = np.zeros(S * S, bool)
    if build_rev:
        has = st.reverse_perm >= 0
        e_ids = np.nonzero(has)[0]
        re = st.reverse_perm[e_ids].astype(np.int64)
        m, p = e_machine[e_ids], e_machine[re]
        ecut = m != p
        e_budget, eghost_gid, esend_idx, esend_mask, gslot = \
            slab_tables(m[ecut], p[ecut], re[ecut], S, epos, max(E, 1), dev)
        rev_local[erow_of[e_ids[~ecut]]] = epos[re[~ecut]]
        if ecut.any():
            rev_local[erow_of[e_ids[ecut]]] = \
                e_loc + p[ecut].astype(np.int64) * e_budget + gslot

    tables = {
        "senders_local": senders_local.astype(np.int32),
        "receivers_local": receivers_local.astype(np.int32),
        "edge_mask": edge_mask,
        "src_deg_e": src_deg_e,
        "dst_deg_e": dst_deg_e,
        "own_mask": (own_gid >= 0),
        "send_idx": send_idx.astype(np.int32),
        "send_mask": send_mask,
        "rev_local": rev_local.astype(np.int32),
        "esend_idx": esend_idx.astype(np.int32),
        "esend_mask": esend_mask,
    }
    return Layout(
        n_machines=S, n_loc=n_loc, budget=budget, e_loc=e_loc,
        e_budget=e_budget, has_rev=build_rev, machine_of=machine_of,
        own_gid=own_gid, row_of=row_of, erow_gid=erow_gid, erow_of=erow_of,
        ghost_gid=ghost_gid, eghost_gid=eghost_gid, tables=tables)


def gas_tables(lay: Layout) -> Dict[str, np.ndarray]:
    """The JAX package's per-machine fused-GAS metadata over the local edge
    rows: senders and receivers padded to a multiple of ``EDGE_BLOCK``
    (pads: sender 0, receiver ``n_loc + ROW_BLOCK``) and each machine's
    CSR block offsets.  The CUDA kernels read none of it (they take the
    stacked ``EdgeSet``); building it checks, machine by machine, that the
    local receivers are sorted, which the stacked set relies on."""
    S, e_loc, n_loc = lay.n_machines, lay.e_loc, lay.n_loc
    e_pad = max(-(-e_loc // EDGE_BLOCK), 1) * EDGE_BLOCK
    rl = lay.tables["receivers_local"].reshape(S, e_loc)
    em = lay.tables["edge_mask"].reshape(S, e_loc)
    sl = lay.tables["senders_local"].reshape(S, e_loc)
    pad_r = np.int32(n_loc + ROW_BLOCK)
    rk = np.pad(np.where(em, rl, pad_r).astype(np.int32),
                ((0, 0), (0, e_pad - e_loc)), constant_values=pad_r)
    sk = np.pad(np.where(em, sl, 0).astype(np.int32),
                ((0, 0), (0, e_pad - e_loc)))
    starts, neblks = [], []
    for m in range(S):
        assert (np.diff(rk[m]) >= 0).all(), \
            "local receivers must be sorted for the GAS kernel"
        st_m, ne_m, _ = csr_block_offsets(rk[m], n_loc, ROW_BLOCK,
                                          EDGE_BLOCK)
        starts.append(st_m)
        neblks.append(ne_m)
    return {"gas_send": sk.reshape(-1), "gas_recv": rk.reshape(-1),
            "gas_start": np.concatenate(starts).astype(np.int32),
            "gas_neblk": np.concatenate(neblks).astype(np.int32)}


def stitch_rows(rows: Pytree, gid: np.ndarray, n: int) -> Pytree:
    """Machine-major padded rows back to global order: row i lands at
    ``gid[i]``; pad rows (gid < 0) are dropped."""
    ok = np.flatnonzero(np.asarray(gid) >= 0)

    def one(x):
        out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
        src = torch.from_numpy(ok).to(x.device)
        dst = torch.from_numpy(np.asarray(gid)[ok]).to(x.device)
        out[dst] = x[src]
        return out

    return tree_map(one, rows)


def _take_rows(tree: Pytree, idx: np.ndarray, device) -> Pytree:
    """Gathers global rows by id onto ``device`` (pad ids < 0 -> zero
    rows)."""
    ok = np.flatnonzero(idx >= 0)

    def one(x):
        x = torch.as_tensor(x).to(device)
        out = torch.zeros((idx.size,) + x.shape[1:], dtype=x.dtype,
                          device=device)
        out[torch.from_numpy(ok).to(device)] = x[
            torch.from_numpy(idx[ok]).to(device)]
        return out

    return tree_map(one, tree)


def _where_rows(m: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """Row-masked replace with a cast to the stored dtype."""
    mm = m.reshape((-1,) + (1,) * (old.ndim - 1))
    return torch.where(mm, new.to(old.dtype), old)


class ShardEngineBase:
    """Schedule-independent half of a distributed engine: partition
    layout, versioned ghost exchange, and the per-phase local update.

    ``exchange`` (``dist/exchange.py``) names the cluster (its
    ``n_machines`` S) and the machines held here; the step runs over those.
    Subclasses build their step from ``_phase_update`` and ``_exchange``.

    Sync ops (paper Sec. 3.5, DESIGN §3.9) evaluate at the step barrier:
    each machine folds ``map_fn`` over its owned rows, the partial sums
    meet in the exchange's ``psum``, and ``finalize`` runs on the result —
    every machine reads identical globals next step.  Inconsistent ops see
    the previous barrier's data, exactly as the local engines do.

    ``use_fused`` selects the fused gather⊕combine path as the local
    engines do (None: when the program qualifies).  ``device`` is where the
    engine runs; it must be the graph's device.
    """

    #: whether the step reads the local edge tables outside the gather (the
    #: locking engine's arbitration does)
    _arbitrates = False

    def __init__(
        self,
        program: VertexProgram,
        graph: DataGraph,
        exchange: Exchange,
        *,
        k_atoms: Optional[int] = None,
        method: str = "hash",
        tolerance: float = 1e-3,
        seed: int = 0,
        sync_ops: Sequence[SyncOp] = (),
        use_fused: Optional[bool] = None,
        wire: Optional[WireConfig] = None,
        atom_of: Optional[np.ndarray] = None,
        atom_placement: Optional[np.ndarray] = None,
        machine_of: Optional[np.ndarray] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        if graph.device.type != self.device.type:
            raise ValueError(f"graph lives on {graph.device}, engine asked "
                             f"for {self.device}")
        self.program = program
        self.graph = graph
        self.exchange = exchange
        self.tolerance = float(tolerance)
        self.sync_ops = tuple(sync_ops)
        self.wire = wire if wire is not None else WireConfig()
        st = graph.structure
        S = int(exchange.n_machines)
        k_atoms = k_atoms or max(4 * S, 32)
        # two-phase placement, with every intermediate overridable
        if machine_of is None:
            if atom_of is None:
                atom_of = overpartition(st, k_atoms, method=method,
                                        seed=seed)
            atom_of = np.asarray(atom_of, np.int32)
            if atom_placement is None:
                atom_placement = place_atoms(atom_meta_index(st, atom_of), S)
            atom_placement = np.asarray(atom_placement, np.int32)
            machine_of = atom_placement[atom_of]
        else:
            machine_of = np.asarray(machine_of, np.int32)
            if atom_of is not None:
                atom_of = np.asarray(atom_of, np.int32)
            if atom_placement is not None:
                atom_placement = np.asarray(atom_placement, np.int32)
        self.atom_of = atom_of
        self.atom_placement = atom_placement
        # reverse-edge ghost machinery only when the program reads
        # ctx.rev_edata (declared, defaulting to has_edge_out)
        use_rev = (program.reads_rev_edata
                   if program.reads_rev_edata is not None
                   else program.has_edge_out)
        # place_atoms may leave a machine empty on tiny graphs; the layout
        # pads every machine to the same shapes, so that is fine
        self.layout = build_layout(graph, np.asarray(machine_of, np.int32),
                                   S, use_rev)
        fusable = supports_fused_gather(program)
        self.use_fused = fusable if use_fused is None \
            else bool(use_fused) and fusable
        if self.use_fused:
            self._gas_leaves, self._gas_treedef = fused_gather_leaves(program)
            self.layout.tables.update(gas_tables(self.layout))
        self._device_tables()

    # -- the held machines' device tables -------------------------------------
    def _held(self, table: np.ndarray) -> np.ndarray:
        """The rows of a machine-major table that the held machines own."""
        S = self.layout.n_machines
        held = list(self.exchange.machines)
        if held == list(range(S)):
            return table
        return table.reshape((S, -1) + table.shape[1:])[held].reshape(
            (-1,) + table.shape[1:])

    def _device_tables(self) -> None:
        """Uploads what the step reads, stacked over the held machines.

        Rows of the stacked tables: own vertex rows ``m·n_loc + slot``, the
        ``[own; ghost]`` read table ``m·(n_loc + S·B) + local``, the dense
        sum's rows ``m·(n_loc + 1) + local`` (row ``n_loc`` of each machine
        takes its masked edges, so the receivers stay sorted), edge rows
        ``m·e_loc + local``, send slots ``(m·S + d)·B + b``."""
        lay, dev = self.layout, self.device
        S, n_loc, B = lay.n_machines, lay.n_loc, lay.budget
        e_loc, EB = lay.e_loc, lay.e_budget
        M = self.exchange.n_held
        tb = {k: self._held(v) for k, v in lay.tables.items()}
        m_e = np.repeat(np.arange(M, dtype=np.int64), e_loc)
        m_s = np.repeat(np.arange(M, dtype=np.int64), S * B)
        emask = tb["edge_mask"]
        sl = tb["senders_local"].astype(np.int64)
        rl = tb["receivers_local"].astype(np.int64)
        sl_all = m_e * (n_loc + S * B) + sl
        rl_own = m_e * n_loc + rl
        recv_dense = m_e * (n_loc + 1) + np.where(emask, rl, n_loc)

        def t(a, dtype=None):
            a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
            return torch.from_numpy(a).to(dev)

        self._t = {
            "own_mask": t(tb["own_mask"]),
            "edge_mask": t(emask),
            "src_deg_e": t(tb["src_deg_e"]),
            "dst_deg_e": t(tb["dst_deg_e"]),
            "send_rows": t(m_s * n_loc + tb["send_idx"], np.int64),
            "send_mask": t(tb["send_mask"]),
        }
        if lay.has_rev:
            m_es = np.repeat(np.arange(M, dtype=np.int64), S * EB)
            rv = tb["rev_local"].astype(np.int64)
            self._t["esend_rows"] = t(m_es * e_loc + tb["esend_idx"],
                                      np.int64)
            self._t["esend_mask"] = t(tb["esend_mask"])
            self._t["rev_all"] = t(np.where(
                rv >= 0, m_e * (e_loc + S * EB) + rv, 0), np.int64)
            self._t["has_rev"] = t(rv >= 0)
        if self.use_fused:
            # the stacked block-diagonal edge set of the held machines'
            # real edges, in machine-major, receiver-sorted order
            real = np.flatnonzero(emask)
            self._edges = EdgeSet.build(
                sl_all[real], rl_own[real], M * n_loc, perm=real,
                device=dev)
            self._scatter_w = self._t["edge_mask"].to(torch.float32)[
                self._edges.perm]
        dense = not self.use_fused
        if dense or self.program.has_edge_out or self._arbitrates:
            self._t["sl_all"] = t(sl_all, np.int64)
            self._t["rl_own"] = t(rl_own, np.int64)
        if dense or self._arbitrates:
            self._t["recv_dense"] = t(recv_dense, np.int64)
        if dense:
            self._dense_segments = RowSegments.build(
                recv_dense, M * (n_loc + 1), dev)

    # -- state ---------------------------------------------------------------
    def init(self, graph: Optional[DataGraph] = None,
             initial_prio: Optional[torch.Tensor] = None) -> DistState:
        graph = graph or self.graph
        st0 = self.graph.structure
        if graph.structure is not st0 and not (
                graph.structure.n_vertices == st0.n_vertices
                and np.array_equal(graph.structure.senders, st0.senders)
                and np.array_equal(graph.structure.receivers,
                                   st0.receivers)):
            raise ValueError(
                "init() graph structure differs from the one this engine "
                "was partitioned for; build a new engine")
        lay, dev = self.layout, self.device
        M = self.exchange.n_held
        vown = _take_rows(graph.vertex_data, self._held(lay.own_gid), dev)
        vghost = _take_rows(graph.vertex_data, self._held(lay.ghost_gid),
                            dev)
        edata = _take_rows(graph.edge_data, self._held(lay.erow_gid), dev)
        eghost = _take_rows(graph.edge_data, self._held(lay.eghost_gid),
                            dev) if lay.has_rev else {}
        prio_g = (torch.as_tensor(initial_prio, dtype=torch.float32)
                  if initial_prio is not None
                  else self.program.initial_priority(
                      graph.n_vertices).to(torch.float32))
        prio = _take_rows(prio_g, self._held(lay.own_gid), dev)

        def zeros(n, dtype=torch.int64):
            return torch.zeros(n, dtype=dtype, device=dev)

        return DistState(
            vown=vown, vghost=vghost, edata=edata, eghost=eghost, prio=prio,
            update_count=zeros(M * lay.n_loc, torch.int32),
            traffic_v=zeros(M), traffic_e=zeros(M), traffic_r=zeros(M),
            traffic_bytes_v=zeros(M), traffic_bytes_e=zeros(M),
            traffic_bytes_r=zeros(M), step_index=zeros(()),
            globals_=run_syncs(self.sync_ops, graph.vertex_data,
                               graph.vertex_data, graph.n_vertices))

    # -- the shared phase machinery -------------------------------------------
    def _stack(self, own: torch.Tensor, ghost: torch.Tensor,
               n_own: int, n_ghost: int) -> torch.Tensor:
        """Per held machine, its own rows then its ghost rows: the
        ``[own; ghost]`` read table, machine-major."""
        M = self.exchange.n_held
        t = own.shape[1:]
        return torch.cat([own.reshape((M, n_own) + t),
                          ghost.to(own.dtype).reshape((M, n_ghost) + t)],
                         dim=1).reshape((M * (n_own + n_ghost),) + t)

    def _v_all(self, vown: Pytree, vghost: Pytree) -> Pytree:
        lay = self.layout
        S = lay.n_machines
        return tree_map(lambda o, g: self._stack(o, g, lay.n_loc,
                                                 S * lay.budget),
                        vown, vghost)

    def _exchange(self, payload: Pytree, changed: torch.Tensor,
                  rows: torch.Tensor, mask: torch.Tensor, budget: int
                  ) -> Tuple[Pytree, torch.Tensor, torch.Tensor]:
        """The versioned all_to_all: ship only rows whose vertex (edge)
        changed.  Returns (received payload, received changed flags, rows
        shipped by each held machine [M])."""
        M = self.exchange.n_held
        ship = torch.logical_and(mask, changed[rows])
        keep_out = torch.logical_not(ship)

        def one(x):
            r = x[rows]       # a fresh tensor: zero the unshipped rows in it
            r.masked_fill_(keep_out.reshape((-1,) + (1,) * (r.ndim - 1)), 0)
            return self.exchange.all_to_all(r, budget)

        recv = tree_map(one, payload)
        recv_changed = self.exchange.all_to_all(ship, budget)
        shipped = torch.sum(ship.reshape(M, -1), dim=1, dtype=torch.int64)
        return recv, recv_changed, shipped

    def _dense_sum(self, vals: torch.Tensor) -> torch.Tensor:
        """Σ over each own row's local in-edges of ``vals`` [M·e_loc, ...]
        (masked edges dropped), through the sorted segment sum → [M·n_loc,
        ...]."""
        lay, M = self.layout, self.exchange.n_held
        flat = vals.reshape(vals.shape[0], -1)
        out = segment_sum_sorted(flat, self._t["recv_dense"],
                                 M * (lay.n_loc + 1),
                                 segments=self._dense_segments)
        out = out.reshape(M, lay.n_loc + 1, -1)[:, :lay.n_loc]
        return out.reshape((M * lay.n_loc,) + vals.shape[1:])

    def _dense_acc(self, msgs: Pytree) -> Pytree:
        prog, lay, M = self.program, self.layout, self.exchange.n_held
        if prog.combiner == "sum":
            return tree_map(self._dense_sum, msgs)
        acc = segment_combine(msgs, self._t["recv_dense"],
                              M * (lay.n_loc + 1), prog.combiner)
        return tree_map(lambda a: a.reshape(
            (M, lay.n_loc + 1) + a.shape[1:])[:, :lay.n_loc].reshape(
            (M * lay.n_loc,) + a.shape[1:]), acc)

    def _edge_ctx(self, v_all: Pytree, vown: Pytree, edata: Pytree,
                  eghost: Pytree) -> FixedEdgeCtx:
        lay, t = self.layout, self._t
        if lay.has_rev:
            e_all = tree_map(lambda o, g: self._stack(
                o, g, lay.e_loc, lay.n_machines * lay.e_budget),
                edata, eghost)

            def _rev(x):
                y = x[t["rev_all"]]
                m = t["has_rev"].reshape((-1,) + (1,) * (y.ndim - 1))
                return torch.where(m, y, torch.zeros_like(y))

            rev_edata = tree_map(_rev, e_all)
        else:
            # program declared it never reads ctx.rev_edata
            rev_edata = tree_map(torch.zeros_like, edata)
        return FixedEdgeCtx(
            edata=edata, rev_edata=rev_edata,
            src=tree_map(lambda x: x[t["sl_all"]], v_all),
            dst=tree_map(lambda x: x[t["rl_own"]], vown),
            src_deg=t["src_deg_e"], dst_deg=t["dst_deg_e"])

    def _fused_acc(self, v_all: Pytree, edata: Pytree,
                   active: torch.Tensor) -> Pytree:
        """The fused local compute: one stacked gather⊕combine launch a
        leaf over every held machine — no [e_loc, D] messages, and row
        blocks with no scheduled own vertex are skipped."""
        es, t = self._edges, self._t
        blk_active = active_row_blocks(active)
        accs = []
        for leaf in self._gas_leaves:
            feat = leaf.feature(v_all)
            trailing = feat.shape[1:]
            w = fused_edge_weight(leaf, edata, t["edge_mask"].shape[0],
                                  t["src_deg_e"], device=self.device)
            a = gather_combine(feat.reshape(feat.shape[0], -1), w[es.perm],
                               es, block_active=blk_active)
            accs.append(a.reshape((a.shape[0],) + trailing))
        return tree_unflatten(self._gas_treedef, accs)

    def _phase_update(self, carry: Dict[str, Any],
                      active: torch.Tensor) -> Dict[str, Any]:
        """One phase for the given active mask over the held machines:
        local gather⊕combine → apply → versioned vdata/contrib exchange →
        reschedule (losers keep their priority untouched) → adjacent-edge
        writes with their own versioned exchange.  ``carry`` is the dict
        {vown, vghost, edata, eghost, prio, count, tv, te, bv, be, glob}."""
        lay, prog, t = self.layout, self.program, self._t
        S, B, EB = lay.n_machines, lay.budget, lay.e_budget
        vown, vghost = carry["vown"], carry["vghost"]
        edata, eghost = carry["edata"], carry["eghost"]
        prio = carry["prio"]
        v_all = self._v_all(vown, vghost)

        ctx = None
        if self.use_fused:
            acc = self._fused_acc(v_all, edata, active)
        else:
            ctx = self._edge_ctx(v_all, vown, edata, eghost)
            acc = self._dense_acc(prog.gather(ctx))
        del v_all       # the [own; ghost] table: freed before the exchange

        new_v, residual = prog.apply(vown, acc, carry["glob"])
        vown = masked_update(vown, new_v, active)
        contrib = torch.where(active, prog.priority(
            residual.to(torch.float32)), torch.zeros((), device=self.device))

        # versioned ghost exchange: vdata (+acc for edge writes, +contrib
        # for remote scheduling) of the vertices updated this phase
        raw = {"v": vown, "contrib": contrib}
        if prog.has_edge_out:
            raw["acc"] = acc
        recv, recv_ch, shipped = self._exchange(
            raw, active, t["send_rows"], t["send_mask"], B)
        tv = carry["tv"] + shipped
        bv = carry["bv"] + shipped * payload_row_nbytes(raw)
        vghost = tree_map(lambda o, n: _where_rows(recv_ch, n, o), vghost,
                          recv["v"])
        ghost_contrib = torch.where(recv_ch, recv["contrib"],
                                    torch.zeros((), device=self.device))

        # T ← (T \ executed) ∪ T': winners consume their priority,
        # losers and remote vertices keep theirs
        if prog.schedule_neighbors:
            contrib_all = self._stack(contrib, ghost_contrib, lay.n_loc,
                                      S * B)
            if self.use_fused:
                prio = scatter_reschedule(contrib_all, prio, active,
                                          self._edges, self._scatter_w)
            else:
                prio = torch.where(active, torch.zeros_like(prio), prio)
                vals = torch.where(t["edge_mask"], contrib_all[t["sl_all"]],
                                   torch.zeros((), device=self.device))
                prio = prio + self._dense_sum(vals)
        else:
            prio = torch.where(active, torch.zeros_like(prio), prio)

        te, be = carry["te"], carry["be"]
        if prog.has_edge_out:
            recv_acc = tree_map(lambda a, r: torch.where(
                recv_ch.reshape((-1,) + (1,) * (r.ndim - 1)), r.to(a.dtype),
                torch.zeros((), dtype=a.dtype, device=self.device)),
                acc, recv["acc"])
            v_all2 = self._v_all(vown, vghost)
            acc_all = tree_map(lambda a, g: self._stack(
                a, g, lay.n_loc, S * B), acc, recv_acc)
            changed_all = self._stack(active, recv_ch, lay.n_loc, S * B)
            sl = t["sl_all"]
            new_src = tree_map(lambda x: x[sl], v_all2)
            ctx2 = ctx._replace(
                src=new_src, dst=tree_map(lambda x: x[t["rl_own"]], vown))
            src_acc = tree_map(lambda x: x[sl], acc_all)
            new_e = prog.edge_out(ctx2, new_src, src_acc)
            wmask = torch.logical_and(changed_all[sl], t["edge_mask"])
            edata = masked_update(edata, new_e, wmask)
            if lay.has_rev:  # refresh remote reverse-message caches
                erecv, erecv_ch, eshipped = self._exchange(
                    edata, wmask, t["esend_rows"], t["esend_mask"], EB)
                te = te + eshipped
                be = be + eshipped * payload_row_nbytes(edata)
                eghost = tree_map(lambda o, n: _where_rows(erecv_ch, n, o),
                                  eghost, erecv)

        return dict(vown=vown, vghost=vghost, edata=edata, eghost=eghost,
                    prio=prio, count=carry["count"] + active.to(torch.int32),
                    tv=tv, te=te, bv=bv, be=be, glob=carry["glob"])

    @staticmethod
    def _carry(state: DistState) -> Dict[str, Any]:
        return dict(vown=state.vown, vghost=state.vghost, edata=state.edata,
                    eghost=state.eghost, prio=state.prio,
                    count=state.update_count, tv=state.traffic_v,
                    te=state.traffic_e, bv=state.traffic_bytes_v,
                    be=state.traffic_bytes_e, glob=state.globals_)

    @staticmethod
    def _from_carry(state: DistState, carry: Dict[str, Any],
                    **kw) -> DistState:
        return state.replace(
            vown=carry["vown"], vghost=carry["vghost"], edata=carry["edata"],
            eghost=carry["eghost"], prio=carry["prio"],
            update_count=carry["count"], traffic_v=carry["tv"],
            traffic_e=carry["te"], traffic_bytes_v=carry["bv"],
            traffic_bytes_e=carry["be"], **kw)

    def _syncs(self, vown: Pytree, vown_prev: Pytree) -> Dict[str, Any]:
        """The §3.9 step-barrier sync: per-machine masked map_fn fold,
        cross-machine psum, finalize."""
        lay, M = self.layout, self.exchange.n_held
        own = self._t["own_mask"]
        out = {}
        for op in self.sync_ops:
            mapped = op.map_fn(vown if op.consistent else vown_prev)

            def fold(m):
                keep = own.reshape((-1,) + (1,) * (m.ndim - 1))
                part = torch.where(keep, m, torch.zeros_like(m)).reshape(
                    (M, lay.n_loc) + m.shape[1:]).sum(dim=1)
                return self.exchange.psum(part)

            out[op.name] = op.finalize(tree_map(fold, mapped),
                                       self.graph.n_vertices)
        return out

    def _body(self, state: DistState) -> DistState:
        raise NotImplementedError

    # -- drivers --------------------------------------------------------------
    def step(self, state: DistState) -> DistState:
        vown_prev = state.vown
        state = self._body(state)
        if self.sync_ops:
            state = state.replace(globals_=self._syncs(state.vown,
                                                       vown_prev))
        return state.replace(step_index=state.step_index + 1)

    def _row(self, state: DistState) -> Dict[str, torch.Tensor]:
        """The JAX package's ``lazy_dist_row`` keys as device scalars."""
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        return {
            "step": state.step_index,
            "updates": torch.sum(state.update_count),
            "edges_touched": zero,
            "residual_max": torch.max(state.prio),
            "backlog": torch.sum(state.prio > self.tolerance),
            "wire_backlog": zero,
            "traffic_rows_v": torch.sum(state.traffic_v),
            "traffic_bytes_v": torch.sum(state.traffic_bytes_v),
            "traffic_rows_e": torch.sum(state.traffic_e),
            "traffic_bytes_e": torch.sum(state.traffic_bytes_e),
            "traffic_rows_r": torch.sum(state.traffic_r),
            "traffic_bytes_r": torch.sum(state.traffic_bytes_r),
        }

    def converged(self, state: DistState) -> bool:
        """Every held priority at or below the tolerance (NaN counts as
        not converged) — the run loop's one host sync a step."""
        p = state.prio
        top = torch.max(torch.where(torch.isnan(p),
                                    torch.full_like(p, torch.inf), p))
        return float(top) <= self.tolerance

    def run(self, state: DistState, max_steps: int = 100
            ) -> Tuple[DistState, List[Dict[str, Any]]]:
        """Host driver loop: step until every priority is at or below the
        tolerance.  Returns ``(state, rows)``, one row a step with the JAX
        package's dist-row keys (``step``, ``updates``, ``residual_max``,
        ``backlog``, ``traffic_{rows,bytes}_{v,e,r}``, ...), fetched in one
        device→host copy when the loop ends."""
        pending = []
        for _ in range(max_steps):
            if self.converged(state):
                break
            state = self.step(state)
            pending.append(self._row(state))
        return state, drain_rows(pending)

    # -- readback -------------------------------------------------------------
    def vertex_data(self, state: DistState) -> Pytree:
        """Owned rows stitched back to global vertex order [N, ...] (the
        held machines' vertices; others stay zero)."""
        return stitch_rows(state.vown, self._held(self.layout.own_gid),
                           self.graph.n_vertices)

    def edge_data(self, state: DistState) -> Pytree:
        """Owned edge rows stitched back to global edge order [E, ...]."""
        return stitch_rows(state.edata, self._held(self.layout.erow_gid),
                           self.graph.n_edges)

    def update_counts(self, state: DistState) -> torch.Tensor:
        """Per-vertex update counts in global vertex order [N]."""
        return stitch_rows(state.update_count,
                           self._held(self.layout.own_gid),
                           self.graph.n_vertices)

    def ghost_rows_sent(self, state: DistState) -> int:
        return int(torch.sum(state.traffic_v))

    def ghost_edge_rows_sent(self, state: DistState) -> int:
        return int(torch.sum(state.traffic_e))

    def rank_rows_sent(self, state: DistState) -> int:
        """Arbitration rank rows shipped (the locking engine's lock-request
        traffic; always 0 for the sweep-scheduled engine)."""
        return int(torch.sum(state.traffic_r))

    def ghost_bytes_sent(self, state: DistState) -> int:
        """Payload bytes of the vertex ghost rows shipped."""
        return int(torch.sum(state.traffic_bytes_v))

    def ghost_edge_bytes_sent(self, state: DistState) -> int:
        return int(torch.sum(state.traffic_bytes_e))

    def rank_bytes_sent(self, state: DistState) -> int:
        return int(torch.sum(state.traffic_bytes_r))

    def total_ghost_slots(self) -> int:
        """Distinct (vertex, caching machine) pairs — the per-sweep upper
        bound on versioned traffic when every vertex updates."""
        return int(self.layout.tables["send_mask"].sum())


class DistributedEngine(ShardEngineBase):
    """The sweep-scheduled distributed engine (paper Sec. 4.2.1):
    ``step(state)`` is one chromatic sweep; within a color every machine
    updates its scheduled own vertices of that color.  A proper coloring
    makes same-color vertices non-adjacent, so refreshing ghosts once per
    color-step reproduces the shared-memory engine's reads exactly, and
    the fixed point matches ``ChromaticEngine`` to float tolerance."""

    def __init__(self, program: VertexProgram, graph: DataGraph,
                 exchange: Exchange, *,
                 colors: Optional[np.ndarray] = None, **kw):
        super().__init__(program, graph, exchange, **kw)
        st = graph.structure
        if colors is None:
            colors = coloring_for(st, program.consistency)
        colors = np.asarray(colors, np.int32)
        radius = program.consistency.exclusion_radius
        if radius >= 1 and not verify_coloring(st, colors, radius):
            raise ValueError(f"coloring does not satisfy "
                             f"{program.consistency} (radius {radius})")
        self.num_colors = int(colors.max()) + 1 if colors.size else 1
        self.colors = colors
        colors_own = np.zeros(self.layout.n_machines * self.layout.n_loc,
                              np.int32)
        ok = self.layout.own_gid >= 0
        colors_own[ok] = colors[self.layout.own_gid[ok]]
        self.layout.tables["colors_own"] = colors_own
        self._t["colors_own"] = torch.from_numpy(
            self._held(colors_own)).to(self.device)

    def _body(self, state: DistState) -> DistState:
        carry = self._carry(state)
        own = self._t["own_mask"]
        for c in range(self.num_colors):
            active = torch.logical_and(own, sweep_mask(
                self._t["colors_own"], carry["prio"], self.tolerance, c))
            carry = self._phase_update(carry, active)
        return self._from_carry(state, carry)
