"""The Scheduler subsystem (paper Secs. 3.3, 4.2.2).

GraphLab separates *what* an update computes (the VertexProgram) from *when*
it runs (the scheduler T).  The paper ships a family of schedulers — sweep,
FIFO, prioritized, and the locking engine's per-machine queues with a
pipeline of in-flight lock requests — and every engine consumes the same
``T ← (T \\ executed) ∪ T'`` contract.

The scheduler is tensor-native: T is a priority tensor (active ⇔
``prio > tolerance``) and a scheduler is four operations over it:

  init(prio)                        -> sched state (dict; () if stateless)
  select(sched, prio, phase)        -> (execute mask, sched)
  reschedule(sched, prio, mask, r)  -> (prio, sched)   # T \\ executed ∪ T'
  done(sched, prio)                 -> scalar bool tensor

Lock arbitration (paper Sec. 4.2.2): a parallel step may only execute an
independent set under the program's consistency model.  The pipelined
selection gives each selected vertex a unique finite *rank* (0 = highest
priority); a vertex wins iff it holds the minimum rank in its exclusion
neighborhood (distance 1 for edge consistency, distance 2 for full, none
for vertex consistency).  Losers keep their priority and retry.

Top-k is a stable descending sort: ties break toward the lower vertex id,
as ``lax.top_k`` does in the JAX package (``torch.topk`` promises no order
among ties, and PageRank's initial priorities are all equal).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import GraphStructure, scatter_to_neighbors
from repro_torch.kernels.gas.ops import scatter_reschedule

Pytree = Any
_INT32_MAX = torch.iinfo(torch.int32).max
_INT32_MIN = torch.iinfo(torch.int32).min


# ---------------------------------------------------------------------------
# Pure primitives
# ---------------------------------------------------------------------------

def _segment_reduce(vals: torch.Tensor, idx: torch.Tensor, n: int,
                    reduce: str) -> torch.Tensor:
    """segment min/max with the ±inf identity for empty segments."""
    fill = torch.inf if reduce == "amin" else -torch.inf
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx, vals, reduce, include_self=True)


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int
                 ) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx, vals)


def top_k_indices(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, ties toward the
    lower index (stable descending sort)."""
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def scheduled_mask(prio: torch.Tensor, tolerance: float) -> torch.Tensor:
    """Membership in T: a vertex is scheduled iff its priority exceeds tol."""
    return prio > tolerance


def sweep_mask(colors: torch.Tensor, prio: torch.Tensor, tolerance: float,
               phase: int) -> torch.Tensor:
    """One color-step of the sweep schedule: scheduled ∧ color == phase."""
    return torch.logical_and(colors == phase, scheduled_mask(prio, tolerance))


def pipeline_select(prio: torch.Tensor, k: int, tolerance: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k scheduled vertices — the pipeline of in-flight lock requests.

    Returns ``(selected [..., N] bool, top_idx [..., k])`` along the last
    dim (one queue a row of a ``[S, n_loc]`` batch: the distributed
    locking engine's per-machine pipelines); ties break toward lower
    vertex id, the paper's canonical ordering.
    """
    in_t = scheduled_mask(prio, tolerance)
    masked = torch.where(in_t, prio, torch.full_like(prio, -torch.inf))
    top_idx = top_k_indices(masked, k)
    in_top = torch.zeros_like(in_t).scatter_(-1, top_idx, True)
    return torch.logical_and(in_top, in_t), top_idx


def pipeline_ranks(prio: torch.Tensor, top_idx: torch.Tensor,
                   tolerance: float, *, stride: int = 1,
                   offset=0) -> torch.Tensor:
    """Arbitration rank per vertex: position in the top-k list, +inf for
    unselected, along the last dim.  ``stride``/``offset`` interleave ranks
    across disjoint selectors (``offset`` may be a tensor broadcast over a
    batch, e.g. ``[S, 1]`` machine ids).  Ranks are f32 so +inf is the
    segment-min identity; they are exact only below 2**24
    (``check_rank_range``)."""
    k = top_idx.shape[-1]
    ranks = torch.arange(k, dtype=torch.float32,
                         device=prio.device) * stride + offset
    in_top = scheduled_mask(prio, tolerance).gather(-1, top_idx)
    vals = torch.where(in_top, ranks, torch.full_like(ranks, torch.inf))
    rank = torch.full(prio.shape, torch.inf, dtype=torch.float32,
                      device=prio.device)
    return rank.scatter_(-1, top_idx, vals.expand(top_idx.shape))


def check_rank_range(max_rank: int, what: str) -> None:
    """Reject configurations whose arbitration ranks exceed f32 integer
    precision (2**24): colliding ranks make tied neighbors both lose
    arbitration forever."""
    if max_rank >= 2 ** 24:
        raise ValueError(
            f"{what}: arbitration rank range {max_rank} exceeds f32 "
            f"integer precision (2**24); ranks would collide and tied "
            f"exclusion neighbors would livelock")


def neighbor_min(key: torch.Tensor, senders, receivers, n: int
                 ) -> torch.Tensor:
    """min over in/out neighbors of ``key`` (symmetrized one-hop); empty
    neighborhoods give +inf."""
    m1 = _segment_reduce(key[senders], receivers, n, "amin")
    m2 = _segment_reduce(key[receivers], senders, n, "amin")
    return torch.minimum(m1, m2)


def _drop(vals, ref):
    return torch.where(vals == ref, torch.full_like(vals, torch.inf), vals)


def _closed_neighborhood_two_mins(rank, senders, receivers, n):
    """(c1, c2): smallest and second-smallest rank over each vertex's
    *closed* neighborhood N[u] = {u} ∪ N(u)."""
    c1 = torch.minimum(rank, neighbor_min(rank, senders, receivers, n))
    m1 = _segment_reduce(_drop(rank[senders], c1[receivers]), receivers, n,
                         "amin")
    m2 = _segment_reduce(_drop(rank[receivers], c1[senders]), senders, n,
                         "amin")
    c2 = torch.minimum(_drop(rank, c1), torch.minimum(m1, m2))
    return c1, c2


def exclusion_min(rank: torch.Tensor, senders, receivers, n: int,
                  radius: int) -> torch.Tensor:
    """min rank over each vertex's distance-≤``radius`` exclusion
    neighborhood, **excluding the vertex itself** (+inf when radius is 0).

    Radius 2 relays, per middle vertex u, the min over N[u] *excluding the
    destination*: c1[u] unless that min *is* rank[v], then c2[u] — counting
    v's own rank over a v→u→v path would deadlock every vertex.
    """
    if radius <= 0:
        return torch.full((n,), torch.inf, dtype=rank.dtype,
                          device=rank.device)
    d1 = neighbor_min(rank, senders, receivers, n)
    if radius == 1:
        return d1
    c1, c2 = _closed_neighborhood_two_mins(rank, senders, receivers, n)

    def relay(mid, dst):
        return torch.where(c1[mid] == rank[dst], c2[mid], c1[mid])

    d2 = torch.minimum(
        _segment_reduce(relay(senders, receivers), receivers, n, "amin"),
        _segment_reduce(relay(receivers, senders), senders, n, "amin"))
    return torch.minimum(d1, d2)


def exclusion_winners(selected: torch.Tensor, rank: torch.Tensor, senders,
                      receivers, n: int, radius: int) -> torch.Tensor:
    """Lock arbitration: a selected vertex wins iff it strictly beats every
    rank in its exclusion neighborhood.  The global minimum-rank vertex
    always wins, so every arbitration round makes progress."""
    if radius <= 0:
        return selected
    nb = exclusion_min(rank, senders, receivers, n, radius)
    return torch.logical_and(selected, rank < nb)


def reschedule_prio(program, structure, prio: torch.Tensor,
                    mask: torch.Tensor, residual: torch.Tensor,
                    scatter=None) -> torch.Tensor:
    """T ← (T \\ executed) ∪ T' — executed vertices consume their priority;
    their priority contribution is scattered to neighbors (Alg. 1 pattern).

    ``scatter`` (a ``kernels.gas.ops.ScatterCtx``) routes the whole
    consume-and-deposit through the fused scatter/reschedule kernel; its
    plain version computes what the dense branch below computes."""
    if scatter is not None and program.schedule_neighbors:
        contrib = torch.where(mask, program.priority(residual),
                              torch.zeros_like(residual))
        return scatter_reschedule(contrib, prio, mask, scatter.edges,
                                  scatter.weights)
    prio = torch.where(mask, torch.zeros_like(prio), prio)
    if program.schedule_neighbors:
        contrib = torch.where(mask, program.priority(residual),
                              torch.zeros_like(residual))
        prio = prio + scatter_to_neighbors(contrib, structure, "out")
    return prio


def reseed_scopes(prio: torch.Tensor, touched: torch.Tensor,
                  senders: torch.Tensor, receivers: torch.Tensor,
                  edge_mask: torch.Tensor, n: int,
                  seed_prio) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-seeds scheduler priority for exactly the scopes whose data
    changed — the distance-1 *closed* neighborhoods of the touched
    vertices.  Returns ``(new prio, scope mask)``; priorities only rise
    (``max(prio, seed)``)."""
    s, r = senders.long(), receivers.long()
    t_i = touched.to(torch.int32)
    zero = torch.zeros_like(t_i[s])
    recv_idx = torch.where(edge_mask, r, torch.full_like(r, n))
    fwd = _segment_sum(torch.where(edge_mask, t_i[s], zero), recv_idx,
                       n + 1)[:n]
    send_idx = torch.where(edge_mask, s, torch.full_like(s, n))
    bwd = _segment_sum(torch.where(edge_mask, t_i[r], zero), send_idx,
                       n + 1)[:n]
    scope = torch.logical_or(touched, (fwd + bwd) > 0)
    seed = torch.as_tensor(seed_prio, dtype=prio.dtype, device=prio.device)
    prio = torch.where(scope, torch.maximum(prio, seed), prio)
    return prio, scope


def marker_wave(pending: torch.Tensor, done: torch.Tensor, structure
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The snapshot update's prioritized phase (paper Alg. 5) as a scheduler
    primitive: the frontier is the scheduled-and-unexecuted set, and its
    reschedule marks every unmarked neighbor (both edge directions)."""
    frontier = torch.logical_and(pending, torch.logical_not(done))
    reached = scatter_to_neighbors(
        frontier.to(torch.int32), structure, "both") > 0
    return frontier, torch.logical_or(pending, reached)


def marker_wave_local(marked_src: torch.Tensor, pending: torch.Tensor,
                      senders_local: torch.Tensor, recv_idx: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """One hop of the marker wave over a machine's *local* edge tables:
    receivers of a newly marked source become pending.  Pad edge rows must
    route to segment ``n_out`` via ``recv_idx``."""
    vals = marked_src[senders_local.long()].to(torch.int32)
    out = torch.zeros(n_out + 1, dtype=torch.int32, device=vals.device)
    reached = out.scatter_reduce_(0, recv_idx.long(), vals, "amax",
                                  include_self=True)[:n_out] > 0
    return torch.logical_or(pending, reached)


# ---------------------------------------------------------------------------
# The Scheduler API
# ---------------------------------------------------------------------------

class Scheduler:
    """Base: holds the program (priority fn + consistency), the static
    structure (exclusion neighborhoods, T' scatter) and the tolerance that
    defines membership in T."""

    num_phases: int = 1

    def __init__(self, program, structure: GraphStructure, tolerance: float):
        self.program = program
        self.structure = structure
        self.tolerance = float(tolerance)
        t = structure.device_arrays()
        self._senders = t["senders"]
        self._receivers = t["receivers"]

    @property
    def device(self) -> torch.device:
        return self.structure.device

    # -- API ------------------------------------------------------------------
    def init(self, prio: torch.Tensor) -> Pytree:
        return ()

    def select(self, sched: Pytree, prio: torch.Tensor, phase: int = 0
               ) -> Tuple[torch.Tensor, Pytree]:
        raise NotImplementedError

    def reschedule(self, sched: Pytree, prio: torch.Tensor,
                   mask: torch.Tensor, residual: torch.Tensor, scatter=None
                   ) -> Tuple[torch.Tensor, Pytree]:
        return reschedule_prio(self.program, self.structure, prio, mask,
                               residual, scatter=scatter), sched

    def done(self, sched: Pytree, prio: torch.Tensor) -> torch.Tensor:
        return torch.max(prio) <= self.tolerance

    def backlog(self, sched: Pytree, prio: torch.Tensor) -> torch.Tensor:
        """Scheduled-set size |T| (vertices with prio > tol), a device
        scalar; NaN priorities compare False."""
        return torch.sum(scheduled_mask(prio, self.tolerance))

    # -- shared arbitration ---------------------------------------------------
    def _arbitrate(self, selected: torch.Tensor, rank: torch.Tensor
                   ) -> torch.Tensor:
        return exclusion_winners(
            selected, rank, self._senders, self._receivers,
            self.structure.n_vertices,
            self.program.consistency.exclusion_radius)


class SweepScheduler(Scheduler):
    """Color-range sweep (paper Sec. 4.2.1): phase c executes every
    scheduled vertex of color c.  A single color (vertex consistency) is the
    BSP schedule; a proper / distance-2 coloring realizes edge / full
    consistency.  Stateless."""

    def __init__(self, program, structure, tolerance,
                 colors: Optional[np.ndarray] = None):
        super().__init__(program, structure, tolerance)
        if colors is None:
            colors = np.zeros(structure.n_vertices, np.int32)
        colors = np.asarray(colors, np.int32)
        self.colors = torch.from_numpy(colors).to(self.device)
        self.num_phases = int(colors.max()) + 1 if colors.size else 1

    def select(self, sched, prio, phase=0):
        return sweep_mask(self.colors, prio, self.tolerance, phase), sched


class PriorityScheduler(Scheduler):
    """Dynamically prioritized top-k pipeline + lock arbitration (paper
    Sec. 4.2.2).  ``pipeline_length`` is the depth p of in-flight lock
    requests: k = 1 is exact serial priority order, large k trades strict
    priority order for machine efficiency (Fig. 3(b)/8(b)).
    ``serializable=False`` skips arbitration and races (Fig. 1(d))."""

    def __init__(self, program, structure, tolerance, pipeline_length: int,
                 serializable: bool = True):
        super().__init__(program, structure, tolerance)
        self.pipeline_length = int(min(pipeline_length, structure.n_vertices))
        self.serializable = bool(serializable)
        if self.serializable:
            check_rank_range(self.pipeline_length, "PriorityScheduler")

    def select(self, sched, prio, phase=0):
        selected, top_idx = pipeline_select(
            prio, self.pipeline_length, self.tolerance)
        if not self.serializable:
            return selected, sched
        rank = pipeline_ranks(prio, top_idx, self.tolerance)
        return self._arbitrate(selected, rank), sched


class FifoScheduler(Scheduler):
    """FIFO queue approximation: vertices are served in enqueue-round order
    (ties toward lower id), k at a time, with the same lock arbitration.
    Stateful — ``sched`` carries per-vertex enqueue rounds and the clock."""

    def __init__(self, program, structure, tolerance, pipeline_length: int,
                 serializable: bool = True):
        super().__init__(program, structure, tolerance)
        self.pipeline_length = int(min(pipeline_length, structure.n_vertices))
        self.serializable = bool(serializable)

    def init(self, prio):
        enq = torch.where(scheduled_mask(prio, self.tolerance),
                          torch.zeros_like(prio, dtype=torch.int32),
                          torch.full_like(prio, _INT32_MAX,
                                          dtype=torch.int32))
        return {"enq": enq,
                "clock": torch.ones((), dtype=torch.int32,
                                    device=prio.device)}

    def select(self, sched, prio, phase=0):
        n = self.structure.n_vertices
        in_t = scheduled_mask(prio, self.tolerance)
        # oldest first: top-k of the negated round, ties by lower id
        key = torch.where(in_t, -sched["enq"],
                          torch.full_like(sched["enq"], _INT32_MIN))
        top_idx = top_k_indices(key, self.pipeline_length)
        in_top = torch.zeros(n, dtype=torch.bool, device=prio.device)
        in_top[top_idx] = True
        selected = torch.logical_and(in_top, in_t)
        if not self.serializable:
            return selected, sched
        rank = pipeline_ranks(prio, top_idx, self.tolerance)
        return self._arbitrate(selected, rank), sched

    def reschedule(self, sched, prio, mask, residual, scatter=None):
        was_in = scheduled_mask(prio, self.tolerance)
        prio = reschedule_prio(self.program, self.structure, prio, mask,
                               residual, scatter=scatter)
        now_in = scheduled_mask(prio, self.tolerance)
        # (re-)enqueue at the current clock anything that entered T this
        # round: executed-and-rescheduled vertices go to the back of the
        # queue, vertices that stayed scheduled keep their round
        fresh = torch.logical_and(now_in, torch.logical_or(
            mask, torch.logical_not(was_in)))
        enq = torch.where(
            fresh, sched["clock"],
            torch.where(now_in, sched["enq"],
                        torch.full_like(sched["enq"], _INT32_MAX)))
        return prio, {"enq": enq, "clock": sched["clock"] + 1}


class MultiQueueScheduler(Scheduler):
    """The paper's per-machine schedulers (Sec. 4.2.2): vertex v lives in
    queue ``machine_of[v]``; each of the S queues independently pops its
    top-p scheduled vertices, and arbitration runs over the union with the
    globally unique rank ``slot * S + machine``."""

    def __init__(self, program, structure, tolerance, machine_of: np.ndarray,
                 pipeline_length: int, serializable: bool = True):
        super().__init__(program, structure, tolerance)
        machine_of = np.asarray(machine_of, np.int32)
        if machine_of.shape != (structure.n_vertices,):
            raise ValueError("machine_of must be [n_vertices]")
        self.n_machines = int(machine_of.max()) + 1 if machine_of.size else 1
        counts = np.bincount(machine_of, minlength=self.n_machines)
        n_loc = max(int(counts.max()), 1)
        self.pipeline_length = int(min(pipeline_length, n_loc))
        self.serializable = bool(serializable)
        if self.serializable:
            check_rank_range(self.pipeline_length * self.n_machines,
                             "MultiQueueScheduler")
        # static machine-major padded layout: queue m owns row block m
        order = np.argsort(machine_of, kind="stable")
        slot = np.zeros(structure.n_vertices, np.int64)
        offs = np.concatenate([[0], np.cumsum(counts)])
        slot[order] = np.arange(structure.n_vertices) - offs[
            machine_of[order]]
        row_of = machine_of.astype(np.int64) * n_loc + slot
        gid = np.full(self.n_machines * n_loc, -1, np.int64)
        gid[row_of] = np.arange(structure.n_vertices)
        self._n_loc = n_loc
        self._gid = torch.from_numpy(np.maximum(gid, 0)).to(self.device)
        self._pad = torch.from_numpy(gid >= 0).to(self.device)

    def select(self, sched, prio, phase=0):
        n, S, k = self.structure.n_vertices, self.n_machines, \
            self.pipeline_length
        dev = prio.device
        in_t = scheduled_mask(prio, self.tolerance)
        # [S, n_loc] padded priority matrix; batched per-queue top-k
        grid = torch.logical_and(self._pad, in_t[self._gid])
        pgrid = torch.where(grid, prio[self._gid],
                            torch.full_like(prio[self._gid], -torch.inf)
                            ).reshape(S, self._n_loc)
        top = top_k_indices(pgrid, k)                           # [S, k]
        rows = (torch.arange(S, device=dev)[:, None] * self._n_loc
                + top).reshape(-1)
        slot_rank = torch.arange(k, dtype=torch.float32,
                                 device=dev).repeat(S, 1)
        qrank = (slot_rank * S + torch.arange(
            S, dtype=torch.float32, device=dev)[:, None]).reshape(-1)
        vids = self._gid[rows]
        ok = torch.logical_and(self._pad[rows], in_t[vids])
        # padded queue rows alias vertex 0: accumulate with max/min so a
        # pad row can never clobber a real selection
        selected = torch.zeros(n, dtype=torch.int32, device=dev)
        selected = selected.scatter_reduce_(0, vids, ok.to(torch.int32),
                                            "amax", include_self=True) > 0
        rank = _segment_reduce(
            torch.where(ok, qrank, torch.full_like(qrank, torch.inf)),
            vids, n, "amin")
        if not self.serializable:
            return selected, sched
        return self._arbitrate(selected, rank), sched
