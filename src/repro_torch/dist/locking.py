"""The distributed pipelined-locking engine (paper Sec. 4.2.2, Fig. 8(b)).

The paper's second engine replaces the color sweep with dynamically
prioritized scheduling: each machine keeps its own priority queue and a
**pipeline** of up to *p* in-flight lock requests over vertex scopes;
pipelining hides lock latency at the price of violating strict priority
order (Fig. 8(b): updates-to-convergence rise with p while wall time —
steps, here — falls).

There are no per-vertex RW locks or callback RPC; the mechanism maps onto
bulk tensor operations while preserving the observable semantics:

  - per-machine queue + pipeline → each machine top-k's its own scheduled
    vertices (``scheduler.pipeline_select`` over the held machines' rows,
    k = p);
  - lock acquisition in canonical order (owner(v), v) → the globally unique
    arbitration rank ``slot * S + machine`` (``scheduler.pipeline_ranks``);
  - the lock-request RPC → ranks of selected boundary vertices ship through
    the **existing versioned ghost-exchange tables**: a ghost rank row
    ships only when its vertex is selected (``traffic_r`` counts them);
  - lock grant → a selected vertex executes iff it holds the minimum rank
    in its exclusion neighborhood (distance 1 for edge consistency,
    distance 2 for full — relayed through a second versioned exchange of
    per-vertex closed-neighborhood minima);
  - a denied lock → losers keep their priority untouched and retry next
    step, a request still queued in the pipeline.

Arbitration needs every conflict edge visible on both sides: machine A
learns about (u_A, v_B) from its own edge rows only if the reverse edge
lives with it, so ``serializable=True`` requires a symmetrized structure.
The minimum-rank selected vertex always wins, so every step makes
progress; the fixed point matches ``DynamicEngine``.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import DataGraph
from repro_torch.core.scheduler import (check_rank_range, pipeline_ranks,
                                        pipeline_select)
from repro_torch.core.update import VertexProgram
from repro_torch.dist.engine import DistState, ShardEngineBase
from repro_torch.dist.exchange import Exchange

#: bytes of one shipped arbitration rank (f32: the default wire)
RANK_NBYTES = 4


class DistributedLockingEngine(ShardEngineBase):
    """Per-machine prioritized top-p selection + cross-machine ghost-rank
    lock arbitration; one engine step = one pipeline round."""

    _arbitrates = True

    def __init__(self, program: VertexProgram, graph: DataGraph,
                 exchange: Exchange, *, pipeline_length: int = 1024,
                 serializable: bool = True, **kw):
        super().__init__(program, graph, exchange, **kw)
        self.serializable = bool(serializable)
        self.radius = program.consistency.exclusion_radius
        if self.serializable and self.radius >= 1 and \
                (graph.structure.reverse_perm < 0).any():
            raise ValueError(
                "DistributedLockingEngine arbitration requires a "
                "symmetrized structure (every edge's reverse present): "
                "machine A only sees the conflict edge (u_A, v_B) if the "
                "reverse edge lives with A")
        # p is per machine, like the paper's per-machine pipeline; the
        # per-machine queue can never hold more than n_loc vertices
        self.pipeline_length = int(min(pipeline_length, self.layout.n_loc))
        if self.serializable:
            check_rank_range(
                self.pipeline_length * self.layout.n_machines,
                "DistributedLockingEngine")

    def _nb_min(self, vals_by_edge: torch.Tensor) -> torch.Tensor:
        """min over each own vertex's in-edges (= its full neighborhood on
        a symmetrized structure); masked edges hit each machine's dropped
        row ``n_loc``; empty neighborhoods give +inf."""
        lay, M = self.layout, self.exchange.n_held
        out = torch.full((M * (lay.n_loc + 1),), torch.inf,
                         dtype=vals_by_edge.dtype, device=self.device)
        out = out.scatter_reduce_(0, self._t["recv_dense"], vals_by_edge,
                                  "amin", include_self=True)
        return out.reshape(M, lay.n_loc + 1)[:, :lay.n_loc].reshape(-1)

    def _body(self, state: DistState) -> DistState:
        lay, t = self.layout, self._t
        S, n_loc, B = lay.n_machines, lay.n_loc, lay.budget
        M = self.exchange.n_held
        dev, inf = self.device, torch.inf
        carry = self._carry(state)
        tr, br = state.traffic_r, state.traffic_bytes_r

        # -- per-machine pipeline: top-p of each held machine's queue ------
        prio_eff = torch.where(t["own_mask"], carry["prio"],
                               torch.zeros((), device=dev))
        grid = prio_eff.reshape(M, n_loc)
        selected, top_idx = pipeline_select(grid, self.pipeline_length,
                                            self.tolerance)
        selected = selected.reshape(-1)
        radius = self.radius if self.serializable else 0
        if radius >= 1:
            # canonical order (owner(v), v): rank = slot * S + machine,
            # globally unique and comparable across machines
            m = torch.tensor(list(self.exchange.machines),
                             dtype=torch.float32, device=dev)[:, None]
            rank = pipeline_ranks(grid, top_idx, self.tolerance, stride=S,
                                  offset=m).reshape(-1)

            def full(x):
                return torch.full_like(x, inf)

            # -- lock requests: selected boundary ranks ride the versioned
            # ghost tables -------------------------------------------------
            recv, recv_ch, shipped = self._exchange(
                {"r": rank}, selected, t["send_rows"], t["send_mask"], B)
            tr = tr + shipped
            br = br + shipped * RANK_NBYTES
            ghost_rank = torch.where(recv_ch, recv["r"], full(recv["r"]))
            rank_all = self._stack(rank, ghost_rank, n_loc, S * B)

            sl, rl, emask = t["sl_all"], t["rl_own"], t["edge_mask"]
            edge_rank = torch.where(emask, rank_all[sl], inf)
            d1 = self._nb_min(edge_rank)

            if radius >= 2:
                # distance-2 (full consistency): relay each middle vertex
                # u's closed-neighborhood (min, second-min) — the second
                # min breaks the v→u→v self-inclusion that would deadlock
                # every non-isolated vertex (core/scheduler.py)
                c1 = torch.minimum(rank, d1)

                def drop(vals, ref):
                    return torch.where(vals == ref, full(vals), vals)

                c2 = torch.minimum(drop(rank, c1), self._nb_min(
                    torch.where(emask, drop(rank_all[sl], c1[rl]), inf)))
                erecv, erecv_ch, shipped2 = self._exchange(
                    {"c1": c1, "c2": c2}, torch.isfinite(c1),
                    t["send_rows"], t["send_mask"], B)
                tr = tr + shipped2
                br = br + shipped2 * (2 * RANK_NBYTES)
                c1_all = self._stack(c1, torch.where(
                    erecv_ch, erecv["c1"], full(erecv["c1"])), n_loc, S * B)
                c2_all = self._stack(c2, torch.where(
                    erecv_ch, erecv["c2"], full(erecv["c2"])), n_loc, S * B)
                relay = torch.where(c1_all[sl] == rank[rl], c2_all[sl],
                                    c1_all[sl])
                d1 = torch.minimum(d1, self._nb_min(
                    torch.where(emask, relay, inf)))

            # lock grant: strictly beat every rank in the exclusion
            # neighborhood (ranks are unique among selected)
            win = torch.logical_and(selected, rank < d1)
        else:
            win = selected

        carry = self._phase_update(carry, win)
        return self._from_carry(state, carry, traffic_r=tr,
                                traffic_bytes_r=br)
