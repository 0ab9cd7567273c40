"""Simulated distributed runtime (paper Sec. 4.4 system design, Sec. 5 eval).

The distributed engines (``dist/engine.py``) run the partitioned graph for
real.  This module provides the complement: a *faithful
performance model* of the paper's 64-machine cluster driven by the real
engine execution, used to reproduce the paper's distributed experiments
(scaling Fig. 6, pipeline sweep Fig. 3/8, snapshots Fig. 4) on a machine
without a cluster:

  - vertices are placed by the two-phase atom partitioner;
  - ghost sets are derived exactly (which machines cache which vertices);
  - per engine step, the machines' compute work is the number of vertex
    updates they own, and their traffic is the *versioned-ghost* traffic:
    only vertices modified this step are transmitted, once per remote
    machine holding a ghost ("each machine receives each modified vertex
    data at most once", Sec. 5.1);
  - wall time of a step = max over machines (synchronous barrier) of
    compute + comm + latency, plus injectable per-machine delays
    (the Fig. 4(b) multi-tenancy straggler).

Everything observable (values, update counts, convergence) comes from the
*real* engine; only time/bytes are modeled.  Model constants default to the
paper's cc1.4xlarge: 8 cores, 10 GigE.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine_base import Engine, EngineState
from repro_torch.core.graph import DataGraph, GraphStructure
from repro_torch.core.partition import (host_leaves, overpartition,
                                        place_vertices)


@dataclasses.dataclass
class ClusterModel:
    n_machines: int = 16
    cores_per_machine: int = 8
    sec_per_update: float = 1e-6         # calibrated per app (Fig. 6(c))
    bandwidth_bytes_per_s: float = 1.25e9  # 10 GigE
    barrier_latency_s: float = 5e-4
    # straggler injection: machine -> (start_step, end_step, extra_seconds)
    stragglers: Dict[int, Tuple[int, int, float]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class StepCost:
    step: int
    updates: int
    wall_time_s: float
    bytes_moved: int
    per_machine_updates: np.ndarray
    per_machine_bytes: np.ndarray


class SimulatedCluster:
    """Drives an Engine and accounts distributed cost per step."""

    def __init__(
        self,
        engine: Engine,
        graph: DataGraph,
        model: ClusterModel,
        k_atoms: Optional[int] = None,
        method: str = "hash",
        vertex_bytes: Optional[int] = None,
        seed: int = 0,
    ):
        self.engine = engine
        self.model = model
        st = graph.structure
        k_atoms = k_atoms or max(4 * model.n_machines, 32)
        atom_of = overpartition(st, k_atoms, method=method, seed=seed)
        # direct atom->machine placement using meta weights from structure
        self.machine_of = self._place(st, atom_of, model.n_machines)

        # ghost sets: machine m holds a ghost of v iff some edge it owns
        # (owned by receiver) has sender v not owned by m.
        e_owner = self.machine_of[st.receivers]
        s_owner = self.machine_of[st.senders]
        cut = e_owner != s_owner
        pairs = np.unique(
            np.stack([st.senders[cut], e_owner[cut]], 1), axis=0)
        self.ghost_v = pairs[:, 0]
        self.ghost_m = pairs[:, 1]
        self.ghost_count = np.bincount(
            self.ghost_v, minlength=st.n_vertices).astype(np.int64)

        if vertex_bytes is None:
            vertex_bytes = sum(
                x.dtype.itemsize * (x.size // max(x.shape[0], 1))
                for x in host_leaves(graph.vertex_data))
        self.vertex_bytes = int(vertex_bytes) + 8  # +id/version header

    @staticmethod
    def _place(st: GraphStructure, atom_of: np.ndarray,
               n_machines: int) -> np.ndarray:
        return place_vertices(st, atom_of, n_machines)

    # -- cost of one step ------------------------------------------------------
    def step_cost(self, step: int, per_vertex_updates: np.ndarray) -> StepCost:
        m = self.model
        upd = per_vertex_updates.astype(np.int64)
        changed = upd > 0

        per_machine_updates = np.bincount(
            self.machine_of, weights=upd, minlength=m.n_machines).astype(np.int64)
        # versioned-ghost traffic: changed vertices, once per remote ghost
        recv_bytes = np.bincount(
            self.ghost_m, weights=changed[self.ghost_v] * self.vertex_bytes,
            minlength=m.n_machines).astype(np.int64)
        send_bytes = np.bincount(
            self.machine_of,
            weights=changed * self.ghost_count * self.vertex_bytes,
            minlength=m.n_machines).astype(np.int64)
        per_machine_bytes = recv_bytes + send_bytes

        compute = per_machine_updates * m.sec_per_update / m.cores_per_machine
        comm = per_machine_bytes / m.bandwidth_bytes_per_s
        per_machine_t = compute + comm
        for mac, (lo, hi, extra) in m.stragglers.items():
            if lo <= step < hi:
                per_machine_t[mac] += extra
        wall = float(per_machine_t.max() + m.barrier_latency_s)
        return StepCost(
            step=step,
            updates=int(upd.sum()),
            wall_time_s=wall,
            bytes_moved=int(per_machine_bytes.sum() // 2),
            per_machine_updates=per_machine_updates,
            per_machine_bytes=per_machine_bytes)

    # -- driver -----------------------------------------------------------------
    def run(
        self,
        state: EngineState,
        max_steps: int = 200,
        hooks: Sequence[Callable[[int, EngineState], None]] = (),
        sync_snapshot_at: Optional[int] = None,
        sync_snapshot_capture_s: float = 0.0,
    ) -> Tuple[EngineState, List[StepCost]]:
        costs: List[StepCost] = []
        clock = 0.0
        prev_counts = state.update_count.cpu().numpy()
        for i in range(max_steps):
            if bool(self.engine.scheduler.done(state.sched, state.prio)):
                break
            if sync_snapshot_at is not None and i == sync_snapshot_at:
                # stop-the-world capture: advance the clock, no updates
                clock += sync_snapshot_capture_s + self._straggler_extra(i)
                costs.append(StepCost(
                    step=i, updates=0,
                    wall_time_s=sync_snapshot_capture_s,
                    bytes_moved=0,
                    per_machine_updates=np.zeros(self.model.n_machines, np.int64),
                    per_machine_bytes=np.zeros(self.model.n_machines, np.int64)))
            state = self.engine.step(state)
            counts = state.update_count.cpu().numpy()
            cost = self.step_cost(i, counts - prev_counts)
            prev_counts = counts
            clock += cost.wall_time_s
            costs.append(cost)
            for h in hooks:
                h(i, state)
        return state, costs

    def _straggler_extra(self, step: int) -> float:
        extra = 0.0
        for mac, (lo, hi, e) in self.model.stragglers.items():
            if lo <= step < hi:
                extra = max(extra, e)
        return extra
