"""Sequential reference execution of the GraphLab model (paper Alg. 2).

This is the *definition* of serializability: "there exists a corresponding
serial schedule of update functions that when executed by Alg. 2 produces
the same values in the data-graph".  The engines' property tests execute a
candidate serial schedule here (one vertex at a time, on the host, exact
scope semantics) and assert the parallel engines reproduce it.

The data lives on the host as CPU tensors (the programs' gather and apply
are written in torch); the structure is read from its numpy arrays.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph import DataGraph
from repro_torch.core.tree import tree_map
from repro_torch.core.update import FixedEdgeCtx, VertexProgram

Pytree = Any


def _host_tree(t):
    return tree_map(lambda x: x.detach().cpu().clone(), t)


class SequentialEngine:
    """Executes Alg. 2 one vertex at a time in a caller-supplied order."""

    def __init__(self, program: VertexProgram, graph: DataGraph,
                 tolerance: float = 1e-3):
        self.program = program
        self.tolerance = float(tolerance)
        st = graph.structure
        self.st = st
        self.vdata = _host_tree(graph.vertex_data)
        self.edata = _host_tree(graph.edge_data)
        self.prio = program.initial_priority(st.n_vertices).to(
            torch.float32).cpu().numpy().copy()
        self.update_count = np.zeros(st.n_vertices, np.int32)
        # in-edges of v: contiguous receiver-sorted block
        self.offsets = st.receiver_offsets()
        # out-edges of v: indices into the receiver-sorted array
        self.out_edges = np.argsort(st.senders, kind="stable")
        self.out_offsets = np.concatenate(
            [[0], np.cumsum(np.bincount(st.senders,
                                        minlength=st.n_vertices))])

    # -- single vertex --------------------------------------------------------
    def _edge_ctx(self, eidx: np.ndarray) -> FixedEdgeCtx:
        st = self.st
        s, r = st.senders[eidx], st.receivers[eidx]
        rp = st.reverse_perm[eidx]
        rp_safe = torch.from_numpy(np.maximum(rp, 0).astype(np.int64))
        has_rev = torch.from_numpy(rp >= 0)
        e = torch.from_numpy(np.asarray(eidx, np.int64))
        s_t = torch.from_numpy(s.astype(np.int64))
        r_t = torch.from_numpy(r.astype(np.int64))

        def _rev(x):
            y = x[rp_safe]
            m = has_rev.reshape((-1,) + (1,) * (y.ndim - 1))
            return torch.where(m, y, torch.zeros_like(y))

        return FixedEdgeCtx(
            edata=tree_map(lambda x: x[e], self.edata),
            rev_edata=tree_map(_rev, self.edata),
            src=tree_map(lambda x: x[s_t], self.vdata),
            dst=tree_map(lambda x: x[r_t], self.vdata),
            src_deg=torch.from_numpy(st.out_degree[s]),
            dst_deg=torch.from_numpy(st.in_degree[r]),
        )

    def _combine(self, msgs, n_in: int):
        comb = self.program.combiner

        def _one(m):
            if n_in == 0:
                if comb in ("sum", "mean"):
                    return torch.zeros(m.shape[1:], dtype=m.dtype)
                return torch.full(m.shape[1:],
                                  -torch.inf if comb == "max" else torch.inf,
                                  dtype=m.dtype)
            if comb == "sum":
                return m.sum(dim=0)
            if comb == "mean":
                return m.mean(dim=0)
            if comb == "max":
                return m.amax(dim=0)
            if comb == "min":
                return m.amin(dim=0)
            raise ValueError(comb)

        return tree_map(_one, msgs)

    def execute_vertex(self, v: int) -> float:
        """Runs f(v, S_v); returns the residual.  Mirrors apply_phase exactly
        but for one vertex."""
        st, prog = self.st, self.program
        in_e = np.arange(self.offsets[v], self.offsets[v + 1])
        msgs = prog.gather(self._edge_ctx(in_e))
        acc = self._combine(msgs, in_e.size)

        v_in = tree_map(lambda x: x[v][None], self.vdata)
        acc_b = tree_map(lambda a: a[None], acc)
        out = prog.apply(v_in, acc_b, None)
        new_v, residual = out.vertex_data, float(out.residual[0])

        def _setv(x, n):
            x[v] = n[0].to(x.dtype)
            return x

        self.vdata = tree_map(_setv, self.vdata, new_v)

        out_e = self.out_edges[self.out_offsets[v]:self.out_offsets[v + 1]]
        if prog.has_edge_out and out_e.size:
            ctx2 = self._edge_ctx(out_e)
            new_src = tree_map(
                lambda x: x[v][None].repeat_interleave(out_e.size, dim=0),
                self.vdata)
            src_acc = tree_map(
                lambda a: a[None].repeat_interleave(out_e.size, dim=0), acc)
            new_e = prog.edge_out(ctx2, new_src, src_acc)
            idx = torch.from_numpy(out_e.astype(np.int64))

            def _sete(x, n):
                x[idx] = n.to(x.dtype)
                return x

            self.edata = tree_map(_sete, self.edata, new_e)

        # scheduling (Alg. 1 pattern): consume own priority, bump out-neighbors
        self.prio[v] = 0.0
        if prog.schedule_neighbors:
            contrib = float(prog.priority(
                torch.tensor([residual], dtype=torch.float32))[0])
            np.add.at(self.prio, st.receivers[out_e], np.float32(contrib))
        self.update_count[v] += 1
        return residual

    # -- schedules -------------------------------------------------------------
    def execute_schedule(self, schedule: Iterable[int]) -> None:
        for v in schedule:
            self.execute_vertex(int(v))

    def run_round_robin(self, max_sweeps: int = 100,
                        order: Optional[Sequence[int]] = None) -> int:
        """Sweeps vertices in a fixed order until the scheduler is empty."""
        n = self.st.n_vertices
        order = np.arange(n) if order is None else np.asarray(order)
        sweeps = 0
        for _ in range(max_sweeps):
            if self.prio.max() <= self.tolerance:
                break
            for v in order:
                if self.prio[v] > self.tolerance:
                    self.execute_vertex(int(v))
            sweeps += 1
        return sweeps

    def run_priority(self, max_updates: int = 100000) -> int:
        """Exact serial priority order (= locking engine with pipeline 1)."""
        updates = 0
        while updates < max_updates and self.prio.max() > self.tolerance:
            self.execute_vertex(int(np.argmax(self.prio)))
            updates += 1
        return updates
