"""Shared engine machinery (paper Sec. 3.3 execution model, Sec. 4.2 engines).

``EngineState`` is the program state: the data graph, the scheduler T (a
priority tensor — active ⇔ prio > tolerance, plus the scheduler's own state
for stateful schedulers like FIFO), per-vertex update counts (Fig. 1(b)) and
the sync operation's global values.  Its counters stay on the device.

An engine IS a scheduler choice: ``step`` runs ``scheduler.num_phases``
select → apply → reschedule phases, and subclasses only pick the scheduler
(BSP = single-color sweep, chromatic = color-range sweep, dynamic =
prioritized pipeline) plus per-phase extras such as the chromatic per-color
edge ranges.  PyTorch runs eagerly, so a step is a plain Python loop of
tensor ops; ``run`` syncs with the host once per step, for the termination
check ("all vertices in T are eventually executed" is the only ordering
requirement the paper imposes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.graph import DataGraph, segment_combine
from repro_torch.core.scheduler import Scheduler, SweepScheduler
from repro_torch.core.sync_op import SyncOp, run_syncs
from repro_torch.core.tree import tree_map, tree_unflatten
from repro_torch.core.update import (VertexProgram, edge_ctx,
                                     fused_edge_weight, fused_gather_leaves,
                                     masked_update, supports_fused_gather)
from repro_torch.device import resolve_device
from repro_torch.kernels.gas.ops import (EdgeSet, ScatterCtx,
                                         active_row_blocks, gather_combine)

Pytree = Any


@dataclasses.dataclass
class EngineState:
    graph: DataGraph
    prio: torch.Tensor           # [N] f32 — the scheduler T with priorities
    update_count: torch.Tensor   # [N] i32 — paper Fig. 1(b) statistic
    step_index: torch.Tensor     # scalar i64
    total_updates: torch.Tensor  # scalar i64
    edges_touched: torch.Tensor  # scalar i64 — gathered-edge accounting
    globals_: Pytree             # sync-op outputs readable by update fns
    sched: Pytree = ()           # scheduler-private state (() if stateless)

    def replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)


def init_state(
    program: VertexProgram,
    graph: DataGraph,
    initial_prio: Optional[torch.Tensor] = None,
    sync_ops: Sequence[SyncOp] = (),
    scheduler: Optional[Scheduler] = None,
) -> EngineState:
    n, dev = graph.n_vertices, graph.device
    prio = (torch.as_tensor(initial_prio, dtype=torch.float32).to(dev)
            if initial_prio is not None
            else program.initial_priority(n, device=dev).to(torch.float32))
    globals_ = run_syncs(sync_ops, graph.vertex_data, graph.vertex_data, n)

    def zero():
        return torch.zeros((), dtype=torch.int64, device=dev)

    return EngineState(
        graph=graph, prio=prio,
        update_count=torch.zeros(n, dtype=torch.int32, device=dev),
        step_index=zero(), total_updates=zero(), edges_touched=zero(),
        globals_=globals_,
        sched=scheduler.init(prio) if scheduler is not None else (),
    )


def apply_phase(
    program: VertexProgram,
    graph: DataGraph,
    mask: torch.Tensor,
    glob: Pytree,
    *,
    edges: Optional[EdgeSet] = None,
) -> Tuple[DataGraph, torch.Tensor, torch.Tensor]:
    """Executes ``f(v, S_v)`` for every vertex in ``mask`` simultaneously.

    Gather → ⊕-combine → apply (masked write-back) → edge_out (masked to
    out-edges of updated vertices).  Returns (new graph, residual·mask,
    edges touched).  Passing ``edges`` (a prepared ``EdgeSet``) routes the
    gather⊕combine through the fused kernel with active-block skipping; the
    dense path gathers all E edges regardless of mask and sums them with
    the sorted segment-sum kernel.
    """
    if edges is not None:
        return fused_apply_phase(program, graph, mask, glob, edges)
    st = graph.structure
    t = st.device_arrays()

    ctx = edge_ctx(graph)
    msgs = program.gather(ctx)
    acc = segment_combine(msgs, t["receivers"], st.n_vertices,
                          program.combiner, segments=st.row_segments())

    new_v, residual = program.apply(graph.vertex_data, acc, glob)
    vdata = masked_update(graph.vertex_data, new_v, mask)
    graph = graph.replace(vertex_data=vdata)

    if program.has_edge_out:
        # The update at v owns its adjacent edges (edge consistency): we
        # rewrite out-edges of updated vertices, reading freshly applied
        # vertex data (Gauss-Seidel within the step).
        senders = t["senders"]
        ctx2 = edge_ctx(graph)
        new_src = tree_map(lambda x: x[senders], vdata)
        src_acc = tree_map(lambda a: a[senders], acc)
        new_e = program.edge_out(ctx2, new_src, src_acc)
        edata = masked_update(graph.edge_data, new_e, mask[senders])
        graph = graph.replace(edge_data=edata)

    residual = torch.where(mask, residual.to(torch.float32),
                           torch.zeros((), device=mask.device))
    return graph, residual, torch.tensor(st.n_edges, dtype=torch.int64,
                                         device=mask.device)


def fused_apply_phase(
    program: VertexProgram,
    graph: DataGraph,
    mask: torch.Tensor,
    glob: Pytree,
    edges: EdgeSet,
) -> Tuple[DataGraph, torch.Tensor, torch.Tensor]:
    """The fused GAS path: one gather⊕combine launch per declared gather
    leaf, no edge_ctx, no [E, D] messages, inactive row blocks skipped.

    Rows outside active blocks come back as zeros; they belong to
    unscheduled vertices whose apply output is discarded by
    ``masked_update`` and whose residual is masked below, so the fixed
    point matches the dense path.
    """
    st = graph.structure
    leaves, treedef = fused_gather_leaves(program)
    block_active = active_row_blocks(mask)
    src_deg = st.device_arrays()["out_degree"][
        st.device_arrays()["senders"]] if any(
        leaf.kind == "degree_normalized_src" for leaf in leaves) else None

    acc_leaves = []
    for leaf in leaves:
        feat = leaf.feature(graph.vertex_data)
        trailing = feat.shape[1:]
        w = fused_edge_weight(leaf, graph.edge_data, st.n_edges, src_deg,
                              device=graph.device)
        if edges.perm is not None:
            w = w[edges.perm]
        acc = gather_combine(feat.reshape(st.n_vertices, -1), w, edges,
                             block_active=block_active)
        acc_leaves.append(acc.reshape((st.n_vertices,) + trailing))
    acc = tree_unflatten(treedef, acc_leaves)

    new_v, residual = program.apply(graph.vertex_data, acc, glob)
    vdata = masked_update(graph.vertex_data, new_v, mask)
    graph = graph.replace(vertex_data=vdata)
    residual = torch.where(mask, residual.to(torch.float32),
                           torch.zeros((), device=mask.device))
    edges_touched = torch.sum(torch.where(
        block_active > 0, edges.block_counts,
        torch.zeros_like(edges.block_counts)))
    return graph, residual, edges_touched


class Engine:
    """Base: an engine is a scheduler plus the shared phase loop.

    ``step`` runs ``scheduler.num_phases`` select → apply → reschedule
    phases; subclasses choose the scheduler — pass one via ``scheduler=`` or
    override ``_make_scheduler`` — and may override ``_phase_edges`` and
    ``_scatter_ctx`` to hand each phase its own prepared ``EdgeSet`` for
    the gather and the scatter (the chromatic per-color edge subsets).

    ``use_fused`` selects the fused gather⊕combine path for programs that
    declare registry gathers: None (default) enables it when the program
    qualifies, False forces the dense path, True requests it but still
    falls back when the program is non-fuseable (the LBP case).

    ``device`` is where the engine runs; it must be the graph's device.
    """

    def __init__(
        self,
        program: VertexProgram,
        graph: DataGraph,
        tolerance: float = 1e-3,
        sync_ops: Sequence[SyncOp] = (),
        *,
        scheduler: Optional[Scheduler] = None,
        use_fused: Optional[bool] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if graph.device.type != self.device.type:
            raise ValueError(f"graph lives on {graph.device}, engine asked "
                             f"for {self.device}")
        self.program = program
        self.structure = graph.structure
        self.tolerance = float(tolerance)
        self.sync_ops = tuple(sync_ops)
        fusable = supports_fused_gather(program)
        self.use_fused = fusable if use_fused is None \
            else bool(use_fused) and fusable
        self._full_edges_cache: Optional[EdgeSet] = None
        self.scheduler = (scheduler if scheduler is not None
                          else self._make_scheduler())

    def _make_scheduler(self) -> Scheduler:
        """Default schedule when none is passed: a single-color sweep
        (execute everything scheduled — the BSP/vertex-consistency case)."""
        return SweepScheduler(self.program, self.structure, self.tolerance)

    @property
    def _full_edges(self) -> Optional[EdgeSet]:
        """Full-graph EdgeSet for fused engines, built on first use (the
        chromatic engine gathers and scatters through its per-color
        subsets and never needs it)."""
        if self.use_fused and self._full_edges_cache is None:
            st = self.structure
            self._full_edges_cache = EdgeSet.build(
                st.senders, st.receivers, st.n_vertices, device=st.device)
        return self._full_edges_cache if self.use_fused else None

    # -- the shared phase loop ------------------------------------------------
    def _phase_edges(self, phase: int) -> Optional[EdgeSet]:
        """Prepared EdgeSet for one phase (chromatic overrides per color)."""
        return self._full_edges

    def _scatter_ctx(self, phase: int) -> Optional[ScatterCtx]:
        """ScatterCtx for one phase's fused reschedule, or None to keep the
        dense scatter.  Here the full edge structure: any vertex may be
        executed, and its contribution targets every out-neighbor
        (chromatic overrides with the phase color's senders' edges)."""
        if not (self.use_fused and self.program.schedule_neighbors):
            return None
        return ScatterCtx(edges=self._full_edges)

    def step(self, state: EngineState) -> EngineState:
        prev_vdata = state.graph.vertex_data
        graph, prio, sched = state.graph, state.prio, state.sched
        count, total = state.update_count, state.total_updates
        edges_t = state.edges_touched
        glob = state.globals_

        for phase in range(self.scheduler.num_phases):
            mask, sched = self.scheduler.select(sched, prio, phase)
            graph, residual, et = apply_phase(
                self.program, graph, mask, glob,
                edges=self._phase_edges(phase))
            prio, sched = self.scheduler.reschedule(
                sched, prio, mask, residual,
                scatter=self._scatter_ctx(phase))
            count = count + mask.to(torch.int32)
            total = total + torch.sum(mask)
            edges_t = edges_t + et

        state = state.replace(
            graph=graph, prio=prio, sched=sched, update_count=count,
            total_updates=total, edges_touched=edges_t,
            step_index=state.step_index + 1)
        return self._run_syncs(state, prev_vdata)

    # -- shared driver --------------------------------------------------------
    def init(self, graph: DataGraph, initial_prio=None) -> EngineState:
        return init_state(self.program, graph, initial_prio, self.sync_ops,
                          scheduler=self.scheduler)

    def _run_syncs(self, state: EngineState, prev_vdata) -> EngineState:
        if not self.sync_ops:
            return state
        g = run_syncs(self.sync_ops, state.graph.vertex_data, prev_vdata,
                      self.structure.n_vertices)
        return state.replace(globals_=g)

    def _row(self, state: EngineState) -> Dict[str, torch.Tensor]:
        """The canonical trace row of the JAX package's ``lazy_local_row``
        as device scalars; traffic fields are structurally zero here."""
        return {
            "step": state.step_index,
            "updates": state.total_updates,
            "edges_touched": state.edges_touched,
            "residual_max": torch.max(state.prio),
            "backlog": self.scheduler.backlog(state.sched, state.prio),
        }

    def run(
        self,
        state: EngineState,
        max_steps: int = 100,
        trace_fn: Optional[Callable[[EngineState], Dict[str, Any]]] = None,
    ) -> Tuple[EngineState, List[Dict[str, float]]]:
        """Host loop: step until the scheduler reports itself empty
        (default: max prio ≤ tol) — the one host sync per step.

        Returns ``(state, rows)``, one row per step with ``step``,
        ``updates``, ``edges_touched``, ``residual_max``, ``backlog`` and the
        zero traffic fields; ``trace_fn`` extras are merged on top.  Rows
        stay device scalars until the loop ends and come to the host in one
        transfer.
        """
        pending, extras = [], []
        for _ in range(max_steps):
            if bool(self.scheduler.done(state.sched, state.prio)):
                break
            state = self.step(state)
            pending.append(self._row(state))
            extras.append(dict(trace_fn(state)) if trace_fn else {})
        return state, drain_rows(pending, extras, zero=_ZERO_TRAFFIC)

    def run_while(self, state: EngineState,
                  max_steps: int = 100) -> EngineState:
        """``run`` without trace rows: step until done or ``max_steps``."""
        while int(state.step_index) < max_steps and not bool(
                self.scheduler.done(state.sched, state.prio)):
            state = self.step(state)
        return state


_ZERO_TRAFFIC = ("wire_backlog", "traffic_rows_v", "traffic_bytes_v",
                 "traffic_rows_e", "traffic_bytes_e", "traffic_rows_r",
                 "traffic_bytes_r")


def drain_rows(pending: List[Dict[str, torch.Tensor]],
               extras: Optional[List[Dict[str, Any]]] = None,
               zero: Sequence[str] = ()) -> List[Dict[str, float]]:
    """Device-scalar rows → host rows, in one device→host copy; ``zero``
    names keys set to 0 in every row (structurally zero here), ``extras``
    are merged on top."""
    if not pending:
        return []
    keys = list(pending[0])
    host = torch.stack([torch.stack([r[k].to(torch.float64) for k in keys])
                        for r in pending]).cpu().tolist()
    rows = []
    for vals, extra in zip(host, extras or [{}] * len(host)):
        row = {k: (v if k == "residual_max" else int(v))
               for k, v in zip(keys, vals)}
        row.update({k: 0 for k in zero})
        row.update({k: (v.item() if isinstance(v, torch.Tensor) else v)
                    for k, v in extra.items()})
        rows.append(row)
    return rows
