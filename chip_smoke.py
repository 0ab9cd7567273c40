#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Builds the three hand-written CUDA kernels from ``src/repro_torch/csrc``
and then runs three phases; any failure exits nonzero without the result
line:

1. Kernel parity and timing.  Each kernel (K1 gather⊕combine, K2
   scatter/reschedule, K3 sorted segment sum) is held against its plain
   PyTorch version on the card, on edge cases and at the shapes its path
   gives it (max relative error ≤ 2e-5), and timed beside its plain
   version, one PyTorch library call for the same function, and its bound.
2. The main path: PageRank on ChromaticEngine (fused) over a synthetic
   power-law graph at the scale of SNAP soc-LiveJournal1 (4.85 M vertices),
   run to convergence and checked against a float64 power iteration on the
   card (L1 ≤ 1e-3).  K1 and K2 must have launched on it.
3. LBP and engine parity.  LBP under Chromatic (the dense path; K3 must
   have launched on it) in float32 at smoothing 0.6 on the card, its
   residual's course logged; then PageRank under BSP, Chromatic and
   Dynamic and LBP in float64 at smoothing 0.1, each on the card and on the
   CPU (fixed points within 1e-5, equal counts), and the first steps of the
   float32 LBP run on both, logged.  The CPU half runs in a child process
   from the start, beside phases 1 and 2.

It prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
WORK_DIR = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
REL_TOL = 2e-5
FIXED_POINT_TOL = 1e-5
ORACLE_L1_TOL = 1e-3
CPU_THREADS = 6                    # the child's share of the host's cores
CHILD_TIMEOUT_S = 900

# main path: SNAP soc-LiveJournal1 has 4,847,571 vertices, 68,993,773 edges
LJ_VERTICES = 4_847_571
LJ_AVG_DEGREE = 16
ALPHA = 0.15
MAIN_MAX_STEPS = 200
# engine parity
PARITY_VERTICES = 200_000
DYNAMIC_PIPELINE = 1024
DYNAMIC_MAX_STEPS = 300
# LBP on the 26-connected grid, 5 states, tolerance 1e-5, in two settings
# (PERF.md, section 4):
#  - the default user path, float32 data at Potts smoothing 0.6.  On this
#    grid it has no fixed point to drain to: the residual oscillates in the
#    hundreds for 200 steps, in float64 too.  The card runs it for
#    MAIN_MAX_STEPS steps (the LBP path whose K3 launches are counted); its
#    first LBP_F32_CPU_STEPS steps are run on the CPU as well, and the two
#    are logged side by side;
#  - float64 data at smoothing 0.1, which drains: card and CPU are held to
#    one fixed point within 1e-5 with equal counts.
LBP_GRID = 64
LBP_STATES = 5
LBP_TOLERANCE = 1e-5
LBP_F32 = (torch.float32, 0.6)
LBP_F64 = (torch.float64, 0.1)
LBP_F32_CPU_STEPS = 3

failures: list = []


def log(msg: str) -> None:
    print(msg, flush=True)


def expect(cond: bool, what: str) -> None:
    log(("ok   " if cond else "FAIL ") + what)
    if not cond:
        failures.append(what)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(k: torch.Tensor, p: torch.Tensor) -> tuple:
    """(max abs error, max abs error over max |plain|); exact zeros must
    stay exact."""
    if k.numel() == 0:
        return 0.0, 0.0
    abs_err = float((k.double() - p.double()).abs().max())
    scale = float(p.abs().max())
    if scale == 0.0:
        return abs_err, (0.0 if abs_err == 0.0 else float("inf"))
    return abs_err, abs_err / scale


# ---------------------------------------------------------------------------
# Phase 1: kernels
# ---------------------------------------------------------------------------

class KernelRecord:
    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.max_abs = 0.0
        self.max_rel = 0.0
        self.times = {}
        self.launches = 0

    def compare(self, what, k, p):
        a, r = rel_err(k, p)
        self.max_abs = max(self.max_abs, a)
        self.max_rel = max(self.max_rel, r)
        expect(r <= REL_TOL, f"{self.name} {what}: rel err {r:.3g}")

    def against_library(self, k, lib):
        """Logged only: a library call sums in its own order."""
        log(f"info {self.name}: rel err vs library {rel_err(k, lib)[1]:.3g}")

    def time(self, run_k, run_p, run_l, n_bytes, n_flops, shape):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_flops / F32_FLOPS_PER_S * 1e3
        self.times = {
            "ms": cuda_ms(run_k), "plain_ms": cuda_ms(run_p, 3),
            "library_ms": cuda_ms(run_l), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": shape}
        log(f"time {self.name} [{shape}]: " + ", ".join(
            f"{k}={v:.4g}" for k, v in self.times.items()
            if isinstance(v, float)))

    def json(self):
        t = self.times
        return {
            "name": self.name, "route": "cuda", "source": self.source,
            "replaces": self.replaces, "launches": self.launches,
            "max_abs_err": self.max_abs, "max_rel_err": self.max_rel,
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
        }


def row_ptr_bytes(n: int) -> int:
    """The CSR offsets [N+1] i32 the function needs to find each row."""
    return 4 * (n + 1)


def edge_cases(rng):
    """(name, senders, receivers, n, d): the cases of the JAX package's
    kernel tests, a hub longer than one row segment, and the widths of the
    main paths."""
    from repro_torch.kernels.csr import ROW_SEGMENT

    def skewed(n, e):
        recv = np.sort(np.minimum((rng.pareto(1.2, e) * 3).astype(np.int64),
                                  n - 1)).astype(np.int32)
        return rng.integers(0, n, e).astype(np.int32), recv

    cases = [("E=0", np.zeros(0, np.int32), np.zeros(0, np.int32), 50, 8),
             ("isolated", np.arange(64, dtype=np.int32),
              np.full(64, 7, np.int32), 200, 4),
             ("self-loop", np.zeros(3, np.int32), np.zeros(3, np.int32), 1, 2)]
    snd = rng.integers(0, 600, 512).astype(np.int32)
    recv = np.sort(rng.integers(0, 100, 512)).astype(np.int32)
    cases.append(("E=512", snd, recv, 600, 4))
    hub = np.sort(np.concatenate([np.full(5 * ROW_SEGMENT + 3, 11),
                                  rng.integers(0, 300, 4000)]))
    hub = hub.astype(np.int32)
    cases.append(("hub", rng.integers(0, 300, hub.size).astype(np.int32),
                  hub, 300, 1))
    for d in (1, 5, 16, 128):
        cases.append((f"pareto D={d}", *skewed(3000, 40000), 3000, d))
    return cases


def kernel_parity_cases(recs, rng):
    from repro_torch.kernels.gas.ops import (EdgeSet, active_row_blocks,
                                             gather_combine,
                                             scatter_reschedule)
    from repro_torch.kernels.gas.ref import (gather_combine_ref,
                                             scatter_reschedule_ref)
    from repro_torch.kernels.segsum.ops import segment_sum_sorted
    from repro_torch.kernels.segsum.ref import segment_sum_sorted_ref
    k1, k2, k3 = recs
    for name, snd, recv, n, d in edge_cases(rng):
        es = EdgeSet.build(snd, recv, n, device="cuda")
        e = snd.size
        feat = torch.from_numpy(
            rng.normal(size=(n, d)).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.normal(size=e).astype(np.float32)).cuda()
        w_pad = torch.nn.functional.pad(w, (0, es.senders.shape[0] - e))
        for mname, mask in (("all", np.ones(n, bool)),
                            ("30%", rng.random(n) < 0.3),
                            ("none", np.zeros(n, bool))):
            blk = active_row_blocks(torch.from_numpy(mask).cuda())
            k = gather_combine(feat, w, es, block_active=blk)
            p = gather_combine_ref(feat, w_pad, es.senders, es.receivers, n,
                                   blk)
            k1.compare(f"{name} mask={mname}", k, p)
            if mname == "none":
                expect(float(k.abs().sum()) == 0.0,
                       f"K1 {name}: all-inactive mask gives exact zeros")
        contrib = torch.from_numpy(np.where(
            rng.random(n) < 0.5, rng.random(n), 0).astype(np.float32)).cuda()
        prio = torch.from_numpy(rng.random(n).astype(np.float32)).cuda()
        for cname, cons in (("30%", rng.random(n) < 0.3),
                            ("all", np.ones(n, bool))):
            cons_t = torch.from_numpy(cons).cuda()
            for wname, wt in (("ones", None), ("w", w)):
                k = scatter_reschedule(contrib, prio, cons_t, es, wt)
                wp = torch.ones_like(w_pad) if wt is None else w_pad
                p = scatter_reschedule_ref(contrib, prio, cons_t, wp,
                                           es.senders, es.receivers, n)
                k2.compare(f"{name} consume={cname} w={wname}", k, p)
        recv_t = torch.from_numpy(recv).cuda()
        for dt in (np.float32, np.float64):
            msgs = torch.from_numpy(rng.normal(size=(e, d)).astype(dt)).cuda()
            k = segment_sum_sorted(msgs, recv_t, n, segments=es.segments)
            p = segment_sum_sorted_ref(msgs, recv_t, n)
            k3.compare(f"{name} {dt.__name__}", k, p)


def csr_matrix(es, values):
    crow = torch.from_numpy(es.row_ptr).cuda()
    return torch.sparse_csr_tensor(crow, es.senders[:es.n_edges], values,
                                   (es.n_vertices, es.n_vertices),
                                   check_invariants=False)


def time_k1(rec, es, w, rng):
    """K1 at the main path's shape: its largest color's edge range, every
    block active (a first sweep), on random ranks of the path's size (~1/n;
    equal rows would hide a gather from the wrong sender)."""
    from repro_torch.kernels.gas.gas import gas_gather_combine_cuda
    from repro_torch.kernels.gas.ref import gather_combine_ref
    n, e, d = es.n_vertices, es.n_edges, 1
    feat = torch.from_numpy((rng.random((n, d)) * (2.0 / n))
                            .astype(np.float32)).cuda()
    blk = torch.ones(es.n_row_blocks, dtype=torch.int32, device="cuda")
    w_pad = torch.nn.functional.pad(w, (0, es.senders.shape[0] - e))
    run_k = lambda: gas_gather_combine_cuda(feat, w, es.senders,
                                            es.segments, blk)
    run_p = lambda: gather_combine_ref(feat, w_pad, es.senders, es.receivers,
                                       n, blk, segments=es.segments)
    rec.compare("main shape", run_k(), run_p())
    a = csr_matrix(es, w)
    run_l = lambda: torch.sparse.mm(a, feat)
    rec.against_library(run_k(), run_l())
    rec.time(run_k, run_p, run_l,
             4 * (2 * e + 2 * n * d + es.n_row_blocks) + row_ptr_bytes(n),
             2 * e * d, f"N={n} D={d} E={e} segments="
             f"{es.segments.n_segments} (largest color)")


def time_k2(rec, es, rng):
    """K2 at the main path's shape: the full edge set, unit weights."""
    from repro_torch.kernels.gas.scatter import gas_scatter_reschedule_cuda
    from repro_torch.kernels.gas.ref import scatter_reschedule_ref
    n, e = es.n_vertices, es.n_edges
    contrib = torch.from_numpy(np.where(rng.random(n) < 0.2,
                                        rng.random(n) * 1e-7, 0)
                               .astype(np.float32)).cuda()
    prio = torch.from_numpy((rng.random(n) * 1e-6).astype(np.float32)).cuda()
    cons = contrib > 0
    ones = torch.ones(es.senders.shape[0], dtype=torch.float32, device="cuda")
    run_k = lambda: gas_scatter_reschedule_cuda(contrib, prio, cons,
                                                es.senders, es.segments)
    run_p = lambda: scatter_reschedule_ref(contrib, prio, cons, ones,
                                           es.senders, es.receivers, n,
                                           segments=es.segments)
    rec.compare("main shape", run_k(), run_p())
    a = csr_matrix(es, ones[:e])
    keep = torch.where(cons, torch.zeros_like(prio), prio)[:, None]
    run_l = lambda: torch.addmm(keep, a, contrib[:, None])
    rec.against_library(run_k(), run_l()[:, 0])
    rec.time(run_k, run_p, run_l, 4 * e + 13 * n + row_ptr_bytes(n),
             e, f"N={n} E={e} segments={es.segments.n_segments} "
             f"(full edge set)")


def time_k3(rec, structure, k, dtype):
    """K3 at the LBP path's shape: [E, K] messages on the 3-D grid."""
    from repro_torch.kernels.segsum.segsum import segment_sum_sorted_cuda
    from repro_torch.kernels.segsum.ref import segment_sum_sorted_ref
    n, e = structure.n_vertices, structure.n_edges
    seg = structure.row_segments()
    recv = structure.device_arrays()["receivers"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    msgs = torch.randn((e, k), generator=gen, device="cuda", dtype=dtype)
    run_k = lambda: segment_sum_sorted_cuda(msgs, seg)
    run_p = lambda: segment_sum_sorted_ref(msgs, recv, n, seg)
    run_l = lambda: torch.zeros((n, k), device="cuda",
                                dtype=dtype).index_add_(0, recv, msgs)
    rec.compare("main shape", run_k(), run_p())
    rec.against_library(run_k(), run_l())
    size = msgs.element_size()
    rec.time(run_k, run_p, run_l, size * (e + n) * k + row_ptr_bytes(n),
             e * k,
             f"N={n} D={k} E={e} {str(dtype)[6:]} (LBP grid)")


# ---------------------------------------------------------------------------
# Phase 2: the main path
# ---------------------------------------------------------------------------

def oracle_pagerank_f64(structure, alpha, iters=300):
    """Float64 power iteration on the card with plain torch."""
    t = structure.device_arrays()
    n = structure.n_vertices
    s, r = t["senders"], t["receivers"]
    w = 1.0 / torch.clamp(t["out_degree"][s].double(), min=1.0)
    rank = torch.full((n,), 1.0 / n, dtype=torch.float64, device="cuda")
    for _ in range(iters):
        acc = torch.zeros_like(rank).index_add_(0, r, w * rank[s])
        rank = alpha / n + (1 - alpha) * acc
    return rank


def profile_steps(eng, graph, steps=2):
    """Device time by kernel over the first ``steps`` engine steps."""
    from torch.profiler import ProfilerActivity, profile
    state = eng.init(graph)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state = eng.step(state)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    table = events.table(sort_by="self_device_time_total", row_limit=15)
    (OUT_DIR / "main_profile.txt").write_text(table)
    busy = sum(ev.self_device_time_total for ev in events) / 1e3  # ms
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:6]
    log(f"main: profiled {steps} steps: wall {1e3 * wall:.1f} ms (with "
        f"profiler), device busy {busy:.1f} ms, idle share "
        f"{max(0.0, 1 - busy / (1e3 * wall)):.3f}")
    for ev in top:
        log(f"main:   {ev.key[:60]:60s} {ev.self_device_time_total / 1e3:9.2f}"
            f" ms  x{ev.count}")


def main_path(recs, rng):
    from repro_torch.apps.pagerank import PageRankProgram, make_pagerank_graph
    from repro_torch.core.chromatic import ChromaticEngine
    from repro_torch.core.coloring import coloring_for
    from repro_torch.core.consistency import Consistency
    from repro_torch.graphs.generators import power_law_graph
    from repro_torch.kernels.gas.gas import gas_gather_combine_cuda
    from repro_torch.kernels.gas.scatter import gas_scatter_reschedule_cuda

    n = LJ_VERTICES
    t0 = time.perf_counter()
    st = power_law_graph(n, avg_degree=LJ_AVG_DEGREE, seed=0, device="cuda")
    graph = make_pagerank_graph(st)
    log(f"main: generation {time.perf_counter() - t0:.1f} s  n={n} "
        f"E={st.n_edges} max in-degree={int(st.in_degree.max())}")
    t0 = time.perf_counter()
    colors = coloring_for(st, Consistency.EDGE)
    log(f"main: coloring {time.perf_counter() - t0:.1f} s  "
        f"colors={int(colors.max()) + 1}")
    tol = 1e-4 / n
    prog = PageRankProgram(alpha=ALPHA, n_vertices=n)
    t0 = time.perf_counter()
    eng = ChromaticEngine(prog, graph, colors=colors, tolerance=tol,
                          device="cuda")
    full = eng._full_edges  # built at first use; counted as set-up here
    torch.cuda.synchronize()
    log(f"main: per-color EdgeSets {time.perf_counter() - t0:.1f} s  "
        f"fused={eng.use_fused}")
    expect(eng.use_fused, "main: PageRank takes the fused path")

    # K1 and K2 at the shapes this path gives them (launches not counted)
    es0 = max(eng._color_edges, key=lambda es: es.n_edges)
    w0 = graph.edge_data["w"][es0.perm].contiguous()
    time_k1(recs[0], es0, w0, rng)
    time_k2(recs[1], full, rng)
    profile_steps(eng, graph)

    state = eng.init(graph)
    torch.cuda.reset_peak_memory_stats()
    gas_gather_combine_cuda.launches = 0
    gas_scatter_reschedule_cuda.launches = 0
    (state, rows), secs = sync_time(
        lambda: eng.run(state, max_steps=MAIN_MAX_STEPS))
    recs[0].launches = gas_gather_combine_cuda.launches
    recs[1].launches = gas_scatter_reschedule_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    steps = int(state.step_index)
    upd = int(state.total_updates)
    log(f"main: n={n} E={st.n_edges} colors={eng.num_colors} steps={steps} "
        f"total_updates={upd} edges_touched={int(state.edges_touched)}")
    log(f"main: run {secs:.3f} s  {1e3 * secs / max(steps, 1):.3f} ms/step  "
        f"{upd / secs:.4g} updates/s  peak device memory "
        f"{peak / 2**30:.3f} GiB  launches K1={recs[0].launches} "
        f"K2={recs[1].launches}")
    expect(recs[0].launches > 0 and recs[1].launches > 0,
           "main: K1 and K2 launched on the main path")
    expect(bool(eng.scheduler.done(state.sched, state.prio)),
           f"main: converged within {MAIN_MAX_STEPS} steps")
    rank = state.graph.vertex_data["rank"]
    expect(bool(torch.isfinite(rank).all()) and rank.shape == (n,),
           "main: ranks finite, shape [n]")
    (exact, secs_o) = sync_time(lambda: oracle_pagerank_f64(st, ALPHA))
    l1 = float((rank.double() - exact).abs().sum())
    log(f"main: float64 oracle {secs_o:.1f} s")
    expect(l1 <= ORACLE_L1_TOL, f"main: L1 vs float64 oracle {l1:.3e}")
    return {"n": n, "E": st.n_edges, "colors": eng.num_colors,
            "steps": steps, "total_updates": upd,
            "edges_touched": int(state.edges_touched), "run_s": secs,
            "ms_per_step": 1e3 * secs / max(steps, 1),
            "updates_per_s": upd / secs, "peak_gib": peak / 2**30, "l1": l1}


# ---------------------------------------------------------------------------
# Phase 3: engine parity, card vs CPU
# ---------------------------------------------------------------------------

def parity_cases(device):
    """(name, engine, graph, leaf, max_steps, held) of the parity phase,
    built on ``device``; the colorings are computed on the host.  A case
    that is ``held`` must reach the CPU's fixed point within 1e-5 with equal
    counts; the others are logged side by side."""
    from repro_torch.apps.lbp import LoopyBPProgram, make_mrf_graph
    from repro_torch.apps.pagerank import PageRankProgram, make_pagerank_graph
    from repro_torch.core import (BSPEngine, ChromaticEngine, Consistency,
                                  DynamicEngine)
    from repro_torch.core.coloring import coloring_for
    from repro_torch.graphs.generators import grid3d_graph, power_law_graph

    n = PARITY_VERTICES
    st = power_law_graph(n, avg_degree=LJ_AVG_DEGREE, seed=0, device=device)
    colors = coloring_for(st, Consistency.EDGE)
    g = make_pagerank_graph(st)
    prog = PageRankProgram(alpha=ALPHA, n_vertices=n)
    tol = 1e-4 / n
    k = LBP_GRID
    gst = grid3d_graph(k, k, k, 26, device=device)
    gcolors = coloring_for(gst, Consistency.EDGE)

    def lbp(dtype, smoothing):
        lg = make_mrf_graph(gst, LBP_STATES, seed=0, dtype=dtype)
        eng = ChromaticEngine(LoopyBPProgram(LBP_STATES, smoothing=smoothing),
                              lg, colors=gcolors, tolerance=LBP_TOLERANCE,
                              device=device)
        return f"lbp Chromatic {str(dtype)[6:]} smoothing {smoothing}", \
            eng, lg

    f32_name, f32_eng, f32_graph = lbp(*LBP_F32)
    return [
        ("pagerank BSP", BSPEngine(prog, g, tolerance=tol, device=device),
         g, "rank", MAIN_MAX_STEPS, True),
        ("pagerank Chromatic", ChromaticEngine(
            prog, g, colors=colors, tolerance=tol, device=device),
         g, "rank", MAIN_MAX_STEPS, True),
        (f"pagerank Dynamic p={DYNAMIC_PIPELINE} ({DYNAMIC_MAX_STEPS} "
         f"steps)", DynamicEngine(prog, g, pipeline_length=DYNAMIC_PIPELINE,
                                  tolerance=tol, device=device),
         g, "rank", DYNAMIC_MAX_STEPS, True),
        (*lbp(*LBP_F64), "belief", MAIN_MAX_STEPS, True),
        (f"{f32_name} ({LBP_F32_CPU_STEPS} steps)", f32_eng, f32_graph,
         "belief", LBP_F32_CPU_STEPS, False),
    ]


def run_case(eng, graph, leaf, max_steps):
    t0 = time.perf_counter()
    state, rows = eng.run(eng.init(graph), max_steps=max_steps)
    vals = state.graph.vertex_data[leaf].cpu().numpy()
    meta = np.array([int(state.step_index), int(state.total_updates),
                     int(state.edges_touched),
                     int(bool(eng.scheduler.done(state.sched, state.prio)))],
                    np.int64)
    return vals, meta, time.perf_counter() - t0, rows


def cpu_side(path: str) -> None:
    """Child process: the CPU half of the parity phase (plain versions)."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(CPU_THREADS)
    out = {}
    for i, (_, eng, graph, leaf, steps, _) in enumerate(parity_cases("cpu")):
        vals, meta, secs, _ = run_case(eng, graph, leaf, steps)
        out[f"vals{i}"], out[f"meta{i}"] = vals, meta
        out[f"secs{i}"] = np.array(secs)
    np.savez(path, **out)


def lbp_course(name, eng, graph):
    """Runs LBP on the card for MAIN_MAX_STEPS steps and logs the residual's
    course; returns (beliefs, meta)."""
    vals, meta, secs, rows = run_case(eng, graph, "belief", MAIN_MAX_STEPS)
    course = [(int(r["step"]), f"{float(r['residual_max']):.4g}")
              for r in rows if int(r["step"]) in (1, 2, 5, 10, 50, 100, 150)
              or int(r["step"]) == len(rows)]
    log(f"lbp on the card: {name}, {meta[0]} steps in {secs:.2f} s, "
        f"updates {meta[1]}, drained {bool(meta[3])}; (step, residual_max):"
        f" {course}")
    return vals, meta


def lbp_f32_path(rec, name, eng, graph):
    """The default LBP path (f32) on the card for MAIN_MAX_STEPS steps: K3
    at its shape and its launches.  Beside it, card only and logged: the
    same MRF in f64 (does a failure to drain come from f32 round-off?) and
    the held f64 case's coupling in f32 (its round-off floor)."""
    from repro_torch.apps.lbp import LoopyBPProgram, make_mrf_graph
    from repro_torch.core import ChromaticEngine
    from repro_torch.kernels.segsum.segsum import segment_sum_sorted_cuda
    time_k3(rec, graph.structure, LBP_STATES, LBP_F32[0])
    segment_sum_sorted_cuda.launches = 0
    vals, _ = lbp_course(name, eng, graph)
    rec.launches = segment_sum_sorted_cuda.launches
    log(f"lbp f32 path: K3 launches {rec.launches}")
    expect(rec.launches > 0, "LBP path: K3 launched")
    expect(bool(np.isfinite(vals).all()), "LBP f32: beliefs finite")
    colors = eng.colors.cpu().numpy()
    for dtype, smoothing in ((torch.float64, LBP_F32[1]),
                             (torch.float32, LBP_F64[1])):
        g = make_mrf_graph(graph.structure, LBP_STATES, seed=0, dtype=dtype)
        lbp_course(f"{str(dtype)[6:]} smoothing {smoothing}", ChromaticEngine(
            LoopyBPProgram(LBP_STATES, smoothing=smoothing), g,
            colors=colors, tolerance=LBP_TOLERANCE, device="cuda"), g)


def engine_parity(recs, child, cpu_path):
    cases = parity_cases("cuda")
    f32_name, f32_eng, f32_graph = cases[-1][:3]
    lbp_f32_path(recs[2], f32_name.split(" (")[0], f32_eng, f32_graph)
    results = []
    for _, eng, graph, leaf, steps, _ in cases:
        torch.cuda.synchronize()
        results.append(run_case(eng, graph, leaf, steps)[:3])

    t0 = time.perf_counter()
    child.join(CHILD_TIMEOUT_S)
    if child.is_alive():
        child.terminate()
        child.join()
    log(f"parity: waited {time.perf_counter() - t0:.1f} s for the CPU side")
    expect(child.exitcode == 0, f"CPU side exit code {child.exitcode}")
    if child.exitcode != 0:
        return
    cpu = np.load(cpu_path)
    for i, (name, *_rest, held) in enumerate(cases):
        vc, mc, tc = results[i]
        vh, mh, th = cpu[f"vals{i}"], cpu[f"meta{i}"], float(cpu[f"secs{i}"])
        diff = float(np.abs(vc.astype(np.float64) - vh).max())
        log(f"parity {name}: steps {mc[0]}/{mh[0]} updates {mc[1]}/{mh[1]} "
            f"edges_touched {mc[2]}/{mh[2]} converged {mc[3]}/{mh[3]} "
            f"time {tc:.2f}/{th:.2f} s (cuda/cpu) max|diff| {diff:.3e}"
            + ("" if held else "  (logged, not held: no fixed point)"))
        if not held:
            continue
        expect(diff <= FIXED_POINT_TOL, f"parity {name}: within 1e-5")
        expect(mc[1] == mh[1] and mc[2] == mh[2],
               f"parity {name}: equal updates and edges_touched")
        if name.startswith("lbp"):
            expect(bool(mc[3]), f"{name}: converged")
    log(f"parity: LBP grid {LBP_GRID}^3 26-connected, {LBP_STATES} states, "
        f"tol {LBP_TOLERANCE}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run it from "
              f"the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    t_all = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    cpu_path = str(WORK_DIR / "cpu_parity.npz")
    child = multiprocessing.get_context("spawn").Process(
        target=cpu_side, args=(cpu_path,))
    child.start()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}  card: {smi}")
        t0 = time.perf_counter()
        build.library()
        log(f"build: {time.perf_counter() - t0:.2f} s")
        (OUT_DIR / "ptxas.txt").write_text(build.build_log)

        rng = np.random.default_rng(0)
        recs = [
            KernelRecord("gas_gather_combine",
                         "src/repro_torch/csrc/gas_gather_combine.cu",
                         "src/repro/kernels/gas/gas.py:103"),
            KernelRecord("gas_scatter_reschedule",
                         "src/repro_torch/csrc/gas_scatter_reschedule.cu",
                         "src/repro/kernels/gas/scatter.py:104"),
            KernelRecord("segment_sum_sorted",
                         "src/repro_torch/csrc/segment_sum_sorted.cu",
                         "src/repro/kernels/segsum/segsum.py:91"),
        ]
        kernel_parity_cases(recs, rng)
        log(f"elapsed {time.perf_counter() - t_all:.1f} s")
        summary = main_path(recs, rng)
        log(f"elapsed {time.perf_counter() - t_all:.1f} s")
        engine_parity(recs, child, cpu_path)
    finally:
        if child.is_alive():
            child.terminate()
        child.join()

    log("main summary: " + json.dumps(summary))
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    if failures:
        log(f"{len(failures)} check(s) failed: {failures}")
        return 1
    print(smi)
    print(json.dumps({"kernels": [r.json() for r in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
