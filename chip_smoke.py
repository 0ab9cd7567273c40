#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Builds the five hand-written CUDA kernels from ``src/repro_torch/csrc``
and then runs six phases; any failure exits nonzero without the result
line:

1. Kernel parity and timing.  Each kernel (K1 gather⊕combine, K2
   scatter/reschedule, K3 sorted segment sum, K4 embedding bag, K5 flash
   attention: its tensor-core kernel in bf16 at d 64 and 128, its SIMT
   kernel otherwise) is held against its plain PyTorch version on the
   card, on edge cases and at the shapes its path gives it (K1-K3 equal
   to the bit to the plain version run on the host, since they add in its
   order; K4 and K5 within a max relative error of 2e-5 in float32, and in
   bfloat16 one bfloat16 ulp of the largest output, 2^-7 relative), and
   timed beside its plain version, one PyTorch library call for the same
   function, and its bound.  K1's cases run at D 1-400 (its D >= 2 column
   kernel at D 2, 3, 5, 16, 20, 128, 204, 300 and 400, a hub of rows of
   2+ segments at D 400, a feature table one row into a larger one at D
   5, not 16-byte aligned, and D 20 and 204 on 16 M edges, more column
   items than the card holds warps) under four masks.  K2 at the full edge set
   and at the largest sender-color subset of phase 2 (also equal to the
   bit to the full set's output); K3 at D 1-64 in f32 and f64 beside the
   LBP shape.  K4
   and K5 are timed at their paths' shapes inside phases 4 and 5, where
   the model's tensors live.
2. The main path: PageRank on ChromaticEngine (fused) over a synthetic
   power-law graph at the scale of SNAP soc-LiveJournal1 (4.85 M vertices),
   run to convergence and checked against a float64 power iteration on the
   card (L1 ≤ 1e-3).  K1 and K2 must have launched on it; K2 reads each
   edge once a sweep (the sender-color subsets).  Then the same run with
   every phase scattering over the full edge set must take the same
   schedule and give the same ranks and priorities to the bit.
3. LBP and engine parity.  LBP under Chromatic (the dense path; K3 must
   have launched on it) in float32 at smoothing 0.6 on the card, its
   residual's course logged; then PageRank under BSP, Chromatic and
   Dynamic and LBP in float64 at smoothing 0.1, each on the card and on the
   CPU (fixed points within 1e-5, equal counts), and the first steps of the
   float32 LBP run on both, logged.  The CPU half runs in a child process
   from the start, beside phases 1, 2, 4 and 5; it is checked last.
4. DLRM-RM2 serving at full width (26 tables of 2^20 x 64 rows, f32):
   ``serve_step`` at serve_p99 (B 512) and serve_bulk (B 262,144) and
   ``retrieval_step`` at retrieval_cand (1 query, 10^6 candidates, top
   100).  K4 must launch once per forward; logits finite; the serve_p99
   forward with K4 equals the same forward with the plain bag within 2e-5.
5. StarCoder2-3B at full width (30 layers, bf16 compute): ``prefill_step``
   at S 32768, batch 1 (K5 must launch 30 times), ``serve_lm`` (batch 4,
   prompt 16, gen 32, 8 requests), and decode against prefill over 64
   tokens (held in f32 at 1 layer, logged at 2 layers in f32 and at 30 in
   bf16: see DECODE_LAYERS).

6. The distributed engines, S machines on the card over the in-process
   exchange.  Netflix ALS (480,189 users, 17,770 movies, 100,480,507
   ratings drawn, d 20, hash placement, users 0 / movies 1) through
   ``DistributedEngine`` at S = 8 for 5 sweeps: K1 at D 400 and D 20 under
   each phase's mask and K2 on the stacked set, each held to its plain
   version (K2 on the whole set, K1 on sampled rows: its [E, D] plain
   version does not fit) and timed, K1 with its effective gather bandwidth
   and, at D 400, timed again at forced slice widths (each equal to the
   bit to the chosen widths' output); the factors held within 1e-5 of
   ``ChromaticEngine`` with equal counts after sweeps 1 and 3; RMSE before
   and after.  NER CoEM (K 204, depth cut to 1.8 M + 0.2 M vertices and
   20 M co-occurrences) for 5 sweeps, K1 at D 204 (with its slice sweep).
   ``DistributedLockingEngine`` (S = 8, p = 1024) on PageRank over a
   6-connected 58 x 58 x 60 grid (n 201,840) against ``DynamicEngine``'s
   fixed point, with no two adjacent winners in any step.  Then the dist
   engines at S = 4 on the card and on the CPU (the child): PageRank equal
   to the bit, LBP (f64, BFS placement, the dense path through K3), ALS
   and CoEM within 1e-5, every counter equal.

``--only models`` runs phase 1's K4/K5 cases and phases 4-5, ``--only
dist`` phase 6 (``--netflix-ratings`` cuts its ALS depth for such a run);
a partial run prints no result line.  It prints the card's name and power
limit, one JSON line of per-kernel numbers (K1's and K2's dist shapes under
``other_shapes``), and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import re
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
BF16_FLOPS_PER_S = 989e12          # H100 SXM bf16 dense tensor cores
REL_TOL = 2e-5
# bf16: kernel and plain version compute in f32 and round once, so they
# differ by at most one bf16 ulp (2^-7 relative) of the largest output (of
# each row, for K5)
BF16_REL_TOL = 2.0 ** -7
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


def log_clocks(label: str) -> None:
    """The card's SM clock against its maximum, power and throttle reasons
    beside a measurement (a card held below its clock runs slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
         "power.draw,power.limit,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"clocks {label}: {out}")


def log_ptxas(text: str) -> None:
    """One line a kernel from ptxas's -v report: registers, spills, stack
    and shared memory."""
    name, props = None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, props = m.group(1), ""
        elif name and "spill" in line:
            props = line.strip()
        elif name and "Used" in line:
            log(f"ptxas {name[:70]}: {line.split(':', 1)[1].strip()}; "
                f"{props}")
            name = None


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


#: cycles of the sleep kernel that ``cuda_ms(queued=True)`` puts before the
#: timed calls (~10 ms at 1980 MHz)
QUEUE_SLEEP_CYCLES = 20_000_000


def cuda_ms(fn, reps: int = 10, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up.
    ``queued``: the calls are enqueued behind a sleep kernel, so the host's
    launch overhead leaves no gaps between them and a kernel's time is its
    device time (a call that syncs with the host waits for the sleep, and
    is timed as before)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
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


def row_rel_err(k: torch.Tensor, p: torch.Tensor) -> tuple:
    """(max abs error, max over rows of a row's max abs error over that
    row's max |plain|), a row being the last axis (one query and head of an
    attention output); a row the plain version leaves zero must be zero."""
    if k.numel() == 0:
        return 0.0, 0.0
    err = (k.double() - p.double()).abs().flatten(0, -2).amax(-1)
    scale = p.double().abs().flatten(0, -2).amax(-1)
    rel = torch.where(scale > 0, err / scale.clamp_min(1e-300),
                      torch.where(err > 0, float("inf"), 0.0))
    return float(err.max()), float(rel.max())


# ---------------------------------------------------------------------------
# Phase 1: kernels
# ---------------------------------------------------------------------------

class KernelRecord:
    def __init__(self, name, source, replaces, row_scale=False):
        """``row_scale``: the relative error takes each output row's own
        scale (``row_rel_err``), not the largest output's."""
        self.name, self.source, self.replaces = name, source, replaces
        self.row_scale = row_scale
        self.max_abs = 0.0
        self.max_rel = 0.0
        self.times = {}
        self.other = []          # timings at further shapes (K2, K3)
        self.launches = 0

    def compare(self, what, k, p, bitwise=False):
        """``bitwise``: the kernel adds in the plain version's order, so the
        two must be equal to the bit (K1, K2, K3, against the plain version
        run on the host: on the card ``index_add_`` adds with atomics, in
        no fixed order)."""
        a, r = (row_rel_err if self.row_scale else rel_err)(k, p)
        self.max_abs = max(self.max_abs, a)
        self.max_rel = max(self.max_rel, r)
        if bitwise:
            bits = torch.int64 if p.dtype == torch.float64 else torch.int32
            same = k.shape == p.shape and k.dtype == p.dtype and \
                torch.equal(k.view(bits), p.view(bits))
            expect(same, f"{self.name} {what}: equal to the bit (max abs "
                   f"diff {a:.3g})")
            return
        tol = BF16_REL_TOL if p.dtype == torch.bfloat16 else REL_TOL
        expect(r <= tol, f"{self.name} {what}: rel err {r:.3g} "
               f"(tol {tol:.3g})")

    def against_library(self, k, lib):
        """Logged only: a library call sums in its own order."""
        log(f"info {self.name}: rel err vs library {rel_err(k, lib)[1]:.3g}")

    def time(self, run_k, run_p, run_l, n_bytes, n_flops, shape,
             flops_per_s=F32_FLOPS_PER_S, plain_reps=3, main=True):
        """``flops_per_s``: the card's peak for the unit and dtype the
        work could use (f32 CUDA cores for sums; bf16 tensor cores for
        bf16 products).  ``main``: the shape the kernel's path gives it
        (the record's own numbers), else one more shape (``other``)."""
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_flops / flops_per_s * 1e3
        times = {
            "ms": cuda_ms(run_k, queued=True),
            "plain_ms": cuda_ms(run_p, plain_reps, queued=True),
            "library_ms": cuda_ms(run_l, queued=True),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": shape}
        times["bound_share"] = times["bound_ms"] / times["ms"]
        if main:
            self.times = times
        else:
            self.other.append(times)
        log(f"time {self.name} [{shape}]: " + ", ".join(
            f"{k}={v:.4g}" for k, v in times.items()
            if isinstance(v, float)))

    def json(self):
        t = self.times or dict.fromkeys(
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "shape"))
        return {
            "name": self.name, "route": "cuda", "source": self.source,
            "replaces": self.replaces, "launches": self.launches,
            "max_abs_err": self.max_abs, "max_rel_err": self.max_rel,
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "other_shapes": self.other,
        }


def row_ptr_bytes(n: int) -> int:
    """The CSR offsets [N+1] i32 the function needs to find each row."""
    return 4 * (n + 1)


def tile_receivers():
    """(name, receivers, n): rows laid out on K1's tiles (kernels/csr.py):
    a tile's edges exactly at its capacity and one edge under; segments at
    the short/long threshold and one edge either side; a tile of one-edge
    rows; a row split over 3 segments between short rows."""
    from repro_torch.kernels.csr import (ROW_SEGMENT, SHORT_SEGMENT,
                                         TILE_WINDOW)
    s, w = SHORT_SEGMENT, TILE_WINDOW
    # rows of s edges up to w - 1 edges, then one that starts at w - 1:
    # the tile holds w - 1 + s edges (its capacity), or one less
    fill = [s] * ((w - 1) // s) + [(w - 1) % s]
    out = []
    for name, lens in (("tile at capacity", fill + [s, s]),
                       ("tile at capacity - 1", fill + [s - 1, s]),
                       ("threshold", [s - 1, s, s + 1, 3, s + 1, s, s - 1]),
                       ("one-edge rows", [1] * 700),
                       ("3-segment row", [5, 2 * ROW_SEGMENT + 7, 4, 1])):
        lens = [x for x in lens if x > 0]
        out.append((name, np.repeat(np.arange(len(lens)), lens)
                    .astype(np.int32), len(lens)))
    return out


def edge_cases(rng):
    """(name, senders, receivers, n, d, offset): the cases of the JAX
    package's kernel tests, a hub longer than one row segment (also at D
    400, rows of 2+ segments through K1's column items), K1's tile layouts,
    the widths of the main paths, and a K1 feature table that starts
    ``offset`` rows into a larger one (at D 5 not 16-byte aligned: K1's
    4-byte cp.async branch)."""
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
    hub_snd = rng.integers(0, 300, hub.size).astype(np.int32)
    cases.append(("hub", hub_snd, hub, 300, 1))
    cases.append(("hub D=400", hub_snd, hub, 300, 400))
    for name, recv, n in tile_receivers():
        cases.append((name, rng.integers(0, n, recv.size).astype(np.int32),
                      recv, n, 1))
    for d in (1, 2, 3, 5, 16, 20, 128, 204, 300, 400):
        cases.append((f"pareto D={d}", *skewed(3000, 40000), 3000, d))
    cases.append(("pareto D=5 table[1:]", *skewed(3000, 40000), 3000, 5))
    return [c + (1 if c[0].endswith("[1:]") else 0,) for c in cases]


def kernel_parity_cases(recs, rng):
    from repro_torch.kernels.gas.ops import (EdgeSet, active_row_blocks,
                                             gather_combine,
                                             scatter_reschedule)
    from repro_torch.kernels.gas.ref import scatter_reschedule_ref
    from repro_torch.kernels.segsum.ops import segment_sum_sorted
    from repro_torch.kernels.segsum.ref import segment_sum_sorted_ref
    k1, k2, k3 = recs[:3]
    for name, snd, recv, n, d, offset in edge_cases(rng):
        es = EdgeSet.build(snd, recv, n, device="cuda")
        e = snd.size
        feat = torch.from_numpy(
            rng.normal(size=(n + offset, d)).astype(np.float32)).cuda()
        feat = feat[offset:]        # a view: K1 reads it where it starts
        if offset:
            expect(feat.data_ptr() % 16 != 0,
                   f"K1 {name}: the view is not 16-byte aligned")
        w = torch.from_numpy(rng.normal(size=e).astype(np.float32)).cuda()
        w_pad = torch.nn.functional.pad(w, (0, es.senders.shape[0] - e))
        # "alternate": every other 128-row block active, so K1's tiles mix
        # active and inactive rows
        for mname, mask in (("all", np.ones(n, bool)),
                            ("30%", rng.random(n) < 0.3),
                            ("alternate", np.arange(n) // 128 % 2 == 0),
                            ("none", np.zeros(n, bool))):
            blk = active_row_blocks(torch.from_numpy(mask).cuda())
            k = gather_combine(feat, w, es, block_active=blk)
            p = k1_plain_on_cpu(feat, w_pad, es, blk)
            k1.compare(f"{name} mask={mname}", k.cpu(), p, bitwise=True)
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
                p = scatter_reschedule_ref(
                    contrib.cpu(), prio.cpu(), cons_t.cpu(), wp.cpu(),
                    es.senders.cpu(), es.receivers.cpu(), n)
                k2.compare(f"{name} consume={cname} w={wname}", k.cpu(), p,
                           bitwise=True)
        recv_t = torch.from_numpy(recv).cuda()
        for dt in (np.float32, np.float64):
            msgs = torch.from_numpy(rng.normal(size=(e, d)).astype(dt)).cuda()
            k = segment_sum_sorted(msgs, recv_t, n, segments=es.segments)
            p = segment_sum_sorted_ref(msgs.cpu(), recv_t.cpu(), n)
            k3.compare(f"{name} {dt.__name__}", k.cpu(), p, bitwise=True)


#: K1's whole-output cases with more column items than the card holds
#: warps at once (a warp then takes several items, claimed in turn, and
#: its ring runs across their boundaries): (N, E, D)
K1_MANY_ITEMS = ((500_000, 16_000_000, 20), (500_000, 16_000_000, 204))


def k1_many_items_cases(k1, rng):
    """K1 at D >= 2 on power-law graphs of 16 M edges (~16,000 column
    items, some rows longer than one segment), held to the bit on the whole
    output under the four masks against its plain version on the host.
    The plain rows do not depend on the mask (it zeroes the rows of
    inactive blocks after the sums), so it runs once a graph."""
    from repro_torch.kernels.gas.ops import (EdgeSet, active_row_blocks,
                                             gather_combine)
    for n, e, d in K1_MANY_ITEMS:
        # power-law degrees of mean ~36 (the longest rows ~10^5 edges)
        deg = ((rng.pareto(1.5, n) + 1) * 12).astype(np.int64)
        recv = np.repeat(np.arange(n, dtype=np.int32), deg)[:e]
        recv = np.concatenate([recv, np.full(e - recv.size, n - 1, np.int32)])
        snd = rng.integers(0, n, e).astype(np.int32)
        es = EdgeSet.build(snd, recv, n, device="cuda")
        feat = torch.from_numpy(
            rng.normal(size=(n, d)).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.normal(size=e).astype(np.float32)).cuda()
        w_pad = torch.nn.functional.pad(w, (0, es.senders.shape[0] - e))
        items = es.segments.column_items(d)
        log(f"K1 many items: N={n} E={e} D={d} items={items.n_items} "
            f"segments={es.segments.n_segments} rows of 2+ segments="
            f"{items.n_multi}")
        plain = k1_plain_on_cpu(feat, w_pad, es, None)
        rows_blk = np.arange(n) // 128
        for mname, mask in (("all", np.ones(n, bool)),
                            ("30%", rng.random(n) < 0.3),
                            ("alternate", rows_blk % 2 == 0),
                            ("none", np.zeros(n, bool))):
            blk = active_row_blocks(torch.from_numpy(mask).cuda())
            on = torch.repeat_interleave(blk.cpu().bool(), 128)[:n]
            want = torch.where(on[:, None], plain, torch.zeros_like(plain))
            k = gather_combine(feat, w, es, block_active=blk)
            k1.compare(f"many items N={n} E={e} D={d} mask={mname}", k.cpu(),
                       want, bitwise=True)
        del es, feat, w, w_pad, plain
        torch.cuda.empty_cache()


def k1_plain_on_cpu(feat, w_pad, es, blk):
    """K1's plain version on the host: its sequential ``index_add_`` fixes
    the order K1 reproduces (on the card ``index_add_`` adds with atomics,
    in no fixed order)."""
    from repro_torch.kernels.gas.ref import gather_combine_ref
    return gather_combine_ref(feat.cpu(), w_pad.cpu(), es.senders.cpu(),
                              es.receivers.cpu(), es.n_vertices,
                              None if blk is None else blk.cpu())


def on_host(seg):
    """A copy of the segment tables ``seg`` on the host: the plain version
    adds in the order of the tables it is given (a subset's are cut at the
    full set's segments, not every ROW_SEGMENT edges)."""
    return dataclasses.replace(seg, **{
        f: getattr(seg, f).cpu()
        for f in ("row_ids", "row_seg", "seg_beg", "seg_row")})


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
    rec.compare("main shape", run_k().cpu(),
                k1_plain_on_cpu(feat, w_pad, es, blk), bitwise=True)
    a = csr_matrix(es, w)
    run_l = lambda: torch.sparse.mm(a, feat)
    rec.against_library(run_k(), run_l())
    tiles = es.segments.tiles
    gather_bytes = 4 * e * d
    rec.time(run_k, run_p, run_l,
             4 * (2 * e + 2 * n * d + es.n_row_blocks) + row_ptr_bytes(n),
             2 * e * d, f"N={n} D={d} E={e} segments="
             f"{es.segments.n_segments} (largest color) tiles={tiles.n_tiles}"
             f" (partial {tiles.n_partial}) multi rows={tiles.n_multi}")
    rec.times["gather_tb_per_s"] = gather_bytes / rec.times["ms"] / 1e9
    log(f"K1 main shape: effective gather {rec.times['gather_tb_per_s']:.3f} "
        f"TB/s (per-edge gather bytes over kernel time)")
    profile_window("K1 main shape (10 calls)",
                   lambda: [run_k() for _ in range(10)], "k1_profile.txt")


def time_k2(rec, full, sub, color, colors, rng):
    """K2 at the main path's two shapes, unit weights: the full edge set
    (BSP and Dynamic scatter over it) with contributions anywhere, and the
    largest sender-color subset (a chromatic phase scatters over its
    color's) with contributions +0 off that color, the record's own shape.
    Each equal to the bit to its plain version on the host; the subset's
    output also to the full set's kernel output on the same inputs."""
    from repro_torch.kernels.gas.scatter import gas_scatter_reschedule_cuda
    from repro_torch.kernels.gas.ref import scatter_reschedule_ref
    n = full.n_vertices
    prio = torch.from_numpy((rng.random(n) * 1e-6).astype(np.float32)).cuda()
    live = rng.random(n) < 0.2
    for es, senders_on in ((full, live), (sub, live & (colors == color))):
        contrib = torch.from_numpy(np.where(
            senders_on, rng.random(n) * 1e-7, 0).astype(np.float32)).cuda()
        cons = contrib > 0
        ones = torch.ones(es.senders.shape[0], dtype=torch.float32,
                          device="cuda")
        run_k = lambda: gas_scatter_reschedule_cuda(contrib, prio, cons,
                                                    es.senders, es.segments)
        run_p = lambda: scatter_reschedule_ref(contrib, prio, cons, ones,
                                               es.senders, es.receivers, n,
                                               segments=es.segments)
        host = scatter_reschedule_ref(
            contrib.cpu(), prio.cpu(), cons.cpu(), ones.cpu(),
            es.senders.cpu(), es.receivers.cpu(), n,
            segments=on_host(es.segments))
        what = "full edge set" if es is full else \
            f"largest sender-color subset (color {color})"
        rec.compare(what, run_k().cpu(), host, bitwise=True)
        if es is sub:
            rec.compare(f"{what} vs the full set's kernel call", run_k(),
                        gas_scatter_reschedule_cuda(contrib, prio, cons,
                                                    full.senders,
                                                    full.segments),
                        bitwise=True)
        a = csr_matrix(es, ones[:es.n_edges])
        keep = torch.where(cons, torch.zeros_like(prio), prio)[:, None]
        run_l = lambda: torch.addmm(keep, a, contrib[:, None])
        rec.against_library(run_k(), run_l()[:, 0])
        n_snd = int(torch.unique(es.senders[:es.n_edges]).numel())
        tiles = es.segments.tiles
        # senders, the contributions of the distinct senders, prio,
        # consume, the row offsets, the output
        if es is sub:
            profile_window(f"K2 {what} (20 calls)",
                           lambda: [run_k() for _ in range(20)],
                           "k2_profile.txt")
        rec.time(run_k, run_p, run_l,
                 4 * es.n_edges + 4 * n_snd + 9 * n + row_ptr_bytes(n),
                 es.n_edges, f"N={n} E={es.n_edges} senders={n_snd} "
                 f"segments={es.segments.n_segments} tiles={tiles.n_tiles}"
                 f" (partial {tiles.n_partial}) ({what})", main=es is sub)


#: K3's widths held and timed on the LBP grid beside its path's shape
K3_WIDTHS = (1, 2, 5, 8, 16, 64)


def time_k3(rec, structure, k, dtype, main=True):
    """K3 on [E, k] messages on the 3-D grid (the LBP path's shape at k =
    LBP_STATES in f32), equal to the bit to its plain version on the
    host."""
    from repro_torch.kernels.segsum.segsum import (segment_sum_sorted_cuda,
                                                   tile_shape)
    from repro_torch.kernels.segsum.ref import segment_sum_sorted_ref
    n, e = structure.n_vertices, structure.n_edges
    seg = structure.row_segments()
    recv = structure.device_arrays()["receivers"]
    gen = torch.Generator(device="cuda").manual_seed(k)
    msgs = torch.randn((e, k), generator=gen, device="cuda", dtype=dtype)
    run_k = lambda: segment_sum_sorted_cuda(msgs, seg)
    run_p = lambda: segment_sum_sorted_ref(msgs, recv, n, seg)
    run_l = lambda: torch.zeros((n, k), device="cuda",
                                dtype=dtype).index_add_(0, recv, msgs)
    shape = f"N={n} D={k} E={e} {str(dtype)[6:]} (LBP grid)"
    rec.compare(shape, run_k().cpu(),
                segment_sum_sorted_ref(msgs.cpu(), recv.cpu(), n),
                bitwise=True)
    rec.against_library(run_k(), run_l())
    size = msgs.element_size()
    tiles = seg.tiles_for(tile_shape(k, size)[0])
    rec.time(run_k, run_p, run_l, size * (e + n) * k + row_ptr_bytes(n),
             e * k, f"{shape} tiles={tiles.n_tiles}", main=main)


def k3_widths(rec, structure):
    """K3 at every width of K3_WIDTHS in f32 and f64 on the LBP grid."""
    for dtype in (torch.float32, torch.float64):
        for k in K3_WIDTHS:
            if (k, dtype) != (LBP_STATES, LBP_F32[0]):
                time_k3(rec, structure, k, dtype, main=False)
                torch.cuda.empty_cache()


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


def profile_window(label, fn, out_name):
    """Runs ``fn`` once under ``torch.profiler`` and logs device time by
    kernel.  Busy time sums the kernels' (and copies') own device time
    only: an operator's row repeats the time of the kernels it launched.
    The profiler's host cost inflates the wall time, so the idle share is
    an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a first small kernel: the window's first launch was missing from
        # the device records
        torch.ones(1, device="cuda").add_(1)
        fn()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    (OUT_DIR / out_name).write_text(
        events.table(sort_by="self_device_time_total", row_limit=20))
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA]
    busy = sum(ev.self_device_time_total for ev in kernels) / 1e3  # ms
    launches = sum(ev.count for ev in kernels)
    idle = max(0.0, 1 - busy / wall)
    log(f"{label}: profiled: wall {wall:.1f} ms (with profiler), device "
        f"busy {busy:.1f} ms in {launches} kernels, idle share {idle:.3f}")
    expect(launches > 0, f"{label}: the profiler saw the device's kernels")
    for ev in sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:8]:
        log(f"{label}:   {ev.key[:60]:60s} "
            f"{ev.self_device_time_total / 1e3:9.2f} ms  x{ev.count}")
    return {"wall_ms": wall, "busy_ms": busy, "kernels": launches,
            "idle_share": idle}


def warm_profiler() -> None:
    """The process's first profiled window pays the profiler's start-up
    (seconds, on the host); pay it here, outside any measured window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile_steps(eng, graph, steps=2):
    """Device time by kernel over the first ``steps`` engine steps."""
    state = eng.init(graph)

    def run():
        nonlocal state
        for _ in range(steps):
            state = eng.step(state)

    profile_window(f"main: {steps} steps", run, "main_profile.txt")


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

    class SetupTimed(ChromaticEngine):
        """ChromaticEngine that logs the seconds and device memory of each
        list of per-color subsets it builds (set-up)."""

        def _subsets(self, edge_color, cuts=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._subsets(edge_color, cuts)
            torch.cuda.synchronize()
            kind = "gather (receiver" if cuts is None else "scatter (sender"
            log(f"main: {kind}-color) subsets {time.perf_counter() - t0:.1f}"
                f" s, {edgeset_bytes(out) / 2**30:.3f} GiB on the card")
            return out

    t0 = time.perf_counter()
    eng = SetupTimed(prog, graph, colors=colors, tolerance=tol,
                     device="cuda")
    torch.cuda.synchronize()
    log(f"main: engine set-up {time.perf_counter() - t0:.1f} s (both kinds "
        f"of subsets, the scatter subsets' cuts, the coloring check)  "
        f"fused={eng.use_fused}")
    expect(eng.use_fused, "main: PageRank takes the fused path")
    t0 = time.perf_counter()
    full = eng._full_edges   # for K2's timing and the full-set comparison
    torch.cuda.synchronize()
    log(f"main: full EdgeSet {time.perf_counter() - t0:.1f} s")

    # K1's and K2's tile tables, built on their first launch, built here
    # (set-up)
    for name, sets in (("K1", eng._color_edges), ("K2", eng._scatter_edges)):
        t0 = time.perf_counter()
        n_tiles = sum(es.segments.tiles.n_tiles for es in sets)
        torch.cuda.synchronize()
        log(f"main: {name} tile tables {time.perf_counter() - t0:.2f} s  "
            f"tiles={n_tiles}; the subsets with them "
            f"{edgeset_bytes(sets) / 2**30:.3f} GiB on the card")
    per_sweep = sum(es.n_edges for es in eng._scatter_edges)
    log(f"main: K2 reads {per_sweep} edges a sweep over {eng.num_colors} "
        f"color phases (E = {st.n_edges}; a full-set scatter reads "
        f"{eng.num_colors} x E = {eng.num_colors * st.n_edges})")
    expect(per_sweep == st.n_edges, "main: the scatter subsets hold each "
           "edge once (edges K2 reads a sweep = E)")
    # K1 and K2 at the shapes this path gives them (launches not counted)
    es0 = max(eng._color_edges, key=lambda es: es.n_edges)
    w0 = graph.edge_data["w"][es0.perm].contiguous()
    c2 = max(range(eng.num_colors),
             key=lambda c: eng._scatter_edges[c].n_edges)
    log_clocks("before K1/K2 timing")
    time_k1(recs[0], es0, w0, rng)
    time_k2(recs[1], full, eng._scatter_edges[c2], c2, colors, rng)
    profile_steps(eng, graph)

    state = eng.init(graph)
    log_clocks("before the main path's run")
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
    full_ms = full_set_run(eng, graph, state)
    return {"n": n, "E": st.n_edges, "colors": eng.num_colors,
            "steps": steps, "total_updates": upd,
            "edges_touched": int(state.edges_touched), "run_s": secs,
            "ms_per_step": 1e3 * secs / max(steps, 1),
            "updates_per_s": upd / secs, "peak_gib": peak / 2**30, "l1": l1,
            "k2_edges_per_sweep": per_sweep,
            "full_scatter_ms_per_step": full_ms}


def full_set_run(eng, graph, state):
    """The main path again with every phase scattering over the full edge
    set (the design before the sender-color subsets): the same schedule
    (steps, updates, edges touched) and the same ranks and priorities to
    the bit.  Returns its ms/step."""
    from repro_torch.core.engine_base import Engine
    eng._scatter_ctx = lambda phase: Engine._scatter_ctx(eng, phase)
    try:
        (full, _), secs = sync_time(
            lambda: eng.run(eng.init(graph), max_steps=MAIN_MAX_STEPS))
    finally:
        del eng._scatter_ctx
    steps = int(full.step_index)
    log(f"main, full-set scatter: steps={steps} total_updates="
        f"{int(full.total_updates)} edges_touched={int(full.edges_touched)}"
        f"  {1e3 * secs / max(steps, 1):.3f} ms/step")
    expect((steps, int(full.total_updates), int(full.edges_touched)) == (
        int(state.step_index), int(state.total_updates),
        int(state.edges_touched)), "main: the sender-color subsets take the "
        "full-set scatter's schedule (steps, updates, edges touched)")
    bits = [(a.view(torch.int32), b.view(torch.int32)) for a, b in (
        (state.graph.vertex_data["rank"], full.graph.vertex_data["rank"]),
        (state.prio, full.prio))]
    expect(all(torch.equal(a, b) for a, b in bits), "main: ranks and "
           "priorities equal to the bit with the full-set scatter")
    return 1e3 * secs / max(steps, 1)


def edgeset_bytes(sets) -> int:
    """Device bytes of a list of EdgeSets: edge arrays, segment tables and
    whatever tile tables they have built."""
    total = 0
    for es in sets:
        seg = es.segments
        ts = [es.senders, es.receivers, es.block_counts, seg.row_ids,
              seg.row_seg, seg.seg_beg, seg.seg_row]
        ts += [] if es.perm is None else [es.perm]
        for tt in seg.__dict__.get("_tile_cache", {}).values():
            ts += [tt.tile_beg, tt.tile_end, tt.multi_rows]
        total += sum(t.numel() * t.element_size() for t in ts)
    return total


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


def cpu_side(path: str, local: bool = True) -> None:
    """Child process: the CPU half of the parity phases (plain versions):
    the local engines' cases (``local``) and the dist engines' cases."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(CPU_THREADS)
    out = {}
    for i, (_, eng, graph, leaf, steps, _) in enumerate(
            parity_cases("cpu") if local else []):
        vals, meta, secs, _ = run_case(eng, graph, leaf, steps)
        out[f"vals{i}"], out[f"meta{i}"] = vals, meta
        out[f"secs{i}"] = np.array(secs)
    for i, (_, eng, leaf, steps, _) in enumerate(dist_parity_cases("cpu")):
        vals, prio, meta, secs = run_dist_case(eng, leaf, steps)
        out[f"dvals{i}"], out[f"dprio{i}"] = vals, prio
        out[f"dmeta{i}"], out[f"dsecs{i}"] = meta, np.array(secs)
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
    k3_widths(rec, graph.structure)
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


def engine_parity_card(recs):
    """The card's half of the parity phase; returns what the CPU half is
    checked against, and drops the cases' card tensors."""
    cases = parity_cases("cuda")
    f32_name, f32_eng, f32_graph = cases[-1][:3]
    lbp_f32_path(recs[2], f32_name.split(" (")[0], f32_eng, f32_graph)
    results = []
    for _, eng, graph, leaf, steps, _ in cases:
        torch.cuda.synchronize()
        results.append(run_case(eng, graph, leaf, steps)[:3])
    return [(name, held) for name, *_rest, held in cases], results


def cpu_results(child, cpu_path):
    """Waits for the CPU half of the parity phases; its results or None."""
    t0 = time.perf_counter()
    child.join(CHILD_TIMEOUT_S)
    if child.is_alive():
        child.terminate()
        child.join()
    log(f"parity: waited {time.perf_counter() - t0:.1f} s for the CPU side")
    expect(child.exitcode == 0, f"CPU side exit code {child.exitcode}")
    return np.load(cpu_path) if child.exitcode == 0 else None


def engine_parity_check(cases, results, cpu):
    for i, (name, held) in enumerate(cases):
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


# ---------------------------------------------------------------------------
# Phase 1, continued: K4 and K5 on edge cases
# ---------------------------------------------------------------------------

#: K4 (V, D, B, H, fields): D not a multiple of 4 (the scalar path), B not
#: a multiple of 128, repeated ids, stacked fields
BAG_CASES = [(16, 16, 1, 1, 1), (300, 64, 37, 3, 1), (3000, 128, 130, 6, 1),
             (1000, 64, 257, 1, 3), (77, 5, 50, 4, 2), (40, 16, 9, 2, 4)]
#: K5 (B, S, T, KV, group, d, causal, window): GQA groups 1, 2, 4 and 12,
#: S not a multiple of 64, windows 8-64, long KV, rows that see no key
#: (T 10 < S 20 under window 2), every head dim the kernel takes
ATTN_CASES = [(1, 40, 40, 2, 1, 64, True, None),
              (2, 200, 200, 1, 2, 128, True, None),
              (1, 130, 130, 2, 4, 64, False, None),
              (1, 77, 77, 2, 12, 128, True, None),
              (1, 150, 150, 2, 2, 64, True, 8),
              (1, 300, 300, 1, 4, 64, True, 64),
              (1, 128, 2048, 2, 1, 64, False, None),
              (1, 20, 10, 1, 2, 64, True, 2),
              (1, 20, 10, 1, 2, 64, False, 2),
              (2, 70, 70, 2, 2, 16, True, None),
              (1, 90, 90, 1, 3, 32, True, 16)]
#: K5 cases for the tensor-core kernel's 128 × 128 tiles: S and T not
#: multiples of 128, windows at 4096 and one either side (S 4500, so the
#: window binds) and 100, G = 12 at d 128, T > S without the causal mask
#: (with and without a window)
ATTN_TILE_CASES = [(1, 4500, 4500, 1, 2, 128, True, 4095),
                   (1, 4500, 4500, 1, 2, 128, True, 4096),
                   (1, 4500, 4500, 1, 2, 128, True, 4097),
                   (1, 1000, 1000, 2, 2, 64, True, 100),
                   (1, 333, 333, 2, 12, 128, True, None),
                   (2, 200, 700, 2, 2, 128, False, None),
                   (1, 300, 1100, 1, 4, 64, False, 256)]


#: K5 mask probes (B, S, T, KV, group, d, W) at the tile shapes: each is
#: run causal under windows W - 1, W and W + 1, and causal and not without
#: a window (``mask_probe``)
ATTN_PROBE_CASES = [(1, 4500, 4500, 1, 2, 128, 4096),
                    (1, 1000, 1000, 2, 2, 64, 100),
                    (1, 333, 333, 2, 12, 128, 128)]
PROBE_GAP = 12.0       # logits from a row's top key to the next
PROBE_DIFF = 0.5       # a moved row's least max abs change (it moves ~1)


def mask_probe(b, s, t, kv, group, d, window):
    """q, k, v (f32 numpy) that make a mask's edge show in every row.  Query
    i scores the key at its target position far above every other key
    (PROBE_GAP logits over the keys one either side, more further off):
    target i - window, the key just outside the window, where the window
    binds (i >= window); else i + 1, the key just past the diagonal.  v is
    one-hot by key position (mod d), so a row comes out as the one-hot of
    its top admitted key, and admitting or dropping a key at the mask's edge
    moves it by about 1.  Scores come from rotations of the positions at
    d / 2 frequencies from 0.5 down to 1 / (4T) radians a step."""
    f = d // 2
    theta = 0.5 * (1.0 / (4 * t)) ** (np.arange(f) / (f - 1))
    amp = np.sqrt(PROBE_GAP * np.sqrt(d) / np.sum(1 - np.cos(theta)))

    def phi(x):
        a = np.asarray(x, np.float64)[:, None] * theta
        return amp * np.concatenate([np.cos(a), np.sin(a)], 1)

    i = np.arange(s)
    target = np.where(i >= window, i - window, i + 1)
    q = np.broadcast_to(phi(target)[None, :, None], (b, s, kv * group, d))
    k = np.broadcast_to(phi(np.arange(t))[None, :, None], (b, t, kv, d))
    v = np.zeros((b, t, kv, d))
    v[:, np.arange(t), :, np.arange(t) % d] = 1.0
    return [np.ascontiguousarray(x, np.float32) for x in (q, k, v)]


def probe_cases(k5):
    """K5 on the mask probes, in bf16 and f32: each run within the tolerance
    of its plain version row by row; windows W - 1, W and W + 1 give
    different answers on every row where they bind, and so do causal and
    not on every row that probes the diagonal (checked on the plain
    version, so that the probe is known to bite)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    for b, s, t, kv, group, d, w in ATTN_PROBE_CASES:
        qkv = mask_probe(b, s, t, kv, group, d, w)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.from_numpy(x).to(dt).cuda() for x in qkv)
            plain = {}
            for causal, window in ((True, w - 1), (True, w), (True, w + 1),
                                   (True, None), (False, None)):
                got = flash_attention_cuda(q, k, v, causal, window)
                want = attention_ref(q, k, v, causal, window, q_chunk=512)
                plain[causal, window] = want.float()
                k5.compare(f"probe B={b} S={s} T={t} KV={kv} G={group} "
                           f"d={d} causal={causal} W={window} "
                           f"{str(dt)[6:]}", got, want)

            def moved(x, y, rows):
                return float((x[:, rows] - y[:, rows]).abs().amax(-1).min())

            edge = slice(w + 1, None)
            windows = min(moved(plain[True, x], plain[True, y], edge)
                          for x, y in ((w - 1, w), (w, w + 1),
                                       (w - 1, w + 1)))
            diag = moved(plain[True, None], plain[False, None],
                         slice(0, min(w, t - 1)))
            expect(min(windows, diag) >= PROBE_DIFF,
                   f"K5 probe S={s} d={d} W={w} {str(dt)[6:]} bites: "
                   f"windows move rows by >= {windows:.3g}, the diagonal "
                   f"by >= {diag:.3g} (need {PROBE_DIFF})")


def model_kernel_cases(k4, k5, rng):
    from repro_torch.kernels.embedding_bag.embedding_bag import \
        embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    for dt in (torch.float32, torch.bfloat16):
        for v, d, b, h, fields in BAG_CASES:
            table = torch.from_numpy(rng.normal(size=(fields * v, d))
                                     .astype(np.float32)).to(dt).cuda()
            ids = np.minimum(rng.integers(0, v, (b, h)), v - 1)
            ids[0, :] = ids[0, 0]                         # repeated ids
            ids = torch.from_numpy(ids.astype(np.int32)).cuda()
            k4.compare(f"V={v} D={d} B={b} H={h} fields={fields} "
                       f"{str(dt)[6:]}", embedding_bag_cuda(table, ids,
                                                            fields),
                       embedding_bag_ref(table, ids, fields))
        for b, s, t, kv, group, d, causal, window in \
                ATTN_CASES + ATTN_TILE_CASES:
            q, k, v = (torch.from_numpy(rng.normal(size=sh)
                                        .astype(np.float32)).to(dt).cuda()
                       for sh in ((b, s, kv * group, d), (b, t, kv, d),
                                  (b, t, kv, d)))
            got = flash_attention_cuda(q, k, v, causal, window)
            want = attention_ref(q, k, v, causal, window)
            k5.compare(f"B={b} S={s} T={t} KV={kv} G={group} d={d} "
                       f"causal={causal} W={window} {str(dt)[6:]}", got,
                       want)
            if t < s and window is not None:
                expect(float(got[:, t + window:].abs().max()) == 0.0,
                       f"K5 rows that see no key are zeros ({str(dt)[6:]}, "
                       f"causal={causal})")
    probe_cases(k5)


# ---------------------------------------------------------------------------
# Phase 4: DLRM-RM2 serving
# ---------------------------------------------------------------------------

DLRM_SEED = 0
DLRM_REPS = 10


def dlrm_batch(cfg, b, gen):
    return {"dense": torch.randn((b, cfg.n_dense), generator=gen,
                                 device="cuda"),
            "sparse_ids": torch.randint(
                0, cfg.vocab_size, (b, cfg.n_sparse, cfg.multi_hot),
                generator=gen, device="cuda", dtype=torch.int32)}


def time_k4(rec, tables, ids):
    """K4 at the serve_bulk shape: the 26 stacked tables as one flat table
    and B·F bags, one launch."""
    from repro_torch.kernels.embedding_bag.embedding_bag import \
        embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    f, v, d = tables.shape
    flat = tables.reshape(f * v, d)
    bags = ids.reshape(-1, ids.shape[-1])
    n, h = bags.shape
    offset = (torch.arange(n, device="cuda") % f) * v
    lib_ids = bags.long() + offset[:, None]
    run_k = lambda: embedding_bag_cuda(flat, bags, f)
    run_p = lambda: embedding_bag_ref(flat, bags, f)
    run_l = lambda: torch.nn.functional.embedding_bag(lib_ids, flat,
                                                      mode="sum")
    rec.compare("serve_bulk shape", run_k(), run_p())
    rec.against_library(run_k(), run_l())
    size = flat.element_size()
    rec.time(run_k, run_p, run_l, size * n * h * d + size * n * d + 4 * n * h,
             n * h * d, f"bags={n} H={h} D={d} table={f}x{v} "
             f"{str(flat.dtype)[6:]} (serve_bulk)")


def dlrm_phase(k4):
    from repro_torch.configs import dlrm_rm2
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag.embedding_bag import \
        embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.launch.steps import retrieval_step, serve_step
    from repro_torch.models import dlrm

    cfg = dlrm_rm2.full_config()
    t0 = time.perf_counter()
    params = dlrm.init_params(cfg, seed=DLRM_SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"dlrm: init {time.perf_counter() - t0:.1f} s, tables "
        f"{params.tables.numel() * params.tables.element_size() / 1e9:.3f}"
        f" GB")
    gen = torch.Generator(device="cuda").manual_seed(DLRM_SEED + 1)
    shapes = {name: RECSYS_SHAPES[name] for name in
              ("serve_p99", "serve_bulk", "retrieval_cand")}
    batches = {name: dlrm_batch(cfg, sh.batch, gen)
               for name, sh in shapes.items()}
    batches["retrieval_cand"]["candidates"] = torch.randn(
        (shapes["retrieval_cand"].n_candidates, cfg.embed_dim),
        generator=gen, device="cuda")
    time_k4(k4, params.tables, batches["serve_bulk"]["sparse_ids"])

    out = {}
    embedding_bag_cuda.launches = 0
    forwards = 0
    for name, sh in shapes.items():
        batch = batches[name]
        if sh.step == "serve":
            run = lambda: serve_step(cfg, params, batch)
        else:
            run = lambda: retrieval_step(cfg, params, batch)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, DLRM_REPS)
        forwards += DLRM_REPS + 1
        peak = torch.cuda.max_memory_allocated() / 2**30
        res = run()
        forwards += 1
        vals = res if sh.step == "serve" else res[0]
        expect(bool(torch.isfinite(vals).all()) and vals.shape[0] == (
            sh.batch if sh.step == "serve" else 100),
            f"dlrm {name}: finite output of the expected shape")
        out[name] = {"ms": ms, "peak_gib": peak, "batch": sh.batch}
        per_s = sh.batch / ms * 1e3
        log(f"dlrm {name}: {ms:.4f} ms/call  {per_s:.4g} samples/s  peak "
            f"device memory {peak:.3f} GiB")
    k4.launches = embedding_bag_cuda.launches
    log(f"dlrm: K4 launches {k4.launches} for {forwards} forwards")
    expect(k4.launches == forwards, "dlrm: K4 launched once per forward")
    def bulk_calls():
        for _ in range(DLRM_REPS):
            serve_step(cfg, params, batches["serve_bulk"])

    profile_window(f"dlrm serve_bulk ({DLRM_REPS} calls)", bulk_calls,
                   "dlrm_profile.txt")

    # the serve_p99 forward with the plain bag on the card
    batch = batches["serve_p99"]
    with_k4 = serve_step(cfg, params, batch)
    saved = dlrm.bag_op
    dlrm.bag_op = embedding_bag_ref
    try:
        plain = serve_step(cfg, params, batch)
    finally:
        dlrm.bag_op = saved
    _, r = rel_err(with_k4, plain)
    log(f"dlrm serve_p99: K4 forward vs plain-bag forward rel err {r:.3g}")
    expect(r <= REL_TOL, "dlrm serve_p99: K4 forward within 2e-5 of the "
           "plain-bag forward")
    scores, idx = retrieval_step(cfg, params, batches["retrieval_cand"])
    expect(bool((scores[:-1] >= scores[1:]).all())
           and int(idx.unique().numel()) == 100,
           "dlrm retrieval: 100 distinct candidates in score order")
    return out


# ---------------------------------------------------------------------------
# Phase 5: StarCoder2-3B prefill and serving
# ---------------------------------------------------------------------------

LM_SEED = 0
PREFILL_WARMUP_S = 2048
DECODE_TOKENS = 64
# Decode against prefill is held at full width in f32 with the depth cut
# to DECODE_LAYERS.  The randomly initialised network amplifies round-off
# with depth: prefill (K5, batched products) and decode (the cache, one
# token's products) round differently, and on the H100 (PERF.md, section
# 6) the two agreed within 2.0e-5 of the largest logit at 1 layer in f32
# over 64 tokens but differed by 1.8e-3 at 2 layers in f32 and by about 1
# at 30 layers in f32 and in bf16, so beyond one layer no tolerance tells
# a fault from round-off.  The bar is the JAX suite's decode-matches-
# prefill tolerance, 2e-4 (tests/test_models.py), of the largest |logit|.
# Thirty layers in bf16 and in f32, and two in f32, are logged beside it.
DECODE_LAYERS = 1
DECODE_REL_TOL = 2e-4
DECODE_PROFILE_STEPS = 4


def decode_vs_prefill(cfg, params, toks):
    """(max |decode - prefill| / max |prefill logit|, positions with equal
    argmax, positions whose top-1 leads by more than the tolerance, of
    which those with equal argmax) over the tokens ``toks`` [1, n]."""
    from repro_torch.launch.steps import prefill_step
    from repro_torch.models import transformer as tf
    n = toks.shape[1]
    pre = prefill_step(cfg, params, {"tokens": toks})[0].float()
    cache = tf.init_kv_cache(cfg, 1, n, dtype=torch.float32, device="cuda")
    outs = []
    for t in range(n):
        lg, cache = tf.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
        outs.append(lg[0].float())
    dec = torch.stack(outs)
    scale = float(pre.abs().max())
    rel = float((dec - pre).abs().max()) / scale
    top2 = pre.topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * DECODE_REL_TOL * scale
    same = pre.argmax(-1) == dec.argmax(-1)
    return rel, int(same.sum()), int(clear.sum()), int(same[clear].sum())


def time_k5(rec, q, k, v, window):
    """K5 at the prefill shape, on one layer's q, k and v.  The plain
    version runs in 512-query chunks (``attn_q_chunk`` of the JAX
    package's bundles); unchunked, its scores would take 103 GB.  The
    library call runs on 4096-query chunks, each against the keys its
    window reaches, with the window as a boolean mask."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    import torch.nn.functional as F
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    chunk = 4096
    pieces = []
    for s0 in range(0, S, chunk):
        kb, ke = max(0, s0 - window + 1), min(T, s0 + chunk)
        qpos = torch.arange(s0, s0 + chunk, device="cuda")[:, None]
        kpos = torch.arange(kb, ke, device="cuda")[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        pieces.append((s0, kb, ke, mask))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def run_l():
        out = torch.empty_like(qt)
        for s0, kb, ke, mask in pieces:
            out[:, :, s0:s0 + chunk] = F.scaled_dot_product_attention(
                qt[:, :, s0:s0 + chunk], kt[:, :, kb:ke], vt[:, :, kb:ke],
                attn_mask=mask, enable_gqa=True)
        return out.transpose(1, 2)

    run_k = lambda: flash_attention_cuda(q, k, v, True, window)
    run_p = lambda: attention_ref(q, k, v, True, window, q_chunk=512)
    rec.compare("prefill shape", run_k(), run_p())
    rec.against_library(run_k(), run_l())
    pairs = sum(min(s + 1, window) for s in range(S))   # inside the mask
    size = q.element_size()
    rec.time(run_k, run_p, run_l,
             size * (2 * B * S * H * d + 2 * B * T * KV * d),
             4 * d * pairs * H * B,
             f"B={B} S={S} H={H} KV={KV} d={d} W={window} "
             f"{str(q.dtype)[6:]} (prefill, layer 0)",
             flops_per_s=BF16_FLOPS_PER_S, plain_reps=1)


def lm_phase(k5):
    from repro_torch.configs import starcoder2_3b
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_cuda
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import prefill_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import apply_rope

    cfg = starcoder2_3b.full_config()
    S = LM_SHAPES["prefill_32k"].seq_len
    t0 = time.perf_counter()
    # drawn in f32 and cast once: the values a cast at every use gives
    params = tf.init_params(dataclasses.replace(cfg, param_dtype=cfg.dtype),
                            seed=LM_SEED, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    log(f"lm: init {time.perf_counter() - t0:.1f} s, {n_par} parameters "
        f"({cfg.n_params()} by the config) in {str(cfg.dtype)[6:]}")
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")

    # K5 at its path's shape: layer 0's q, k, v of this prompt
    with torch.inference_mode():
        lp = params.layers.index(0)
        x = params.embed[tokens]
        h = tf._norm(cfg, x, lp["norms"]["ln1"], lp["norms"]["ln1_b"])
        pos = torch.arange(S, device="cuda")[None]
        q = apply_rope(tf._proj(h, lp["attn"]["wq"], cfg), pos,
                       cfg.rope_theta)
        k = apply_rope(tf._proj(h, lp["attn"]["wk"], cfg), pos,
                       cfg.rope_theta)
        v = tf._proj(h, lp["attn"]["wv"], cfg)
        log_clocks("before K5 timing")
        time_k5(k5, q, k, v, cfg.sliding_window)
        log_clocks("after K5 timing")
        del lp, x, h, q, k, v

    prefill_step(cfg, params, {"tokens": tokens[:, :PREFILL_WARMUP_S]})
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    logits, secs = sync_time(
        lambda: prefill_step(cfg, params, {"tokens": tokens}))
    k5.launches = flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"lm prefill: B=1 S={S} {secs:.3f} s  {S / secs:.5g} tokens/s  "
        f"peak device memory {peak:.3f} GiB  K5 launches {k5.launches}")
    expect(k5.launches == cfg.n_layers, f"lm prefill: K5 launched "
           f"{cfg.n_layers} times")
    expect(tuple(logits.shape) == (1, S, cfg.vocab_size)
           and bool(torch.isfinite(logits).all()),
           "lm prefill: finite logits [1, S, V]")
    del logits
    profile_window("lm prefill", lambda: prefill_step(
        cfg, params, {"tokens": tokens}), "prefill_profile.txt")
    cache = tf.init_kv_cache(cfg, 4, 48, dtype=torch.float32, device="cuda")
    step_toks = tokens[0, :4, None]

    def decode_steps():
        for t in range(DECODE_PROFILE_STEPS):
            lg, _ = tf.decode_step(cfg, params, cache, step_toks, t)
            lg.argmax(-1).cpu()

    decode_steps()
    profile_window(f"lm decode (batch 4, {DECODE_PROFILE_STEPS} steps)",
                   decode_steps, "decode_profile.txt")
    del cache

    t0 = time.perf_counter()
    done = serve_lm(cfg, batch=4, prompt_len=16, gen=32, n_requests=8,
                    params=params, device="cuda")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    made = sum(len(r) - 16 for r in done)
    log(f"lm serve: {len(done)} requests, {made} generated tokens in "
        f"{serve_s:.3f} s")
    expect(len(done) > 0 and all(0 <= t < cfg.vocab_size
                                 for r in done for t in r),
           "lm serve: requests served with tokens in the vocabulary")

    # decode against prefill at full width
    toks = tokens[:, :DECODE_TOKENS]
    rel, same, clear, clear_same = decode_vs_prefill(cfg, params, toks)
    log(f"lm decode vs prefill, bf16, {cfg.n_layers} layers, "
        f"{DECODE_TOKENS} tokens (logged): rel err {rel:.3g}, argmax equal "
        f"at {same}/{DECODE_TOKENS}")
    del params
    for layers in (cfg.n_layers, 2, DECODE_LAYERS):
        cfg32 = dataclasses.replace(cfg, n_layers=layers,
                                    dtype=torch.float32)
        params32 = tf.init_params(cfg32, seed=LM_SEED, device="cuda")
        rel, same, clear, clear_same = decode_vs_prefill(cfg32, params32,
                                                         toks)
        del params32
        log(f"lm decode vs prefill, f32, {layers} layers, {DECODE_TOKENS} "
            f"tokens: rel err {rel:.3g}, argmax equal at {same}/"
            f"{DECODE_TOKENS} ({clear_same}/{clear} where the top-1 leads "
            f"by more than the tolerance)"
            + ("" if layers == DECODE_LAYERS else " (logged)"))
    expect(rel <= DECODE_REL_TOL,
           f"lm decode within {DECODE_REL_TOL} of prefill (f32, "
           f"{DECODE_LAYERS} layer)")
    expect(clear_same == clear, "lm decode: same argmax as prefill "
           "wherever the top-1 leads by more than the tolerance")
    err = rel
    return {"prefill_s": secs, "prefill_tokens_per_s": S / secs,
            "prefill_peak_gib": peak, "serve_s": serve_s,
            "serve_generated": made, "decode_rel_err": err}


# ---------------------------------------------------------------------------
# Phase 6: the distributed engines
# ---------------------------------------------------------------------------

#: Netflix Prize: 480,189 users, 17,770 movies, 100,480,507 ratings (the
#: paper's Table 2: 0.5 M vertices, 99 M edges); d = 20 lies in the paper's
#: d sweep (Sec. 5.1)
NETFLIX_USERS = 480_189
NETFLIX_MOVIES = 17_770
NETFLIX_RATINGS = 100_480_507
ALS_D = 20
DIST_TOLERANCE = 1e-3
DIST_MACHINES = 8
DIST_SWEEPS = 5
HOLD_SWEEPS = (1, 3)
#: NER CoEM, K = 204 types (the paper's 816-byte vertex data); depth cut
#: from the paper's 2 M vertices and 200 M edges (PERF.md, section 4)
COEM_NPS, COEM_CONTEXTS, COEM_COOCCURRENCES = 1_800_000, 200_000, 20_000_000
COEM_TYPES = 204
#: card-vs-CPU parity of the dist engines, S = 4
DIST_PARITY_MACHINES = 4
DIST_PARITY_PR = 20_000
DIST_PARITY_GRID = 16
#: the locking engine: PageRank at n ~ 200,000, S = 8, p = 1024, on a
#: 6-connected 3-D grid.  On the power-law graph of phase 3 the top
#: vertices of each queue crowd around the hubs and lock each other out
#: (21 winners a step on average, DynamicEngine 45), so neither converges
#: in 20,000 steps (PERF.md, section 4)
LOCK_GRID = (58, 58, 60)
LOCK_MACHINES = 8
LOCK_PIPELINE = 1024
LOCK_MAX_STEPS = 20_000
#: the plain K1 at D >= 2 materializes [E, D] messages (up to 320 GB at
#: D 400 on the Netflix set): it is timed edges-chunk by edges-chunk
PLAIN_CHUNK = 1 << 22
# K1's slice widths to time beside the chosen ones: the full width, then
# narrower (multiples of 4 columns)
SLICE_SWEEP_D400 = (400, 200, 96, 16)
SLICE_SWEEP_D204 = (204, 104, 52, 16)
#: K1 at D >= 2 is held to the bit, against its plain version run on the
#: host, on sampled rows: the longest rows, every machine's first and last
#: own rows, and random rows (a row's sum reads only its own edges)
HOLD_LONGEST, HOLD_RANDOM = 4, 256


def dist_parity_cases(device):
    """(name, engine, exact) of the dist engines' card-vs-CPU parity, at S
    = 4, built on ``device``.  ``exact``: values and priorities equal to
    the bit (K1 and K2 equal their plain versions bit for bit), else within
    1e-5; counters equal either way."""
    from repro_torch.apps.als import ALSProgram, make_als_graph
    from repro_torch.apps.coem import CoEMProgram, make_coem_graph
    from repro_torch.apps.lbp import LoopyBPProgram, make_mrf_graph
    from repro_torch.apps.pagerank import PageRankProgram, make_pagerank_graph
    from repro_torch.core.coloring import coloring_for
    from repro_torch.core.consistency import Consistency
    from repro_torch.dist import DistributedEngine, InProcessExchange
    from repro_torch.graphs.generators import grid3d_graph, power_law_graph

    ex = InProcessExchange(DIST_PARITY_MACHINES)
    n = DIST_PARITY_PR
    st = power_law_graph(n, avg_degree=LJ_AVG_DEGREE, seed=0, device=device)
    pr = DistributedEngine(
        PageRankProgram(alpha=ALPHA, n_vertices=n), make_pagerank_graph(st),
        ex, colors=coloring_for(st, Consistency.EDGE), tolerance=1e-4 / n,
        device=device)
    k = DIST_PARITY_GRID
    gst = grid3d_graph(k, k, k, 26, device=device)
    lbp = DistributedEngine(
        LoopyBPProgram(LBP_STATES, smoothing=LBP_F64[1]),
        make_mrf_graph(gst, LBP_STATES, seed=0, dtype=torch.float64), ex,
        colors=coloring_for(gst, Consistency.EDGE), method="bfs",
        tolerance=LBP_TOLERANCE, device=device)
    ag, _ = make_als_graph(3000, 600, 60_000, d=ALS_D, seed=1, device=device)
    als = DistributedEngine(
        ALSProgram(ALS_D), ag, ex, tolerance=DIST_TOLERANCE,
        colors=(np.arange(3600) >= 3000).astype(np.int32), device=device)
    cg, _ = make_coem_graph(6000, 1500, 60_000, n_types=COEM_TYPES, seed=1,
                            device=device)
    coem = DistributedEngine(
        CoEMProgram(COEM_TYPES), cg, ex, tolerance=DIST_TOLERANCE,
        colors=(np.arange(7500) >= 6000).astype(np.int32), device=device)
    return [(f"dist pagerank n={n} S={DIST_PARITY_MACHINES} (fused)", pr,
             "rank", MAIN_MAX_STEPS, True),
            (f"dist lbp f64 {k}^3 smoothing {LBP_F64[1]} bfs placement "
             f"(dense)", lbp, "belief", MAIN_MAX_STEPS, False),
            (f"dist als 3000x600 d={ALS_D} ({DIST_SWEEPS} sweeps)", als,
             "factor", DIST_SWEEPS, False),
            (f"dist coem 6000x1500 K={COEM_TYPES} ({DIST_SWEEPS} sweeps)",
             coem, "p", DIST_SWEEPS, False)]


def run_dist_case(eng, leaf, max_steps):
    """(values [N, ...], prio by row, counters, seconds) of one dist case;
    counters: steps, updates, rows and bytes shipped (v, e, r)."""
    t0 = time.perf_counter()
    state, _ = eng.run(eng.init(), max_steps=max_steps)
    vals = eng.vertex_data(state)[leaf].cpu().numpy()
    meta = np.array([int(state.step_index), int(state.update_count.sum()),
                     eng.ghost_rows_sent(state), eng.ghost_bytes_sent(state),
                     eng.ghost_edge_rows_sent(state),
                     eng.ghost_edge_bytes_sent(state),
                     eng.rank_rows_sent(state)], np.int64)
    return vals, state.prio.cpu().numpy(), meta, time.perf_counter() - t0


DIST_META = ("steps", "updates", "rows_v", "bytes_v", "rows_e", "bytes_e",
             "rows_r")


def dist_parity_card():
    """The card's half of the dist parity: each case's results; K3's
    launches on the dense (LBP) case, counted from 0."""
    from repro_torch.kernels.segsum.segsum import segment_sum_sorted_cuda
    out = []
    for name, eng, leaf, steps, _ in dist_parity_cases("cuda"):
        segment_sum_sorted_cuda.launches = 0
        out.append(run_dist_case(eng, leaf, steps))
        if "dense" in name:
            log(f"{name}: K3 launches {segment_sum_sorted_cuda.launches}")
            expect(segment_sum_sorted_cuda.launches > 0,
                   f"{name}: K3 launched on the dist dense path")
    return out


def dist_parity_check(results, cpu):
    names = [(c[0], c[4]) for c in dist_parity_cases("cpu")]
    for i, (name, exact) in enumerate(names):
        vc, pc, mc, tc = results[i]
        vh, ph, mh = cpu[f"dvals{i}"], cpu[f"dprio{i}"], cpu[f"dmeta{i}"]
        diff = float(np.abs(vc.astype(np.float64) - vh).max())
        log(f"parity {name}: " + " ".join(
            f"{k} {a}/{b}" for k, a, b in zip(DIST_META, mc, mh))
            + f" time {tc:.2f}/{float(cpu[f'dsecs{i}']):.2f} s (cuda/cpu) "
            f"max|diff| {diff:.3e}")
        expect(np.array_equal(mc, mh),
               f"parity {name}: equal steps, updates and traffic counters")
        if exact:
            same = vc.dtype == vh.dtype and np.array_equal(
                vc.view(np.int32), vh.view(np.int32)) and np.array_equal(
                pc.view(np.int32), ph.view(np.int32))
            expect(same, f"parity {name}: values and priorities equal to "
                   f"the bit")
        else:
            expect(diff <= FIXED_POINT_TOL, f"parity {name}: within 1e-5")


def sampled_rows(es, rng, machines, n_loc, active_rows):
    """Rows of ``es`` to hold a kernel on: the longest, each machine's
    first and last own row, and random rows, all active."""
    lengths = np.diff(es.row_ptr)
    rows = np.concatenate([
        np.argsort(-lengths, kind="stable")[:HOLD_LONGEST],
        np.arange(machines) * n_loc, np.arange(1, machines + 1) * n_loc - 1,
        rng.integers(0, es.n_vertices, HOLD_RANDOM)])
    rows = np.unique(rows)
    return rows[active_rows[rows] & (lengths[rows] > 0)]


def k1_rows_on_host(feat, w, es, rows):
    """K1's plain version on the host over ``rows`` only (whole rows, so
    the same segments as the full set): [len(rows), D]."""
    from repro_torch.kernels.gas.ops import EdgeSet
    from repro_torch.kernels.gas.ref import gather_combine_ref
    rp = es.row_ptr
    lens = rp[rows + 1] - rp[rows]
    idx = np.repeat(rp[rows] - np.cumsum(np.append(0, lens[:-1])), lens) \
        + np.arange(lens.sum())
    snd = es.senders[:es.n_edges].cpu().numpy()[idx]
    uniq, local = np.unique(snd, return_inverse=True)
    sub = EdgeSet.build(local.astype(np.int32),
                        np.repeat(np.arange(rows.size), lens).astype(np.int32),
                        rows.size, device="cpu")
    f = feat[torch.from_numpy(uniq).cuda()].cpu()
    wi = w[torch.from_numpy(idx).cuda()].cpu()
    w_pad = torch.nn.functional.pad(wi, (0, sub.senders.shape[0] - idx.size))
    return gather_combine_ref(f, w_pad, sub.senders, sub.receivers,
                              rows.size)


def k1_plain_chunked(feat, w, es, blk):
    """The plain K1's arithmetic (``index_add_`` of ``w·feat[snd]``, then
    inactive row blocks zeroed) over ``PLAIN_CHUNK`` edges at a time: its
    [E, D] messages do not fit the card at D 400."""
    from repro_torch.kernels.gas.gas import ROW_BLOCK
    e, n = es.n_edges, es.n_vertices
    snd = es.senders[:e].long()
    rcv = es.receivers[:e].long()
    acc = torch.zeros((n, feat.shape[1]), dtype=torch.float32, device="cuda")
    for lo in range(0, e, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, e)
        acc.index_add_(0, rcv[lo:hi], w[lo:hi, None] * feat[snd[lo:hi]])
    act = torch.repeat_interleave(blk.bool(), ROW_BLOCK)[:n]
    return torch.where(act[:, None], acc, torch.zeros_like(acc))


def active_csr(es, w, blk, n_src):
    """The CSR matrix ``[n_rows, n_src]`` of the edges whose receiver's row
    block is active (what K1 sums), for the library call."""
    from repro_torch.kernels.gas.gas import ROW_BLOCK
    e, n = es.n_edges, es.n_vertices
    rcv = es.receivers[:e].long()
    keep = blk.bool()[rcv // ROW_BLOCK]
    counts = torch.bincount(rcv[keep], minlength=n)
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                      torch.cumsum(counts, 0)])
    return torch.sparse_csr_tensor(crow, es.senders[:e][keep].long(),
                                   w[keep], (n, n_src),
                                   check_invariants=False), int(keep.sum())


def time_k1_stacked(rec, label, eng, state, leaf, active, rng, sweep=()):
    """K1 at a dist path's shape: the stacked set of every machine, one
    leaf's features of the [own; ghost] table and its weights, the blocks
    of ``active`` (one phase of a first sweep) active.  Held to the bit
    against its plain version on the host on sampled rows; timed beside the
    plain arithmetic (chunked) and ``torch.sparse.mm``; its effective
    gather bandwidth logged (per-edge gather bytes over its time).
    ``sweep``: slice widths to time it at as well (``slice_sweep``)."""
    from repro_torch.core.update import fused_edge_weight
    from repro_torch.kernels.gas.gas import gas_gather_combine_cuda
    from repro_torch.kernels.gas.ops import active_row_blocks
    es, lay = eng._edges, eng.layout
    feat = leaf.feature(eng._v_all(state.vown, state.vghost))
    feat = feat.reshape(feat.shape[0], -1).float().contiguous()
    d = feat.shape[1]
    w = fused_edge_weight(leaf, state.edata, eng._t["edge_mask"].shape[0],
                          eng._t["src_deg_e"])[es.perm].float().contiguous()
    blk = active_row_blocks(active).to(torch.int32)
    run_k = lambda: gas_gather_combine_cuda(feat, w, es.senders,
                                            es.segments, blk)
    out = run_k()
    act_rows = torch.repeat_interleave(blk.bool(), 128)[:es.n_vertices]
    rows = sampled_rows(es, rng, lay.n_machines, lay.n_loc,
                        act_rows.cpu().numpy())
    rec.compare(f"{label} (D {d}, {rows.size} sampled rows, "
                f"{int(np.diff(es.row_ptr)[rows].sum())} edges)",
                out[torch.from_numpy(rows).cuda()].cpu(),
                k1_rows_on_host(feat, w, es, rows), bitwise=True)
    a, e_act = active_csr(es, w, blk, feat.shape[0])
    run_l = lambda: torch.sparse.mm(a, feat)
    rec.against_library(out, run_l())
    run_p = lambda: k1_plain_chunked(feat, w, es, blk)
    rcv = es.receivers[:es.n_edges].long()
    on = blk.bool()[rcv // 128]
    n_snd = int(torch.unique(es.senders[:es.n_edges][on]).numel())
    n = es.n_vertices
    gather_bytes = 4 * d * e_act
    rec.time(run_k, run_p, run_l,
             8 * e_act + 4 * d * (n_snd + n) + 4 * es.n_row_blocks
             + row_ptr_bytes(n), 2 * e_act * d,
             f"{label}: N={n} D={d} E={es.n_edges} (stacked, "
             f"{lay.n_machines} machines) active edges={e_act} distinct "
             f"senders={n_snd} segments={es.segments.n_segments}; per-edge "
             f"gather {gather_bytes / 1e9:.2f} GB; slice width "
             f"{es.segments.column_items(d).width}",
             plain_reps=1, main=False)
    row = rec.other[-1]
    row["gather_tb_per_s"] = gather_bytes / row["ms"] / 1e9
    row["library_gather_tb_per_s"] = gather_bytes / row["library_ms"] / 1e9
    log(f"{label}: effective gather {row['gather_tb_per_s']:.3f} TB/s "
        f"(torch.sparse.mm {row['library_gather_tb_per_s']:.3f}; the per-edge "
        f"gather, {gather_bytes} bytes, at HBM's 3.35 TB/s alone takes "
        f"{gather_bytes / HBM_BYTES_PER_S * 1e3:.4g} ms)")
    if sweep:
        row["slice_sweep"] = slice_sweep(label, feat, w, es, blk, out, sweep)
    return row


def slice_sweep(label, feat, w, es, blk, want, widths):
    """K1 at one forced slice width after another (narrower slices keep a
    smaller part of the table in play, for the L2 cache) and, at rows of at
    most 128 bytes, at the chosen width with cp.async.bulk forced in place
    of 16-byte cp.async pieces, each equal to the bit to the chosen output
    ``want`` and timed: what narrower slices and the copy mode buy.  The
    tables are built here and dropped."""
    from repro_torch.kernels.csr import ColumnItems
    from repro_torch.kernels.gas.gas import launch_cols
    seg, d = es.segments, feat.shape[1]
    log(f"{label}: the chosen slice width is {seg.column_items(d).width}")
    out = {}
    runs = [(f"width {width}", ColumnItems.build(seg, d, width), -1)
            for width in widths]
    if 4 * d <= 128:
        runs.append(("copy bulk", seg.column_items(d), 0))
    for name, items, mode in runs:
        run = lambda: launch_cols(feat, w, es.senders, seg, blk, items, mode)
        same = torch.equal(run().view(torch.int32), want.view(torch.int32))
        expect(same, f"{label}: K1 at {name} equals the chosen output to "
               f"the bit")
        out[name] = ms = cuda_ms(run, queued=True)
        log(f"{label}: K1 at {name} ({items.n_items} items): {ms:.4g} ms")
    return out


def time_k2_stacked(rec, label, eng, active, rng):
    """K2 at the dist path's shape: the stacked set, weights = edge_mask,
    contributions on the first phase's rows; equal to the bit to its plain
    version on the host (the whole set), timed beside ``torch.addmm``."""
    from repro_torch.kernels.gas.scatter import gas_scatter_reschedule_cuda
    from repro_torch.kernels.gas.ref import scatter_reschedule_ref
    es, lay = eng._edges, eng.layout
    n, n_all = es.n_vertices, lay.n_machines * (lay.n_loc + lay.n_machines
                                                * lay.budget)
    w = eng._scatter_w
    prio = torch.from_numpy((rng.random(n) * 1e-3).astype(np.float32)).cuda()
    cons = active.contiguous()
    contrib = torch.from_numpy((rng.random(n_all) * 1e-2).astype(
        np.float32)).cuda()
    run_k = lambda: gas_scatter_reschedule_cuda(contrib, prio, cons,
                                                es.senders, es.segments, w)
    w_pad = torch.nn.functional.pad(w, (0, es.senders.shape[0] - es.n_edges))
    run_p = lambda: scatter_reschedule_ref(contrib, prio, cons, w_pad,
                                           es.senders, es.receivers, n,
                                           segments=es.segments)
    host = scatter_reschedule_ref(
        contrib.cpu(), prio.cpu(), cons.cpu(), w_pad.cpu(), es.senders.cpu(),
        es.receivers.cpu(), n, segments=on_host(es.segments))
    rec.compare(f"{label} (stacked set, weights = edge_mask)",
                run_k().cpu(), host, bitwise=True)
    del host
    crow = torch.from_numpy(es.row_ptr.astype(np.int64)).cuda()
    a = torch.sparse_csr_tensor(crow, es.senders[:es.n_edges].long(), w,
                                (n, n_all), check_invariants=False)
    keep = torch.where(cons, torch.zeros_like(prio), prio)[:, None]
    run_l = lambda: torch.addmm(keep, a, contrib[:, None])
    rec.against_library(run_k(), run_l()[:, 0])
    n_snd = int(torch.unique(es.senders[:es.n_edges]).numel())
    rec.time(run_k, run_p, run_l,
             8 * es.n_edges + 4 * n_snd + 9 * n + row_ptr_bytes(n),
             2 * es.n_edges,
             f"{label}: N={n} E={es.n_edges} (stacked, {lay.n_machines} "
             f"machines) senders={n_snd} segments={es.segments.n_segments}",
             plain_reps=1, main=False)
    return rec.other[-1]


def layout_line(label, eng):
    lay = eng.layout
    rows = lay.n_machines * (lay.n_loc + lay.n_machines * lay.budget)
    log(f"{label}: layout S={lay.n_machines} n_loc={lay.n_loc} "
        f"e_loc={lay.e_loc} B={lay.budget} stacked feature rows={rows} "
        f"ghost slots={eng.total_ghost_slots()} stacked edges="
        f"{eng._edges.n_edges} segments={eng._edges.segments.n_segments}")
    return {"n_loc": lay.n_loc, "e_loc": lay.e_loc, "B": lay.budget,
            "stacked_rows": rows, "ghost_slots": eng.total_ghost_slots()}


def dist_sweeps(label, eng, state, sweeps, keep=(), leaf=None):
    """``sweeps`` steps of ``eng``, each timed on the host clock ending in
    ``torch.cuda.synchronize()``; logs ms, updates and ghost rows and bytes
    a sweep.  Returns (state, per-sweep rows, {sweep: (vertex leaf,
    update counts)} for the sweeps in ``keep``)."""
    rows, kept = [], {}
    upd0 = int(state.update_count.sum())
    rv0, bv0 = eng.ghost_rows_sent(state), eng.ghost_bytes_sent(state)
    for i in range(1, sweeps + 1):
        state, secs = sync_time(lambda: eng.step(state))
        upd = int(state.update_count.sum())
        rv, bv = eng.ghost_rows_sent(state), eng.ghost_bytes_sent(state)
        row = {"sweep": i, "ms": 1e3 * secs, "updates": upd - upd0,
               "ghost_rows": rv - rv0, "ghost_bytes": bv - bv0}
        log(f"{label} sweep {i}: {row['ms']:.2f} ms, updates "
            f"{row['updates']}, ghost rows {row['ghost_rows']}, ghost bytes "
            f"{row['ghost_bytes']}")
        rows.append(row)
        upd0, rv0, bv0 = upd, rv, bv
        if i in keep:
            kept[i] = (eng.vertex_data(state)[leaf], eng.update_counts(state))
    return state, rows, kept


def netflix_als(recs, rng, n_ratings):
    """Netflix ALS through ``DistributedEngine`` at S = 8 on the card: the
    slice's full-width path; held against ``ChromaticEngine``."""
    from repro_torch.apps.als import ALSProgram, als_rmse, make_als_graph
    from repro_torch.core.chromatic import ChromaticEngine
    from repro_torch.core.coloring import verify_coloring
    from repro_torch.core.scheduler import sweep_mask
    from repro_torch.dist import DistributedEngine, InProcessExchange
    from repro_torch.kernels.gas.gas import gas_gather_combine_cuda as k1c
    from repro_torch.kernels.gas.scatter import \
        gas_scatter_reschedule_cuda as k2c

    n_u, n_m = NETFLIX_USERS, NETFLIX_MOVIES
    (g, _), secs = sync_time(lambda: make_als_graph(
        n_u, n_m, n_ratings, d=ALS_D, seed=0, device="cuda"))
    st = g.structure
    out = {"ratings_drawn": n_ratings, "E": st.n_edges,
           "generation_s": secs}
    log(f"als: generation {secs:.1f} s  users={n_u} movies={n_m} ratings "
        f"drawn={n_ratings}, {st.n_edges // 2} after dedup, E={st.n_edges} "
        f"directed edges, max in-degree={int(st.in_degree.max())}")
    colors = (np.arange(st.n_vertices) >= n_u).astype(np.int32)
    expect(verify_coloring(st, colors, 1),
           "als: users 0 / movies 1 is a proper coloring")
    prog = ALSProgram(ALS_D)
    eng, secs = sync_time(lambda: DistributedEngine(
        prog, g, InProcessExchange(DIST_MACHINES), colors=colors,
        tolerance=DIST_TOLERANCE, method="hash", device="cuda"))
    out["setup_s"] = secs
    log(f"als: engine set-up {secs:.1f} s (placement, layout, the stacked "
        f"edge set)  fused={eng.use_fused}")
    expect(eng.use_fused, "als: the dist engine takes the fused path")
    out["layout"] = layout_line("als", eng)
    out["rmse_before"] = (als_rmse(g, True), als_rmse(g, False))
    state = eng.init()
    phases = [torch.logical_and(eng._t["own_mask"], sweep_mask(
        eng._t["colors_own"], state.prio, DIST_TOLERANCE, color))
        for color in (0, 1)]
    leaves = dict(zip(("xxt", "rx"), eng._gas_leaves))
    # a sweep launches K1 once a leaf a phase: users (phase 1) gather movie
    # rows, movies (phase 2) user rows
    k1_rows = [time_k1_stacked(
        recs[0], f"als {name} phase {i + 1}", eng, state, leaf, active, rng,
        sweep=SLICE_SWEEP_D400 if name == "xxt" else (ALS_D,))
        for i, active in enumerate(phases) for name, leaf in leaves.items()]
    k2_row = time_k2_stacked(recs[1], "als", eng, phases[0], rng)
    del state
    torch.cuda.empty_cache()

    log_clocks("before the dist ALS sweeps")
    torch.cuda.reset_peak_memory_stats()
    k1c.launches = k2c.launches = 0
    state, sweeps, kept = dist_sweeps("als", eng, eng.init(), DIST_SWEEPS,
                                      keep=HOLD_SWEEPS, leaf="factor")
    l1, l2 = k1c.launches, k2c.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"als: launches K1={l1} K2={l2} over {DIST_SWEEPS} sweeps; peak "
        f"device memory {peak:.2f} GiB")
    expect(l1 > 0 and l2 > 0, "als: K1 and K2 launched on the dist path")
    for row in k1_rows:
        row["launches"] = l1 // len(k1_rows)
    k2_row["launches"] = l2
    factors = eng.vertex_data(state)["factor"]
    expect(bool(torch.isfinite(factors).all())
           and factors.shape == (st.n_vertices, ALS_D),
           "als: factors finite, shape [N, d]")
    out["rmse_after"] = (als_rmse(g.replace(vertex_data={"factor": factors}),
                                  True),
                         als_rmse(g.replace(vertex_data={"factor": factors}),
                                  False))
    log(f"als: RMSE train/test before {out['rmse_before'][0]:.4f}/"
        f"{out['rmse_before'][1]:.4f}, after {DIST_SWEEPS} sweeps "
        f"{out['rmse_after'][0]:.4f}/{out['rmse_after'][1]:.4f}")
    expect(out["rmse_after"][0] < out["rmse_before"][0],
           "als: train RMSE fell")
    before = k1c.launches
    out["profile"] = profile_window("als: one sweep", lambda: eng.step(state),
                                    "als_profile.txt")
    log(f"als: one sweep: K1 launched {k1c.launches - before} times in the "
        f"profiled window (compare the profiler's rows)")
    out.update(sweeps=sweeps, peak_gib=peak, launches_k1=l1,
               launches_k2=l2)
    del eng, state, factors
    torch.cuda.empty_cache()

    # the hold: ChromaticEngine on the same graph and colors
    ce, secs = sync_time(lambda: ChromaticEngine(
        prog, g, colors=colors, tolerance=DIST_TOLERANCE, device="cuda"))
    log(f"als: ChromaticEngine set-up {secs:.1f} s")
    cs = ce.init(g)
    for i in range(1, max(HOLD_SWEEPS) + 1):
        cs = ce.step(cs)
        if i in HOLD_SWEEPS:
            f_d, c_d = kept[i]
            diff = float((f_d - cs.graph.vertex_data["factor"]).abs().max())
            same = torch.equal(c_d, cs.update_count)
            log(f"als hold, sweep {i}: max|factor diff| {diff:.3e}, "
                f"updates {int(c_d.sum())}/{int(cs.total_updates)} "
                f"(dist/chromatic)")
            expect(diff <= FIXED_POINT_TOL,
                   f"als: dist within 1e-5 of ChromaticEngine after sweep {i}")
            expect(same, f"als: equal update counts after sweep {i}")
    del ce, cs, kept, g
    torch.cuda.empty_cache()
    return out


def ner_coem(recs, rng):
    """NER CoEM through ``DistributedEngine`` at S = 8, K = 204."""
    from repro_torch.apps.coem import (CoEMProgram, coem_accuracy,
                                       make_coem_graph)
    from repro_torch.core.coloring import verify_coloring
    from repro_torch.core.scheduler import sweep_mask
    from repro_torch.dist import DistributedEngine, InProcessExchange
    from repro_torch.kernels.gas.gas import gas_gather_combine_cuda as k1c
    from repro_torch.kernels.gas.scatter import \
        gas_scatter_reschedule_cuda as k2c

    (g, info), secs = sync_time(lambda: make_coem_graph(
        COEM_NPS, COEM_CONTEXTS, COEM_COOCCURRENCES, n_types=COEM_TYPES,
        seed=0, device="cuda"))
    st = g.structure
    out = {"E": st.n_edges, "generation_s": secs}
    log(f"coem: generation {secs:.1f} s  noun-phrases={COEM_NPS} contexts="
        f"{COEM_CONTEXTS} co-occurrences={COEM_COOCCURRENCES}, E="
        f"{st.n_edges} directed edges, K={COEM_TYPES}")
    colors = (np.arange(st.n_vertices) >= COEM_NPS).astype(np.int32)
    expect(verify_coloring(st, colors, 1),
           "coem: noun-phrases 0 / contexts 1 is a proper coloring")
    eng, secs = sync_time(lambda: DistributedEngine(
        CoEMProgram(COEM_TYPES), g, InProcessExchange(DIST_MACHINES),
        colors=colors, tolerance=DIST_TOLERANCE, method="hash",
        device="cuda"))
    out["setup_s"] = secs
    log(f"coem: engine set-up {secs:.1f} s  fused={eng.use_fused}")
    expect(eng.use_fused, "coem: the dist engine takes the fused path")
    out["layout"] = layout_line("coem", eng)
    out["accuracy_before"] = coem_accuracy(g, info)
    state = eng.init()
    active = torch.logical_and(eng._t["own_mask"], sweep_mask(
        eng._t["colors_own"], state.prio, DIST_TOLERANCE, 0))
    k1_row = time_k1_stacked(recs[0], "coem p", eng, state,
                             eng._gas_leaves[0], active, rng,
                             sweep=SLICE_SWEEP_D204)
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1c.launches = k2c.launches = 0
    state, sweeps, _ = dist_sweeps("coem", eng, eng.init(), DIST_SWEEPS)
    l1, l2 = k1c.launches, k2c.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1_row["launches"] = l1
    expect(l1 > 0 and l2 > 0, "coem: K1 and K2 launched on the dist path")
    p = eng.vertex_data(state)["p"]
    expect(bool(torch.isfinite(p).all())
           and p.shape == (st.n_vertices, COEM_TYPES),
           "coem: distributions finite, shape [N, K]")
    total = p.sum(dim=1)
    isolated = torch.from_numpy(st.in_degree == 0).cuda()
    expect(bool(torch.where(isolated, total.abs() == 0,
                            (total - 1).abs() < 1e-3).all()),
           f"coem: every distribution sums to 1 (0 on the "
           f"{int(isolated.sum())} isolated vertices, which gather nothing)")
    acc = coem_accuracy(g.replace(vertex_data={"p": p,
                                               "seed": g.vertex_data["seed"]}),
                        info)
    log(f"coem: launches K1={l1} K2={l2}; accuracy {out['accuracy_before']:.4f}"
        f" -> {acc:.4f} after {DIST_SWEEPS} sweeps; peak device memory "
        f"{peak:.2f} GiB")
    out.update(sweeps=sweeps, peak_gib=peak, accuracy_after=acc,
               launches_k1=l1, launches_k2=l2)
    del eng, state, p, g
    torch.cuda.empty_cache()
    return out


def locking_card():
    """``DistributedLockingEngine`` (S = 8, p = 1024) on PageRank over
    LOCK_GRID on the card: within 1e-5 of ``DynamicEngine``'s fixed point
    (and within 1e-3 of it in L1 over its L1), and no two winners adjacent
    in any step (edge consistency)."""
    from repro_torch.apps.pagerank import PageRankProgram, make_pagerank_graph
    from repro_torch.core import DynamicEngine
    from repro_torch.dist import DistributedLockingEngine, InProcessExchange
    from repro_torch.graphs.generators import grid3d_graph

    st = grid3d_graph(*LOCK_GRID, 6, device="cuda")
    n = st.n_vertices
    g = make_pagerank_graph(st)
    prog = PageRankProgram(alpha=ALPHA, n_vertices=n)
    tol = 1e-4 / n
    dyn = DynamicEngine(prog, g, pipeline_length=LOCK_PIPELINE,
                        tolerance=tol, device="cuda")
    ds, dsecs = sync_time(lambda: dyn.run_while(dyn.init(g),
                                                max_steps=LOCK_MAX_STEPS))
    le = DistributedLockingEngine(prog, g, InProcessExchange(LOCK_MACHINES),
                                  pipeline_length=LOCK_PIPELINE,
                                  tolerance=tol, device="cuda")
    t = st.device_arrays()
    snd, rcv = t["senders"], t["receivers"]
    s = le.init()
    prev = le.update_counts(s)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    steps = 0
    while steps < LOCK_MAX_STEPS and not le.converged(s):
        s = le.step(s)
        cnt = le.update_counts(s)
        win = cnt > prev
        bad += torch.sum(torch.logical_and(win[snd], win[rcv]))
        prev = cnt
        steps += 1
    torch.cuda.synchronize()
    lsecs = time.perf_counter() - t0
    ref = ds.graph.vertex_data["rank"]
    out = le.vertex_data(s)["rank"]
    diff = float((out - ref).abs().max())
    rel = float((out - ref).abs().sum() / ref.abs().sum())
    log(f"locking: PageRank on a {LOCK_GRID} 6-connected grid, n={n}, "
        f"E={st.n_edges}, tolerance {tol:.3g}")
    log(f"locking: DynamicEngine p={LOCK_PIPELINE} {int(ds.step_index)} steps"
        f" {dsecs:.2f} s, {int(ds.total_updates)} updates; locking S="
        f"{LOCK_MACHINES} p={LOCK_PIPELINE} {steps} steps {lsecs:.2f} s, "
        f"{int(s.update_count.sum())} updates, rank rows "
        f"{le.rank_rows_sent(s)}, ghost rows {le.ghost_rows_sent(s)}; "
        f"max|diff| {diff:.3e}, L1 diff / L1 {rel:.3e}")
    expect(bool(dyn.scheduler.done(ds.sched, ds.prio)) and le.converged(s),
           "locking: both engines converged")
    expect(diff <= FIXED_POINT_TOL and rel <= ORACLE_L1_TOL,
           "locking: within 1e-5 of DynamicEngine's fixed point (L1 "
           "difference within 1e-3 of its L1)")
    expect(int(bad) == 0, f"locking: no two adjacent winners in any of "
           f"{steps} steps ({int(bad)} adjacent pairs)")
    return {"steps": steps, "seconds": lsecs, "max_diff": diff,
            "l1_rel": rel, "dynamic_steps": int(ds.step_index)}


def dist_phase(recs, rng, n_ratings):
    """Phase 6: Netflix ALS and NER CoEM through DistributedEngine at S = 8,
    the locking engine, and the card's half of the dist parity."""
    out = {"als": netflix_als(recs, rng, n_ratings)}
    torch.cuda.empty_cache()
    out["coem"] = ner_coem(recs, rng)
    torch.cuda.empty_cache()
    out["locking"] = locking_card()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--only", choices=("models", "dist"),
                    help="models: run only phase 1's K4/K5 cases and phases "
                    "4-5; dist: run only phase 6 (a partial run prints no "
                    "result line)")
    ap.add_argument("--netflix-ratings", type=int, default=NETFLIX_RATINGS,
                    help="ratings drawn for phase 6's ALS (a partial run's "
                    "depth; the full run keeps the default)")
    args = ap.parse_args()
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

    partial = args.only is not None or args.netflix_ratings != NETFLIX_RATINGS
    local = args.only is None      # phases 1-3 (the local engines)
    models = args.only in (None, "models")
    dist = args.only in (None, "dist")
    t_all = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    cpu_path = str(WORK_DIR / "cpu_parity.npz")
    child = multiprocessing.get_context("spawn").Process(
        target=cpu_side, args=(cpu_path, local))
    if dist:
        child.start()
    summary = {}
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
        log_ptxas(build.build_log)
        warm_profiler()

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
            KernelRecord("embedding_bag",
                         "src/repro_torch/csrc/embedding_bag.cu",
                         "src/repro/kernels/embedding_bag/"
                         "embedding_bag.py:73"),
            KernelRecord("flash_attention",
                         "src/repro_torch/csrc/flash_attention_sm90.cu",
                         "src/repro/kernels/flash_attention/"
                         "flash_attention.py:85", row_scale=True),
        ]
        if local:
            kernel_parity_cases(recs, rng)
            k1_many_items_cases(recs[0], rng)
        if models:
            model_kernel_cases(recs[3], recs[4], rng)
        log(f"elapsed {time.perf_counter() - t_all:.1f} s")
        if local:
            summary = main_path(recs, rng)
            log(f"elapsed {time.perf_counter() - t_all:.1f} s")
            cases, results = engine_parity_card(recs)
            torch.cuda.empty_cache()
            log(f"elapsed {time.perf_counter() - t_all:.1f} s")
        if models:
            summary["dlrm"] = dlrm_phase(recs[3])
            torch.cuda.empty_cache()
            log(f"elapsed {time.perf_counter() - t_all:.1f} s")
            summary["lm"] = lm_phase(recs[4])
            torch.cuda.empty_cache()
            log(f"elapsed {time.perf_counter() - t_all:.1f} s")
        if dist:
            summary["dist"] = dist_phase(recs, rng, args.netflix_ratings)
            log(f"elapsed {time.perf_counter() - t_all:.1f} s")
            dist_results = dist_parity_card()
            log(f"elapsed {time.perf_counter() - t_all:.1f} s")
            cpu = cpu_results(child, cpu_path)
            if cpu is not None:
                if local:
                    engine_parity_check(cases, results, cpu)
                dist_parity_check(dist_results, cpu)
    finally:
        if child.is_alive():
            child.terminate()
        if child.pid is not None:
            child.join()

    log("main summary: " + json.dumps(summary))
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    if failures:
        log(f"{len(failures)} check(s) failed: {failures}")
        return 1
    if partial:
        log("kernels: " + json.dumps([r.json() for r in recs
                                      if r.times or r.other]))
        log(f"partial run (--only {args.only}, {args.netflix_ratings} "
            f"ratings): no result line")
        return 0
    print(smi)
    print(json.dumps({"kernels": [r.json() for r in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
