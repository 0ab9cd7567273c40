"""The port's placement, layout and distributed engines against the JAX
package's, on identical seeded inputs: S = 4 machines in-process for the
port, the 4 forced CPU devices (``cpu_mesh``) for the JAX package.

Exact equality: ``overpartition`` (hash and BFS), ``place_atoms``,
``AtomIndex``, ``rebalance_placement``, the ``.atom.npz`` journals loaded
across packages, and every layout table at S = 4 (a power-law graph, an LBP
grid with reverse edges, an ALS bipartite graph, a tiny graph that leaves
machines empty).

Engines: fixed points within 1e-5 of the JAX ``DistributedEngine`` /
``DistributedLockingEngine`` and of the port's ``ChromaticEngine`` /
``DynamicEngine``.  Counters: the port's dist engine takes exactly the
port's chromatic schedule at any tolerance (both add each row's in-edges in
the same order); against the JAX package, update counts and traffic rows
and bytes are equal where the schedule does not hinge on float rounding at
the tolerance (PageRank at 1e-5: ranks ~5e-3 carry f32 round-off ~3e-10,
so at 1e-7 a rounding can move a vertex across the threshold, in either
package's local engines alike).  The locking engine is compared with the
JAX one step by step over its first steps (winners, ``traffic_r``) before
top-k ties start to hinge on rounding.  Mirrors tests/test_dist_engine.py,
test_dist_sync.py, test_partition.py and test_locking_engine.py (except its
snapshot case, which is ROADMAP A7's).
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import als as jals
from repro.apps import lbp as jlbp
from repro.apps import pagerank as jpr
from repro.core import ChromaticEngine as JChromatic
from repro.core import FnSyncOp as JFnSyncOp
from repro.core import partition as jpart
from repro.core.consistency import Consistency as JConsistency
from repro.dist import wire as jwire
from repro.dist.engine import DistributedEngine as JDist
from repro.dist.locking import DistributedLockingEngine as JLock
from repro.graphs import generators as jgen
from repro_torch.apps import als as tals
from repro_torch.apps import lbp as tlbp
from repro_torch.apps import pagerank as tpr
from repro_torch.core import ChromaticEngine, DynamicEngine, FnSyncOp
from repro_torch.core import partition as tpart
from repro_torch.core.consistency import Consistency
from repro_torch.core.convert import dist_state_from_numpy, layout_from_numpy
from repro_torch.core.graph import GraphStructure
from repro_torch.dist import (DistributedEngine, DistributedLockingEngine,
                              InProcessExchange, WireConfig)
from repro_torch.dist import engine as tdist
from repro_torch.dist import wire as twire
from repro_torch.dist.engine import DIST_STATE_FIELDS
from repro_torch.graphs import generators as tgen

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4, reason="needs 4 forced host devices "
    "(XLA_FLAGS=--xla_force_host_platform_device_count=4)")

TOL = 1e-5
S = 4
EX = InProcessExchange(S)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _pr(n, deg, seed):
    js = jgen.power_law_graph(n, avg_degree=deg, seed=seed)
    ts = tgen.power_law_graph(n, avg_degree=deg, seed=seed, device="cpu")
    return (jpr.make_pagerank_graph(js), tpr.make_pagerank_graph(ts),
            jpr.PageRankProgram(0.15, n), tpr.PageRankProgram(0.15, n))


@pytest.fixture(scope="module")
def pr200():
    return _pr(200, 5, 7)


@pytest.fixture(scope="module")
def lbp120():
    js = jgen.power_law_graph(120, avg_degree=4, seed=3)
    ts = tgen.power_law_graph(120, avg_degree=4, seed=3, device="cpu")
    return (jlbp.make_mrf_graph(js, 3, seed=1), tlbp.make_mrf_graph(ts, 3,
                                                                    seed=1),
            jlbp.LoopyBPProgram(3), tlbp.LoopyBPProgram(3))


def _dist_pair(cpu_mesh, jg, tg, jp, tp, tol, **kw):
    """The JAX and the port's DistributedEngine on one coloring (the JAX
    ChromaticEngine's)."""
    colors = np.asarray(JChromatic(jp, jg, tolerance=tol).colors)
    je = JDist(jp, jg, cpu_mesh, tolerance=tol, colors=colors, **kw)
    te = DistributedEngine(tp, tg, EX, tolerance=tol, colors=colors,
                           device="cpu", **kw)
    return je, te, colors


def _counters(eng, state):
    return (int(_np(state.update_count).sum()), eng.ghost_rows_sent(state),
            eng.ghost_bytes_sent(state), eng.ghost_edge_rows_sent(state),
            eng.ghost_edge_bytes_sent(state), eng.rank_rows_sent(state),
            eng.rank_bytes_sent(state))


# ---------------------------------------------------------------------------
# placement (core/partition.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def part_graphs():
    return _pr(200, 8, 7)[:2]


class TestPlacement:
    @pytest.mark.parametrize("method", ["hash", "bfs"])
    @pytest.mark.parametrize("k", [5, 16, 32])
    def test_overpartition_equal(self, part_graphs, method, k):
        jg, tg = part_graphs
        for seed in (0, 3):
            np.testing.assert_array_equal(
                jpart.overpartition(jg.structure, k, method, seed),
                tpart.overpartition(tg.structure, k, method, seed))

    @pytest.mark.parametrize("n_machines", [2, 3, 4, 8])
    def test_atom_index_and_placement_equal(self, part_graphs, n_machines):
        jg, tg = part_graphs
        atom_of = tpart.overpartition(tg.structure, 32, "hash")
        ji = jpart.atom_meta_index(jg.structure, atom_of)
        ti = tpart.atom_meta_index(tg.structure, atom_of)
        for f in ("k_atoms", "n_vertices", "n_edges", "atom_nv", "atom_ne",
                  "meta_src", "meta_dst", "meta_weight"):
            a, b = getattr(ji, f), getattr(ti, f)
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
        jp = jpart.place_atoms(ji, n_machines)
        tp = tpart.place_atoms(ti, n_machines)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(
            jpart.place_vertices(jg.structure, atom_of, n_machines),
            tpart.place_vertices(tg.structure, atom_of, n_machines))
        assert jpart.cut_edges(ji, jp) == tpart.cut_edges(ti, tp)
        if n_machines > 2:
            np.testing.assert_array_equal(
                jpart.rebalance_placement(ji, jp, n_machines, remove=(1,)),
                tpart.rebalance_placement(ti, tp, n_machines, remove=(1,)))
            np.testing.assert_array_equal(
                jpart.rebalance_placement(ji, jp, n_machines + 1),
                tpart.rebalance_placement(ti, tp, n_machines + 1))

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_journals_load_across_packages(self, writer):
        """Atoms written by either package replay in the other into the
        same local graphs (the ``.atom.npz`` format is shared)."""
        js = jgen.power_law_graph(90, avg_degree=5, seed=2)
        ts = tgen.power_law_graph(90, avg_degree=5, seed=2, device="cpu")
        jg = jlbp.make_mrf_graph(js, 3, seed=4)      # two vertex leaves
        tg = tlbp.make_mrf_graph(ts, 3, seed=4)
        atom_of = tpart.overpartition(ts, 12, "bfs")
        with tempfile.TemporaryDirectory() as d:
            if writer == "jax":
                index = jpart.build_atoms(jg, atom_of, d)
            else:
                index = tpart.build_atoms(tg, atom_of, d)
            ji = jpart.AtomIndex.load(os.path.join(d, "atom_index.json"))
            ti = tpart.AtomIndex.load(os.path.join(d, "atom_index.json"))
            assert ji.files == ti.files == index.files
            placement = tpart.place_atoms(ti, 3)
            for m in range(3):
                a = jpart.load_machine(ji, placement, m)
                b = tpart.load_machine(ti, placement, m)
                for f in ("own_global", "ghost_global", "edge_src_local",
                          "edge_dst_local", "edge_ids", "ghost_version"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f), err_msg=f)
                for x, y in zip(a.vdata + a.edata, b.vdata + b.edata):
                    np.testing.assert_array_equal(x, y)
            # every vertex and edge in exactly one atom; replay on any
            # machine count reproduces the data
            for n_machines in (2, 5):
                got = np.zeros_like(_np(tg.vertex_data["belief"]))
                for lg in tpart.load_cluster(ti, n_machines):
                    # leaves in sorted key order: belief, unary
                    got[lg.own_global] = lg.vdata[0][:lg.n_own]
                np.testing.assert_array_equal(got,
                                              _np(tg.vertex_data["belief"]))

    def test_journal_files_hold_the_same_arrays(self):
        js = jgen.power_law_graph(60, avg_degree=4, seed=8)
        ts = tgen.power_law_graph(60, avg_degree=4, seed=8, device="cpu")
        atom_of = tpart.overpartition(ts, 6, "hash")
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            a = jpart.build_atoms(jpr.make_pagerank_graph(js), atom_of, d1)
            b = tpart.build_atoms(tpr.make_pagerank_graph(ts), atom_of, d2)
            for fa, fb in zip(a.files, b.files):
                za, zb = np.load(fa), np.load(fb)
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype, k
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=k)

    def test_ghosts_cover_remote_reads(self, part_graphs):
        _, tg = part_graphs
        rank = _np(tg.vertex_data["rank"])
        with tempfile.TemporaryDirectory() as d:
            index = tpart.build_atoms(
                tg, tpart.overpartition(tg.structure, 16), d)
            for lg in tpart.load_cluster(index, 4):
                assert lg.edge_src_local.max(initial=0) < lg.n_own + lg.n_ghost
                assert lg.edge_dst_local.max(initial=0) < lg.n_own
                np.testing.assert_array_equal(lg.vdata[0][lg.n_own:],
                                              rank[lg.ghost_global])

    def test_elastic_rebalance_and_bfs_locality(self, part_graphs):
        _, tg = part_graphs
        with tempfile.TemporaryDirectory() as d:
            index = tpart.build_atoms(
                tg, tpart.overpartition(tg.structure, 32), d)
            w = index.atom_nv + index.atom_ne
            for n_machines in (2, 4, 8):
                loads = np.bincount(tpart.place_atoms(index, n_machines),
                                    weights=w, minlength=n_machines)
                assert loads.max() <= 2.2 * loads.mean()
        grid = tgen.grid3d_graph(6, 6, 6, connectivity=6, device="cpu")
        cuts = {}
        for method in ("hash", "bfs"):
            idx = tpart.atom_meta_index(
                grid, tpart.overpartition(grid, 16, method=method))
            cuts[method] = tpart.cut_edges(idx, tpart.place_atoms(idx, 4))
        assert cuts["bfs"] < cuts["hash"]


# ---------------------------------------------------------------------------
# layout (dist/engine.py)
# ---------------------------------------------------------------------------

def _layout_graphs(name):
    if name == "power_law":
        return _pr(200, 5, 7)
    if name == "lbp_grid":
        js = jgen.grid3d_graph(5, 5, 4, 26)
        ts = tgen.grid3d_graph(5, 5, 4, 26, device="cpu")
        return (jlbp.make_mrf_graph(js, 2, seed=0),
                tlbp.make_mrf_graph(ts, 2, seed=0), jlbp.LoopyBPProgram(2),
                tlbp.LoopyBPProgram(2))
    if name == "als":
        jg, _ = jals.make_als_graph(150, 40, 1200, d=3, seed=2)
        tg, _ = tals.make_als_graph(150, 40, 1200, d=3, seed=2,
                                    device="cpu")
        return jg, tg, jals.ALSProgram(3), tals.ALSProgram(3)
    # tiny: 3 vertices on 4 machines, so a machine is left empty
    js, _ = jpart.GraphStructure.undirected([0, 1], [1, 2], 3)
    ts, _ = GraphStructure.undirected([0, 1], [1, 2], 3, device="cpu")
    return (jpr.make_pagerank_graph(js), tpr.make_pagerank_graph(ts),
            jpr.PageRankProgram(0.15, 3), tpr.PageRankProgram(0.15, 3))


LAYOUT_FIELDS = ("n_machines", "n_loc", "budget", "e_loc", "e_budget",
                 "has_rev", "machine_of", "own_gid", "row_of", "erow_gid",
                 "erow_of", "ghost_gid", "eghost_gid")


class TestLayout:
    @pytest.mark.parametrize("method", ["hash", "bfs"])
    @pytest.mark.parametrize("name", ["power_law", "lbp_grid", "als",
                                      "tiny"])
    def test_every_table_equal(self, cpu_mesh, name, method):
        jg, tg, jp, tp = _layout_graphs(name)
        je = JDist(jp, jg, cpu_mesh, method=method, tolerance=1e-3)
        te = DistributedEngine(tp, tg, EX, method=method, tolerance=1e-3,
                               device="cpu")
        jl = layout_from_numpy(
            {f: getattr(je.layout, f) for f in LAYOUT_FIELDS}
            | {"tables": je.layout.tables})
        tl = te.layout
        for f in LAYOUT_FIELDS:
            np.testing.assert_array_equal(getattr(jl, f), getattr(tl, f),
                                          err_msg=f)
        np.testing.assert_array_equal(je.atom_of, te.atom_of)
        np.testing.assert_array_equal(je.atom_placement, te.atom_placement)
        # every table of the port's (the JAX package also keeps stall and
        # the quantized wire's cacher masks, which the port has not)
        assert set(tl.tables) <= set(jl.tables)
        for k, v in tl.tables.items():
            assert v.dtype == jl.tables[k].dtype, k
            np.testing.assert_array_equal(v, jl.tables[k], err_msg=k)
        assert ("gas_send" in tl.tables) == te.use_fused == je._use_fused
        assert te.total_ghost_slots() == je.total_ghost_slots()
        if name == "tiny":
            assert (np.bincount(tl.machine_of, minlength=S) == 0).any()

    def test_slab_tables_equal_jax(self):
        """The slabs, and each triple's slot (the JAX package's
        ``_slab_lookup`` of every input triple)."""
        from repro.dist.engine import _slab_lookup, _slab_tables
        rng = np.random.default_rng(0)
        dest, owner = rng.integers(0, S, 500), rng.integers(0, S, 500)
        keep = dest != owner
        dest, owner = dest[keep], owner[keep]
        gid = rng.integers(0, 90, dest.size)
        row = rng.permutation(90)
        jt = _slab_tables(dest, owner, gid, S, row, 90)
        tt = tdist.slab_tables(dest, owner, gid, S, row, 90)
        for a, b in zip(jt[:4], tt[:4]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tt[4], _slab_lookup(jt[4], jt[5], dest, owner, gid, S, 90))
        empty = tdist.slab_tables(dest[:0], owner[:0], gid[:0], S, row, 90)
        for a, b in zip(_slab_tables(dest[:0], owner[:0], gid[:0], S, row,
                                     90)[:4], empty[:4]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# DistributedEngine (the sweep engine)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pr_runs(cpu_mesh, pr200):
    """PageRank at tolerance 1e-5: both packages' dist engines run to the
    end, and the port's chromatic engine on the same coloring."""
    jg, tg, jp, tp = pr200
    je, te, colors = _dist_pair(cpu_mesh, jg, tg, jp, tp, 1e-5)
    js, _ = je.run(je.init(), max_steps=300)
    ts, rows = te.run(te.init(), max_steps=300)
    ce = ChromaticEngine(tp, tg, colors=colors, tolerance=1e-5, device="cpu")
    cs, _ = ce.run(ce.init(tg), max_steps=300)
    return je, js, te, ts, rows, cs


class TestDistributedEngine:
    def test_pagerank_matches_jax_and_chromatic(self, pr_runs):
        je, js, te, ts, rows, cs = pr_runs
        out = _np(te.vertex_data(ts)["rank"])
        np.testing.assert_allclose(out, je.vertex_data(js)["rank"],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(out, _np(cs.graph.vertex_data["rank"]),
                                   atol=TOL, rtol=0)
        assert int(ts.step_index) == int(js.step_index) == len(rows)
        assert _counters(te, ts) == _counters(je, js)
        np.testing.assert_array_equal(_np(te.update_counts(ts)),
                                      _np(cs.update_count))
        assert rows[-1]["updates"] == int(_np(ts.update_count).sum())
        assert rows[-1]["traffic_rows_v"] == te.ghost_rows_sent(ts)
        assert rows[-1]["traffic_bytes_v"] == te.ghost_bytes_sent(ts)

    @pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
    @pytest.mark.parametrize("tol", [1e-7, 1e-6])
    def test_schedule_equals_chromatic_at_any_tolerance(self, pr200, tol,
                                                        fused):
        """The port's dist engine takes its chromatic engine's schedule
        step for step (the same sums in the same order, card or CPU)."""
        _, tg, _, tp = pr200
        ce = ChromaticEngine(tp, tg, tolerance=tol, use_fused=fused,
                             device="cpu")
        te = DistributedEngine(tp, tg, EX, tolerance=tol,
                               colors=_np(ce.colors), use_fused=fused,
                               device="cpu")
        cs, ts = ce.init(tg), te.init()
        for _ in range(300):
            if te.converged(ts):
                break
            cs, ts = ce.step(cs), te.step(ts)
            np.testing.assert_array_equal(_np(te.update_counts(ts)),
                                          _np(cs.update_count))
        assert bool(ce.scheduler.done(cs.sched, cs.prio))
        np.testing.assert_array_equal(_np(te.vertex_data(ts)["rank"]),
                                      _np(cs.graph.vertex_data["rank"]))

    def test_fixed_point_is_exact(self, pr200):
        _, tg, _, tp = pr200
        te = DistributedEngine(tp, tg, EX, tolerance=1e-7, device="cpu")
        ts, _ = te.run(te.init(), max_steps=300)
        exact = tpr.exact_pagerank(tg.structure, 0.15, iters=500)
        assert np.abs(_np(te.vertex_data(ts)["rank"]) - exact).max() <= 1e-4

    @pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
    def test_first_sweep_ships_each_ghost_pair_once(self, pr200, fused):
        _, tg, _, tp = pr200
        te = DistributedEngine(tp, tg, EX, tolerance=1e-7, use_fused=fused,
                               device="cpu")
        s = te.step(te.init())
        assert te.ghost_rows_sent(s) == te.total_ghost_slots()
        assert te.ghost_bytes_sent(s) == 8 * te.total_ghost_slots()

    def test_traffic_decays_and_converged_step_ships_nothing(self, pr_runs):
        _, _, te, ts, _, _ = pr_runs
        n_steps = int(ts.step_index)
        assert n_steps > 2
        total = te.ghost_rows_sent(ts)
        assert total < n_steps * te.total_ghost_slots()
        before = _counters(te, ts)
        s2 = te.step(ts)       # empty scheduler: no updates, no traffic
        assert _counters(te, s2) == before
        assert te.ghost_edge_rows_sent(s2) == 0

    def test_lbp_matches_jax_and_chromatic(self, cpu_mesh, lbp120):
        jg, tg, jp, tp = lbp120
        je, te, colors = _dist_pair(cpu_mesh, jg, tg, jp, tp, 1e-6)
        assert not te.use_fused and te.layout.has_rev
        js, _ = je.run(je.init(), max_steps=150)
        ts, _ = te.run(te.init(), max_steps=150)
        out = _np(te.vertex_data(ts)["belief"])
        np.testing.assert_allclose(out, je.vertex_data(js)["belief"],
                                   atol=TOL, rtol=0)
        ce = ChromaticEngine(tp, tg, colors=colors, tolerance=1e-6,
                             device="cpu")
        cs, _ = ce.run(ce.init(tg), max_steps=150)
        np.testing.assert_allclose(out, _np(cs.graph.vertex_data["belief"]),
                                   atol=TOL, rtol=0)
        assert int(ts.step_index) == int(cs.step_index)
        # edge traffic: cross-machine reverse edges ship, versioned
        before = _counters(te, ts)
        assert before[3] > 0 and before[4] == before[3] * 3 * 4
        assert _counters(te, te.step(ts)) == before

    def test_lbp_counters_equal_jax(self, cpu_mesh, lbp120):
        """Step by step while the schedule is not at the tolerance's
        rounding edge: the first five sweeps' counters are equal."""
        jg, tg, jp, tp = lbp120
        je, te, _ = _dist_pair(cpu_mesh, jg, tg, jp, tp, 1e-3)
        js, ts = je.init(), te.init()
        for _ in range(5):
            js, ts = je.step(js), te.step(ts)
            assert _counters(te, ts) == _counters(je, js)
            np.testing.assert_allclose(_np(te.vertex_data(ts)["belief"]),
                                       je.vertex_data(js)["belief"],
                                       atol=TOL, rtol=0)

    def test_gather_only_rev_edata_reader(self, cpu_mesh):
        """A program that reads ctx.rev_edata in gather but never writes
        edges declares reads_rev_edata=True and matches the chromatic
        engine, with zero edge-ghost traffic."""

        class RevWeightedRank(tpr.PageRankProgram):
            reads_rev_edata = True

            def gather(self, ctx):
                return ctx.rev_edata["w"] * ctx.src["rank"]

            def fused_gather(self):
                return None     # the gather above, not PageRank's

        st = tgen.power_law_graph(150, avg_degree=4, seed=9, device="cpu")
        g = tpr.make_pagerank_graph(st)
        w = g.edge_data["w"] * torch.from_numpy(
            0.4 + 0.2 * (st.senders % 3).astype(np.float32))
        g = g.replace(edge_data={"w": w})
        prog = RevWeightedRank(0.15, st.n_vertices)
        ce = ChromaticEngine(prog, g, tolerance=1e-6, device="cpu")
        te = DistributedEngine(prog, g, EX, tolerance=1e-6,
                               colors=_np(ce.colors), device="cpu")
        assert not te.use_fused and te.layout.has_rev
        cs, _ = ce.run(ce.init(g), max_steps=200)
        ts, _ = te.run(te.init(), max_steps=200)
        np.testing.assert_allclose(_np(te.vertex_data(ts)["rank"]),
                                   _np(cs.graph.vertex_data["rank"]),
                                   atol=TOL, rtol=0)
        assert te.ghost_edge_rows_sent(ts) == 0

    def test_tiny_graph_pads_empty_machines(self, cpu_mesh):
        jg, tg, jp, tp = _pr(8, 2, 5)
        je, te, _ = _dist_pair(cpu_mesh, jg, tg, jp, tp, 1e-7)
        js, _ = je.run(je.init(), max_steps=100)
        ts, _ = te.run(te.init(), max_steps=100)
        np.testing.assert_allclose(_np(te.vertex_data(ts)["rank"]),
                                   je.vertex_data(js)["rank"], atol=TOL,
                                   rtol=0)

    def test_continues_the_jax_state(self, cpu_mesh, pr200):
        """``dist_state_from_numpy``: the port continues the JAX engine's
        run from its state after one sweep, and both agree after the
        next."""
        jg, tg, jp, tp = pr200
        je, te, _ = _dist_pair(cpu_mesh, jg, tg, jp, tp, 1e-5)
        js = je.step(je.init())
        ts = dist_state_from_numpy(
            {f: jax.tree.map(np.asarray, getattr(js, f))
             for f in DIST_STATE_FIELDS}, device="cpu")
        np.testing.assert_array_equal(_np(ts.vown["rank"]),
                                      np.asarray(js.vown["rank"]))
        js, ts = je.step(js), te.step(ts)
        np.testing.assert_allclose(_np(te.vertex_data(ts)["rank"]),
                                   je.vertex_data(js)["rank"], atol=1e-7,
                                   rtol=0)
        assert _counters(te, ts) == _counters(je, js)
        assert int(ts.step_index) == int(js.step_index) == 2

    @pytest.mark.parametrize("app", ["als", "coem"])
    def test_bipartite_apps_match_jax_and_chromatic(self, cpu_mesh, app):
        if app == "als":
            jg, tg, jp, tp = _layout_graphs("als")
            n_left, leaf = 150, "factor"
        else:
            from repro.apps import coem as jcoem
            from repro_torch.apps import coem as tcoem
            jg, _ = jcoem.make_coem_graph(200, 60, 1500, n_types=8, seed=3)
            tg, _ = tcoem.make_coem_graph(200, 60, 1500, n_types=8, seed=3,
                                          device="cpu")
            jp, tp = jcoem.CoEMProgram(8), tcoem.CoEMProgram(8)
            n_left, leaf = 200, "p"
        colors = (np.arange(tg.n_vertices) >= n_left).astype(np.int32)
        je = JDist(jp, jg, cpu_mesh, tolerance=1e-3, colors=colors)
        te = DistributedEngine(tp, tg, EX, tolerance=1e-3, colors=colors,
                               device="cpu")
        ce = ChromaticEngine(tp, tg, colors=colors, tolerance=1e-3,
                             device="cpu")
        assert te.use_fused
        js, ts, cs = je.init(), te.init(), ce.init(tg)
        for _ in range(3):
            js, ts, cs = je.step(js), te.step(ts), ce.step(cs)
            out = _np(te.vertex_data(ts)[leaf])
            np.testing.assert_allclose(out, je.vertex_data(js)[leaf],
                                       atol=TOL, rtol=0)
            np.testing.assert_allclose(out, _np(cs.graph.vertex_data[leaf]),
                                       atol=TOL, rtol=0)
            assert _counters(te, ts) == _counters(je, js)
            np.testing.assert_array_equal(_np(te.update_counts(ts)),
                                          _np(cs.update_count))

    def test_wrong_structure_and_coloring_rejected(self, pr200):
        _, tg, _, tp = pr200
        te = DistributedEngine(tp, tg, EX, device="cpu")
        other = tpr.make_pagerank_graph(
            tgen.power_law_graph(200, avg_degree=5, seed=8, device="cpu"))
        with pytest.raises(ValueError, match="differs"):
            te.init(other)
        with pytest.raises(ValueError, match="coloring"):
            DistributedEngine(tp, tg, EX, colors=np.zeros(200, np.int32),
                              device="cpu")


# ---------------------------------------------------------------------------
# sync ops at the step barrier (mirrors tests/test_dist_sync.py)
# ---------------------------------------------------------------------------

def _mass():
    return FnSyncOp(lambda v: {"mass": v["rank"]}, name="mass")


def _mean():
    return FnSyncOp(lambda v: {"m": v["rank"]},
                    finalize=lambda z, n: {"m": z["m"] / n}, name="mean")


class TestDistSync:
    def test_sweep_engine_matches_chromatic_and_jax(self, cpu_mesh, pr200):
        jg, tg, jp, tp = pr200
        ce = ChromaticEngine(tp, tg, tolerance=1e-5, sync_ops=(_mass(),
                                                               _mean()),
                             device="cpu")
        te = DistributedEngine(tp, tg, EX, tolerance=1e-5,
                               colors=_np(ce.colors),
                               sync_ops=(_mass(), _mean()), device="cpu")
        je = JDist(jp, jg, cpu_mesh, tolerance=1e-5, colors=_np(ce.colors),
                   sync_ops=(JFnSyncOp(lambda v: {"mass": v["rank"]},
                                       name="mass"),))
        cs, _ = ce.run(ce.init(tg), max_steps=300)
        ts, _ = te.run(te.init(), max_steps=300)
        js, _ = je.run(je.init(), max_steps=300)
        for name, key in (("mass", "mass"), ("mean", "m")):
            np.testing.assert_allclose(_np(ts.globals_[name][key]),
                                       _np(cs.globals_[name][key]),
                                       rtol=1e-6)
        np.testing.assert_allclose(_np(ts.globals_["mass"]["mass"]),
                                   np.asarray(js.globals_["mass"]["mass"]),
                                   rtol=1e-5)
        own = float(_np(te.vertex_data(ts)["rank"]).sum())
        assert abs(float(_np(ts.globals_["mass"]["mass"])) - own) <= 1e-6

    def test_inconsistent_sync_sees_previous_barrier(self):
        _, tg, _, tp = _pr(120, 4, 3)
        stale = FnSyncOp(lambda v: {"mass": v["rank"]}, name="stale",
                         consistent=False)
        fresh = FnSyncOp(lambda v: {"mass": v["rank"]}, name="fresh")
        te = DistributedEngine(tp, tg, EX, tolerance=1e-7,
                               sync_ops=(stale, fresh), device="cpu")
        s0 = te.init()
        init_mass = float(s0.globals_["stale"]["mass"])
        s1 = te.step(s0)
        assert abs(float(s1.globals_["stale"]["mass"]) - init_mass) <= 1e-6
        own = float(_np(te.vertex_data(s1)["rank"]).sum())
        assert abs(float(s1.globals_["fresh"]["mass"]) - own) <= 1e-6

    def test_update_fn_reads_globals(self):
        _, tg, _, _ = _pr(100, 4, 1)

        class NormalizingPR(tpr.PageRankProgram):
            def apply(self, vertex_data, acc, glob=None):
                out = super().apply(vertex_data, acc, glob)
                if glob and "mass" in glob:
                    scale = torch.clamp(glob["mass"]["mass"], min=1e-6)
                    out = out._replace(vertex_data={
                        "rank": out.vertex_data["rank"] / scale})
                return out

        prog = NormalizingPR(0.15, 100)
        ce = ChromaticEngine(prog, tg, tolerance=1e-7, sync_ops=(_mass(),),
                             device="cpu")
        te = DistributedEngine(prog, tg, EX, tolerance=1e-7,
                               colors=_np(ce.colors), sync_ops=(_mass(),),
                               device="cpu")
        cs, _ = ce.run(ce.init(tg), max_steps=200)
        ts, _ = te.run(te.init(), max_steps=200)
        np.testing.assert_allclose(_np(te.vertex_data(ts)["rank"]),
                                   _np(cs.graph.vertex_data["rank"]),
                                   atol=TOL)

    def test_locking_engine_mass_at_fixed_point(self, pr200):
        _, tg, _, tp = pr200
        le = DistributedLockingEngine(tp, tg, EX, tolerance=1e-7,
                                      pipeline_length=1024,
                                      sync_ops=(_mass(),), device="cpu")
        ls, _ = le.run(le.init(), max_steps=400)
        own = float(_np(le.vertex_data(ls)["rank"]).sum())
        assert abs(float(ls.globals_["mass"]["mass"]) - own) <= 1e-5


# ---------------------------------------------------------------------------
# DistributedLockingEngine (mirrors tests/test_locking_engine.py)
# ---------------------------------------------------------------------------

def _conflicts(st, radius):
    n = st.n_vertices
    a = np.zeros((n, n), bool)
    a[st.senders, st.receivers] = True
    a |= a.T
    d = a.copy() if radius >= 1 else np.zeros((n, n), bool)
    if radius >= 2:
        d |= (a.astype(np.int32) @ a.astype(np.int32)) > 0
    np.fill_diagonal(d, False)
    return d


class TestLockingEngine:
    def test_pagerank_matches_dynamic_and_jax(self, cpu_mesh, pr200):
        jg, tg, jp, tp = pr200
        dyn = DynamicEngine(tp, tg, pipeline_length=64, tolerance=1e-7,
                            device="cpu")
        ds, _ = dyn.run(dyn.init(tg), max_steps=3000)
        le = DistributedLockingEngine(tp, tg, EX, pipeline_length=16,
                                      tolerance=1e-7, device="cpu")
        ls, _ = le.run(le.init(), max_steps=3000)
        assert le.converged(ls)
        out = _np(le.vertex_data(ls)["rank"])
        np.testing.assert_allclose(out, _np(ds.graph.vertex_data["rank"]),
                                   atol=TOL, rtol=0)
        jle = JLock(jp, jg, cpu_mesh, pipeline_length=16, tolerance=1e-7)
        jls, _ = jle.run(jle.init(), max_steps=3000)
        np.testing.assert_allclose(out, jle.vertex_data(jls)["rank"],
                                   atol=TOL, rtol=0)
        exact = tpr.exact_pagerank(tg.structure, 0.15, iters=500)
        assert np.abs(out - exact).max() <= 1e-4

    @pytest.mark.parametrize("model", ["EDGE", "FULL"])
    def test_steps_equal_jax(self, cpu_mesh, pr200, model):
        """Winners, ranks shipped and every counter equal to the JAX
        engine's, step by step, over the first 40 steps."""
        jg, tg, _, _ = pr200

        class JP(jpr.PageRankProgram):
            consistency = JConsistency[model]

        class TP(tpr.PageRankProgram):
            consistency = Consistency[model]

        je = JLock(JP(0.15, 200), jg, cpu_mesh, pipeline_length=16,
                   tolerance=1e-5)
        te = DistributedLockingEngine(TP(0.15, 200), tg, EX,
                                      pipeline_length=16, tolerance=1e-5,
                                      device="cpu")
        js, ts = je.init(), te.init()
        for _ in range(40):
            js, ts = je.step(js), te.step(ts)
            np.testing.assert_array_equal(_np(ts.update_count),
                                          np.asarray(js.update_count))
            assert _counters(te, ts) == _counters(je, js)
            np.testing.assert_allclose(_np(ts.prio), np.asarray(js.prio),
                                       atol=TOL, rtol=0)
        assert te.rank_rows_sent(ts) > 0

    def test_lbp_reaches_a_bp_fixed_point(self, lbp120):
        """LBP at smoothing 2 has several fixed points on this loopy graph,
        and which one a schedule reaches hinges on f32 ties in its first
        steps (every priority starts at 1 and gains ~1e-7), so the port's
        locking engine and DynamicEngine reach different ones (the JAX
        package's two engines happen to agree).  Held instead: the locking
        engine converges to a BP fixed point — one more chromatic sweep
        moves no belief or message by 1e-5."""
        _, tg, _, tp = lbp120
        le = DistributedLockingEngine(tp, tg, EX, pipeline_length=16,
                                      tolerance=1e-6, device="cpu")
        ls, _ = le.run(le.init(), max_steps=3000)
        assert le.converged(ls)
        g = tg.replace(vertex_data=le.vertex_data(ls),
                       edge_data=le.edge_data(ls))
        ce = ChromaticEngine(tp, g, tolerance=0.0, device="cpu")
        s = ce.step(ce.init(g))
        for part, k in (("vertex_data", "belief"), ("edge_data", "msg")):
            moved = getattr(s.graph, part)[k] - getattr(g, part)[k]
            assert float(moved.abs().max()) <= TOL, k

    def test_lbp_steps_equal_jax_from_the_same_state(self, cpu_mesh,
                                                     lbp120):
        """Each step, started from the JAX engine's state, picks the JAX
        engine's winners and reaches its values within 1e-5."""
        jg, tg, jp, tp = lbp120
        je = JLock(jp, jg, cpu_mesh, pipeline_length=16, tolerance=1e-6)
        te = DistributedLockingEngine(tp, tg, EX, pipeline_length=16,
                                      tolerance=1e-6, device="cpu")
        js = je.init()
        for _ in range(8):
            ts = te.step(dist_state_from_numpy(
                {f: jax.tree.map(np.asarray, getattr(js, f))
                 for f in DIST_STATE_FIELDS}, device="cpu"))
            js = je.step(js)
            np.testing.assert_array_equal(_np(ts.update_count),
                                          np.asarray(js.update_count))
            assert _counters(te, ts) == _counters(je, js)
            for k in ("belief",):
                np.testing.assert_allclose(_np(ts.vown[k]),
                                           np.asarray(js.vown[k]), atol=TOL,
                                           rtol=0)
            np.testing.assert_allclose(_np(ts.edata["msg"]),
                                       np.asarray(js.edata["msg"]), atol=TOL,
                                       rtol=0)

    def test_asymmetric_graph_rejected_when_serializable(self):
        st, _ = GraphStructure.from_edges([0, 1, 2], [1, 2, 3], 8,
                                          device="cpu")
        g = tpr.make_pagerank_graph(st)
        prog = tpr.PageRankProgram(0.15, 8)
        with pytest.raises(ValueError, match="symmetrized"):
            DistributedLockingEngine(prog, g, EX, device="cpu")
        DistributedLockingEngine(prog, g, EX, serializable=False,
                                 device="cpu")

    @pytest.mark.parametrize("model", ["VERTEX", "EDGE", "FULL"])
    @pytest.mark.parametrize("seed", [0, 41, 96])
    def test_winners_respect_exclusion(self, model, seed):
        st = tgen.power_law_graph(40, avg_degree=4, seed=seed,
                                  device="cpu")

        class P(tpr.PageRankProgram):
            consistency = Consistency[model]

        le = DistributedLockingEngine(
            P(0.15, st.n_vertices), tpr.make_pagerank_graph(st), EX,
            pipeline_length=4, tolerance=1e-6, seed=seed % 11, device="cpu")
        radius = Consistency[model].exclusion_radius
        d = _conflicts(st, radius)
        s = le.init()
        for _ in range(4):
            scheduled = bool((_np(s.prio) > le.tolerance).any())
            prev = _np(le.update_counts(s)).copy()
            s = le.step(s)
            ids = np.nonzero(_np(le.update_counts(s)) - prev)[0]
            assert not d[np.ix_(ids, ids)].any(), \
                f"winners within radius {radius} co-executed"
            if scheduled and radius >= 1:
                assert ids.size, "arbitration made no progress"

    def test_rank_rows_are_versioned(self, pr200):
        _, tg, _, tp = pr200
        le = DistributedLockingEngine(tp, tg, EX, pipeline_length=16,
                                      tolerance=1e-7, device="cpu")
        ls, _ = le.run(le.init(), max_steps=3000)
        sent = le.rank_rows_sent(ls)
        assert sent > 0
        assert le.rank_bytes_sent(ls) == 4 * sent
        assert sent < int(ls.step_index) * le.total_ghost_slots()
        ls2 = le.step(ls)
        assert le.rank_rows_sent(ls2) == sent
        assert le.ghost_rows_sent(ls2) == le.ghost_rows_sent(ls)

    def test_racing_mode_ships_no_ranks(self, pr200):
        _, tg, _, tp = pr200
        le = DistributedLockingEngine(tp, tg, EX, pipeline_length=16,
                                      tolerance=1e-5, serializable=False,
                                      device="cpu")
        ls, _ = le.run(le.init(), max_steps=500)
        assert le.rank_rows_sent(ls) == 0

    def test_updates_rise_with_pipeline_depth(self):
        """Fig. 8(b): deep pipelines violate priority order, so convergence
        costs more updates than p = 1."""
        st = tgen.power_law_graph(400, avg_degree=6, seed=0, device="cpu")
        g = tpr.make_pagerank_graph(st)
        totals = {}
        for p in (1, 64):
            le = DistributedLockingEngine(tpr.PageRankProgram(0.8, 400), g,
                                          EX, pipeline_length=p,
                                          tolerance=1e-6, device="cpu")
            ls, _ = le.run(le.init(), max_steps=20000)
            assert le.converged(ls)
            totals[p] = int(_np(ls.update_count).sum())
        assert totals[1] < totals[64], totals


# ---------------------------------------------------------------------------
# the exchange and the wire
# ---------------------------------------------------------------------------

class TestExchangeAndWire:
    def test_in_process_all_to_all_swaps_machine_axes(self):
        ex = InProcessExchange(3)
        b = 2
        x = torch.arange(3 * 3 * b * 2).reshape(3 * 3 * b, 2)
        got = ex.all_to_all(x, b).reshape(3, 3, b, 2)
        want = x.reshape(3, 3, b, 2)
        for m in range(3):
            for o in range(3):
                assert torch.equal(got[m, o], want[o, m])
        assert torch.equal(ex.psum(torch.ones(3, 4)), torch.full((4,), 3.0))
        assert ex.machines == (0, 1, 2) and ex.n_held == 3

    def test_all_to_all_equals_jax_tiled(self, cpu_mesh):
        from repro.dist.compat import shard_map
        from jax.sharding import PartitionSpec as P
        b = 3
        x = np.arange(S * S * b * 2, dtype=np.float32).reshape(S * S * b, 2)
        f = shard_map(lambda r: jax.lax.all_to_all(r, "data", 0, 0,
                                                   tiled=True),
                      mesh=cpu_mesh, in_specs=P("data"),
                      out_specs=P("data"), check_vma=False)
        want = np.asarray(f(jnp.asarray(x)))
        np.testing.assert_array_equal(
            _np(EX.all_to_all(torch.from_numpy(x), b)), want)

    def test_wire_config(self):
        assert WireConfig() == WireConfig(codec="f32", top_k=None)
        for kw in ({"codec": "int8"}, {"codec": "bf16"}, {"top_k": 4}):
            with pytest.raises(NotImplementedError, match="A9"):
                WireConfig(**kw)
        with pytest.raises(NotImplementedError):
            DistributedEngine(*_pr(20, 3, 1)[1::2], EX,
                              wire=WireConfig(codec="int8"), device="cpu")

    def test_payload_bytes_and_rank_codec_equal_jax(self):
        payload = {"v": {"a": np.zeros((5, 3), np.float32),
                         "b": np.zeros((5,), np.float64)},
                   "contrib": np.zeros(5, np.float32)}
        assert twire.payload_row_nbytes(
            {"v": {k: torch.from_numpy(v) for k, v in payload["v"].items()},
             "contrib": torch.from_numpy(payload["contrib"])}) == \
            jwire.payload_row_nbytes(payload)
        rank = np.array([0, 3, 17, np.inf, 32766, np.inf], np.float32)
        q = twire.encode_rank(torch.from_numpy(rank))
        np.testing.assert_array_equal(
            _np(q), np.asarray(jwire.encode_rank(jnp.asarray(rank))))
        np.testing.assert_array_equal(_np(twire.decode_rank(q)), rank)
        for r in (100, 32766, 32767, 40000):
            assert twire.rank_codec_fits(r) == jwire.rank_codec_fits(r)


@pytest.mark.cuda
class TestOnCard:
    """The dist engines on the card against the same engines on the CPU
    (the kernels add in the plain versions' order)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
    def test_pagerank_card_equals_cpu(self, fused):
        out = {}
        for dev in ("cpu", "cuda"):
            st = tgen.power_law_graph(3000, avg_degree=6, seed=1, device=dev)
            g = tpr.make_pagerank_graph(st)
            te = DistributedEngine(tpr.PageRankProgram(0.15, 3000), g, EX,
                                   tolerance=1e-7, use_fused=fused,
                                   device=dev)
            ts, _ = te.run(te.init(), max_steps=300)
            out[dev] = (_np(te.vertex_data(ts)["rank"]), _np(ts.prio),
                        _counters(te, ts))
        np.testing.assert_array_equal(out["cpu"][0], out["cuda"][0])
        np.testing.assert_array_equal(out["cpu"][1], out["cuda"][1])
        assert out["cpu"][2] == out["cuda"][2]

    def test_als_and_locking_card_within_tolerance_of_cpu(self):
        out = {}
        for dev in ("cpu", "cuda"):
            g, _ = tals.make_als_graph(300, 80, 4000, d=8, seed=2,
                                       device=dev)
            colors = (np.arange(380) >= 300).astype(np.int32)
            te = DistributedEngine(tals.ALSProgram(8), g, EX, colors=colors,
                                   tolerance=1e-3, device=dev)
            ts = te.init()
            for _ in range(3):
                ts = te.step(ts)
            st = tgen.power_law_graph(2000, avg_degree=6, seed=3, device=dev)
            le = DistributedLockingEngine(tpr.PageRankProgram(0.15, 2000),
                                          tpr.make_pagerank_graph(st), EX,
                                          pipeline_length=64,
                                          tolerance=1e-6, device=dev)
            ls, _ = le.run(le.init(), max_steps=3000)
            out[dev] = (_np(te.vertex_data(ts)["factor"]),
                        _np(le.vertex_data(ls)["rank"]))
        for a, b in zip(out["cpu"], out["cuda"]):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
