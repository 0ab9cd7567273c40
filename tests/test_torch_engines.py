"""The port's engines against the JAX package's, on identical graphs.

PageRank fixed points within 1e-5 of the JAX BSP, Chromatic and Dynamic
engines, fused and dense, with equal step, update and edges-touched counts
(both packages sum in edge order, so their schedules agree).  LBP under
Chromatic within 1e-5 of the JAX fixed point: its message updates go
through logsumexp, whose last bits differ between the two libraries, so
only the fixed point is compared.  Scheduler selections are compared
exactly.  ChromaticEngine's sender-color scatter subsets give, phase by
phase, the priorities of a full-set scatter to the bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import lbp as jlbp
from repro.apps import pagerank as jpr
from repro.core import scheduler as jsch
from repro.core.bsp import BSPEngine as JBSP
from repro.core.chromatic import ChromaticEngine as JChromatic
from repro.core.dynamic import DynamicEngine as JDynamic
from repro.core.sync_op import FnSyncOp as JFnSyncOp
from repro.graphs import generators as jgen
from repro_torch.apps import lbp as tlbp
from repro_torch.apps import pagerank as tpr
from repro_torch.core import scheduler as tsch
from repro_torch.core.bsp import BSPEngine
from repro_torch.core.chromatic import ChromaticEngine
from repro_torch.core.dynamic import DynamicEngine
from repro_torch.core.engine_base import Engine
from repro_torch.core.sync_op import FnSyncOp
from repro_torch.graphs import generators as tgen

TOL = 1e-5
ROW_KEYS = {"step", "updates", "edges_touched", "residual_max", "backlog",
            "wire_backlog", "traffic_rows_v", "traffic_bytes_v",
            "traffic_rows_e", "traffic_bytes_e", "traffic_rows_r",
            "traffic_bytes_r"}

ENGINES = {
    "bsp": (JBSP, BSPEngine, {}, 60),
    "chromatic": (JChromatic, ChromaticEngine, {}, 60),
    "dynamic": (JDynamic, DynamicEngine, {"pipeline_length": 64}, 40),
}


@pytest.fixture(scope="module")
def pagerank_graphs():
    js = jgen.power_law_graph(260, 5, seed=11)
    ts = tgen.power_law_graph(260, 5, seed=11, device="cpu")
    return jpr.make_pagerank_graph(js), tpr.make_pagerank_graph(ts)


class TestPageRank:
    @pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
    @pytest.mark.parametrize("engine", list(ENGINES))
    def test_matches_jax(self, pagerank_graphs, engine, fused):
        jg, tg = pagerank_graphs
        jcls, tcls, kw, steps = ENGINES[engine]
        je = jcls(jpr.PageRankProgram(n_vertices=260), jg, tolerance=1e-6,
                  use_fused=fused, **kw)
        te = tcls(tpr.PageRankProgram(n_vertices=260), tg, tolerance=1e-6,
                  use_fused=fused, device="cpu", **kw)
        assert je.use_fused == te.use_fused == fused
        js, _ = je.run(je.init(jg), max_steps=steps)
        ts, rows = te.run(te.init(tg), max_steps=steps)
        diff = np.abs(np.asarray(js.graph.vertex_data["rank"])
                      - ts.graph.vertex_data["rank"].numpy()).max()
        assert diff <= TOL
        assert int(js.step_index) == int(ts.step_index) == len(rows)
        assert int(js.total_updates) == int(ts.total_updates)
        assert int(js.edges_touched) == int(ts.edges_touched)
        np.testing.assert_array_equal(np.asarray(js.update_count),
                                      ts.update_count.numpy())
        assert set(rows[-1]) == ROW_KEYS
        assert rows[-1]["updates"] == int(ts.total_updates)
        assert rows[-1]["edges_touched"] == int(ts.edges_touched)

    def test_converges_to_exact(self, pagerank_graphs):
        _, tg = pagerank_graphs
        st = tg.structure
        eng = ChromaticEngine(tpr.PageRankProgram(n_vertices=260), tg,
                              tolerance=1e-8, device="cpu")
        state = eng.run_while(eng.init(tg), max_steps=200)
        exact = tpr.exact_pagerank(st, 0.15, 300)
        np.testing.assert_allclose(
            exact, jpr.exact_pagerank(jgen.power_law_graph(260, 5, seed=11),
                                      0.15, 300))
        assert np.abs(state.graph.vertex_data["rank"].numpy()
                      - exact).sum() <= 1e-4

    def test_fused_touches_fewer_edges(self, pagerank_graphs):
        _, tg = pagerank_graphs
        prog = tpr.PageRankProgram(n_vertices=260)
        out = {}
        for fused in (True, False):
            e = ChromaticEngine(prog, tg, tolerance=1e-6, use_fused=fused,
                                device="cpu")
            out[fused] = e.run(e.init(tg), max_steps=60)[0]
        assert int(out[True].edges_touched) < int(out[False].edges_touched)
        diff = (out[True].graph.vertex_data["rank"]
                - out[False].graph.vertex_data["rank"]).abs().max()
        assert float(diff) <= TOL

    def test_sync_op_matches_jax(self, pagerank_graphs):
        jg, tg = pagerank_graphs
        jop = JFnSyncOp(lambda v: v["rank"], name="mass")
        top = FnSyncOp(lambda v: v["rank"], name="mass")
        je = JChromatic(jpr.PageRankProgram(n_vertices=260), jg,
                        tolerance=1e-6, sync_ops=(jop,))
        te = ChromaticEngine(tpr.PageRankProgram(n_vertices=260), tg,
                             tolerance=1e-6, sync_ops=(top,), device="cpu")
        js = je.step(je.init(jg))
        ts = te.step(te.init(tg))
        np.testing.assert_allclose(float(ts.globals_["mass"]),
                                   float(js.globals_["mass"]), rtol=1e-6)


class _FullScatter(ChromaticEngine):
    """ChromaticEngine scattering over the full edge set in every phase."""

    def _scatter_ctx(self, phase):
        return Engine._scatter_ctx(self, phase)


class TestScatterSubsets:
    def test_phase_priorities_equal_full_set(self, pagerank_graphs):
        """Over 4 sweeps, the priorities after every color phase are equal
        to the bit with the phase color's sender subset and with the full
        edge set; each subset is smaller than E and together they hold E."""
        _, tg = pagerank_graphs
        prog = tpr.PageRankProgram(n_vertices=260)
        trails = []
        for cls in (ChromaticEngine, _FullScatter):
            eng = cls(prog, tg, tolerance=1e-6, device="cpu")
            trail = []
            resched = eng.scheduler.reschedule

            def record(*args, _r=resched, _t=trail, **kw):
                prio, sched = _r(*args, **kw)
                _t.append(prio.clone())
                return prio, sched

            eng.scheduler.reschedule = record
            state = eng.init(tg)
            for _ in range(4):
                state = eng.step(state)
            trails.append(trail)
            if cls is ChromaticEngine:
                sizes = [eng._scatter_ctx(c).edges.n_edges
                         for c in range(eng.num_colors)]
                assert sum(sizes) == tg.structure.n_edges
                assert max(sizes) < tg.structure.n_edges
        assert len(trails[0]) == len(trails[1]) == 4 * eng.num_colors
        for a, b in zip(*trails):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))

    def test_matches_jax_chromatic(self, pagerank_graphs):
        """The subsets change no count: within 1e-5 of the JAX
        ChromaticEngine's fixed point, equal steps, updates and
        edges_touched (the gather's edges; the scatter is not counted)."""
        jg, tg = pagerank_graphs
        je = JChromatic(jpr.PageRankProgram(n_vertices=260), jg,
                        tolerance=1e-6)
        te = ChromaticEngine(tpr.PageRankProgram(n_vertices=260), tg,
                             tolerance=1e-6, device="cpu")
        assert te._scatter_edges is not None
        js, _ = je.run(je.init(jg), max_steps=60)
        ts, _ = te.run(te.init(tg), max_steps=60)
        diff = np.abs(np.asarray(js.graph.vertex_data["rank"])
                      - ts.graph.vertex_data["rank"].numpy()).max()
        assert diff <= TOL
        assert int(js.step_index) == int(ts.step_index)
        assert int(js.total_updates) == int(ts.total_updates)
        assert int(js.edges_touched) == int(ts.edges_touched)


class TestLBP:
    def test_chromatic_matches_jax(self):
        js = jgen.grid3d_graph(4, 4, 3)
        ts = tgen.grid3d_graph(4, 4, 3, device="cpu")
        jg = jlbp.make_mrf_graph(js, n_states=3, seed=0)
        tg = tlbp.make_mrf_graph(ts, n_states=3, seed=0)
        je = JChromatic(jlbp.LoopyBPProgram(3), jg, tolerance=1e-4,
                        use_fused=True)
        te = ChromaticEngine(tlbp.LoopyBPProgram(3), tg, tolerance=1e-4,
                             use_fused=True, device="cpu")
        # edge writes are non-fuseable: requesting fusion falls back
        assert not te.use_fused and te._color_edges is None
        jst, _ = je.run(je.init(jg), max_steps=30)
        tst, _ = te.run(te.init(tg), max_steps=30)
        diff = np.abs(np.asarray(jst.graph.vertex_data["belief"])
                      - tst.graph.vertex_data["belief"].numpy()).max()
        assert diff <= TOL
        np.testing.assert_array_equal(
            jlbp.lbp_map_labels(jst.graph), tlbp.lbp_map_labels(tst.graph))

    def test_chain_marginals(self):
        """On a chain (a tree) BP is exact: beliefs equal the brute-force
        marginals of both packages' oracles."""
        from repro_torch.core.graph import GraphStructure
        st, _ = GraphStructure.undirected(np.arange(5), np.arange(1, 6), 6,
                                          device="cpu")
        g = tlbp.make_mrf_graph(st, n_states=2, seed=3, dtype=torch.float64)
        prog = tlbp.LoopyBPProgram(2, smoothing=1.0)
        eng = ChromaticEngine(prog, g, tolerance=1e-10, device="cpu")
        state, _ = eng.run(eng.init(g), max_steps=100)
        unary = g.vertex_data["unary"].numpy()
        exact = tlbp.exact_marginals_chain(unary, prog.pairwise)
        np.testing.assert_allclose(
            exact, jlbp.exact_marginals_chain(unary, prog.pairwise))
        np.testing.assert_allclose(
            np.exp(state.graph.vertex_data["belief"].numpy()), exact,
            atol=1e-6)


class TestSchedulers:
    @pytest.fixture(scope="class")
    def setup(self):
        js = jgen.power_law_graph(300, 4, seed=2)
        ts = tgen.power_law_graph(300, 4, seed=2, device="cpu")
        rng = np.random.default_rng(5)
        # ties on purpose: many equal priorities, as at PageRank's start
        prio = np.round(rng.random(300), 1).astype(np.float32)
        return js, ts, prio

    @pytest.mark.parametrize("radius", [0, 1, 2])
    def test_exclusion_winners_equal(self, setup, radius):
        js, ts, prio = setup
        jsel, jtop = jsch.pipeline_select(jnp.asarray(prio), 64, 0.05)
        tsel, ttop = tsch.pipeline_select(torch.from_numpy(prio), 64, 0.05)
        np.testing.assert_array_equal(np.asarray(jtop), ttop.numpy())
        np.testing.assert_array_equal(np.asarray(jsel), tsel.numpy())
        jr = jsch.pipeline_ranks(jnp.asarray(prio), jtop, 0.05)
        tr = tsch.pipeline_ranks(torch.from_numpy(prio), ttop, 0.05)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        t = ts.device_arrays()
        jw = jsch.exclusion_winners(jsel, jr, jnp.asarray(js.senders),
                                    jnp.asarray(js.receivers), 300, radius)
        tw = tsch.exclusion_winners(tsel, tr, t["senders"], t["receivers"],
                                    300, radius)
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())

    @pytest.mark.parametrize("kind", ["priority", "fifo", "multiqueue"])
    def test_select_reschedule_sequence_equal(self, setup, kind):
        js, ts, prio = setup
        prog_j = jpr.PageRankProgram(n_vertices=300)
        prog_t = tpr.PageRankProgram(n_vertices=300)
        machine_of = np.arange(300) % 4
        make = {
            "priority": lambda m, p, s: m.PriorityScheduler(p, s, 0.05, 32),
            "fifo": lambda m, p, s: m.FifoScheduler(p, s, 0.05, 32),
            "multiqueue": lambda m, p, s: m.MultiQueueScheduler(
                p, s, 0.05, machine_of, 8),
        }[kind]
        jsd, tsd = make(jsch, prog_j, js), make(tsch, prog_t, ts)
        jp, tp = jnp.asarray(prio), torch.from_numpy(prio)
        jst, tst = jsd.init(jp), tsd.init(tp)
        rng = np.random.default_rng(6)
        for _ in range(4):
            jm, jst = jsd.select(jst, jp)
            tm, tst = tsd.select(tst, tp)
            np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
            res = rng.random(300).astype(np.float32) * 0.1
            jp, jst = jsd.reschedule(jst, jp, jm, jnp.asarray(res))
            tp, tst = tsd.reschedule(tst, tp, tm, torch.from_numpy(res))
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                       rtol=1e-6)
            assert bool(jsd.done(jst, jp)) == bool(tsd.done(tst, tp))


class TestPrimitives:
    def test_reseed_scopes_and_marker_wave_equal(self):
        js = jgen.power_law_graph(120, 3, seed=8)
        ts = tgen.power_law_graph(120, 3, seed=8, device="cpu")
        rng = np.random.default_rng(1)
        prio = rng.random(120).astype(np.float32)
        touched = rng.random(120) < 0.05
        emask = rng.random(ts.n_edges) < 0.9
        jp, jscope = jsch.reseed_scopes(
            jnp.asarray(prio), jnp.asarray(touched), jnp.asarray(js.senders),
            jnp.asarray(js.receivers), jnp.asarray(emask), 120, 0.7)
        t = ts.device_arrays()
        tp, tscope = tsch.reseed_scopes(
            torch.from_numpy(prio), torch.from_numpy(touched), t["senders"],
            t["receivers"], torch.from_numpy(emask), 120, 0.7)
        np.testing.assert_array_equal(np.asarray(jscope), tscope.numpy())
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        done = rng.random(120) < 0.5
        jf, jpend = jsch.marker_wave(jnp.asarray(touched), jnp.asarray(done),
                                     js)
        tf, tpend = tsch.marker_wave(torch.from_numpy(touched),
                                     torch.from_numpy(done), ts)
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
        np.testing.assert_array_equal(np.asarray(jpend), tpend.numpy())

    def test_traffic_accounting_equal(self, pagerank_graphs):
        jg, tg = pagerank_graphs
        jb = JBSP(jpr.PageRankProgram(n_vertices=260), jg)
        tb = BSPEngine(tpr.PageRankProgram(n_vertices=260), tg, device="cpu")
        assert int(jb.message_bytes_per_step(jb.init(jg))) == \
            int(tb.message_bytes_per_step(tb.init(tg)))
        jd = JDynamic(jpr.PageRankProgram(n_vertices=260), jg,
                      pipeline_length=64)
        td = DynamicEngine(tpr.PageRankProgram(n_vertices=260), tg,
                           pipeline_length=64, device="cpu")
        assert int(jd.active_gather_bytes(jd.init(jg))) == \
            int(td.active_gather_bytes(td.init(tg)))

    @pytest.mark.parametrize("kind", ["src_copy", "degree_normalized_src"])
    def test_fused_registry_kinds_match_dense(self, kind):
        """A program declaring ``kind`` runs the fused path to the same
        fixed point as its dense gather (within 1e-5)."""
        from repro_torch.core.update import (ApplyOut, FusedGather,
                                             VertexProgram)

        class Smooth(VertexProgram):
            def gather(self, ctx):
                x = ctx.src["x"]
                if kind == "degree_normalized_src":
                    x = x / torch.clamp(ctx.src_deg.float(), min=1.0)[:, None]
                return x

            def fused_gather(self):
                return FusedGather(kind, feature=lambda v: v["x"])

            def apply(self, v, acc, glob=None):
                new = 0.5 * v["b"] + 0.5 * acc / (1.0 + acc.abs().sum(
                    -1, keepdim=True))
                return ApplyOut({"x": new, "b": v["b"]},
                                (new - v["x"]).abs().sum(-1))

        st = tgen.power_law_graph(200, 4, seed=3, device="cpu")
        rng = np.random.default_rng(0)
        b = torch.from_numpy(rng.random((200, 2)).astype(np.float32))
        from repro_torch.core.graph import DataGraph
        g = DataGraph.build(st, {"x": torch.zeros(200, 2), "b": b})
        out = {}
        for fused in (True, False):
            e = ChromaticEngine(Smooth(), g, tolerance=1e-7,
                                use_fused=fused, device="cpu")
            assert e.use_fused == fused
            out[fused] = e.run(e.init(g), max_steps=80)[0]
        diff = (out[True].graph.vertex_data["x"]
                - out[False].graph.vertex_data["x"]).abs().max()
        assert float(diff) <= TOL
