"""The port's ALS, CoEM, sequential engine and simulated cluster against the
JAX package's, on identical seeded inputs.

Generators: the bipartite, ALS and CoEM builders give arrays equal to the
JAX package's for the same seed (the port computes the planted ratings in
chunks and draws CoEM's co-occurrences in one vectorised call).  Programs:
gather and apply outputs within 1e-5 of the JAX package's, each fused
declaration equal to its dense gather.  ALS under ``ChromaticEngine``: one
sweep equals an independent numpy solve of each vertex's normal equations
within 1e-5 (the JAX package's own fused-vs-dense chromatic ALS test is
red, 3.7e-3 apart after 40 steps, so the port is held to the oracle and to
the JAX engine only over 1-3 sweeps).  ``SequentialEngine``: equal to the
JAX package's on the same schedule, and the mirrors of
tests/test_serializability.py.  ``SimulatedCluster``: the same modelled
times and bytes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import als as jals
from repro.apps import coem as jcoem
from repro.apps import lbp as jlbp
from repro.apps import pagerank as jpr
from repro.core.chromatic import ChromaticEngine as JChromatic
from repro.core.distributed import ClusterModel as JClusterModel
from repro.core.distributed import SimulatedCluster as JSimulatedCluster
from repro.core.sequential import SequentialEngine as JSequential
from repro.graphs import generators as jgen
from repro_torch.apps import als as tals
from repro_torch.apps import coem as tcoem
from repro_torch.apps import lbp as tlbp
from repro_torch.apps import pagerank as tpr
from repro_torch.core import (ChromaticEngine, ClusterModel, Consistency,
                              DynamicEngine, SequentialEngine,
                              SimulatedCluster)
from repro_torch.core.coloring import coloring_for, verify_coloring
from repro_torch.core.engine_base import apply_phase
from repro_torch.core.graph import GraphStructure
from repro_torch.core.update import edge_ctx
from repro_torch.graphs import generators as tgen
from repro_torch.kernels.gas.ops import EdgeSet

TOL = 1e-5
STRUCT = ("n_vertices", "senders", "receivers", "reverse_perm", "in_degree",
          "out_degree")


def _same_structure(js, ts):
    for k in STRUCT:
        np.testing.assert_array_equal(np.asarray(getattr(js, k)),
                                      np.asarray(getattr(ts, k)), err_msg=k)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _bip_colors(n_left, n):
    return (np.arange(n) >= n_left).astype(np.int32)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

class TestGenerators:
    @pytest.mark.parametrize("args", [(50, 20, 300, 0), (200, 37, 4000, 5),
                                      (7, 3, 40, 2)])
    def test_bipartite_graph_equal(self, args):
        n_l, n_r, n_e, seed = args
        js, jperm = jgen.bipartite_graph(n_l, n_r, n_e, seed=seed)
        ts, tperm = tgen.bipartite_graph(n_l, n_r, n_e, seed=seed,
                                         device="cpu")
        _same_structure(js, ts)
        np.testing.assert_array_equal(jperm, tperm)

    @pytest.mark.parametrize("chunk", [7, 1 << 22])
    def test_make_als_graph_equal(self, monkeypatch, chunk):
        """Chunked planted ratings, bit for bit (a chunk of 7 edges cuts
        every row of the einsum into many calls)."""
        monkeypatch.setattr(tals, "RATING_CHUNK", chunk)
        jg, ji = jals.make_als_graph(300, 50, 4000, d=5, seed=3)
        tg, ti = tals.make_als_graph(300, 50, 4000, d=5, seed=3,
                                     device="cpu")
        _same_structure(jg.structure, tg.structure)
        for k in ("rating", "train"):
            np.testing.assert_array_equal(np.asarray(jg.edge_data[k]),
                                          _np(tg.edge_data[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(jg.vertex_data["factor"]),
                                      _np(tg.vertex_data["factor"]))
        for k in ("user_of", "movie_of"):
            np.testing.assert_array_equal(ji[k], ti[k])
        for train in (True, False):
            assert abs(jals.als_rmse(jg, train)
                       - tals.als_rmse(tg, train, chunk=chunk)) <= 1e-6

    @pytest.mark.parametrize("args", [(300, 80, 5000, 7), (100, 30, 2000, 40),
                                      (60, 500, 900, 3)])
    def test_make_coem_graph_equal(self, args):
        """Vectorised co-occurrence draws; (100, 30, 2000, 40) leaves some
        types without contexts, so the empty-pool fallback draws too."""
        jg, ji = jcoem.make_coem_graph(*args, seed=2)
        tg, ti = tcoem.make_coem_graph(*args, seed=2, device="cpu")
        _same_structure(jg.structure, tg.structure)
        np.testing.assert_array_equal(np.asarray(jg.edge_data["w"]),
                                      _np(tg.edge_data["w"]))
        for k in ("p", "seed"):
            np.testing.assert_array_equal(np.asarray(jg.vertex_data[k]),
                                          _np(tg.vertex_data[k]), err_msg=k)
        for k in ("true_np", "true_ctx"):
            np.testing.assert_array_equal(ji[k], ti[k])
        assert jcoem.coem_accuracy(jg, ji) == tcoem.coem_accuracy(tg, ti)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def als_graphs():
    jg, _ = jals.make_als_graph(120, 40, 1500, d=4, seed=1)
    tg, _ = tals.make_als_graph(120, 40, 1500, d=4, seed=1, device="cpu")
    return jg, tg


@pytest.fixture(scope="module")
def coem_graphs():
    jg, ji = jcoem.make_coem_graph(150, 50, 1200, n_types=6, seed=4)
    tg, ti = tcoem.make_coem_graph(150, 50, 1200, n_types=6, seed=4,
                                   device="cpu")
    return jg, ji, tg, ti


def _jax_dense_acc(prog, g):
    """The JAX package's dense gather ⊕ sum on the whole graph."""
    from repro.core.engine_base import edge_ctx as jedge_ctx
    from repro.core.graph import segment_combine as jsegment_combine
    st = g.structure
    msgs = prog.gather(jedge_ctx(g))
    return jsegment_combine(msgs, jnp.asarray(st.receivers), st.n_vertices,
                            prog.combiner)


def _torch_dense_acc(prog, g):
    from repro_torch.core.graph import segment_combine
    st = g.structure
    return segment_combine(prog.gather(edge_ctx(g)),
                           st.device_arrays()["receivers"], st.n_vertices,
                           prog.combiner, segments=st.row_segments())


def _torch_fused_acc(prog, g):
    from repro_torch.core.tree import tree_unflatten
    from repro_torch.core.update import (fused_edge_weight,
                                         fused_gather_leaves)
    from repro_torch.kernels.gas.ops import gather_combine
    st = g.structure
    es = EdgeSet.build(st.senders, st.receivers, st.n_vertices, device="cpu")
    leaves, treedef = fused_gather_leaves(prog)
    out = []
    for leaf in leaves:
        feat = leaf.feature(g.vertex_data)
        w = fused_edge_weight(leaf, g.edge_data, st.n_edges)
        a = gather_combine(feat.reshape(st.n_vertices, -1), w, es)
        out.append(a.reshape(feat.shape))
    return tree_unflatten(treedef, out)


class TestPrograms:
    def test_als_gather_apply_match_jax(self, als_graphs):
        jg, tg = als_graphs
        jp, tp = jals.ALSProgram(4), tals.ALSProgram(4)
        jacc = _jax_dense_acc(jp, jg)
        tacc = _torch_dense_acc(tp, tg)
        for k in ("xxt", "rx"):
            np.testing.assert_allclose(_np(tacc[k]), np.asarray(jacc[k]),
                                       atol=TOL, rtol=0, err_msg=k)
        jout = jp.apply(jg.vertex_data, jacc)
        tout = tp.apply(tg.vertex_data, tacc)
        np.testing.assert_allclose(_np(tout.vertex_data["factor"]),
                                   np.asarray(jout.vertex_data["factor"]),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(_np(tout.residual),
                                   np.asarray(jout.residual), atol=TOL,
                                   rtol=0)

    def test_coem_gather_apply_match_jax(self, coem_graphs):
        jg, _, tg, _ = coem_graphs
        jp, tp = jcoem.CoEMProgram(6), tcoem.CoEMProgram(6)
        jacc = _jax_dense_acc(jp, jg)
        tacc = _torch_dense_acc(tp, tg)
        np.testing.assert_allclose(_np(tacc), np.asarray(jacc), atol=TOL,
                                   rtol=0)
        jout = jp.apply(jg.vertex_data, jacc)
        tout = tp.apply(tg.vertex_data, tacc)
        for k in ("p", "seed"):
            np.testing.assert_allclose(_np(tout.vertex_data[k]),
                                       np.asarray(jout.vertex_data[k]),
                                       atol=TOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(_np(tout.residual),
                                   np.asarray(jout.residual), atol=TOL,
                                   rtol=0)

    @pytest.mark.parametrize("app", ["als", "coem"])
    def test_fused_declaration_equals_dense_gather(self, app, als_graphs,
                                                   coem_graphs):
        if app == "als":
            g, prog = als_graphs[1], tals.ALSProgram(4)
        else:
            g, prog = coem_graphs[2], tcoem.CoEMProgram(6)
        dense = _torch_dense_acc(prog, g)
        fused = _torch_fused_acc(prog, g)
        if app == "coem":
            dense, fused = {"p": dense}, {"p": fused}
        for k in dense:
            np.testing.assert_allclose(_np(fused[k]), _np(dense[k]),
                                       atol=TOL, rtol=0, err_msg=k)

    @pytest.mark.parametrize("app", ["als", "coem"])
    def test_fused_phase_equals_dense_phase(self, app, als_graphs,
                                            coem_graphs):
        if app == "als":
            g, prog = als_graphs[1], tals.ALSProgram(4)
        else:
            g, prog = coem_graphs[2], tcoem.CoEMProgram(6)
        st = g.structure
        es = EdgeSet.build(st.senders, st.receivers, st.n_vertices,
                           device="cpu")
        mask = torch.from_numpy(np.arange(st.n_vertices) % 3 == 0)
        gd, rd, _ = apply_phase(prog, g, mask, None)
        gf, rf, _ = apply_phase(prog, g, mask, None, edges=es)
        for k, v in gd.vertex_data.items():
            np.testing.assert_allclose(_np(gf.vertex_data[k]), _np(v),
                                       atol=TOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(_np(rf), _np(rd), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# ALS under the chromatic engine: the numpy oracle, and the JAX engine
# ---------------------------------------------------------------------------

def _als_oracle_sweep(st, x, rating, train, n_users, reg):
    """One chromatic ALS sweep in float64 numpy: users (color 0) solve
    their normal equations against the movies' factors, then movies
    against the users' new ones."""
    x = x.astype(np.float64).copy()
    d = x.shape[1]
    s, r = st.senders, st.receivers
    for side in (np.arange(n_users), np.arange(n_users, st.n_vertices)):
        new = {}
        for v in side:
            e = np.flatnonzero(r == v)
            xs = x[s[e]]
            w = train[e]
            A = (w[:, None, None] * xs[:, :, None] * xs[:, None, :]).sum(0) \
                + reg * np.eye(d)
            b = (w[:, None] * rating[e][:, None] * xs).sum(0)
            new[v] = np.linalg.solve(A, b)
        for v, f in new.items():
            x[v] = f
    return x


class TestALSChromatic:
    @pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
    def test_one_sweep_equals_normal_equations(self, als_graphs, fused):
        _, tg = als_graphs
        st = tg.structure
        prog = tals.ALSProgram(4)
        colors = _bip_colors(120, st.n_vertices)
        eng = ChromaticEngine(prog, tg, colors=colors, tolerance=1e-9,
                              use_fused=fused, device="cpu")
        s = eng.step(eng.init(tg))
        want = _als_oracle_sweep(
            st, _np(tg.vertex_data["factor"]), _np(tg.edge_data["rating"]),
            _np(tg.edge_data["train"]), 120, prog.reg)
        np.testing.assert_allclose(_np(s.graph.vertex_data["factor"]), want,
                                   atol=TOL, rtol=0)

    def test_matches_jax_over_three_sweeps(self, als_graphs):
        jg, tg = als_graphs
        colors = _bip_colors(120, tg.n_vertices)
        je = JChromatic(jals.ALSProgram(4), jg, colors=colors,
                        tolerance=1e-3)
        te = ChromaticEngine(tals.ALSProgram(4), tg, colors=colors,
                             tolerance=1e-3, device="cpu")
        js, ts = je.init(jg), te.init(tg)
        for _ in range(3):
            js, ts = je.step(js), te.step(ts)
            np.testing.assert_allclose(
                _np(ts.graph.vertex_data["factor"]),
                np.asarray(js.graph.vertex_data["factor"]), atol=TOL, rtol=0)
            assert int(js.total_updates) == int(ts.total_updates)

    def test_coem_matches_jax(self, coem_graphs):
        jg, _, tg, _ = coem_graphs
        colors = _bip_colors(150, tg.n_vertices)
        je = JChromatic(jcoem.CoEMProgram(6), jg, colors=colors,
                        tolerance=1e-4)
        te = ChromaticEngine(tcoem.CoEMProgram(6), tg, colors=colors,
                             tolerance=1e-4, device="cpu")
        js, _ = je.run(je.init(jg), max_steps=30)
        ts, _ = te.run(te.init(tg), max_steps=30)
        np.testing.assert_allclose(_np(ts.graph.vertex_data["p"]),
                                   np.asarray(js.graph.vertex_data["p"]),
                                   atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# SequentialEngine (paper Alg. 2)
# ---------------------------------------------------------------------------

def _random_graph(n, avg_deg, seed):
    st = tgen.power_law_graph(n, avg_degree=avg_deg, seed=seed, device="cpu")
    if st.n_edges == 0:  # degenerate draw: add one edge
        st, _ = GraphStructure.undirected([0], [1], n, device="cpu")
    return st


class TestSequential:
    @pytest.mark.parametrize("app", ["pagerank", "lbp"])
    def test_equals_jax_on_the_same_schedule(self, app):
        js = jgen.power_law_graph(40, avg_degree=4, seed=5)
        ts = tgen.power_law_graph(40, avg_degree=4, seed=5, device="cpu")
        if app == "pagerank":
            jg, tg = jpr.make_pagerank_graph(js), tpr.make_pagerank_graph(ts)
            jp, tp = jpr.PageRankProgram(0.15, 40), tpr.PageRankProgram(0.15,
                                                                        40)
            leaves = ("rank",)
        else:
            jg, tg = jlbp.make_mrf_graph(js, 3, seed=2), \
                tlbp.make_mrf_graph(ts, 3, seed=2)
            jp, tp = jlbp.LoopyBPProgram(3, 0.5), tlbp.LoopyBPProgram(3, 0.5)
            leaves = ("belief",)
        jseq = JSequential(jp, jg, tolerance=1e-9)
        tseq = SequentialEngine(tp, tg, tolerance=1e-9)
        sched = np.random.default_rng(0).integers(0, 40, 120)
        for v in sched:
            rj = jseq.execute_vertex(int(v))
            rt = tseq.execute_vertex(int(v))
            assert abs(rj - rt) <= TOL
        for k in leaves:
            np.testing.assert_allclose(_np(tseq.vdata[k]), jseq.vdata[k],
                                       atol=TOL, rtol=0)
        if app == "lbp":
            np.testing.assert_allclose(_np(tseq.edata["msg"]),
                                       jseq.edata["msg"], atol=TOL, rtol=0)
        np.testing.assert_allclose(tseq.prio, jseq.prio, atol=TOL, rtol=0)
        np.testing.assert_array_equal(tseq.update_count, jseq.update_count)

    def test_run_round_robin_and_priority_match_jax(self):
        js = jgen.power_law_graph(30, avg_degree=3, seed=9)
        ts = tgen.power_law_graph(30, avg_degree=3, seed=9, device="cpu")
        jg, tg = jpr.make_pagerank_graph(js), tpr.make_pagerank_graph(ts)
        for run in ("run_round_robin", "run_priority"):
            jseq = JSequential(jpr.PageRankProgram(0.15, 30), jg,
                               tolerance=1e-6)
            tseq = SequentialEngine(tpr.PageRankProgram(0.15, 30), tg,
                                    tolerance=1e-6)
            assert getattr(jseq, run)() == getattr(tseq, run)()
            np.testing.assert_allclose(_np(tseq.vdata["rank"]),
                                       jseq.vdata["rank"], atol=TOL, rtol=0)

    @pytest.mark.parametrize("seed", [0, 17, 4242])
    @pytest.mark.parametrize("n", [10, 60])
    def test_chromatic_equals_serial_schedule_pagerank(self, n, seed):
        """One chromatic sweep == the serial schedule (color asc, id
        asc)."""
        st = _random_graph(n, 4, seed)
        g = tpr.make_pagerank_graph(st)
        prog = tpr.PageRankProgram(0.15, st.n_vertices)
        eng = ChromaticEngine(prog, g, tolerance=1e-9, device="cpu")
        s = eng.step(eng.init(g))
        seq = SequentialEngine(prog, g, tolerance=1e-9)
        colors = _np(eng.colors)
        for v in np.lexsort((np.arange(n), colors)):
            if seq.prio[v] > seq.tolerance:
                seq.execute_vertex(int(v))
        np.testing.assert_allclose(_np(s.graph.vertex_data["rank"]),
                                   _np(seq.vdata["rank"]), rtol=1e-5,
                                   atol=1e-7)

    @pytest.mark.parametrize("seed,k_states", [(3, 2), (91, 3), (505, 4)])
    def test_chromatic_equals_serial_schedule_lbp(self, seed, k_states):
        """Edge-data writes (BP messages) also serialize correctly."""
        st = _random_graph(20, 3, seed)
        g = tlbp.make_mrf_graph(st, n_states=k_states, seed=seed % 97)
        prog = tlbp.LoopyBPProgram(k_states, smoothing=0.5)
        eng = ChromaticEngine(prog, g, tolerance=1e-9, device="cpu")
        s = eng.step(eng.init(g))
        seq = SequentialEngine(prog, g, tolerance=1e-9)
        colors = _np(eng.colors)
        for v in np.lexsort((np.arange(st.n_vertices), colors)):
            if seq.prio[v] > seq.tolerance:
                seq.execute_vertex(int(v))
        np.testing.assert_allclose(_np(s.graph.vertex_data["belief"]),
                                   _np(seq.vdata["belief"]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(s.graph.edge_data["msg"]),
                                   _np(seq.edata["msg"]), rtol=1e-4,
                                   atol=1e-5)

    @pytest.mark.parametrize("seed,pipeline", [(1, 1), (23, 4), (777, 16)])
    def test_dynamic_engine_is_serializable(self, seed, pipeline):
        """Every dynamic-engine step's active set admits a serial order: it
        is an independent set, and replaying it serially reproduces the
        step."""
        st = _random_graph(40, 4, seed)
        g = tpr.make_pagerank_graph(st)
        prog = tpr.PageRankProgram(0.15, st.n_vertices)
        eng = DynamicEngine(prog, g, pipeline_length=pipeline,
                            serializable=True, tolerance=1e-9, device="cpu")
        s = eng.init(g)
        seq = SequentialEngine(prog, g, tolerance=1e-9)
        for _ in range(5):
            prev = _np(s.update_count).copy()
            s = eng.step(s)
            executed = np.nonzero(_np(s.update_count) - prev)[0]
            on = np.zeros(st.n_vertices, bool)
            on[executed] = True
            assert not (on[st.senders] & on[st.receivers]
                        & (st.senders != st.receivers)).any()
            seq.execute_schedule(executed)
            np.testing.assert_allclose(_np(s.graph.vertex_data["rank"]),
                                       _np(seq.vdata["rank"]), rtol=1e-5,
                                       atol=1e-7)

    @pytest.mark.parametrize("seed", [2, 31, 999])
    def test_priority_order_respected_at_pipeline_1(self, seed):
        st = _random_graph(30, 3, seed)
        g = tpr.make_pagerank_graph(st)
        prog = tpr.PageRankProgram(0.15, st.n_vertices)
        eng = DynamicEngine(prog, g, pipeline_length=1, tolerance=1e-9,
                            device="cpu")
        s = eng.init(g)
        seq = SequentialEngine(prog, g, tolerance=1e-9)
        for _ in range(8):
            if float(s.prio.max()) <= 1e-9:
                break
            s = eng.step(s)
            seq.execute_vertex(int(np.argmax(seq.prio)))
        np.testing.assert_allclose(_np(s.graph.vertex_data["rank"]),
                                   _np(seq.vdata["rank"]), rtol=1e-5,
                                   atol=1e-7)

    @pytest.mark.parametrize("model", ["EDGE", "FULL", "VERTEX"])
    def test_coloring_realizes_consistency_model(self, model):
        st = _random_graph(30, 4, 11)
        colors = coloring_for(st, Consistency[model])
        assert verify_coloring(st, colors,
                               Consistency[model].exclusion_radius)
        if model == "VERTEX":
            assert colors.max() == 0


# ---------------------------------------------------------------------------
# the simulated cluster (core/distributed.py)
# ---------------------------------------------------------------------------

class TestSimulatedCluster:
    @pytest.mark.parametrize("method", ["hash", "bfs"])
    def test_costs_equal_jax(self, method):
        js = jgen.power_law_graph(150, avg_degree=5, seed=2)
        ts = tgen.power_law_graph(150, avg_degree=5, seed=2, device="cpu")
        jg, tg = jpr.make_pagerank_graph(js), tpr.make_pagerank_graph(ts)
        model = dict(n_machines=4, stragglers={1: (2, 4, 0.01)})
        je = JChromatic(jpr.PageRankProgram(0.15, 150), jg, tolerance=1e-5)
        te = ChromaticEngine(tpr.PageRankProgram(0.15, 150), tg,
                             colors=np.asarray(je.colors), tolerance=1e-5,
                             device="cpu")
        jc = JSimulatedCluster(je, jg, JClusterModel(**model), method=method)
        tc = SimulatedCluster(te, tg, ClusterModel(**model), method=method)
        np.testing.assert_array_equal(jc.machine_of, tc.machine_of)
        np.testing.assert_array_equal(jc.ghost_count, tc.ghost_count)
        assert jc.vertex_bytes == tc.vertex_bytes
        _, jcosts = jc.run(je.init(jg), max_steps=40, sync_snapshot_at=3,
                           sync_snapshot_capture_s=0.02)
        _, tcosts = tc.run(te.init(tg), max_steps=40, sync_snapshot_at=3,
                           sync_snapshot_capture_s=0.02)
        assert len(jcosts) == len(tcosts) > 4
        for a, b in zip(jcosts, tcosts):
            assert (a.step, a.updates, a.bytes_moved) == \
                (b.step, b.updates, b.bytes_moved)
            assert a.wall_time_s == pytest.approx(b.wall_time_s, rel=1e-12)
            np.testing.assert_array_equal(a.per_machine_updates,
                                          b.per_machine_updates)
            np.testing.assert_array_equal(a.per_machine_bytes,
                                          b.per_machine_bytes)
