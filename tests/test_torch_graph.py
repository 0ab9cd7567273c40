"""The port's substrate against the JAX package: structure, generators,
colorings, segment ops and conversion.

Host-side arrays (structure, block offsets, generator outputs, colorings)
must be exactly equal.  Float segment ops are held to 1e-6 relative: both
packages sum in edge order, so they agree to the last bit in practice, and
1e-6 leaves room only for a different summation order, not a wrong sum.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coloring as jcol
from repro.core import graph as jgraph
from repro.core.consistency import Consistency as JConsistency
from repro.graphs import generators as jgen
from repro_torch.core import coloring as tcol
from repro_torch.core import graph as tgraph
from repro_torch.core.consistency import Consistency
from repro_torch.core.convert import data_graph_from_numpy
from repro_torch.graphs import generators as tgen

FLOAT_RTOL = 1e-6
STRUCT_FIELDS = ("senders", "receivers", "reverse_perm", "in_degree",
                 "out_degree")


def _assert_same_structure(js, ts):
    assert js.n_vertices == ts.n_vertices
    for f in STRUCT_FIELDS:
        np.testing.assert_array_equal(getattr(js, f), getattr(ts, f), f)


def _random_edges(seed, n, e):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


class TestStructure:
    @pytest.mark.parametrize("seed,n,e", [(0, 50, 300), (1, 7, 0),
                                          (2, 300, 2000), (3, 1, 4)])
    def test_from_edges_equal(self, seed, n, e):
        s, r = _random_edges(seed, n, e)
        js, jp = jgraph.GraphStructure.from_edges(s, r, n)
        ts, tp = tgraph.GraphStructure.from_edges(s, r, n, device="cpu")
        _assert_same_structure(js, ts)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(js.receiver_offsets(),
                                      ts.receiver_offsets())
        assert js.is_symmetric() == ts.is_symmetric()

    def test_undirected_equal_and_symmetric(self):
        u, v = _random_edges(4, 80, 400)
        keep = u != v
        js, jp = jgraph.GraphStructure.undirected(u[keep], v[keep], 80)
        ts, tp = tgraph.GraphStructure.undirected(u[keep], v[keep], 80,
                                                  device="cpu")
        _assert_same_structure(js, ts)
        np.testing.assert_array_equal(jp, tp)
        assert ts.is_symmetric()
        ts.validate()

    def test_device_arrays_match_host(self):
        ts = tgen.power_law_graph(120, 4, seed=3, device="cpu")
        t = ts.device_arrays()
        for f in STRUCT_FIELDS:
            np.testing.assert_array_equal(t[f].numpy(), getattr(ts, f))
        seg = ts.row_segments()
        ptr = ts.receiver_offsets()
        owns = ptr[1:] > ptr[:-1]
        np.testing.assert_array_equal(seg.row_ids.numpy(),
                                      np.flatnonzero(owns))
        np.testing.assert_array_equal(
            seg.seg_beg.numpy()[seg.row_seg.numpy()[:-1]], ptr[:-1][owns])

    @pytest.mark.parametrize("n,e,hi", [(600, 512, 100), (1000, 5000, 1000),
                                        (10, 0, 10), (300, 1024, 300),
                                        (129, 700, 129)])
    def test_csr_block_offsets_equal(self, n, e, hi):
        rng = np.random.default_rng(n + e)
        recv = np.sort(rng.integers(0, hi, e)).astype(np.int32)
        for rb, eb in ((128, 512), (64, 256)):
            j = jgraph.csr_block_offsets(recv, n, rb, eb)
            t = tgraph.csr_block_offsets(recv, n, rb, eb)
            for a, b in zip(j, t):
                np.testing.assert_array_equal(a, b)

    def test_csr_blocks_defaults_equal(self):
        js = jgen.power_law_graph(700, 6, seed=2)
        ts = tgen.power_law_graph(700, 6, seed=2, device="cpu")
        for a, b in zip(js.csr_blocks(), ts.csr_blocks()):
            np.testing.assert_array_equal(a, b)


class TestGenerators:
    @pytest.mark.parametrize("n,deg,seed,sym", [(260, 5, 11, True),
                                                (1000, 8, 0, True),
                                                (500, 3, 7, False)])
    def test_power_law_equal(self, n, deg, seed, sym):
        _assert_same_structure(
            jgen.power_law_graph(n, deg, seed=seed, symmetric=sym),
            tgen.power_law_graph(n, deg, seed=seed, symmetric=sym,
                                 device="cpu"))

    def test_connected_power_law_equal(self):
        _assert_same_structure(
            jgen.connected_power_law_graph(300, seed=5),
            tgen.connected_power_law_graph(300, seed=5, device="cpu"))

    @pytest.mark.parametrize("dims,conn", [((4, 4, 3), 26), ((5, 3, 2), 6),
                                           ((6, 6, 6), 26)])
    def test_grid3d_equal(self, dims, conn):
        _assert_same_structure(jgen.grid3d_graph(*dims, conn),
                               tgen.grid3d_graph(*dims, conn, device="cpu"))


class TestColoring:
    @pytest.fixture(scope="class")
    def graphs(self):
        return [(jgen.power_law_graph(400, 6, seed=s),
                 tgen.power_law_graph(400, 6, seed=s, device="cpu"))
                for s in (0, 1)] + [
                (jgen.grid3d_graph(5, 5, 4, 26),
                 tgen.grid3d_graph(5, 5, 4, 26, device="cpu"))]

    def test_greedy_and_distance2_equal(self, graphs):
        for js, ts in graphs:
            np.testing.assert_array_equal(jcol.greedy_coloring(js),
                                          tcol.greedy_coloring(ts))
            c2 = tcol.distance2_coloring(ts)
            np.testing.assert_array_equal(jcol.distance2_coloring(js), c2)
            assert tcol.verify_coloring(ts, c2, 2)

    @pytest.mark.parametrize("name", ["VERTEX", "EDGE", "FULL"])
    def test_coloring_for_equal(self, graphs, name):
        for js, ts in graphs:
            jc = jcol.coloring_for(js, getattr(JConsistency, name))
            tc = tcol.coloring_for(ts, getattr(Consistency, name))
            np.testing.assert_array_equal(jc, tc)
            radius = getattr(Consistency, name).exclusion_radius
            assert tcol.verify_coloring(ts, tc, radius) \
                == jcol.verify_coloring(js, jc, radius)

    def test_bipartite_found(self):
        u = np.arange(0, 20, 2)
        v = np.arange(1, 21, 2)
        ts, _ = tgraph.GraphStructure.undirected(u, v, 20, device="cpu")
        js, _ = jgraph.GraphStructure.undirected(u, v, 20)
        np.testing.assert_array_equal(jcol.bipartite_coloring(js),
                                      tcol.bipartite_coloring(ts))


class TestSegmentOps:
    @pytest.mark.parametrize("combiner", ["sum", "mean", "max", "min"])
    @pytest.mark.parametrize("shape", [(), (3,)])
    def test_segment_combine_equal(self, combiner, shape):
        rng = np.random.default_rng(9)
        n, e = 40, 300
        recv = np.sort(rng.integers(0, n - 5, e)).astype(np.int32)  # empties
        msgs = rng.normal(size=(e,) + shape).astype(np.float32)
        j = np.asarray(jgraph.segment_combine(
            jnp.asarray(msgs), jnp.asarray(recv), n, combiner))
        t = tgraph.segment_combine(torch.from_numpy(msgs),
                                   torch.from_numpy(recv), n, combiner)
        np.testing.assert_allclose(t.numpy(), j, rtol=FLOAT_RTOL)

    def test_segment_sum_through_kernel_path_equal(self):
        """With row segments the sum goes through the segment-sum
        dispatch."""
        ts = tgen.power_law_graph(300, 5, seed=4, device="cpu")
        js = jgen.power_law_graph(300, 5, seed=4)
        msgs = np.random.default_rng(1).normal(
            size=(ts.n_edges, 4)).astype(np.float32)
        t = tgraph.segment_combine(
            torch.from_numpy(msgs), ts.device_arrays()["receivers"],
            ts.n_vertices, "sum", segments=ts.row_segments())
        j = jgraph.segment_combine(jnp.asarray(msgs),
                                   jnp.asarray(js.receivers), js.n_vertices,
                                   "sum", receivers_np=js.receivers)
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   rtol=FLOAT_RTOL, atol=1e-6)

    @pytest.mark.parametrize("direction", ["out", "in", "both"])
    def test_scatter_to_neighbors_equal(self, direction):
        js = jgen.power_law_graph(150, 4, seed=6, symmetric=False)
        ts = tgen.power_law_graph(150, 4, seed=6, symmetric=False,
                                  device="cpu")
        vals = np.random.default_rng(2).random(150).astype(np.float32)
        j = jgraph.scatter_to_neighbors(jnp.asarray(vals), js, direction)
        t = tgraph.scatter_to_neighbors(torch.from_numpy(vals), ts,
                                        direction)
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   rtol=FLOAT_RTOL)

    def test_gather_scope_equal(self):
        from repro.apps.pagerank import make_pagerank_graph as jmk
        from repro_torch.apps.pagerank import make_pagerank_graph as tmk
        jg = jmk(jgen.power_law_graph(90, 4, seed=1))
        tg = tmk(tgen.power_law_graph(90, 4, seed=1, device="cpu"))
        for a, b in zip(jgraph.gather_scope(jg), tgraph.gather_scope(tg)):
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              b[k].numpy())

    def test_edge_ctx_equal(self):
        """Every view of the (lazily gathered) edge context equals the JAX
        package's, on a directed graph where some reverse edges are absent
        (their ``rev_edata`` rows are zeros)."""
        from repro.core.update import edge_ctx as jctx
        from repro_torch.core.update import edge_ctx as tctx
        js = jgen.power_law_graph(120, 4, seed=4, symmetric=False)
        ts = tgen.power_law_graph(120, 4, seed=4, symmetric=False,
                                  device="cpu")
        assert not ts.is_symmetric()
        rng = np.random.default_rng(5)
        vdata = {"x": rng.random((120, 3)).astype(np.float32)}
        edata = {"m": rng.random((ts.n_edges, 2)).astype(np.float32)}
        j = jctx(jgraph.DataGraph.build(
            js, {k: jnp.asarray(v) for k, v in vdata.items()},
            {k: jnp.asarray(v) for k, v in edata.items()}))
        t = tctx(tgraph.DataGraph.build(
            ts, {k: torch.from_numpy(v) for k, v in vdata.items()},
            {k: torch.from_numpy(v) for k, v in edata.items()}))
        for f in ("edata", "rev_edata", "src", "dst"):
            a, b = getattr(j, f), getattr(t, f)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              b[k].numpy(), f)
        for f in ("src_deg", "dst_deg"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f).numpy(), f)


class TestConvert:
    def test_data_graph_from_numpy(self):
        from repro.apps.lbp import make_mrf_graph
        js = jgen.grid3d_graph(3, 3, 2, 26)
        jg = make_mrf_graph(js, n_states=3, seed=2)
        arrays = {"n_vertices": js.n_vertices,
                  **{f: np.asarray(getattr(js, f)) for f in STRUCT_FIELDS}}
        tg = data_graph_from_numpy(
            arrays, {k: np.asarray(v) for k, v in jg.vertex_data.items()},
            {k: np.asarray(v) for k, v in jg.edge_data.items()},
            device="cpu")
        _assert_same_structure(js, tg.structure)
        for k, v in jg.vertex_data.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          tg.vertex_data[k].numpy())
        for k, v in jg.edge_data.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          tg.edge_data[k].numpy())


class TestGuards:
    def test_port_imports_neither_jax_nor_repro(self):
        """Import every module of the port in a fresh interpreter; neither
        ``jax`` nor any module of the JAX package may load."""
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        code = (
            "import pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    __import__(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules "
            "if m.startswith('repro_torch')]))\n")
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout.strip()) >= 20

    def test_cuda_requested_without_gpu_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        from repro_torch.apps.pagerank import (PageRankProgram,
                                               make_pagerank_graph)
        from repro_torch.core.chromatic import ChromaticEngine
        from repro_torch.kernels.gas.ops import EdgeSet
        with pytest.raises(RuntimeError, match="cuda"):
            tgen.power_law_graph(50, 4, seed=0)
        with pytest.raises(RuntimeError, match="cuda"):
            EdgeSet.build(np.zeros(2, np.int32), np.zeros(2, np.int32), 3)
        ts = tgen.power_law_graph(50, 4, seed=0, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            ChromaticEngine(PageRankProgram(n_vertices=50),
                            make_pagerank_graph(ts))
