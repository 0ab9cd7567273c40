"""The port's kernel dispatch on the CPU (the plain versions of K1, K2, K3)
against the JAX package's functions, through its reference and through
the Pallas kernel in interpret mode.

Tolerance: 2e-5 of the largest magnitude of the expected output, the JAX
package's own kernel bar (tests/test_gas_kernel.py).  The ``cuda`` tests
hold the hand-written kernels to their plain versions on the card and skip
without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gas import ops as jops
from repro.kernels.segsum import ops as jseg
from repro.kernels.segsum import segsum as jsegk
from repro_torch.kernels import build
from repro_torch.kernels.csr import (ROW_SEGMENT, RowSegments,
                                     segment_tables, segmented_row_sum)
from repro_torch.kernels.gas import ops as tops
from repro_torch.kernels.gas.gas import EDGE_BLOCK, ROW_BLOCK
from repro_torch.kernels.segsum import ops as tseg
from repro_torch.kernels.segsum import segsum as tsegk

REL_TOL = 2e-5


def _close(got, want):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(np.asarray(got, np.float64) - want).max() if want.size \
        else 0.0
    assert err <= REL_TOL * scale, (err, scale)


def _edges(rng, n, e, skew):
    if skew:  # power-law receiver degrees: hot rows
        recv = np.minimum((rng.pareto(1.2, e) * 3).astype(np.int64), n - 1)
    else:
        recv = rng.integers(0, n, e)
    return rng.integers(0, n, e).astype(np.int32), \
        np.sort(recv).astype(np.int32)


#: (name, senders, receivers, n) — TestGatherCombine's cases
def _cases():
    rng = np.random.default_rng(0)
    out = [("random", *_edges(rng, 300, 1500, False), 300),
           ("pareto", *_edges(rng, 500, 2600, True), 500),
           ("isolated", np.arange(64, dtype=np.int32),
            np.full(64, 7, np.int32), 200),
           ("empty", np.zeros(0, np.int32), np.zeros(0, np.int32), 50),
           ("self-loop", np.zeros(3, np.int32), np.zeros(3, np.int32), 1)]
    snd = rng.integers(0, 600, EDGE_BLOCK).astype(np.int32)
    recv = np.sort(rng.integers(0, 100, EDGE_BLOCK)).astype(np.int32)
    out.append(("exact-multiple", snd, recv, 600))
    # a hub row longer than ROW_SEGMENT: summed segment by segment
    recv = np.sort(np.concatenate([np.full(2 * ROW_SEGMENT + 77, 9),
                                   rng.integers(0, 60, 300)])).astype(np.int32)
    out.append(("hub", rng.integers(0, 60, recv.size).astype(np.int32),
                recv, 60))
    return out


CASES = _cases()
CASE_IDS = [c[0] for c in CASES]
#: the Pallas interpreter is slow: it sees the small cases only
SMALL = [c for c in CASES if c[0] not in ("pareto", "hub")]


class TestRowSegments:
    def test_tables_cut_rows_into_segments(self):
        long_row = 2 * ROW_SEGMENT + 1
        # rows 0 and 3 own no edge: the tables list rows 1, 2 and 4 only
        recv = np.repeat([1, 2, 4], [3, long_row, 1])
        row_ids, row_seg, seg_beg, seg_row = segment_tables(recv)
        np.testing.assert_array_equal(row_ids, [1, 2, 4])
        np.testing.assert_array_equal(row_seg, [0, 1, 4, 5])
        np.testing.assert_array_equal(seg_row, [1, 2, 2, 2, 4])
        np.testing.assert_array_equal(
            seg_beg, [0, 3, 3 + ROW_SEGMENT, 3 + 2 * ROW_SEGMENT,
                      3 + 2 * ROW_SEGMENT + 1, 4 + 2 * ROW_SEGMENT + 1])

    def test_short_edge_arrays_rejected(self):
        """A kernel reads senders, weights and messages up to the tables'
        edge count: a shorter array is refused before any launch."""
        _, snd, recv, n = CASES[0]
        seg = RowSegments.build(recv, n, "cpu")
        assert seg.n_edges == recv.size
        build.require_edges("senders", torch.zeros(recv.size), seg)
        with pytest.raises(ValueError):
            build.require_edges("senders", torch.zeros(recv.size - 1), seg)

    def test_segmented_sum_order(self):
        """Each segment summed in edge order, then the row's segments in
        order — checked against a float32 loop of exactly that order."""
        rng = np.random.default_rng(2)
        recv = np.sort(np.concatenate([np.full(3 * ROW_SEGMENT + 5, 1),
                                       rng.integers(0, 4, 50)]))
        terms = rng.normal(size=recv.size).astype(np.float32)
        got = segmented_row_sum(torch.from_numpy(terms),
                                torch.from_numpy(recv), 4).numpy()
        ptr = np.searchsorted(recv, np.arange(5))
        for v in range(4):
            total = np.float32(0)
            for beg in range(ptr[v], ptr[v + 1], ROW_SEGMENT):
                part = np.float32(0)
                for x in terms[beg:min(beg + ROW_SEGMENT, ptr[v + 1])]:
                    part = np.float32(part + x)
                total = np.float32(total + part)
            assert got[v] == total


class TestEdgeSet:
    @pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
    def test_fields_equal(self, case):
        _, snd, recv, n = case
        perm = np.arange(snd.size, dtype=np.int32)[::-1].copy()
        j = jops.EdgeSet.build(snd, recv, n, perm=perm)
        t = tops.EdgeSet.build(snd, recv, n, perm=perm, device="cpu")
        assert (j.n_vertices, j.n_edges, j.max_eblk, j.n_row_blocks) == \
            (t.n_vertices, t.n_edges, t.max_eblk, t.n_row_blocks)
        for f in ("senders", "receivers", "eblk_start", "n_eblk",
                  "block_counts", "perm"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          np.asarray(getattr(t, f)), f)
        np.testing.assert_array_equal(
            t.row_ptr, np.searchsorted(recv, np.arange(n + 1)))
        assert int(t.block_counts.sum()) == snd.size

    @pytest.mark.parametrize("n,e,hi", [(600, 512, 100), (1000, 3000, 1000),
                                        (130, 1024, 130), (5, 0, 5)])
    def test_segsum_block_offsets_equal(self, n, e, hi):
        rng = np.random.default_rng(e)
        recv = np.sort(rng.integers(0, hi, e)).astype(np.int32)
        e_pad = -(-e // EDGE_BLOCK) * EDGE_BLOCK
        recv = np.concatenate([recv, np.full(e_pad - e, n + ROW_BLOCK,
                                             np.int32)])
        for a, b in zip(jsegk.block_offsets(recv, n, e_pad),
                        tsegk.block_offsets(recv, n, e_pad)):
            np.testing.assert_array_equal(a, b)

    def test_active_row_blocks_equal(self):
        mask = np.random.default_rng(3).random(700) < 0.01
        np.testing.assert_array_equal(
            np.asarray(jops.active_row_blocks(jnp.asarray(mask))),
            tops.active_row_blocks(torch.from_numpy(mask)).numpy())


def _masks(rng, n):
    return {"all": None, "30%": rng.random(n) < 0.3,
            "none": np.zeros(n, bool)}


class TestGatherCombine:
    @pytest.mark.parametrize("d", [1, 16, 128])
    @pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
    def test_plain_matches_jax_ref(self, case, d):
        _, snd, recv, n = case
        rng = np.random.default_rng(d)
        feat = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.normal(size=snd.size).astype(np.float32)
        je = jops.EdgeSet.build(snd, recv, n)
        te = tops.EdgeSet.build(snd, recv, n, device="cpu")
        for mname, mask in _masks(rng, n).items():
            jb = None if mask is None else \
                jops.active_row_blocks(jnp.asarray(mask))
            tb = None if mask is None else \
                tops.active_row_blocks(torch.from_numpy(mask))
            j = jops.gather_combine(jnp.asarray(feat), jnp.asarray(w), je,
                                    block_active=jb)
            t = tops.gather_combine(torch.from_numpy(feat),
                                    torch.from_numpy(w), te, block_active=tb)
            _close(t.numpy(), j)
            if mname == "none":
                assert float(t.abs().sum()) == 0.0

    @pytest.mark.parametrize("case", SMALL, ids=[c[0] for c in SMALL])
    def test_plain_matches_pallas_interpret(self, case):
        _, snd, recv, n = case
        rng = np.random.default_rng(1)
        feat = rng.normal(size=(n, 4)).astype(np.float32)
        w = rng.normal(size=snd.size).astype(np.float32)
        mask = rng.random(n) < 0.5
        je = jops.EdgeSet.build(snd, recv, n)
        te = tops.EdgeSet.build(snd, recv, n, device="cpu")
        j = jops.gather_combine(
            jnp.asarray(feat), jnp.asarray(w), je,
            block_active=jops.active_row_blocks(jnp.asarray(mask)),
            interpret=True)
        t = tops.gather_combine(
            torch.from_numpy(feat), torch.from_numpy(w), te,
            block_active=tops.active_row_blocks(torch.from_numpy(mask)))
        _close(t.numpy(), j)

    def test_weights_padded_or_not(self):
        _, snd, recv, n = CASES[0]
        te = tops.EdgeSet.build(snd, recv, n, device="cpu")
        feat = torch.ones((n, 2))
        w = torch.ones(snd.size)
        a = tops.gather_combine(feat, w, te)
        b = tops.gather_combine(
            feat, torch.nn.functional.pad(w, (0, te.senders.shape[0]
                                              - snd.size)), te)
        assert torch.equal(a, b)
        with pytest.raises(ValueError):
            tops.gather_combine(feat, w[:-1], te)


class TestScatterReschedule:
    @pytest.mark.parametrize("weighted", [False, True])
    @pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
    def test_plain_matches_jax_ref(self, case, weighted):
        _, snd, recv, n = case
        rng = np.random.default_rng(7)
        contrib = np.where(rng.random(n) < 0.5, rng.random(n),
                           0).astype(np.float32)
        prio = rng.random(n).astype(np.float32)
        je = jops.EdgeSet.build(snd, recv, n)
        te = tops.EdgeSet.build(snd, recv, n, device="cpu")
        w = rng.random(snd.size).astype(np.float32) if weighted else None
        for consume in (rng.random(n) < 0.3, np.ones(n, bool)):
            j = jops.scatter_reschedule(
                jnp.asarray(contrib), jnp.asarray(prio), jnp.asarray(consume),
                je, None if w is None else jnp.asarray(w))
            t = tops.scatter_reschedule(
                torch.from_numpy(contrib), torch.from_numpy(prio),
                torch.from_numpy(consume), te,
                None if w is None else torch.from_numpy(w))
            _close(t.numpy(), j)

    @pytest.mark.parametrize("case", [CASES[1], CASES[5]],
                             ids=[CASE_IDS[1], CASE_IDS[5]])
    def test_plain_matches_pallas_interpret(self, case):
        _, snd, recv, n = case
        rng = np.random.default_rng(8)
        contrib = np.where(rng.random(n) < 0.3, rng.random(n),
                           0).astype(np.float32)
        prio = rng.random(n).astype(np.float32)
        consume = rng.random(n) < 0.4
        je = jops.EdgeSet.build(snd, recv, n)
        te = tops.EdgeSet.build(snd, recv, n, device="cpu")
        j = jops.scatter_reschedule(
            jnp.asarray(contrib), jnp.asarray(prio), jnp.asarray(consume),
            je, interpret=True)
        t = tops.scatter_reschedule(
            torch.from_numpy(contrib), torch.from_numpy(prio),
            torch.from_numpy(consume), te)
        _close(t.numpy(), j)


class TestSegSum:
    @pytest.mark.parametrize("d", [1, 5, 16, 128])
    @pytest.mark.parametrize("skew", [False, True])
    def test_plain_matches_jax(self, d, skew):
        rng = np.random.default_rng(d + skew)
        n = 300
        _, recv = _edges(rng, n, 2500, skew)
        msgs = rng.normal(size=(recv.size, d)).astype(np.float32)
        j = jseg.segment_sum_sorted(jnp.asarray(msgs), recv, n)
        t = tseg.segment_sum_sorted(torch.from_numpy(msgs),
                                    torch.from_numpy(recv), n)
        _close(t.numpy(), j)

    def test_plain_matches_pallas_interpret(self):
        rng = np.random.default_rng(4)
        recv = np.sort(np.minimum((rng.pareto(1.2, 1200) * 5)
                                  .astype(np.int32), 99))
        msgs = rng.normal(size=(1200, 16)).astype(np.float32)
        j = jseg.segment_sum_sorted(jnp.asarray(msgs), recv, 100,
                                    interpret=True)
        t = tseg.segment_sum_sorted(torch.from_numpy(msgs),
                                    torch.from_numpy(recv), 100)
        _close(t.numpy(), j)

    def test_empty_rows_and_pads_dropped(self):
        msgs = torch.ones((10, 16))
        recv = torch.tensor([3] * 8 + [10 + ROW_BLOCK] * 2)  # two pads
        out = tseg.segment_sum_sorted(msgs, recv, 10)
        assert float(out[3].sum()) == 8 * 16
        assert float(out.sum()) == 8 * 16

    def test_f64_stays_f64(self):
        msgs = torch.ones((6, 3), dtype=torch.float64)
        out = tseg.segment_sum_sorted(msgs, torch.tensor([0, 0, 1, 1, 1, 4]),
                                      5)
        assert out.dtype == torch.float64
        np.testing.assert_array_equal(out[:, 0].numpy(), [2, 3, 0, 0, 1])


@pytest.mark.cuda
class TestOnCard:
    """The hand-written kernels against their plain versions on the card
    (the CUDA kernels sum in edge order, so they match bit for bit)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("d", [1, 16, 128])
    @pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
    def test_kernels_equal_plain(self, case, d):
        _, snd, recv, n = case
        rng = np.random.default_rng(d)
        feat = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.normal(size=snd.size).astype(np.float32)
        mask = rng.random(n) < 0.3
        contrib = rng.random(n).astype(np.float32)
        prio = rng.random(n).astype(np.float32)
        msgs = rng.normal(size=(snd.size, d)).astype(np.float32)
        out = {}
        for dev in ("cuda", "cpu"):
            es = tops.EdgeSet.build(snd, recv, n, device=dev)
            m = torch.from_numpy(mask).to(dev)
            out[dev] = [
                tops.gather_combine(torch.from_numpy(feat).to(dev),
                                    torch.from_numpy(w).to(dev), es,
                                    block_active=tops.active_row_blocks(m)),
                tops.scatter_reschedule(torch.from_numpy(contrib).to(dev),
                                        torch.from_numpy(prio).to(dev), m,
                                        es, torch.from_numpy(w).to(dev)),
                tseg.segment_sum_sorted(torch.from_numpy(msgs).to(dev),
                                        torch.from_numpy(recv).to(dev), n,
                                        segments=es.segments)]
        for k, p in zip(out["cuda"], out["cpu"]):
            assert torch.equal(k.cpu(), p)

    def test_wrappers_reject_short_edge_arrays(self):
        from repro_torch.kernels.gas.gas import gas_gather_combine_cuda
        from repro_torch.kernels.gas.scatter import \
            gas_scatter_reschedule_cuda
        _, snd, recv, n = CASES[0]
        es = tops.EdgeSet.build(snd, recv, n, device="cuda")
        short = torch.ones(snd.size - 1, device="cuda")
        feat = torch.ones((n, 1), device="cuda")
        with pytest.raises(ValueError):
            gas_gather_combine_cuda(feat, short, es.senders, es.segments)
        with pytest.raises(ValueError):
            gas_gather_combine_cuda(feat, torch.ones(snd.size, device="cuda"),
                                    es.senders[:snd.size - 1], es.segments)
        with pytest.raises(ValueError):
            gas_scatter_reschedule_cuda(
                feat[:, 0], feat[:, 0], torch.zeros(n, dtype=torch.bool,
                                                    device="cuda"),
                es.senders, es.segments, short)
        with pytest.raises(ValueError):
            tsegk.segment_sum_sorted_cuda(
                torch.ones((snd.size - 1, 2), device="cuda"), es.segments)
