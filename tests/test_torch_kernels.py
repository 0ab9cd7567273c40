"""The port's kernel dispatch on the CPU (the plain versions of K1, K2, K3)
against the JAX package's functions, through its reference and through
the Pallas kernel in interpret mode; the kernels' tile tables and their
order of adds, walked on the host; K2 over sender-color subsets cut at the
full set's segments, equal to the full set to the bit.

Tolerance: 2e-5 of the largest magnitude of the expected output, the JAX
package's own kernel bar (tests/test_gas_kernel.py).  The ``cuda`` tests
hold the hand-written kernels to their plain versions on the card and skip
without one.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gas import ops as jops
from repro.kernels.segsum import ops as jseg
from repro.kernels.segsum import segsum as jsegk
from repro_torch.kernels import build
from repro_torch.kernels.csr import (ROW_SEGMENT, SHORT_SEGMENT,
                                     TILE_SEGMENTS, TILE_WINDOW, RowSegments,
                                     TileTables, edge_segments,
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


def _tile_cases():
    """(name, receivers, n): K1's tile tables' edge cases beside CASES."""
    rng = np.random.default_rng(5)
    s = SHORT_SEGMENT
    # rows of exactly the short/long threshold, one edge either side, and
    # rows that fill a tile's edge capacity
    lens = [s - 1, s, s + 1, 1, TILE_WINDOW, s, 2, TILE_WINDOW + s - 1, 3]
    at = np.repeat(np.arange(len(lens)), lens)
    # a row split over 3 segments between short rows
    split = np.repeat([0, 1, 2], [5, 2 * ROW_SEGMENT + 7, 4])
    pareto = np.sort(np.minimum((rng.pareto(1.2, 40000) * 3).astype(
        np.int64), 2999))
    return [(name, recv.astype(np.int32), n) for name, recv, n in (
        ("threshold", at, len(lens)),
        ("split-3", split, 3),
        ("one-edge-rows", np.arange(5000), 5000),
        ("pareto", pareto, 3000))]


TILE_CASES = [(c[0], c[2], c[3]) for c in CASES] + _tile_cases()


def _ordered(xs, acc=None):
    """Sum of ``xs`` added one by one in float32/64 from ``acc`` (0)."""
    acc = xs.dtype.type(0) if acc is None else acc
    for x in xs:
        acc = xs.dtype.type(acc + x)
    return acc


def _tile_walk(terms, seg, tiles, n_rows, active=None):
    """K1's D = 1 sums in the kernel's order, in float32 on the host: each
    tile stages its products, then each of its segments is summed from 0 in
    edge order, kept as a partial by the first ``n_partial`` tiles and
    written as 0 + sum by the others; rows of several segments add their
    partials in order.  ``active`` [n_rows] bool: rows to write (a tile
    with no active row is skipped)."""
    sb, sr = seg.seg_beg.numpy(), seg.seg_row.numpy()
    rs, ri = seg.row_seg.numpy(), seg.row_ids.numpy()
    act = np.ones(n_rows, bool) if active is None else active
    out = np.zeros(n_rows, np.float32)
    partial = np.full(seg.n_segments, np.nan, np.float32)
    for j, (lo, hi) in enumerate(zip(tiles.tile_beg.numpy(),
                                     tiles.tile_end.numpy())):
        if not act[sr[lo:hi]].any():
            continue
        base = sb[lo]
        staged = terms[base:sb[hi]].copy()
        for k in range(lo, hi):
            if act[sr[k]]:
                acc = _ordered(staged[sb[k] - base:sb[k + 1] - base])
                if j < tiles.n_partial:
                    partial[k] = acc
                else:
                    out[sr[k]] = np.float32(0) + acc
    for i in tiles.multi_rows.numpy():
        if act[ri[i]]:
            out[ri[i]] = _ordered(partial[rs[i]:rs[i + 1]])
    return out


class TestTileTables:
    """K1's tiles (``csr.TileTables``): which segments a block sums, and
    that summing them so gives the plain version's bits."""

    @pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in
                                                      TILE_CASES])
    def test_every_segment_once_in_order(self, case):
        _, recv, n = case
        seg = RowSegments.build(recv, n, "cpu")
        t = TileTables.build(seg)
        sb = seg.seg_beg.numpy().astype(np.int64)
        n_seg_row = np.diff(seg.row_seg.numpy())
        single = np.repeat(n_seg_row == 1, n_seg_row)
        length = np.diff(sb)
        beg, end = t.tile_beg.numpy(), t.tile_end.numpy()
        p = t.n_partial
        members = [np.arange(a, b) for a, b in zip(beg, end)]
        # each segment in exactly one tile, every tile a run of segments
        np.testing.assert_array_equal(
            np.sort(np.concatenate(members + [np.zeros(0, np.int64)])),
            np.arange(seg.n_segments))
        assert (end > beg).all() and ((end - beg) <= TILE_SEGMENTS).all()
        assert t.tile_segs == ((end - beg).max() if beg.size else 0)
        edges = sb[end] - sb[beg]
        assert (edges <= t.tile_cap).all()
        assert t.tile_cap <= max(TILE_WINDOW + SHORT_SEGMENT - 1,
                                 ROW_SEGMENT)
        if beg.size:
            assert t.tile_cap == edges.max()
        # first the segments of rows of 2+ segments, one a tile, in order
        np.testing.assert_array_equal(beg[:p], np.flatnonzero(~single))
        assert (end[:p] == beg[:p] + 1).all()
        # then longer segments of one-segment rows, one a tile, in order;
        # then runs of short segments of one-segment rows, in order
        alone = (end[p:] - beg[p:] == 1) & (
            length[beg[p:]] > SHORT_SEGMENT)
        n_long = int(alone.sum())
        assert alone[:n_long].all() and not alone[n_long:].any()
        np.testing.assert_array_equal(
            beg[p:p + n_long],
            np.flatnonzero(single & (length > SHORT_SEGMENT)))
        packed = np.concatenate(members[p + n_long:]
                                + [np.zeros(0, np.int64)])
        assert (np.diff(packed) > 0).all()
        assert single[packed].all()
        assert (length[packed] <= SHORT_SEGMENT).all()
        np.testing.assert_array_equal(t.multi_rows.numpy(),
                                      np.flatnonzero(n_seg_row > 1))
        assert (t.n_tiles, t.n_multi) == (beg.size, t.multi_rows.numel())

    def test_edge_cases(self):
        def tables(recv, n):
            return TileTables.build(RowSegments.build(
                np.asarray(recv, np.int32), n, "cpu"))

        empty = tables([], 5)
        assert (empty.n_tiles, empty.n_partial, empty.n_multi,
                empty.tile_cap, empty.tile_segs) == (0, 0, 0, 0, 0)
        loop = tables([0], 1)
        assert (loop.n_tiles, loop.n_partial, loop.tile_cap,
                loop.tile_segs) == (1, 0, 1, 1)
        hub = tables([3] * (2 * ROW_SEGMENT + 5), 4)
        assert (hub.n_tiles, hub.n_partial, hub.tile_cap) == (3, 3,
                                                              ROW_SEGMENT)
        np.testing.assert_array_equal(hub.multi_rows.numpy(), [0])
        ones = tables(np.arange(1000), 1000)
        np.testing.assert_array_equal(
            ones.tile_end.numpy() - ones.tile_beg.numpy(),
            [TILE_SEGMENTS] * 3 + [1000 - 3 * TILE_SEGMENTS])
        assert ones.n_partial == 0 and ones.tile_cap == TILE_SEGMENTS
        assert ones.tile_segs == TILE_SEGMENTS

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("case", ["pareto", "hub", "threshold",
                                      "split-3"])
    def test_walk_in_tile_order_equals_plain(self, case, masked):
        """The kernel's order over the tiles gives ``segmented_row_sum``'s
        bits, with rows whose products are -0.0 or sum to -0.0 (written
        as +0.0 by both)."""
        _, recv, n = next(c for c in TILE_CASES if c[0] == case)
        rng = np.random.default_rng(7)
        seg = RowSegments.build(recv, n, "cpu")
        feat = rng.normal(size=n).astype(np.float32)
        w = rng.normal(size=recv.size).astype(np.float32)
        snd = rng.integers(0, n, recv.size)
        ptr = np.searchsorted(recv, np.arange(n + 1))
        # rows of one product of -0.0, and of two (-0.0 + -0.0)
        zero = np.concatenate([ptr[np.flatnonzero(np.diff(ptr) == 1)[:3]],
                               ptr[np.flatnonzero(np.diff(ptr) == 2)[:3]]])
        zero = np.concatenate([zero, zero + 1])
        zero = zero[zero < recv.size]
        w[zero] = np.copysign(np.float32(0), -feat[snd[zero]])
        terms = (torch.from_numpy(w) * torch.from_numpy(feat)[snd]).numpy()
        assert np.signbit(terms[zero]).all() and (terms[zero] == 0).all()
        active = rng.random(n) < 0.5 if masked else None
        want = segmented_row_sum(torch.from_numpy(terms),
                                 torch.from_numpy(recv), n, seg).numpy()
        if masked:
            want = np.where(active, want, np.float32(0))
        got = _tile_walk(terms, seg, seg.tiles, n, active)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        assert not np.signbit(want[want == 0]).any()

    def test_tile_segments_fit_a_block(self):
        """Thread t of K1's block sums its tile's segment t, so a tile holds
        at most as many segments as the block has threads (``kThreads`` in
        csrc/row_reduce.cuh)."""
        src = (build.CSRC / "row_reduce.cuh").read_text()
        warps = int(re.search(r"kWarpsPerBlock = (\d+);", src).group(1))
        assert TILE_SEGMENTS <= 32 * warps

    def test_built_lazily_once(self):
        _, snd, recv, n = CASES[1]
        seg = RowSegments.build(recv, n, "cpu")
        assert "tiles" not in seg.__dict__
        assert seg.tiles is seg.tiles


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
    @pytest.mark.parametrize("d", [1, 16, 128, 20, 204, 400])
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


def _scatter_graph():
    """(senders, receivers, n, colors, n_colors): a hub of 2·ROW_SEGMENT +
    300 in-edges whose senders span the colors, Pareto rows beside it, and
    a last color none of whose vertices sends an edge."""
    rng = np.random.default_rng(11)
    n, n_colors = 3000, 6
    colors = rng.integers(0, n_colors, n).astype(np.int32)
    pool = np.flatnonzero(colors < n_colors - 1)
    other = np.minimum((rng.pareto(1.2, 20000) * 3).astype(np.int64), n - 1)
    recv = np.sort(np.concatenate([np.full(2 * ROW_SEGMENT + 300, 17),
                                   other])).astype(np.int32)
    snd = rng.choice(pool, recv.size).astype(np.int32)
    return snd, recv, n, colors, n_colors


def _sender_subsets(snd, recv, n, colors, n_colors, device="cpu"):
    """ChromaticEngine's scatter subsets: per sender color, cut at the full
    set's segments."""
    cut = edge_segments(recv)
    return [tops.EdgeSet.build(snd[idx], recv[idx], n, perm=idx,
                               cuts=cut[idx], device=device)
            for idx in (np.flatnonzero(colors[snd] == c)
                        for c in range(n_colors))]


def _scatter_inputs(rng, n, colors, c):
    """contrib (+0 off color ``c`` and off the executed set; some on-color
    zeros), prio (some -0.0 and +0.0 entries) and consume."""
    mask = (colors == c) & (rng.random(n) < 0.7)
    contrib = np.where(mask, rng.random(n) * (rng.random(n) < 0.9),
                       0).astype(np.float32)
    prio = rng.random(n).astype(np.float32)
    prio[rng.random(n) < 0.05] = -0.0
    prio[rng.random(n) < 0.05] = 0.0
    return (torch.from_numpy(contrib), torch.from_numpy(prio),
            torch.from_numpy(mask))


class TestScatterSubsets:
    """K2 over ChromaticEngine's sender-color subsets."""

    def test_cut_tables(self):
        """Every subset edge in one segment, in order; no segment crosses a
        full-set segment boundary, and none is cut further."""
        snd, recv, n, colors, n_colors = _scatter_graph()
        full = edge_segments(recv)
        sets = _sender_subsets(snd, recv, n, colors, n_colors)
        assert sets[-1].n_edges == 0
        assert sum(es.n_edges for es in sets) == recv.size
        for es in sets:
            seg = es.segments
            sb = seg.seg_beg.numpy().astype(np.int64)
            assert sb[0] == 0 and sb[-1] == es.n_edges
            assert (np.diff(sb) > 0).all()
            assert (np.diff(sb) <= ROW_SEGMENT).all()
            cut = full[es.perm.numpy()]
            k = np.repeat(np.arange(seg.n_segments), np.diff(sb))
            # one full-set segment a subset segment, each one only once
            assert (np.diff(cut)[np.diff(k) == 0] == 0).all()
            assert (np.diff(cut[sb[:-1]]) > 0).all()
            r = es.receivers[:es.n_edges].numpy()
            np.testing.assert_array_equal(r[sb[:-1]], seg.seg_row.numpy())
            np.testing.assert_array_equal(np.unique(r), seg.row_ids.numpy())
        # the hub's subset segments in a color: one per full segment it hits
        hub = sets[0].segments
        assert int((hub.seg_row == 17).sum()) == len(
            np.unique(full[(recv == 17) & (colors[snd] == 0)]))

    def test_cuts_refused_when_inconsistent(self):
        recv = np.array([0, 0, 1, 1], np.int32)
        with pytest.raises(ValueError):        # a cut spans two rows
            RowSegments.build(recv, 2, "cpu", cuts=np.array([0, 0, 0, 1]))
        with pytest.raises(ValueError):
            RowSegments.build(recv, 2, "cpu", cuts=np.array([1, 1, 0, 2]))
        with pytest.raises(ValueError):
            RowSegments.build(np.zeros(ROW_SEGMENT + 1, np.int32), 1, "cpu",
                              cuts=np.zeros(ROW_SEGMENT + 1))

    @pytest.mark.parametrize("weighted", [False, True],
                             ids=["unweighted", "weighted"])
    def test_subset_equals_full_bitwise(self, weighted):
        """Contributions +0 off the color: the subset's output equals the
        full set's to the bit on every row, -0.0 priorities included (both
        add the row's empty sum, +0, to where(consume, 0, prio))."""
        snd, recv, n, colors, n_colors = _scatter_graph()
        full = tops.EdgeSet.build(snd, recv, n, device="cpu")
        sets = _sender_subsets(snd, recv, n, colors, n_colors)
        rng = np.random.default_rng(12)
        w = torch.from_numpy(rng.normal(size=recv.size).astype(np.float32)) \
            if weighted else None
        for c, es in enumerate(sets):
            contrib, prio, consume = _scatter_inputs(rng, n, colors, c)
            want = tops.scatter_reschedule(contrib, prio, consume, full, w)
            got = tops.scatter_reschedule(
                contrib, prio, consume, es,
                None if w is None else w[es.perm])
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            assert not torch.signbit(want[want == 0]).any()


def _k2_walk(terms, keep, seg, tiles, n_rows):
    """K2's order in float32 on the host: the keep pass writes keep + 0 on
    every row; each tile sums its segments from 0 in edge order, kept as a
    partial by the first ``n_partial`` tiles and written as keep + sum by
    the others; rows of several segments write keep + their partials."""
    sb, sr = seg.seg_beg.numpy(), seg.seg_row.numpy()
    rs, ri = seg.row_seg.numpy(), seg.row_ids.numpy()
    out = keep + np.float32(0)
    partial = np.full(seg.n_segments, np.nan, np.float32)
    for j, (lo, hi) in enumerate(zip(tiles.tile_beg.numpy(),
                                     tiles.tile_end.numpy())):
        for k in range(lo, hi):
            acc = _ordered(terms[sb[k]:sb[k + 1]])
            if j < tiles.n_partial:
                partial[k] = acc
            else:
                out[sr[k]] = np.float32(keep[sr[k]] + acc)
    for i in tiles.multi_rows.numpy():
        acc = _ordered(partial[rs[i]:rs[i + 1]])
        out[ri[i]] = np.float32(keep[ri[i]] + acc)
    return out


class TestScatterTiles:
    @pytest.mark.parametrize("subset", [False, True], ids=["full", "subset"])
    def test_walk_in_tile_order_equals_plain(self, subset):
        """K2's order over K1's D = 1 tiles gives the plain version's bits,
        on the full set and on a sender-color subset, -0.0 priorities
        included."""
        snd, recv, n, colors, n_colors = _scatter_graph()
        es = (_sender_subsets(snd, recv, n, colors, n_colors)[1] if subset
              else tops.EdgeSet.build(snd, recv, n, device="cpu"))
        rng = np.random.default_rng(13)
        contrib, prio, consume = _scatter_inputs(rng, n, colors, 1)
        w = torch.from_numpy(rng.normal(size=es.n_edges).astype(np.float32))
        want = tops.scatter_reschedule(contrib, prio, consume, es, w)
        terms = (w * contrib[es.senders[:es.n_edges].long()]).numpy()
        keep = torch.where(consume, torch.zeros_like(prio), prio).numpy()
        got = _k2_walk(terms, keep, es.segments, es.segments.tiles, n)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.numpy().view(np.int32))


K3_WIDTHS = [1, 2, 5, 8, 64]


def _k3_chunks(tb, te, e0, e1, chunk):
    """The edges K3's thread for segment [e0, e1) adds, chunk by chunk, in
    a tile spanning [tb, te) staged ``chunk`` edges at a time."""
    out = []
    for ea in range(tb, te, chunk):
        eb = min(ea + chunk, te)
        out.extend(range(max(e0, ea), min(e1, eb)))
    return out


class TestSegSumTiles:
    """K3's tile tables (``segsum.tile_shape``) and its order of adds."""

    @pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
    @pytest.mark.parametrize("d", K3_WIDTHS)
    @pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in
                                                      TILE_CASES])
    def test_every_pair_once_and_fits(self, case, d, itemsize):
        """Each (segment, column) pair is one thread's of one tile; a tile's
        pairs fit the block; its stage fits 48 KB of shared memory; a
        packed tile is read in one chunk; each thread adds exactly its
        segment's edges, in order."""
        _, recv, n = case
        seg = RowSegments.build(recv, n, "cpu")
        shape, stage = tsegk.tile_shape(d, itemsize)
        t = seg.tiles_for(shape)
        assert seg.tiles_for(shape) is t
        sb = seg.seg_beg.numpy().astype(np.int64)
        beg, end = t.tile_beg.numpy(), t.tile_end.numpy()
        owner = np.zeros((seg.n_segments, d), np.int64)
        for lo, hi in zip(beg, end):
            assert (hi - lo) * d <= TILE_SEGMENTS
            owner[lo:hi] += 1
        assert (owner == 1).all()
        assert t.tile_segs * d <= TILE_SEGMENTS
        chunk = min(stage, t.tile_cap)
        assert (chunk * d + 16 // itemsize) * itemsize <= 48 * 1024
        span = sb[end] - sb[beg]
        packed = np.arange(beg.size) >= t.n_partial
        packed &= (end - beg > 1) | (np.diff(sb)[beg] <= shape.short)
        assert (span[packed] <= stage).all()
        for lo, hi in zip(beg, end):
            for k in range(lo, hi):
                assert _k3_chunks(sb[lo], sb[hi], sb[k], sb[k + 1],
                                  max(chunk, 1)) == list(range(sb[k],
                                                               sb[k + 1]))

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("d", [2, 5])
    @pytest.mark.parametrize("case", ["pareto", "split-3", "threshold"])
    def test_walk_in_tile_order_equals_plain(self, case, d, dtype):
        """K3's order over its tiles gives ``segmented_row_sum``'s bits:
        each pair's sum from 0 in edge order, 0 + sum for a one-segment
        row, a row's partials in segment order for the others."""
        _, recv, n = next(c for c in TILE_CASES if c[0] == case)
        seg = RowSegments.build(recv, n, "cpu")
        t = seg.tiles_for(tsegk.tile_shape(d, np.dtype(dtype).itemsize)[0])
        msgs = np.random.default_rng(d).normal(size=(recv.size, d)) \
            .astype(dtype)
        sb, sr = seg.seg_beg.numpy(), seg.seg_row.numpy()
        rs, ri = seg.row_seg.numpy(), seg.row_ids.numpy()
        out = np.zeros((n, d), dtype)
        partial = np.full((seg.n_segments, d), np.nan, dtype)
        for j, (lo, hi) in enumerate(zip(t.tile_beg.numpy(),
                                         t.tile_end.numpy())):
            for k in range(lo, hi):
                for c in range(d):
                    acc = _ordered(msgs[sb[k]:sb[k + 1], c])
                    if j < t.n_partial:
                        partial[k, c] = acc
                    else:
                        out[sr[k], c] = dtype(0) + acc
        for i in t.multi_rows.numpy():
            for c in range(d):
                out[ri[i], c] = _ordered(partial[rs[i]:rs[i + 1], c])
        want = segmented_row_sum(torch.from_numpy(msgs),
                                 torch.from_numpy(recv), n, seg).numpy()
        np.testing.assert_array_equal(out, want)
        assert np.array_equal(np.signbit(out), np.signbit(want))


@pytest.mark.cuda
class TestOnCard:
    """The hand-written kernels against their plain versions on the card
    (the CUDA kernels sum in edge order, so they match bit for bit)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("d", [1, 16, 128, 2, 20, 204, 400])
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

    @pytest.mark.parametrize("d", [5, 400])
    def test_k1_table_view_equals_plain(self, d):
        """K1 on a feature table that starts one row into a larger one
        (``table[1:]``, still contiguous): at D 5 its rows are not 16-byte
        aligned and take the 4-byte cp.async branch, at D 400 the bulk
        copies; equal to the plain version on the host to the bit under
        every mask."""
        for name in ("pareto", "hub"):
            _, snd, recv, n = next(c for c in CASES if c[0] == name)
            rng = np.random.default_rng(d)
            table = torch.from_numpy(rng.normal(size=(n + 1, d)).astype(
                np.float32))
            w = torch.from_numpy(rng.normal(size=snd.size).astype(
                np.float32))
            es = tops.EdgeSet.build(snd, recv, n, device="cuda")
            hs = tops.EdgeSet.build(snd, recv, n, device="cpu")
            feat = table.cuda()[1:]
            assert feat.is_contiguous() and feat.data_ptr() % 16 == 4 * d % 16
            for mask in _masks(rng, n).values():
                m = torch.ones(n, dtype=torch.bool) if mask is None else \
                    torch.from_numpy(mask)
                got = tops.gather_combine(
                    feat, w.cuda(), es,
                    block_active=tops.active_row_blocks(m.cuda()))
                want = tops.gather_combine(
                    table[1:], w, hs, block_active=tops.active_row_blocks(m))
                assert torch.equal(got.cpu().view(torch.int32),
                                   want.view(torch.int32)), name

    @pytest.mark.parametrize("d", [20, 204])
    def test_k1_many_items_equals_plain(self, d):
        """K1 at D >= 2 over ~8,000 column items, more than the card holds
        warps at once: each warp claims several items and its ring runs
        across their boundaries.  Equal to the plain version on the host to
        the bit under every mask."""
        rng = np.random.default_rng(d)
        n, e = 250_000, 8_000_000
        deg = ((rng.pareto(1.5, n) + 1) * 12).astype(np.int64)
        recv = np.repeat(np.arange(n, dtype=np.int32), deg)[:e]
        recv = np.concatenate([recv, np.full(e - recv.size, n - 1,
                                             np.int32)])
        snd = rng.integers(0, n, e).astype(np.int32)
        feat = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
        w = torch.from_numpy(rng.normal(size=e).astype(np.float32))
        es = tops.EdgeSet.build(snd, recv, n, device="cuda")
        hs = tops.EdgeSet.build(snd, recv, n, device="cpu")
        assert es.segments.column_items(d).n_items > 4000
        for mask in _masks(rng, n).values():
            m = torch.ones(n, dtype=torch.bool) if mask is None else \
                torch.from_numpy(mask)
            got = tops.gather_combine(
                feat.cuda(), w.cuda(), es,
                block_active=tops.active_row_blocks(m.cuda()))
            want = tops.gather_combine(
                feat, w, hs, block_active=tops.active_row_blocks(m))
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32))

    def test_scatter_subsets_equal_full(self):
        """K2 over each sender-color subset equals K2 over the full set and
        the plain version on the host, to the bit."""
        snd, recv, n, colors, n_colors = _scatter_graph()
        full = tops.EdgeSet.build(snd, recv, n, device="cuda")
        sets = _sender_subsets(snd, recv, n, colors, n_colors, "cuda")
        host = _sender_subsets(snd, recv, n, colors, n_colors)
        rng = np.random.default_rng(14)
        w = torch.from_numpy(rng.normal(size=recv.size).astype(np.float32))
        for c, (es, hs) in enumerate(zip(sets, host)):
            args = _scatter_inputs(rng, n, colors, c)
            for wt in (None, w):
                cw = None if wt is None else wt.cuda()
                dev = [a.cuda() for a in args]
                k_full = tops.scatter_reschedule(*dev, full, cw)
                k_sub = tops.scatter_reschedule(
                    *dev, es, None if cw is None else cw[es.perm])
                plain = tops.scatter_reschedule(
                    *args, hs, None if wt is None else wt[hs.perm])
                for k in (k_full, k_sub):
                    assert torch.equal(k.cpu().view(torch.int32),
                                       plain.view(torch.int32))

    @pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("d", [1, 2, 5, 8, 16, 64, 300])
    def test_segsum_widths_equal_plain(self, d, dtype, offset):
        """K3 at every width (its tiles up to 256 columns, one warp a
        segment past that), in f32 and f64, on messages that start 16-byte
        aligned and one row later: equal to the plain version on the host
        to the bit."""
        for name in ("pareto", "hub", "split-3"):
            _, recv, n = next(c for c in TILE_CASES if c[0] == name)
            rng = np.random.default_rng(d)
            msgs = torch.from_numpy(rng.normal(size=(recv.size + offset, d))
                                    ).to(dtype)
            seg = RowSegments.build(recv, n, "cuda")
            got = tsegk.segment_sum_sorted_cuda(msgs.cuda()[offset:], seg)
            want = tseg.segment_sum_sorted(msgs[offset:],
                                           torch.from_numpy(recv), n)
            assert torch.equal(got.cpu(), want), name

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
