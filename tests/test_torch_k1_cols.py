"""K1 at D >= 2: its column items (``csr.ColumnItems``) and its order of
adds, walked on the host.

The CUDA kernel (csrc/gas_gather_combine.cu ``items_cols``) runs one warp
an item (a run of segments over one column slice), streams the item's
edges through a ring in chunks and adds each (segment, column) in edge
order from 0; rows of two or more segments add their partials in a second
pass.  ``_column_walk`` repeats that order in float32 with numpy and must
give ``segmented_row_sum``'s bits — the bar the kernel is held to on the
card.  The walk is also held against the JAX package's gather within its
kernel bar, 2e-5 of the largest output (tests/test_gas_kernel.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gas import ops as jops
from repro_torch.kernels import build, csr
from repro_torch.kernels.csr import (COL_ITEM_EDGES, COL_MAX_WIDTH,
                                     ROW_SEGMENT, ColumnItems, RowSegments,
                                     col_chunk, segmented_row_sum,
                                     slice_width)
from repro_torch.kernels.gas import ops as tops

WIDTHS = [2, 5, 20, 204, 400]


def _graphs():
    """(name, senders, receivers, n): power-law rows, a hub longer than
    ROW_SEGMENT between short rows, rows of one edge, no edge at all."""
    rng = np.random.default_rng(16)
    n = 700
    recv = np.sort(np.minimum((rng.pareto(1.2, 6000) * 3).astype(np.int64),
                              n - 1))
    hub = np.sort(np.concatenate([np.full(2 * ROW_SEGMENT + 77, 9),
                                  rng.integers(0, 60, 500)]))
    out = []
    for name, r, m in (("pareto", recv, n), ("hub", hub, 60),
                       ("one-edge rows", np.arange(900), 900),
                       ("empty", np.zeros(0, np.int64), 50)):
        out.append((name, rng.integers(0, m, r.size).astype(np.int32),
                    r.astype(np.int32), m))
    return out


GRAPHS = _graphs()
GRAPH_IDS = [g[0] for g in GRAPHS]


def _tables(snd, recv, n, d, width=None):
    """The segments and their column items: the wrapper's (kept on the
    segments), or built at a forced slice ``width``."""
    seg = RowSegments.build(recv, n, "cpu")
    if width is None:
        return seg, seg.column_items(d)
    return seg, ColumnItems.build(seg, d, width)


def _items(table):
    """[(lo, hi, c0, width)] in grid order."""
    return [(int(lo), int(hi), int(c0), int(width))
            for lo, hi, c0, *_, width in table.items.numpy()]


def _column_walk(feat, w, snd, seg, table, active=None):
    """K1's D >= 2 sums in the kernel's order, in float32 on the host: item
    by item, the item's edges chunk by chunk (``col_chunk(width)`` edges),
    each (segment, column) of the slice added from 0 in edge order; a
    segment of a row of two or more segments kept as a partial, any other
    written as 0 + sum; then each such row's partials added in segment
    order.  ``active`` [n_rows] bool: rows to write (an item with no
    active row is skipped)."""
    n, d = seg.n_rows, feat.shape[1]
    sb, sr = seg.seg_beg.numpy(), seg.seg_row.numpy()
    rs, ri = seg.row_seg.numpy(), seg.row_ids.numpy()
    act = np.ones(n, bool) if active is None else active
    out = np.zeros((n, d), np.float32)
    partial = np.full((seg.n_segments, d), np.nan, np.float32)
    for lo, hi, c0, width in _items(table):
        if not act[sr[lo:hi]].any():
            continue
        chunk = int(col_chunk(width))
        acc = np.zeros((hi - lo, width), np.float32)
        tb, te = sb[lo], sb[hi]
        for ea in range(tb, te, chunk):
            eb = min(ea + chunk, te)
            # the stage: each edge's weight and row slice
            ws = w[ea:eb]
            rows = feat[snd[ea:eb], c0:c0 + width]
            for k in range(lo, hi):
                for e in range(max(sb[k], ea), min(sb[k + 1], eb)):
                    acc[k - lo] = acc[k - lo] + ws[e - ea] * rows[e - ea]
        for k in range(lo, hi):
            row = sr[k]
            if not act[row]:
                continue
            multi = (k > 0 and sr[k - 1] == row) or (
                k + 1 < seg.n_segments and sr[k + 1] == row)
            if multi:
                partial[k, c0:c0 + width] = acc[k - lo]
            else:
                out[row, c0:c0 + width] = np.float32(0) + acc[k - lo]
    for i in table.multi_rows.numpy():
        if act[ri[i]]:
            total = np.zeros(d, np.float32)
            for k in range(rs[i], rs[i + 1]):
                total = total + partial[k]
            out[ri[i]] = total
    return out


def _inputs(snd, recv, n, d, seed=0):
    """Features, weights, and rows of one or two edges whose products are
    all -0.0 (their sum is +0.0 in both orders)."""
    rng = np.random.default_rng(seed + d)
    feat = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=recv.size).astype(np.float32)
    ptr = np.searchsorted(recv, np.arange(n + 1))
    zero = np.concatenate([ptr[np.flatnonzero(np.diff(ptr) == 1)[:3]],
                           ptr[np.flatnonzero(np.diff(ptr) == 2)[:3]]])
    zero = np.concatenate([zero, zero + 1])
    zero = zero[zero < recv.size]
    w[zero] = -0.0
    feat[snd[zero]] = np.abs(feat[snd[zero]]) + 1
    return feat, w


def _masks(n):
    rng = np.random.default_rng(n)
    return {"all": None, "30%": rng.random(n) < 0.3,
            "none": np.zeros(n, bool)}


def _plain(feat, w, snd, recv, n, seg):
    terms = torch.from_numpy(w)[:, None] * torch.from_numpy(feat)[snd]
    return segmented_row_sum(terms, torch.from_numpy(recv), n, seg).numpy()


class TestColumnItems:
    @pytest.mark.parametrize("d", WIDTHS)
    @pytest.mark.parametrize("graph", GRAPHS, ids=GRAPH_IDS)
    def test_every_segment_and_column_once(self, graph, d):
        _, snd, recv, n = graph
        seg, table = _tables(snd, recv, n, d)
        seen = np.zeros((seg.n_segments, d), np.int64)
        for lo, hi, c0, width in _items(table):
            assert 0 < width <= COL_MAX_WIDTH and c0 + width <= d
            seen[lo:hi, c0:c0 + width] += 1
        assert (seen == 1).all()
        np.testing.assert_array_equal(
            table.multi_rows.numpy(),
            np.flatnonzero(np.diff(seg.row_seg.numpy()) > 1))
        assert table.stage_floats % 4 == 0

    @pytest.mark.parametrize("d,width", [(d, None) for d in WIDTHS]
                             + [(204, 104), (400, 96), (1100, None)])
    @pytest.mark.parametrize("graph", GRAPHS, ids=GRAPH_IDS)
    def test_items_are_runs_that_stream(self, graph, d, width):
        """An item is a run of whole segments that start in one aligned
        span of COL_ITEM_EDGES edges, so its edges are at most that span
        and one segment more; it streams through the ring in chunks that
        fit a stage, also where the last slice is narrower (and takes more
        edges a chunk)."""
        _, snd, recv, n = graph
        seg, table = _tables(snd, recv, n, d, width)
        sb = seg.seg_beg.numpy().astype(np.int64)
        for lo, hi, c0, width in _items(table):
            assert hi > lo
            assert sb[lo] // COL_ITEM_EDGES == sb[hi - 1] // COL_ITEM_EDGES
            assert sb[hi] - sb[lo] <= COL_ITEM_EDGES + ROW_SEGMENT - 1
            assert width * int(col_chunk(width)) <= table.stage_floats
            assert 1 <= col_chunk(width) <= 32

    @pytest.mark.parametrize("graph", GRAPHS, ids=GRAPH_IDS)
    def test_items_follow_row_order(self, graph):
        """One window here: each slice walks every segment in row order,
        and an item's edge and row ranges are its segments'."""
        _, snd, recv, n = graph
        seg, table = _tables(snd, recv, n, 400, width=200)
        items = table.items.numpy().astype(np.int64)
        sb, sr = seg.seg_beg.numpy(), seg.seg_row.numpy()
        for c0 in (0, 200):
            lo, hi = items[items[:, 2] == c0, :2].T
            np.testing.assert_array_equal(lo[1:], hi[:-1])
            assert lo.size == 0 if seg.n_segments == 0 else \
                (lo[0], hi[-1]) == (0, seg.n_segments)
        np.testing.assert_array_equal(items[:, 3], sb[items[:, 0]])
        np.testing.assert_array_equal(items[:, 4], sb[items[:, 1]])
        np.testing.assert_array_equal(items[:, 5], sr[items[:, 0]])
        np.testing.assert_array_equal(items[:, 6], sr[items[:, 1] - 1])

    def test_slices_outer(self):
        """Where D is wider than a warp takes (or a narrower slice is
        forced), the items go slice by slice, each slice over every
        segment in row order, and the walk still gives the plain bits."""
        _, snd, recv, n = GRAPHS[0]
        seg, table = _tables(snd, recv, n, 1100)
        assert table.width == 368          # 3 slices: 368, 368, 364
        items = _items(table)
        c0s = [c0 for _, _, c0, _ in items]
        assert c0s == sorted(c0s) and set(c0s) == {0, 368, 736}
        per = len(items) // 3
        assert [lo for lo, *_ in items[:per]] == \
            [lo for lo, *_ in items[per:2 * per]]
        feat, w = _inputs(snd, recv, n, 1100)
        got = _column_walk(feat, w, snd, seg, table)
        want = _plain(feat, w, snd, recv, n, seg)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))

    def test_built_lazily_once(self):
        _, snd, recv, n = GRAPHS[0]
        seg = RowSegments.build(recv, n, "cpu")
        assert "_column_cache" not in seg.__dict__
        t = seg.column_items(20)
        assert seg.column_items(20) is t
        assert seg.column_items(400) is not t
        assert set(seg._column_cache) == {20, 400}

    def test_slice_width(self):
        """The full width where a warp takes it (16 columns a lane), else
        the fewest equal slices, each a multiple of 4 columns."""
        assert [slice_width(d) for d in (2, 5, 20, 204, 400, 512)] == \
            [2, 5, 20, 204, 400, 512]
        assert slice_width(513) == 260 and slice_width(1100) == 368
        for d in range(513, 2000, 37):
            w = slice_width(d)
            assert w % 4 == 0 and w <= COL_MAX_WIDTH
            assert -(-d // w) == -(-d // COL_MAX_WIDTH)

    def test_forced_width_checked(self):
        _, snd, recv, n = GRAPHS[0]
        seg = RowSegments.build(recv, n, "cpu")
        with pytest.raises(ValueError):
            ColumnItems.build(seg, 400, 10)
        with pytest.raises(ValueError):
            seg.column_items(1)
        assert ColumnItems.build(seg, 400, 1000).width == 400

    def test_constants_mirrored_in_the_kernel(self):
        """The kernel computes a slice's chunk and its lanes' columns with
        the constants the host cuts the items by."""
        cu = (build.CSRC / "gas_gather_combine.cu").read_text()
        stage = re.search(r"kStageBytes = (\d+) \* (\d+);", cu)
        assert int(stage.group(1)) * int(stage.group(2)) == \
            csr.COL_STAGE_BYTES
        per_lane = int(re.search(r"kMaxPerLane = (\d+);", cu).group(1))
        assert COL_MAX_WIDTH == 32 * per_lane
        chunk = int(re.search(r"kChunkEdges = (\d+);", cu).group(1))
        assert csr.COL_CHUNK_EDGES == chunk

    def test_no_limit_on_d(self):
        """Wide tables (D 70,000: ALS at d 265) are cut into slices whose
        first column and width each have a field of their own."""
        _, snd, recv, n = GRAPHS[0]
        seg = RowSegments.build(recv, n, "cpu")
        d = 70_000
        table = seg.column_items(d)
        items = table.items.numpy().astype(np.int64)
        per_run = items[items[:, 0] == 0]
        cols = sorted(zip(per_run[:, 2], per_run[:, 7]))
        assert cols[0][0] == 0 and cols[-1][0] > 1 << 16
        assert all(c0 + w == nxt for (c0, w), (nxt, _) in
                   zip(cols, cols[1:]))
        assert cols[-1][0] + cols[-1][1] == d
        assert max(w for _, w in cols) == table.width <= COL_MAX_WIDTH

    @pytest.mark.parametrize("width", range(2, 33))
    def test_index_division_exact(self, width):
        """At rows of at most 32 columns the kernel finds an index's edge by
        multiplying with 2^16 / q rounded up and shifting (q = width / 4
        for 4-float pieces where width % 4 == 0, else width): exact for
        every index of a chunk, and for a lane's piece of a round."""
        q = width // 4 if width % 4 == 0 else width
        inv = -(-(1 << 16) // q)
        i = np.arange(int(col_chunk(width)) * q)
        np.testing.assert_array_equal((i * inv) >> 16, i // q)
        if width % 4 == 0:
            lane = np.arange(32)
            np.testing.assert_array_equal((lane * inv) >> 16, lane // q)
            assert (32 * inv) >> 16 == 32 // q


class TestColumnWalk:
    @pytest.mark.parametrize("mask", ["all", "30%", "none"])
    @pytest.mark.parametrize("d", WIDTHS)
    @pytest.mark.parametrize("graph", GRAPHS[:2], ids=GRAPH_IDS[:2])
    def test_walk_equals_plain(self, graph, d, mask):
        """The kernel's order (chunks, slices, then the combine pass) gives
        ``segmented_row_sum``'s bits, with rows whose products are -0.0
        (written as +0.0 by both)."""
        _, snd, recv, n = graph
        seg, table = _tables(snd, recv, n, d)
        feat, w = _inputs(snd, recv, n, d)
        active = _masks(n)[mask]
        got = _column_walk(feat, w, snd, seg, table, active)
        want = _plain(feat, w, snd, recv, n, seg)
        if active is not None:
            want = np.where(active[:, None], want, np.float32(0))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        assert not np.signbit(want[want == 0]).any()

    @pytest.mark.parametrize("width", [8, 16, 100, 200])
    def test_narrow_slices_equal_plain(self, width):
        """Slices of every forced width (the smoke's sweep) add the same
        bits, the last slice narrower where the width does not divide D."""
        _, snd, recv, n = GRAPHS[1]
        seg, table = _tables(snd, recv, n, 400, width)
        assert table.width == width
        feat, w = _inputs(snd, recv, n, 400)
        got = _column_walk(feat, w, snd, seg, table)
        want = _plain(feat, w, snd, recv, n, seg)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))

    @pytest.mark.parametrize("d", [20, 204, 400])
    def test_walk_matches_jax(self, d):
        _, snd, recv, n = GRAPHS[0]
        seg, table = _tables(snd, recv, n, d)
        feat, w = _inputs(snd, recv, n, d)
        mask = _masks(n)["30%"]
        got = _column_walk(feat, w, snd, seg, table, mask)
        je = jops.EdgeSet.build(snd, recv, n)
        want = np.asarray(jops.gather_combine(
            jnp.asarray(feat), jnp.asarray(w), je,
            block_active=jops.active_row_blocks(jnp.asarray(mask))))
        # the JAX gather zeros inactive 128-row blocks, the walk inactive
        # rows: compare the active rows, and zeros elsewhere in both
        blk = np.repeat(np.asarray(tops.active_row_blocks(
            torch.from_numpy(mask))).astype(bool), 128)[:n]
        assert (want[~blk] == 0).all()
        scale = np.abs(want[mask]).max()
        assert np.abs(got[mask] - want[mask]).max() <= 2e-5 * scale
