"""Receiver-sorted CSR rows cut into segments: the summation order shared by
the CUDA kernels and their plain versions.

A row's edges (a run of equal receivers) are cut into consecutive segments
of at most ``ROW_SEGMENT`` edges.  Every row sum in the port is
taken in this order: each segment's terms added one by one in edge order,
then the row's segment sums added in segment order.  The CUDA kernels sum
the segments in parallel, so a power-law hub with millions of in-edges
spreads over hundreds of segments instead of serialising onto one; the
plain versions add in the same order, so kernel and plain version agree
bit for bit.  A row with at most ``ROW_SEGMENT`` edges is one segment, and
its sum is the plain sequential sum (what ``jax.ops.segment_sum`` computes
on the CPU).

An edge subset may be cut at the segments of the set it came from
(``cuts``): each of its segments is then the subset's edges inside one
segment of the full set.  Where the left-out edges add exact zeros, the
subset's sums equal the full set's to the bit (``ChromaticEngine``'s
sender-color scatter subsets).

K1 at D = 1, K2 and K3 at D <= 256 read the segments through
``TileTables``, built on their first launch: a thread block stages a
tile's terms in shared memory and one thread adds each of its segments
(K3: each (segment, column) pair).
Runs of short segments of one-segment rows share a tile; every other
segment is a tile of its own.  The tiles change who adds, not the order of
the adds.

K1 at D >= 2 reads ``ColumnItems``: runs of segments in row order, each
summed by one warp over all the columns (over slices of them, slice by
slice, where D exceeds what a warp takes).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

ROW_SEGMENT = 2048
#: K1's and K2's tiles (D = 1): runs of segments of at most
#: ``SHORT_SEGMENT`` edges share a tile, at most ``TILE_SEGMENTS`` of them
#: (one a thread), all starting inside one aligned window of
#: ``TILE_WINDOW`` edges, so their edges fit ``TILE_WINDOW + SHORT_SEGMENT
#: - 1`` floats of shared memory; a longer segment is a tile of its own (at
#: most ``ROW_SEGMENT`` edges).  ``TILE_SEGMENTS`` is tied to the kernels'
#: block of ``kThreads`` (256) threads in csrc/row_reduce.cuh: the C entries
#: refuse tiles of more segments (K3: more (segment, column) pairs) than
#: threads.
SHORT_SEGMENT = 128
TILE_SEGMENTS = 256
TILE_WINDOW = 1024
#: K1's column items (D >= 2, ``ColumnItems``; the constants the kernel
#: shares are mirrored in csrc/gas_gather_combine.cu).  A warp takes an
#: item: a run of consecutive segments that start in one aligned span of
#: ``COL_ITEM_EDGES`` edges, over one slice of at most ``COL_MAX_WIDTH``
#: columns (up to 16 a lane; D itself where it fits), and streams its
#: edges through a ring of stages of ``col_chunk(width)`` edges (about
#: ``COL_STAGE_BYTES`` of gathered rows, at most ``COL_CHUNK_EDGES``).
COL_MAX_WIDTH = 512
COL_STAGE_BYTES = 8 * 1024
COL_CHUNK_EDGES = 32
COL_ITEM_EDGES = 1024


class TileShape(NamedTuple):
    """How ``tile_tables`` packs segments: at most ``segments`` a tile,
    each of at most ``short`` edges, all starting in one aligned window of
    ``window`` edges."""

    segments: int = TILE_SEGMENTS
    short: int = SHORT_SEGMENT
    window: int = TILE_WINDOW


@dataclasses.dataclass(frozen=True, eq=False)
class RowSegments:
    """Segment tables of one receiver-sorted edge array, on a device.

    Only the rows that own an edge are listed, so an edge subset (one
    color's edges) costs tables of its own size, not of the vertex count.
    ``row_ids`` [R] i32: the listed rows, ascending; ``row_seg`` [R+1] i32:
    listed row i owns segments ``[row_seg[i], row_seg[i+1])``; ``seg_beg``
    [S+1] i32: segment k covers edges ``[seg_beg[k], seg_beg[k+1])``;
    ``seg_row`` [S] i32: its row.  ``n_rows`` is the output's row count and
    ``n_edges`` the edges the tables cover (a kernel reads senders and
    weights up to there).
    """

    n_rows: int
    n_edges: int
    n_listed: int
    n_segments: int
    row_ids: torch.Tensor
    row_seg: torch.Tensor
    seg_beg: torch.Tensor
    seg_row: torch.Tensor

    @staticmethod
    def build(receivers: np.ndarray, n_rows: int, device,
              cuts: Optional[np.ndarray] = None) -> "RowSegments":
        """Tables for sorted ``receivers`` (real edges only, all
        < ``n_rows``).  ``cuts`` [E] (optional, non-decreasing): the segment
        of the full edge set each edge lies in; a segment then ends exactly
        where the cut changes (``segment_tables``)."""
        row_ids, row_seg, seg_beg, seg_row = segment_tables(receivers, cuts)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        return RowSegments(n_rows=int(n_rows), n_edges=int(receivers.size),
                           n_listed=int(row_ids.size),
                           n_segments=int(seg_row.size), row_ids=t(row_ids),
                           row_seg=t(row_seg), seg_beg=t(seg_beg),
                           seg_row=t(seg_row))

    @functools.cached_property
    def edge_segment(self) -> torch.Tensor:
        """[E] i64: the segment of each edge (for the plain versions)."""
        return torch.repeat_interleave(
            torch.arange(self.n_segments, device=self.seg_beg.device),
            (self.seg_beg[1:] - self.seg_beg[:-1]).long())

    @functools.cached_property
    def _tile_cache(self) -> dict:
        return {}

    def tiles_for(self, shape: TileShape) -> "TileTables":
        """The tile tables of ``shape``, built on first use and kept."""
        if shape not in self._tile_cache:
            self._tile_cache[shape] = TileTables.build(self, shape)
        return self._tile_cache[shape]

    @functools.cached_property
    def tiles(self) -> "TileTables":
        """K1's and K2's tile tables (D = 1), built on first use."""
        return self.tiles_for(TileShape())

    @functools.cached_property
    def _column_cache(self) -> dict:
        return {}

    def column_items(self, d: int) -> "ColumnItems":
        """K1's column items at ``d`` columns (D >= 2), built on first use
        and kept."""
        if d not in self._column_cache:
            self._column_cache[d] = ColumnItems.build(self, d)
        return self._column_cache[d]


@dataclasses.dataclass(frozen=True, eq=False)
class TileTables:
    """A kernel's work list over one ``RowSegments``, on its device.

    ``tile_beg``/``tile_end`` [n_tiles] i32: tile j sums segments
    ``[tile_beg[j], tile_end[j])``, whose edges (one contiguous range)
    number at most ``tile_cap``.  The first ``n_partial`` tiles are the
    segments of rows of two or more segments, one a tile, in segment order;
    they leave partial sums.  Then each segment longer than the shape's
    ``short`` of a one-segment row, one a tile; then runs of the other
    segments, packed at most ``shape.segments`` to a tile, all starting
    inside one aligned window of ``shape.window`` edges.  The longest
    chains of adds come first in the grid.  ``tile_segs`` is the most
    segments of any tile (at most ``shape.segments``).  ``multi_rows``
    [n_multi] i32: the listed indices of the rows of two or more segments,
    the only rows whose partials the combine pass adds.
    """

    n_tiles: int
    n_partial: int
    n_multi: int
    tile_cap: int
    tile_segs: int
    tile_beg: torch.Tensor
    tile_end: torch.Tensor
    multi_rows: torch.Tensor

    @staticmethod
    def build(seg: RowSegments, shape: TileShape = TileShape()
              ) -> "TileTables":
        tile_beg, tile_end, n_partial, cap, multi_rows = tile_tables(
            seg.row_seg.cpu().numpy(), seg.seg_beg.cpu().numpy(), shape)
        segs = int((tile_end - tile_beg).max()) if tile_beg.size else 0
        assert segs <= shape.segments, segs
        dev = seg.seg_beg.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

        return TileTables(
            n_tiles=int(tile_beg.size), n_partial=n_partial,
            n_multi=int(multi_rows.size), tile_cap=cap, tile_segs=segs,
            tile_beg=t(tile_beg), tile_end=t(tile_end),
            multi_rows=t(multi_rows))


def tile_tables(row_seg: np.ndarray, seg_beg: np.ndarray,
                shape: TileShape = TileShape()):
    """Host tables ``(tile_beg, tile_end, n_partial, tile_cap, multi_rows)``
    of ``TileTables`` from the segment tables (``tile_cap``: the most edges
    of any tile); vectorised, O(segments)."""
    row_seg = np.asarray(row_seg, np.int64)
    seg_beg = np.asarray(seg_beg, np.int64)
    n_seg_row = np.diff(row_seg)
    single = np.repeat(n_seg_row == 1, n_seg_row)
    packed = single & (np.diff(seg_beg) <= shape.short)
    alone = np.concatenate([np.flatnonzero(~single),
                            np.flatnonzero(single & ~packed)])
    k = np.flatnonzero(packed)
    starts = np.zeros(0, np.int64)
    if k.size:
        # a group: consecutive packed segments that start in one window;
        # a tile: up to shape.segments of a group's segments
        new_group = np.ones(k.size, bool)
        new_group[1:] = (np.diff(k) != 1) | (
            np.diff(seg_beg[k] // shape.window) != 0)
        pos = np.arange(k.size)
        rank = pos - np.maximum.accumulate(np.where(new_group, pos, 0))
        starts = np.flatnonzero(rank % shape.segments == 0)
    tile_beg = np.concatenate([alone, k[starts]])
    tile_end = np.concatenate([alone + 1, np.append(k[starts[1:] - 1],
                                                    k[-1:]) + 1])
    cap = int((seg_beg[tile_end] - seg_beg[tile_beg]).max()) \
        if tile_beg.size else 0
    return (tile_beg, tile_end, int((~single).sum()), cap,
            np.flatnonzero(n_seg_row > 1))


def _cdiv(a, b):
    return -(-a // b)


def col_chunk(width: int):
    """Edges a ring stage holds at a slice of ``width`` columns."""
    return np.minimum(COL_CHUNK_EDGES, np.maximum(
        1, COL_STAGE_BYTES // (4 * np.asarray(width))))


def slice_width(d: int) -> int:
    """The slice width at ``d`` columns: the full width where it fits
    ``COL_MAX_WIDTH``, else the fewest equal slices that fit, each a
    multiple of 4 columns (16 bytes) wide."""
    return min(d, 4 * _cdiv(_cdiv(d, _cdiv(d, COL_MAX_WIDTH)), 4))


#: the columns of ``ColumnItems.items``
ITEM_FIELDS = ("seg_lo", "seg_hi", "c0", "edge_lo", "edge_hi", "row_lo",
               "row_hi", "width")


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnItems:
    """K1's work list at D >= 2 over one ``RowSegments``, on its device.

    ``items`` [n_items, 8] i32, one row an item (``ITEM_FIELDS``): the
    warp that takes it sums segments ``[seg_lo, seg_hi)``, each in edge
    order from 0, over the ``width`` columns from ``c0``; their edges are
    ``[edge_lo, edge_hi)`` and their rows ``[row_lo, row_hi]``.  An item
    is a run of the segments that start in one aligned span of
    ``COL_ITEM_EDGES`` edges.  The items go slice by slice, each slice
    over all the segments in row order.  ``width``: the slice width.
    ``stage_floats``: the floats of gathered rows a ring stage holds at
    that width (a multiple of 4).  ``multi_rows`` [n_multi] i32: the listed
    rows of two or more segments, whose partials the combine pass adds.
    """

    n_items: int
    n_multi: int
    stage_floats: int
    width: int
    items: torch.Tensor
    multi_rows: torch.Tensor

    @staticmethod
    def build(seg: RowSegments, d: int,
              width: Optional[int] = None) -> "ColumnItems":
        """The items of ``seg`` at ``d`` columns, in slices of
        ``slice_width(d)`` columns, or of ``width`` where that is narrower
        (what ``chip_smoke.py`` measures narrower slices with)."""
        if d < 2:
            raise ValueError(f"column items take D >= 2, got {d}")
        full = slice_width(d)
        if width is not None and width < full and width % 4:
            raise ValueError(f"a slice narrower than {full} columns must be "
                             f"a multiple of 4, got {width}")
        width = full if width is None else min(width, full)
        items = item_table(seg.seg_beg.cpu().numpy(),
                           seg.seg_row.cpu().numpy(), d, width)
        n_seg_row = np.diff(seg.row_seg.cpu().numpy())
        dev = seg.seg_beg.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

        # the last slice may be narrower, and then holds more edges a stage
        used = np.array([width, d - (d - 1) // width * width])
        return ColumnItems(
            n_items=len(items), n_multi=int((n_seg_row > 1).sum()),
            stage_floats=int((4 * _cdiv(col_chunk(used) * used, 4)).max()),
            width=width, items=t(items),
            multi_rows=t(np.flatnonzero(n_seg_row > 1)))


def item_table(seg_beg: np.ndarray, seg_row: np.ndarray, d: int,
               width: int) -> np.ndarray:
    """``ColumnItems.items`` [n_items, 8] (i64 on the host) at slices of
    ``width`` columns; vectorised over the segments."""
    seg_beg = np.asarray(seg_beg, np.int64)
    seg_row = np.asarray(seg_row, np.int64)
    starts = seg_beg[:-1]
    lo = np.flatnonzero(np.diff(starts // COL_ITEM_EDGES, prepend=-1))
    hi = np.append(lo[1:], starts.size)[:lo.size]
    runs = np.stack([lo, hi, np.zeros_like(lo), seg_beg[lo], seg_beg[hi],
                     seg_row[lo], seg_row[hi - 1], np.zeros_like(lo)], axis=1)
    out = [np.zeros((0, len(ITEM_FIELDS)), np.int64)]
    for c0 in range(0, d, width):
        part = runs.copy()
        part[:, 2] = c0
        part[:, 7] = min(width, d - c0)
        out.append(part)
    return np.concatenate(out)


def segment_tables(receivers: np.ndarray,
                   cuts: Optional[np.ndarray] = None):
    """Host tables ``(row_ids [R], row_seg [R+1], seg_beg [S+1], seg_row
    [S])`` for sorted ``receivers`` [E]; O(E), whatever the row count.
    Without ``cuts``, rows are cut every ``ROW_SEGMENT`` edges; with
    ``cuts`` [E] (the full set's segment of each edge of a subset), a
    segment is a run of equal cuts, so no segment crosses a full-set
    segment boundary and none is cut further."""
    r = np.asarray(receivers, np.int64)
    e = r.size
    row_beg = np.flatnonzero(np.diff(r, prepend=-1)) if e else \
        np.zeros(0, np.int64)
    row_ids = r[row_beg]
    if cuts is not None:
        c = np.asarray(cuts, np.int64)
        if c.shape != r.shape:
            raise ValueError(f"cuts: {c.shape} for {r.shape} receivers")
        beg = np.flatnonzero(np.diff(c, prepend=-1)) if e else \
            np.zeros(0, np.int64)
        # a full-set segment lies in one row: every row starts a segment
        if (np.diff(c) < 0).any() or not np.isin(row_beg, beg).all():
            raise ValueError("cuts must be non-decreasing and change at "
                             "every new receiver")
        if beg.size and np.diff(np.append(beg, e)).max() > ROW_SEGMENT:
            raise ValueError(f"a cut segment exceeds {ROW_SEGMENT} edges")
        row_seg = np.append(np.searchsorted(beg, row_beg), beg.size)
        return row_ids, row_seg, np.append(beg, e), r[beg]
    row_len = np.diff(np.append(row_beg, e))
    n_seg_row = -(-row_len // ROW_SEGMENT)
    row_seg = np.concatenate([[0], np.cumsum(n_seg_row)]).astype(np.int64)
    local = np.arange(row_seg[-1], dtype=np.int64) \
        - np.repeat(row_seg[:-1], n_seg_row)
    seg_beg = np.concatenate([np.repeat(row_beg, n_seg_row)
                              + local * ROW_SEGMENT, [e]])
    return row_ids, row_seg, seg_beg, np.repeat(row_ids, n_seg_row)


def edge_segments(receivers: np.ndarray) -> np.ndarray:
    """[E] i64: the segment of each edge of sorted ``receivers`` (host) —
    the ``cuts`` of a subset taken from these edges."""
    seg_beg = segment_tables(receivers)[2]
    return np.repeat(np.arange(seg_beg.size - 1), np.diff(seg_beg))


def n_real_edges(receivers: torch.Tensor, n_rows: int) -> int:
    """Edges before the padding: pad receivers (>= n_rows) sort last."""
    return int(torch.searchsorted(
        receivers.contiguous(),
        torch.tensor([n_rows], dtype=receivers.dtype,
                     device=receivers.device)))


def row_segments_of(receivers: torch.Tensor, n_rows: int) -> RowSegments:
    """Tables for sorted ``receivers`` on their device; entries >= ``n_rows``
    are pads (they sort last) and are left out."""
    recv = receivers.cpu().numpy()
    return RowSegments.build(recv[:np.searchsorted(recv, n_rows)], n_rows,
                             receivers.device)


def segmented_row_sum(terms: torch.Tensor, receivers: torch.Tensor,
                      n_rows: int,
                      segments: Optional[RowSegments] = None) -> torch.Tensor:
    """Plain PyTorch row sums ``out[v] = Σ_{recv(e)=v} terms[e]`` over
    sorted ``receivers`` (all < ``n_rows``), added in the segment order of
    this module with sequential ``index_add_`` — the order of the kernels.
    ``segments`` (the receivers' tables, if the caller holds them) saves
    recomputing the cut."""
    if segments is None:
        segments = row_segments_of(receivers, n_rows)
    partial = torch.zeros((segments.n_segments,) + terms.shape[1:],
                          dtype=terms.dtype, device=terms.device)
    partial.index_add_(0, segments.edge_segment, terms)
    out = torch.zeros((n_rows,) + terms.shape[1:], dtype=terms.dtype,
                      device=terms.device)
    return out.index_add_(0, segments.seg_row.long(), partial)
