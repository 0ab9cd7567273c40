"""The GraphLab data graph (paper Sec. 3.1), as PyTorch tensors.

The data graph ``G = (V, E, D)`` stores mutable user data on vertices and
edges over a *static* structure.  The structure is a pair of index arrays
(``senders``/``receivers``) kept sorted by receiver, so the receiver-sorted
edges are CSR rows and the ``⊕``-combine of gathered messages is a segmented
reduction over each row's edge range.

Structure arrays are built on the host in numpy (graph ingress is host-side,
cf. paper Sec. 4.1) and copied once to the structure's device; they are
static for the lifetime of the computation ("while the graph data is
mutable, the structure is static").
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.keysort import reverse_positions, stable_argsort
from repro_torch.core.tree import tree_map
from repro_torch.device import DeviceLike, resolve_device

Pytree = Any


# ---------------------------------------------------------------------------
# Static structure
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class GraphStructure:
    """Static directed-edge structure, receiver-sorted.

    Host numpy arrays are the source of truth; ``device_arrays()`` holds
    their copies on ``device`` (made once, on first use).

    Attributes:
      n_vertices: |V|.
      senders:    [E] int32 — source vertex of each directed edge.
      receivers:  [E] int32 — destination vertex; **non-decreasing**.
      reverse_perm: [E] int32 — index of the reverse edge (r, s) for each
        edge (s, r), or -1 when the reverse edge does not exist.
      in_degree / out_degree: [N] int32.
      device: where the tensor copies live.
    """

    n_vertices: int
    senders: np.ndarray
    receivers: np.ndarray
    reverse_perm: np.ndarray
    in_degree: np.ndarray
    out_degree: np.ndarray
    device: torch.device = torch.device("cpu")

    @property
    def n_edges(self) -> int:
        return int(self.senders.shape[0])

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_edges(
        senders: np.ndarray,
        receivers: np.ndarray,
        n_vertices: Optional[int] = None,
        *,
        sort: bool = True,
        device: DeviceLike = "cuda",
    ) -> Tuple["GraphStructure", np.ndarray]:
        """Builds a structure from raw edge lists.

        Returns ``(structure, perm)`` where ``perm`` maps *input* edge order
        to the stored (receiver-sorted) order: ``edata_sorted = edata[perm]``.
        """
        device = resolve_device(device)
        senders = np.asarray(senders, dtype=np.int32)
        receivers = np.asarray(receivers, dtype=np.int32)
        if senders.shape != receivers.shape or senders.ndim != 1:
            raise ValueError("senders/receivers must be equal-length 1D arrays")
        if n_vertices is None:
            n_vertices = int(max(senders.max(initial=-1),
                                 receivers.max(initial=-1)) + 1)
        if senders.size and (senders.min() < 0 or receivers.min() < 0):
            raise ValueError("negative vertex ids")
        if senders.size and max(senders.max(), receivers.max()) >= n_vertices:
            raise ValueError("vertex id out of range")

        # receiver-major, sender-minor keys: CSR rows are contiguous and
        # deterministic.  The sort and the reverse-edge search run on the
        # structure's device (core/keysort.py; the same arrays as numpy's).
        key_in = receivers.astype(np.int64) * n_vertices + senders
        if sort:
            perm = stable_argsort(key_in, device).astype(np.int32)
        else:
            perm = np.arange(senders.size, dtype=np.int32)
        s, r = senders[perm], receivers[perm]

        # Reverse-edge lookup: position of (r, s) among receiver-sorted keys.
        reverse_perm = reverse_positions(
            key_in[perm], s.astype(np.int64) * n_vertices + r, device)

        in_degree = np.bincount(r, minlength=n_vertices).astype(np.int32)
        out_degree = np.bincount(s, minlength=n_vertices).astype(np.int32)
        return (
            GraphStructure(
                n_vertices=int(n_vertices), senders=s, receivers=r,
                reverse_perm=reverse_perm, in_degree=in_degree,
                out_degree=out_degree, device=device),
            perm,
        )

    @staticmethod
    def undirected(
        u: np.ndarray, v: np.ndarray, n_vertices: Optional[int] = None,
        *, device: DeviceLike = "cuda",
    ) -> Tuple["GraphStructure", np.ndarray]:
        """Builds a symmetric structure from undirected pairs (u, v).

        Every pair is materialized as two directed edges.  The returned perm
        maps the concatenated ``[u→v ; v→u]`` input order to storage order.
        """
        u = np.asarray(u, dtype=np.int32)
        v = np.asarray(v, dtype=np.int32)
        s = np.concatenate([u, v])
        r = np.concatenate([v, u])
        return GraphStructure.from_edges(s, r, n_vertices, device=device)

    # -- derived quantities --------------------------------------------------

    def receiver_offsets(self) -> np.ndarray:
        """CSR row offsets over the receiver-sorted edge array."""
        return np.concatenate(
            [[0], np.cumsum(np.bincount(self.receivers,
                                        minlength=self.n_vertices))]
        ).astype(np.int32)

    def csr_blocks(
        self,
        row_block: Optional[int] = None,
        edge_block: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Row-block → edge-block ranges over the receiver-sorted edges (the
        block metadata the JAX package's kernels prefetch; here it feeds the
        ``EdgeSet`` fields and the edges-touched accounting)."""
        if row_block is None or edge_block is None:
            from repro_torch.kernels.gas import gas as _gas
            row_block = row_block or _gas.ROW_BLOCK
            edge_block = edge_block or _gas.EDGE_BLOCK
        return csr_block_offsets(self.receivers, self.n_vertices,
                                 row_block, edge_block)

    def is_symmetric(self) -> bool:
        return bool(self.n_edges == 0 or (self.reverse_perm >= 0).all())

    def validate(self) -> None:
        if not (np.diff(self.receivers) >= 0).all():
            raise ValueError("receivers must be sorted")
        if self.in_degree.sum() != self.n_edges \
                or self.out_degree.sum() != self.n_edges:
            raise ValueError("degrees do not sum to |E|")
        ok = self.reverse_perm >= 0
        if ok.any():
            idx = np.nonzero(ok)[0]
            rp = self.reverse_perm[idx]
            if not ((self.senders[rp] == self.receivers[idx]).all()
                    and (self.receivers[rp] == self.senders[idx]).all()):
                raise ValueError("reverse_perm does not point at reverses")

    def device_arrays(self) -> Dict[str, torch.Tensor]:
        """Tensor copies on ``device``: the index arrays as int64 (what
        torch indexing takes), degrees as int32."""
        return self._device_arrays

    def row_segments(self):
        """The receiver rows cut into segments (``kernels/csr.py``) on
        ``device`` — what the sorted segment-sum kernel reads."""
        return self._row_segments

    @functools.cached_property
    def _row_segments(self):
        from repro_torch.kernels.csr import RowSegments
        return RowSegments.build(self.receivers, self.n_vertices, self.device)

    @functools.cached_property
    def _device_arrays(self) -> Dict[str, torch.Tensor]:
        def i64(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

        def i32(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

        return {
            "senders": i64(self.senders),
            "receivers": i64(self.receivers),
            "reverse_perm": i64(self.reverse_perm),
            "in_degree": i32(self.in_degree),
            "out_degree": i32(self.out_degree),
        }


def csr_block_offsets(
    receivers: np.ndarray,
    n_rows: int,
    row_block: int = 128,
    edge_block: int = 512,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side: per output row block, (first edge block, #edge blocks).

    ``receivers`` must be non-decreasing; entries >= ``n_rows`` are padding
    and land past every row block's range.  Returns ``(eblk_start, n_eblk,
    max_eblk)`` with ``n_eblk >= 1``; starts and ends are clamped to the
    real block range (a row block beginning past the last edge, with E an
    exact ``edge_block`` multiple, would otherwise index one block past the
    end)."""
    receivers = np.asarray(receivers)
    n_edge_blocks = max(-(-receivers.size // edge_block), 1)
    n_row_blocks = max(-(-n_rows // row_block), 1)
    bounds = np.arange(n_row_blocks + 1) * row_block
    edge_pos = np.searchsorted(receivers, bounds)
    start = np.minimum(edge_pos[:-1] // edge_block, n_edge_blocks - 1)
    end = np.minimum(np.maximum(-(-edge_pos[1:] // edge_block), start + 1),
                     n_edge_blocks)
    n_eblk = np.maximum(end - start, 1).astype(np.int32)
    return start.astype(np.int32), n_eblk, int(n_eblk.max(initial=1))


# ---------------------------------------------------------------------------
# Data graph = structure + mutable data
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DataGraph:
    """Paper Sec. 3.1: ``G = (V, E, D)``.

    ``vertex_data``/``edge_data`` are dicts of tensors whose leading dim is
    |V| / |E| (edge leaves in receiver-sorted order), on the structure's
    device.
    """

    vertex_data: Pytree
    edge_data: Pytree
    structure: GraphStructure

    @property
    def n_vertices(self) -> int:
        return self.structure.n_vertices

    @property
    def n_edges(self) -> int:
        return self.structure.n_edges

    @property
    def device(self) -> torch.device:
        return self.structure.device

    def replace(self, **kw) -> "DataGraph":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def build(
        structure: GraphStructure,
        vertex_data: Pytree,
        edge_data: Pytree = None,
        edge_perm: Optional[np.ndarray] = None,
    ) -> "DataGraph":
        """Builds a DataGraph on the structure's device, permuting edge data
        into storage order."""
        dev = structure.device

        def _vchk(x):
            x = torch.as_tensor(x).to(dev)
            if x.shape[0] != structure.n_vertices:
                raise ValueError(f"vertex leaf leading dim {x.shape[0]} != "
                                 f"|V|={structure.n_vertices}")
            return x

        def _echk(x):
            x = torch.as_tensor(x).to(dev)
            if x.shape[0] != structure.n_edges:
                raise ValueError(f"edge leaf leading dim {x.shape[0]} != "
                                 f"|E|={structure.n_edges}")
            if edge_perm is not None:
                x = x[torch.as_tensor(np.asarray(edge_perm, np.int64),
                                      device=dev)]
            return x

        vertex_data = tree_map(_vchk, vertex_data)
        edge_data = tree_map(_echk, edge_data) if edge_data is not None \
            else {}
        return DataGraph(vertex_data=vertex_data, edge_data=edge_data,
                         structure=structure)


# ---------------------------------------------------------------------------
# Message-passing primitives (the system's segment ops)
# ---------------------------------------------------------------------------

def _segment_sum(m: torch.Tensor, receivers: torch.Tensor,
                 n: int) -> torch.Tensor:
    return torch.zeros((n,) + m.shape[1:], dtype=m.dtype,
                       device=m.device).index_add_(0, receivers, m)


def segment_combine(
    messages: Pytree,
    receivers: torch.Tensor,
    n_vertices: int,
    combiner: str = "sum",
    segments=None,
) -> Pytree:
    """``⊕``-combine per-edge messages into per-vertex accumulators.

    ``combiner`` ∈ {sum, mean, max, min}; every receiver must be a real
    vertex id.  When the caller holds the row segments of the (sorted)
    receivers (``GraphStructure.row_segments()``), the sum goes through the
    sorted segment-sum kernel (``kernels/segsum``) — the hand-written CUDA
    kernel on the card, its plain version on the CPU.  Empty segments give
    0 (sum, mean), -inf (max) and +inf (min), as ``jax.ops.segment_*`` do.
    """
    receivers = receivers.long()

    def _one(m):
        if combiner == "sum":
            if segments is not None:
                from repro_torch.kernels.segsum.ops import segment_sum_sorted
                flat = segment_sum_sorted(
                    m.reshape(m.shape[0], -1), receivers, n_vertices,
                    segments=segments)
                return flat.reshape((n_vertices,) + m.shape[1:])
            return _segment_sum(m, receivers, n_vertices)
        if combiner == "mean":
            s = _segment_sum(m, receivers, n_vertices)
            c = _segment_sum(torch.ones(m.shape[0], dtype=m.dtype,
                                        device=m.device),
                             receivers, n_vertices)
            c = torch.clamp(c, min=1).reshape((-1,) + (1,) * (m.ndim - 1))
            return s / c
        if combiner in ("max", "min"):
            fill = -torch.inf if combiner == "max" else torch.inf
            out = torch.full((n_vertices,) + m.shape[1:], fill,
                             dtype=m.dtype, device=m.device)
            idx = receivers.reshape((-1,) + (1,) * (m.ndim - 1)).expand(
                m.shape)
            return out.scatter_reduce_(
                0, idx, m, "amax" if combiner == "max" else "amin",
                include_self=True)
        raise ValueError(f"unknown combiner {combiner!r}")

    return tree_map(_one, messages)


def gather_scope(graph: DataGraph) -> Tuple[Pytree, Pytree, Pytree]:
    """Per-edge views of the scope: (edge, src vertex, dst vertex) — the
    read half of the paper's scope ``S_v`` (Fig. 2(a))."""
    t = graph.structure.device_arrays()
    s, r = t["senders"], t["receivers"]
    src_v = tree_map(lambda x: x[s], graph.vertex_data)
    dst_v = tree_map(lambda x: x[r], graph.vertex_data)
    return graph.edge_data, src_v, dst_v


def scatter_to_neighbors(
    values: torch.Tensor,
    structure: GraphStructure,
    direction: str = "out",
) -> torch.Tensor:
    """Scatters per-vertex scalars along edges to neighbors (scheduling ∪T').

    ``direction='out'``: each vertex v adds ``values[v]`` to every out-
    neighbor; ``'in'`` uses in-edges; ``'both'`` the symmetrized structure.
    The out-edge sum runs over the sorted receivers through the sorted
    segment sum, in the one order of ``kernels/csr.py`` on the card and on
    the CPU (an atomic ``index_add_`` would sum in launch order, and a last
    bit that differs moves a priority across the tolerance).
    """
    t = structure.device_arrays()
    s, r = t["senders"], t["receivers"]
    n = structure.n_vertices
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    if direction in ("out", "both"):
        from repro_torch.kernels.segsum.ops import segment_sum_sorted
        out = out + segment_sum_sorted(
            values[s].reshape(-1, 1), r, n,
            segments=structure.row_segments())[:, 0]
    if direction in ("in", "both"):
        out = out + _segment_sum(values[r], s, n)
    return out
