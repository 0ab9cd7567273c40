"""Carrying a data graph across from the JAX package.

For this system the "weights" are the data graph: its structure and its
vertex and edge data.  These builders take the JAX package's
``GraphStructure`` fields and data leaves as numpy arrays (``np.asarray``
of each) and make the port's objects from them, so both packages can run on
identical graphs.  Colorings pass as numpy arrays unchanged.

The distributed engines' layout tables and state carry across the same way
(``layout_from_numpy``, ``dist_state_from_numpy``), so both packages'
distributed engines can start from one state and be compared step by step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.graph import DataGraph, GraphStructure
from repro_torch.core.tree import tree_map
from repro_torch.device import DeviceLike, resolve_device

STRUCTURE_FIELDS = ("n_vertices", "senders", "receivers", "reverse_perm",
                    "in_degree", "out_degree")


def structure_from_numpy(arrays: Mapping[str, Any],
                         device: DeviceLike = "cuda") -> GraphStructure:
    """A ``GraphStructure`` from the JAX structure's fields (a mapping with
    the keys of ``STRUCTURE_FIELDS``), taken as they are: already sorted,
    with their reverse permutation and degrees."""
    missing = [k for k in STRUCTURE_FIELDS if k not in arrays]
    if missing:
        raise ValueError(f"structure arrays lack {missing}")
    st = GraphStructure(
        n_vertices=int(arrays["n_vertices"]),
        senders=np.asarray(arrays["senders"], np.int32),
        receivers=np.asarray(arrays["receivers"], np.int32),
        reverse_perm=np.asarray(arrays["reverse_perm"], np.int32),
        in_degree=np.asarray(arrays["in_degree"], np.int32),
        out_degree=np.asarray(arrays["out_degree"], np.int32),
        device=resolve_device(device))
    st.validate()
    return st


def data_graph_from_numpy(structure_arrays: Mapping[str, Any],
                          vertex_data: Dict[str, Any],
                          edge_data: Dict[str, Any],
                          device: DeviceLike = "cuda") -> DataGraph:
    """A ``DataGraph`` from the JAX graph's structure fields and its vertex
    and edge leaves (already in storage order) as numpy arrays."""
    st = structure_from_numpy(structure_arrays, device)

    def leaf(x):
        return torch.from_numpy(np.array(x))

    return DataGraph.build(st, tree_map(leaf, vertex_data),
                           tree_map(leaf, edge_data))


def layout_from_numpy(fields: Mapping[str, Any]):
    """A distributed ``Layout`` (``dist/engine.py``) from the JAX package's
    ``_Layout`` fields as a mapping (its dataclass fields, ``tables`` a
    dict of numpy arrays), the host tables as they are."""
    from repro_torch.dist.engine import Layout
    names = [f.name for f in dataclasses.fields(Layout)]
    missing = [k for k in names if k not in fields]
    if missing:
        raise ValueError(f"layout fields lack {missing}")
    kw = {k: fields[k] for k in names}
    for k in ("n_machines", "n_loc", "budget", "e_loc", "e_budget"):
        kw[k] = int(kw[k])
    kw["has_rev"] = bool(kw["has_rev"])
    kw["tables"] = {k: np.asarray(v) for k, v in fields["tables"].items()}
    for k in ("machine_of", "own_gid", "row_of", "erow_gid", "erow_of",
              "ghost_gid", "eghost_gid"):
        kw[k] = np.asarray(kw[k])
    return Layout(**kw)


def dist_state_from_numpy(fields: Mapping[str, Any],
                          device: DeviceLike = "cuda"):
    """A distributed ``DistState`` from the JAX package's ``DistState``
    fields as numpy trees (``DIST_STATE_FIELDS``; the snapshot, heartbeat
    and wire fields are not carried), machine-major as they are, so an
    engine of the port over all S machines can continue the reference's
    run.  Traffic counters widen to int64."""
    from repro_torch.dist.engine import DIST_STATE_FIELDS, DistState
    missing = [k for k in DIST_STATE_FIELDS if k not in fields]
    if missing:
        raise ValueError(f"DistState fields lack {missing}")
    dev = resolve_device(device)

    def leaf(x):
        return torch.from_numpy(np.array(x)).to(dev)

    kw = {k: tree_map(leaf, fields[k]) for k in DIST_STATE_FIELDS}
    for k in ("traffic_v", "traffic_e", "traffic_r", "traffic_bytes_v",
              "traffic_bytes_e", "traffic_bytes_r", "step_index"):
        kw[k] = kw[k].to(torch.int64)
    return DistState(**kw)
