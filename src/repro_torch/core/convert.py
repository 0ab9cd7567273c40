"""Carrying a data graph across from the JAX package.

For this system the "weights" are the data graph: its structure and its
vertex and edge data.  These builders take the JAX package's
``GraphStructure`` fields and data leaves as numpy arrays (``np.asarray``
of each) and make the port's objects from them, so both packages can run on
identical graphs.  Colorings pass as numpy arrays unchanged.
"""
from __future__ import annotations

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
