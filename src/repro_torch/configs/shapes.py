"""The input-shape sets, one per architecture family: a copy of the JAX
package's ``configs/shapes.py``, held equal to it by the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    step: str                 # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


LM_SHAPES: Dict[str, LMShape] = {
    "train_4k": LMShape("train_4k", "train", 4096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32768, 128),
    # decode with a 524288-token context; only sub-quadratic-attention archs
    # run it (DESIGN.md: starcoder2's sliding window); others -> SKIP
    "long_500k": LMShape("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    step: str                 # 'train'
    n_nodes: int
    n_edges: int
    d_feat: int
    task: str = "node_class"
    n_classes: int = 47
    n_graphs: int = 1
    sampled: bool = False     # minibatch_lg: shapes = padded sampler output
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    edge_chunks: int = 1      # memory-roofline knob for the big cells


def _sampler_padded(batch_nodes: int, fanout: Tuple[int, ...]) -> Tuple[int, int]:
    acc, total = 1, 1
    for f in fanout:
        acc *= f
        total += acc
    max_nodes = batch_nodes * total
    return max_nodes, max_nodes - batch_nodes


_MB_NODES, _MB_EDGES = _sampler_padded(1024, (15, 10))

GNN_SHAPES: Dict[str, GNNShape] = {
    "full_graph_sm": GNNShape(
        "full_graph_sm", "train", 2708, 10556, 1433, n_classes=7),
    "minibatch_lg": GNNShape(
        "minibatch_lg", "train", _MB_NODES, _MB_EDGES, 602, n_classes=41,
        sampled=True, batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": GNNShape(
        "ogb_products", "train", 2449029, 61859140, 100, n_classes=47,
        edge_chunks=64),
    "molecule": GNNShape(
        "molecule", "train", 30 * 128, 64 * 128, 16, task="graph_energy",
        n_graphs=128),
}


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    step: str                 # 'train' | 'serve' | 'retrieval'
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES: Dict[str, RecsysShape] = {
    "train_batch": RecsysShape("train_batch", "train", 65536),
    "serve_p99": RecsysShape("serve_p99", "serve", 512),
    "serve_bulk": RecsysShape("serve_bulk", "serve", 262144),
    "retrieval_cand": RecsysShape("retrieval_cand", "retrieval", 1,
                                  n_candidates=1_000_000),
}


def shapes_for(kind: str) -> Dict[str, object]:
    return {"lm": LM_SHAPES, "moe": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": RECSYS_SHAPES}[kind]
