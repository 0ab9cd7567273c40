"""DLRM-RM2 (arXiv:1906.00091): sparse embedding bags -> dot interaction ->
MLPs, for serving.

The 26 tables are stacked ``[F, V, D]``; the bags of every field of a batch
go through one launch of the embedding-bag kernel (K4) over the flat table
``[F·V, D]``.  Parameter names follow the JAX package's paths (``tables``,
``bot.0.w``, ``top.3.b``).  Training (``loss_fn``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.embedding_bag.ops import embedding_bag as bag_op
from repro_torch.models.layers import init_dense
from repro_torch.models.tree import ParamTree


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_size: int = 1_048_576          # per table (2^20)
    multi_hot: int = 1                    # ids per field (bag size)
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    dtype: torch.dtype = torch.float32

    @property
    def n_embed_rows(self) -> int:
        return self.n_sparse * self.vocab_size


class DLRM(ParamTree):
    """The parameters: ``tables`` [F, V, D], ``bot`` and ``top`` lists of
    ``{w, b}``."""

    def __init__(self, cfg: DLRMConfig, tree):
        super().__init__(tree)
        self.cfg = cfg


def top_in_dim(cfg: DLRMConfig) -> int:
    n_feat = 1 + cfg.n_sparse                  # bottom output + embeddings
    return n_feat * (n_feat - 1) // 2 + cfg.bot_mlp[-1]


def init_params(cfg: DLRMConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> DLRM:
    """Random parameters drawn on ``device`` from a seeded generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = torch.randn((cfg.n_sparse, cfg.vocab_size, cfg.embed_dim),
                         generator=gen, device=dev, dtype=torch.float32)
    tables = tables.div_(np.sqrt(cfg.embed_dim)).to(cfg.dtype)

    def mlp(dims_in, dims):
        ws, d = [], dims_in
        for h in dims:
            ws.append({"w": init_dense(gen, (d, h), dtype=cfg.dtype),
                       "b": torch.zeros((h,), dtype=cfg.dtype, device=dev)})
            d = h
        return ws

    return DLRM(cfg, {"tables": tables,
                      "bot": mlp(cfg.n_dense, cfg.bot_mlp),
                      "top": mlp(top_in_dim(cfg), cfg.top_mlp)})


def embedding_bag(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables [F, V, D], ids [B, F, H] (H-hot) -> bags [B, F, D], through
    one K4 launch over the flat table [F·V, D] and B·F bags."""
    F, V, D = tables.shape
    B = ids.shape[0]
    flat = bag_op(tables.reshape(F * V, D), ids.reshape(B * F, -1), fields=F)
    return flat.reshape(B, F, D)


def _mlp_apply(ws, x, act_last=False):
    for i, layer in enumerate(ws):
        x = x @ layer.w + layer.b
        if i < len(ws) - 1 or act_last:
            x = torch.relu(x)
    return x


def forward(cfg: DLRMConfig, params: DLRM,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: dense [B, 13] float, sparse_ids [B, 26, H] int -> logits [B]."""
    dense = batch["dense"].to(cfg.dtype)
    bot = _mlp_apply(params.bot, dense)                  # [B, D]
    bags = embedding_bag(params.tables, batch["sparse_ids"])  # [B, F, D]
    feats = torch.cat([bot[:, None, :], bags], 1)        # [B, F+1, D]
    inter = torch.bmm(feats, feats.transpose(1, 2))      # dot interaction
    iu, ju = torch.triu_indices(feats.shape[1], feats.shape[1], offset=1,
                                device=feats.device)
    pairs = inter[:, iu, ju]                             # [B, n_pairs]
    top_in = torch.cat([bot, pairs], -1)
    return _mlp_apply(params.top, top_in)[:, 0]


def retrieval_score(cfg: DLRMConfig, params: DLRM,
                    batch: Dict[str, torch.Tensor], top_k: int = 100
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query against N candidate item embeddings: a two-tower batched
    dot and top-k -> (scores [k] f32, indices [k])."""
    dense = batch["dense"].to(cfg.dtype)                 # [1, 13]
    cand = batch["candidates"].to(cfg.dtype)             # [N, D]
    bot = _mlp_apply(params.bot, dense)                  # [1, D]
    bags = embedding_bag(params.tables, batch["sparse_ids"])  # [1, F, D]
    query = bot + bags.sum(1)                            # [1, D] user tower
    scores = (cand @ query[0]).float()                   # [N]
    return torch.topk(scores, top_k)
