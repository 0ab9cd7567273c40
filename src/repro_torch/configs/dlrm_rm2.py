"""dlrm-rm2 [arXiv:1906.00091; RM2 profile per DLRM benchmark suite]
n_dense=13 n_sparse=26 embed_dim=64 bot_mlp=13-512-256-64
top_mlp=512-512-256-1 interaction=dot.  Per-table vocab 2^20 rows
(26.2M embedding rows, 6.98 GB of f32 tables).
"""
import dataclasses

import torch

from repro_torch.models.dlrm import DLRMConfig

KIND = "recsys"


def full_config(**over) -> DLRMConfig:
    cfg = DLRMConfig(
        name="dlrm-rm2",
        n_dense=13, n_sparse=26, embed_dim=64, vocab_size=1_048_576,
        multi_hot=1,
        bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1),
        dtype=torch.float32)
    return dataclasses.replace(cfg, **over)


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-smoke", vocab_size=1024, embed_dim=16,
        bot_mlp=(32, 16), top_mlp=(32, 1))
