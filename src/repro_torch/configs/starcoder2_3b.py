"""starcoder2-3b [arXiv:2402.19173; hf:bigcode/starcoder2-3b]
30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 — GQA, RoPE,
sliding-window attention (4096), LayerNorm + GELU (tanh) MLP.
"""
import dataclasses

import torch

from repro_torch.models.transformer import TransformerConfig

KIND = "lm"


def full_config(**over) -> TransformerConfig:
    cfg = TransformerConfig(
        name="starcoder2-3b",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
        d_ff=12288, vocab_size=49152,
        norm="layernorm", mlp="gelu", qk_norm=False,
        sliding_window=4096, rope_theta=1e5,
        dtype=torch.bfloat16)
    return dataclasses.replace(cfg, **over)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-3b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512,
        norm="layernorm", mlp="gelu", sliding_window=16,
        dtype=torch.float32)
