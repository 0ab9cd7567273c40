"""Dispatch for the flash-attention kernel (K5): CUDA tensor → the
hand-written kernel (or raise); CPU tensor → the plain version (ref.py)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """[B, S, H, d] x [B, T, KV, d]^2 -> [B, S, H, d] (GQA when KV < H)."""
    if not q.is_cuda:
        return attention_ref(q, k, v, causal, sliding_window)
    return flash_attention_cuda(q, k, v, causal, sliding_window)
