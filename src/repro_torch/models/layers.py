"""Shared neural-net layers (pure functions over tensors)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [..., seq, n_heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions.float()[..., None] * freqs      # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]             # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def init_dense(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, scale²) weights drawn from ``gen`` on its device (f32, then
    cast); ``scale`` defaults to 1/√fan_in."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)
