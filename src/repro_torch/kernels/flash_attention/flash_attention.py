"""K5, the flash-attention forward kernel: its launch wrapper.

FlashAttention forward with GQA (query head ``h`` reads kv head
``h // (H // KV)``), causal and sliding-window masks and zeros on rows that
see no key; q ``[B, S, H, d]``, k and v ``[B, T, KV, d]``, f32 or bf16 in,
output in q's dtype.  It replaces ``src/repro/kernels/flash_attention/
flash_attention.py: flash_attention_pallas`` with two CUDA C++ kernels for
sm_90a behind one entry point:

- bf16 at d 64 and 128: ``repro_torch/csrc/flash_attention_sm90.cu``, on
  tensor cores (``wgmma``) with TMA loads; scores, softmax and the output
  sum in f32, P rounded to bf16 for its product with V;
- f32 at every head dim, and bf16 at d 16 and 32:
  ``repro_torch/csrc/flash_attention.cu``, f32 FMAs throughout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on a 16-byte boundary (the kernel reads rows
    as vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         sliding_window: Optional[int] = None
                         ) -> torch.Tensor:
    """Launches K5 on one card → ``[B, S, H, d]`` in q's dtype.  Counts
    each launch in ``.launches``."""
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    build.require("q", q, q.dtype, dev, (None, None, None, None))
    B, S, H, d = q.shape
    build.require("k", k, q.dtype, dev, (B, None, None, d))
    T, KV = k.shape[1], k.shape[2]
    build.require("v", v, q.dtype, dev, (B, T, KV, d))
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not split over {KV} kv heads")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got "
                         f"{sliding_window}")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = build.library().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H,
        KV, d, int(causal), sliding_window or 0, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), build.stream_ptr(dev))
    build.check(rc, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
