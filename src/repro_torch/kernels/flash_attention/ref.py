"""Plain PyTorch version of the flash-attention kernel (K5)."""
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sliding_window: Optional[int] = None,
                  q_chunk: int = 0) -> torch.Tensor:
    """q [B, S, H, d], k and v [B, T, KV, d] → [B, S, H, d] in q's dtype,
    with f32 math.  Query ``s`` sees key ``t`` when ``t < T``, ``t <= s``
    (causal) and ``t > s - sliding_window`` (window); a row that sees no
    key comes out as zeros, as from the kernel.  ``q_chunk > 0`` walks the
    queries in chunks of that many rows, so the scores never exceed
    ``[B, KV, G, q_chunk, T]``."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    kf, vf = k.float(), v.float()
    kpos = torch.arange(T, device=q.device)
    step = q_chunk if q_chunk > 0 else max(S, 1)
    out = torch.zeros_like(q)
    if T == 0:
        return out
    for s0 in range(0, S, step):
        qg = q[:, s0:s0 + step].float()
        sq = qg.shape[1]
        qg = qg.reshape(B, sq, KV, G, d)
        scores = torch.einsum("bsgjk,btgk->bgjst", qg, kf) / (d ** 0.5)
        qpos = torch.arange(s0, s0 + sq, device=q.device)[:, None]
        mask = torch.ones((sq, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos
        if sliding_window is not None:
            mask &= kpos[None, :] > qpos - sliding_window
        scores = scores.masked_fill(~mask, NEG_INF)
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m) * mask
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bgjst,btgk->bsgjk", p / l, vf)
        out[:, s0:s0 + sq] = o.reshape(B, sq, H, d).to(q.dtype)
    return out
