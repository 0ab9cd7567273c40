"""Decoder-only LM with GQA / RoPE / qk-norm / sliding window: the dense
path of the JAX package's ``models/transformer.py``, for serving.

Parameters are stacked over layers as in the JAX package
(``layers.attn.wq`` is ``[L, d, H, hd]``) and named by its paths.  Prefill
attention goes through the flash-attention kernel (K5); decode attends to
the KV cache in plain PyTorch, as the JAX package does.  Not ported yet:
MoE layers (``n_experts > 0``), padded query heads (``n_heads_padded``),
tied embeddings, training (``loss_fn``) and sharding (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (apply_rope, init_dense, layer_norm,
                                       rms_norm)
from repro_torch.models.tree import ParamTree


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm: str = "rmsnorm"          # 'rmsnorm' | 'layernorm'
    mlp: str = "swiglu"            # 'swiglu' | 'gelu'
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # starcoder2: 4096
    rope_theta: float = 1e4
    n_experts: int = 0             # MoE: not ported (raises)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    n_heads_padded: Optional[int] = None   # not ported (raises)

    def n_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        ffn = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        emb = 2 * self.vocab_size * d
        return self.n_layers * (attn + ffn + 2 * d) + emb + d


def _check_dense(cfg: TransformerConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet "
                                  "(ROADMAP A13)")
    if cfg.n_heads_padded is not None:
        raise NotImplementedError("padded query heads are not ported yet "
                                  "(ROADMAP A13)")


class TransformerLM(ParamTree):
    """The parameters: ``embed``, ``layers.{attn,mlp,norms}.*`` stacked
    over layers, ``final_norm`` (``final_norm_b``) and ``lm_head``."""

    def __init__(self, cfg: TransformerConfig, tree):
        _check_dense(cfg)
        super().__init__(tree)
        self.cfg = cfg


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> TransformerLM:
    """Random parameters in ``cfg.param_dtype``, drawn on ``device`` from a
    seeded generator."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, H, KV, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    L, pdt = cfg.n_layers, cfg.param_dtype

    def dense(shape, scale=None):
        return init_dense(gen, shape, scale, pdt)

    def const(shape, value):
        return torch.full(shape, value, dtype=pdt, device=dev)

    attn = {"wq": dense((L, d, H, hd)), "wk": dense((L, d, KV, hd)),
            "wv": dense((L, d, KV, hd)),
            "wo": dense((L, H, hd, d), scale=1.0 / np.sqrt(H * hd))}
    if cfg.qk_norm:
        attn["q_norm"] = const((L, hd), 1.0)
        attn["k_norm"] = const((L, hd), 1.0)
    mlp = {"w_up": dense((L, d, ff)),
           "w_down": dense((L, ff, d), scale=1.0 / np.sqrt(ff))}
    if cfg.mlp == "swiglu":
        mlp["w_gate"] = dense((L, d, ff))
    norms = {"ln1": const((L, d), 1.0), "ln2": const((L, d), 1.0)}
    if cfg.norm == "layernorm":
        norms["ln1_b"] = const((L, d), 0.0)
        norms["ln2_b"] = const((L, d), 0.0)
    tree: Dict[str, Any] = {
        "embed": dense((cfg.vocab_size, d), scale=1.0),
        "layers": {"attn": attn, "mlp": mlp, "norms": norms},
        "final_norm": const((d,), 1.0),
    }
    if cfg.norm == "layernorm":
        tree["final_norm_b"] = const((d,), 0.0)
    tree["lm_head"] = dense((d, cfg.vocab_size))
    return TransformerLM(cfg, tree)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _norm(cfg, x, scale, bias):
    if cfg.norm == "layernorm":
        return layer_norm(x, scale, bias)
    return rms_norm(x, scale)


def _proj(x: torch.Tensor, w: torch.Tensor, cfg) -> torch.Tensor:
    """x [..., d] times a weight [d, *out] in the compute dtype ->
    [..., *out]."""
    w = w.to(cfg.dtype)
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _attend_cached(cfg, q, k, v, qpos, kpos):
    """Exact attention of q [B, S, H, hd] over the cache k, v
    [B, T, KV, hd] with slot positions kpos [B, T] (-1 = unwritten), as
    the JAX package's ``_attend``: masked scores are -1e30."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bsgjk,btgk->bgjst", qg, k).float() \
        * (1.0 / np.sqrt(hd))
    mask = kpos[:, None, :] <= qpos[:, :, None]                 # causal
    if cfg.sliding_window is not None:
        mask &= kpos[:, None, :] > qpos[:, :, None] - cfg.sliding_window
    mask &= (kpos >= 0)[:, None, :]                             # unwritten
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, -1).to(cfg.dtype)
    return torch.einsum("bgjst,btgk->bsgjk", probs, v).reshape(B, S, H, hd)


def _attention(cfg: TransformerConfig, x, lp, positions, kv_cache=None,
               cache_positions=None):
    """x: [B, S, d].  Prefill when kv_cache is None (K5), else decode
    against ``kv_cache = (ck, cv, slot)``, written in place at ``slot``."""
    attn = lp["attn"]
    q = _proj(x, attn["wq"], cfg)
    k = _proj(x, attn["wk"], cfg)
    v = _proj(x, attn["wv"], cfg)
    if cfg.qk_norm:
        q = rms_norm(q, attn["q_norm"])
        k = rms_norm(k, attn["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        out = flash_attention(q, k, v, causal=True,
                              sliding_window=cfg.sliding_window)
    else:
        ck, cv, slot = kv_cache
        ck[:, slot:slot + k.shape[1]] = k.to(ck.dtype)
        cv[:, slot:slot + v.shape[1]] = v.to(cv.dtype)
        out = _attend_cached(cfg, q, ck.to(cfg.dtype), cv.to(cfg.dtype),
                             positions, cache_positions)
    wo = attn["wo"].to(cfg.dtype)
    return out.reshape(*out.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _mlp(cfg: TransformerConfig, x, lp):
    mlp = lp["mlp"]
    u = _proj(x, mlp["w_up"], cfg)
    if cfg.mlp == "swiglu":
        h = F.silu(_proj(x, mlp["w_gate"], cfg)) * u
    else:
        h = F.gelu(u, approximate="tanh")      # jax.nn.gelu's default
    return _proj(h, mlp["w_down"], cfg)


def _layer(cfg, x, lp, positions, kv_cache=None, cache_positions=None):
    norms = lp["norms"]
    h = _norm(cfg, x, norms["ln1"], norms.get("ln1_b"))
    x = x + _attention(cfg, h, lp, positions, kv_cache, cache_positions)
    h = _norm(cfg, x, norms["ln2"], norms.get("ln2_b"))
    return x + _mlp(cfg, h, lp)


def _logits(cfg, params, x):
    x = _norm(cfg, x, params.final_norm, params.get("final_norm_b"))
    return x @ params.lm_head.to(cfg.dtype)


@torch.inference_mode()
def forward(cfg: TransformerConfig, params: TransformerLM,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] in ``cfg.dtype``."""
    _check_dense(cfg)
    B, S = tokens.shape
    x = params.embed.to(cfg.dtype)[tokens]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    for i in range(cfg.n_layers):
        x = _layer(cfg, x, params.layers.index(i), positions)
    return _logits(cfg, params, x)


# ---------------------------------------------------------------------------
# Decode: one new token against a KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Cache [L, B, T, KV, hd].  Sliding-window archs keep only the window
    (a ring buffer)."""
    dev = resolve_device(device)
    T = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            # position of each cache slot, -1 = unwritten; [B, T]
            "positions": torch.full((batch, T), -1, dtype=torch.int32,
                                    device=dev)}


@torch.inference_mode()
def decode_step(cfg: TransformerConfig, params: TransformerLM,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int):
    """tokens [B, 1] at position ``pos`` -> (logits [B, V], cache).  The
    cache slot is ``pos % T`` (a ring buffer under a sliding window).  The
    cache is updated in place (one copy on the card, as the JAX package
    gets by donating it) and returned."""
    _check_dense(cfg)
    B = tokens.shape[0]
    T = cache["k"].shape[2]
    x = params.embed.to(cfg.dtype)[tokens]               # [B, 1, d]
    positions = torch.full((B, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    slot = pos % T
    cache["positions"][:, slot] = pos
    for i in range(cfg.n_layers):
        x = _layer(cfg, x, params.layers.index(i), positions,
                   kv_cache=(cache["k"][i], cache["v"][i], slot),
                   cache_positions=cache["positions"])
    return _logits(cfg, params, x)[:, 0], cache
