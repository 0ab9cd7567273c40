"""The serving steps of the ported cells, as plain functions.

The JAX package builds a ``StepBundle`` per (arch x shape x mesh) with
shardings for ``jax.jit``; the port runs eagerly on one card, so a step is
the model call alone:

- ``prefill_step``: LM prefill (``prefill_32k``) -> logits [B, S, V];
- ``serve_step``: DLRM serving (``serve_p99``, ``serve_bulk``) -> [B];
- ``retrieval_step``: DLRM retrieval (``retrieval_cand``) -> top-k.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import dlrm as dlrm_lib
from repro_torch.models import transformer as tf_lib


@torch.inference_mode()
def prefill_step(cfg: tf_lib.TransformerConfig, params: tf_lib.TransformerLM,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: tokens [B, S] -> logits [B, S, V]."""
    return tf_lib.forward(cfg, params, batch["tokens"])


@torch.inference_mode()
def serve_step(cfg: dlrm_lib.DLRMConfig, params: dlrm_lib.DLRM,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: dense [B, 13], sparse_ids [B, 26, H] -> logits [B]."""
    return dlrm_lib.forward(cfg, params, batch)


@torch.inference_mode()
def retrieval_step(cfg: dlrm_lib.DLRMConfig, params: dlrm_lib.DLRM,
                   batch: Dict[str, torch.Tensor], top_k: int = 100
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: dense [1, 13], sparse_ids [1, 26, H], candidates [N, D] ->
    (scores [k], candidate indices [k])."""
    return dlrm_lib.retrieval_score(cfg, params, batch, top_k)
