"""Serving driver: batched decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
        [--smoke] [--device cpu] [--batch 4 --prompt-len 16 --gen 32]

Prefill + decode loop with continuous batching slots: finished sequences
(EOS or length) free their slot, pending requests claim it at the next
step.  Greedy sampling.  The schedule is the JAX package's
(``repro/launch/serve.py``): one global position counter for every slot,
so the same parameters serve the same tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf


def serve_lm(cfg: tf.TransformerConfig, batch: int, prompt_len: int,
             gen: int, n_requests: int = 8, seed: int = 0,
             params: Optional[tf.TransformerLM] = None,
             device: DeviceLike = "cuda") -> List[List[int]]:
    """Serves ``n_requests`` random prompts; returns each request's tokens
    (prompt and generated).  ``params`` default to ``init_params`` with
    seed 0, drawn in the compute dtype (the values a cast at every use
    would give)."""
    dev = resolve_device(device)
    if params is None:
        params = tf.init_params(
            dataclasses.replace(cfg, param_dtype=cfg.dtype), 0, dev)
    max_seq = prompt_len + gen
    cache = tf.init_kv_cache(cfg, batch, max_seq, dtype=torch.float32,
                             device=dev)

    rng = np.random.default_rng(seed)
    pending = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
               for _ in range(n_requests)]
    done = []

    slots = [None] * batch  # each: {'toks': [...], 'made': int, 'fed': int}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    steps = 0
    pos = 0
    cur = np.zeros((batch, 1), np.int64)
    while pending or any(s is not None for s in slots):
        # admit pending requests into free slots (continuous batching)
        for b in range(batch):
            if slots[b] is None and pending:
                req = pending.pop()
                slots[b] = {"toks": list(req), "made": 0, "fed": 0}
        # feed one token per active slot (prompt tokens first, then argmax)
        for b in range(batch):
            s = slots[b]
            cur[b, 0] = 0 if s is None else s["toks"][min(
                s["fed"], len(s["toks"]) - 1)]
        logits, cache = tf.decode_step(cfg, params, cache,
                                       torch.from_numpy(cur).to(dev), pos)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        for b in range(batch):
            s = slots[b]
            if s is None:
                continue
            s["fed"] += 1
            if s["fed"] >= len(s["toks"]):       # past the prompt: generate
                s["toks"].append(int(nxt[b]))
                s["made"] += 1
                if s["made"] >= gen:
                    done.append(s["toks"])
                    slots[b] = None
        pos += 1
        steps += 1
        if pos >= max_seq:  # ring exhausted for full-attn: flush remaining
            for b in range(batch):
                if slots[b] is not None:
                    done.append(slots[b]["toks"])
                    slots[b] = None
            break
    dt = time.perf_counter() - t0
    print(f"served {len(done)} requests in {steps} steps "
          f"({steps * batch / max(dt, 1e-9):.1f} tok/s batch={batch})",
          flush=True)
    return done


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    spec = get_arch(args.arch)
    if spec.kind != "lm":
        raise SystemExit(f"serve is for LM archs; {args.arch} is "
                         f"{spec.kind}")
    cfg = spec.smoke_config() if args.smoke else spec.full_config()
    serve_lm(cfg, args.batch, args.prompt_len, args.gen, device=args.device)


if __name__ == "__main__":
    main()
