"""K4, the embedding-bag kernel: its launch wrapper.

``out[i] = Σ_h table[(i % fields)·V + ids[i, h]]`` for a table
``[fields·V, D]`` (f32 or bf16) and int32 ids ``[N, H]``, summed in f32
and stored in the table's dtype.  The kernel is CUDA C++ for sm_90a in
``repro_torch/csrc/embedding_bag.cu``; it replaces
``src/repro/kernels/embedding_bag/embedding_bag.py:embedding_bag_pallas``.
Ids must lie in ``[0, V)``: the kernel reads the row it is given.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       fields: int = 1) -> torch.Tensor:
    """Launches K4: table ``[fields·V, D]`` and ids ``[N, H]`` int32 on
    one card → ``[N, D]`` in the table's dtype.  Counts each launch in
    ``.launches``."""
    dev = table.device
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table: expected float32 or bfloat16, got "
                         f"{table.dtype}")
    build.require("table", table, table.dtype, dev, (None, None))
    build.require("ids", ids, torch.int32, dev, (None, None))
    if fields < 1 or table.shape[0] % fields:
        raise ValueError(f"table: {table.shape[0]} rows do not split into "
                         f"{fields} fields")
    n, bag = ids.shape
    d = table.shape[1]
    out = torch.empty((n, d), dtype=table.dtype, device=dev)
    if n == 0 or d == 0:
        return out
    align = 16 if table.dtype == torch.float32 else 8
    vec_ok = int(table.data_ptr() % align == 0 and out.data_ptr() % align == 0)
    rc = build.library().embedding_bag(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, bag, d,
        table.shape[0] // fields, fields, int(table.dtype == torch.bfloat16),
        vec_ok, build.stream_ptr(dev))
    build.check(rc, "embedding_bag")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
