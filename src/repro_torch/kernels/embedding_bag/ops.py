"""Dispatch for the embedding-bag kernel (K4): CUDA tensor → the
hand-written kernel (or raise); CPU tensor → the plain version (ref.py)."""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import \
    embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  fields: int = 1) -> torch.Tensor:
    """table [fields·V, D], ids [N, H] (H-hot bags) → sum-bags [N, D]; bag
    ``i`` reads field ``i % fields`` of the stacked table."""
    if not table.is_cuda:
        return embedding_bag_ref(table, ids, fields)
    return embedding_bag_cuda(table.contiguous(),
                              ids.to(torch.int32).contiguous(), fields)
