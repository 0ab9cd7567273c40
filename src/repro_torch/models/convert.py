"""Carrying model weights across from the JAX package.

The JAX package keeps a model's parameters as a pytree of nested dicts and
lists.  These builders take that tree with numpy leaves (``np.asarray`` of
each leaf; bfloat16 leaves come as ``ml_dtypes.bfloat16`` arrays) and make
the port's module from it, leaf for leaf under the same path, with dtypes
and layouts kept.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.transformer import TransformerConfig, TransformerLM


def tensor_from_numpy(x: Any, device: DeviceLike = "cuda") -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor of the same dtype on
    ``device``."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(resolve_device(device))


def _tensors(tree: Mapping[str, Any], device: DeviceLike):
    return tree_map(lambda x: tensor_from_numpy(x, device), dict(tree))


def transformer_from_numpy(cfg: TransformerConfig, tree: Mapping[str, Any],
                           device: DeviceLike = "cuda") -> TransformerLM:
    """The port's LM from the JAX ``init_params`` tree (numpy leaves)."""
    return TransformerLM(cfg, _tensors(tree, device))


def dlrm_from_numpy(cfg: DLRMConfig, tree: Mapping[str, Any],
                    device: DeviceLike = "cuda") -> DLRM:
    """The port's DLRM from the JAX ``init_params`` tree (numpy leaves)."""
    return DLRM(cfg, _tensors(tree, device))
