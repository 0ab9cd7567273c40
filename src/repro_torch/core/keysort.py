"""Sorts of int64 keys for graph ingress, on the structure's device.

Graph ingress (generators, ``GraphStructure.from_edges``, the partition
layout) is host numpy, as in the JAX package; its few sorts of one key an
edge are what cost minutes at E ~ 2e8 on the host.  These helpers run them
on the device the structure is built for (the card, or the CPU) with
``torch.sort(stable=True)`` and bring the result back as numpy.  A stable
sort's permutation is fixed by the keys, so each helper returns exactly
what its numpy counterpart (named in its docstring) returns.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _on(key: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(key, np.int64)).to(device)


def stable_argsort(key: np.ndarray, device) -> np.ndarray:
    """``np.argsort(key, kind="stable")`` (int64)."""
    if key.size == 0:
        return np.zeros(0, np.int64)
    return torch.sort(_on(key, device), stable=True).indices.cpu().numpy()


def unique_first(key: np.ndarray, device) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(key, return_index=True)``: the sorted unique keys and
    the index of each one's first occurrence."""
    if key.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    sk, perm = torch.sort(_on(key, device), stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    return sk[first].cpu().numpy(), perm[first].cpu().numpy()


def unique_inverse(key: np.ndarray,
                   device) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(key, return_inverse=True)``: the sorted unique keys and
    each key's index among them."""
    if key.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    u, inv = torch.unique(_on(key, device), sorted=True, return_inverse=True)
    return u.cpu().numpy(), inv.cpu().numpy()


def unique_counts(key: np.ndarray, device) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(key, return_counts=True)``."""
    if key.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    u, c = torch.unique(_on(key, device), sorted=True, return_counts=True)
    return u.cpu().numpy(), c.cpu().numpy()


def reverse_positions(key: np.ndarray, rev_key: np.ndarray,
                      device) -> np.ndarray:
    """Position of each ``rev_key`` among the sorted ``key``, or -1 where
    it is absent (``np.searchsorted`` and an equality check), int32."""
    if key.size == 0:
        return np.zeros(0, np.int32)
    k = _on(key, device)
    rk = _on(rev_key, device)
    pos = torch.searchsorted(k, rk).clamp_(0, k.numel() - 1)
    return torch.where(k[pos] == rk, pos,
                       torch.full_like(pos, -1)).to(torch.int32).cpu().numpy()
