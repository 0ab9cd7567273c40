"""Parameter trees as ``nn.Module``s.

The JAX package keeps parameters as nested dicts and lists.  A
``ParamTree`` holds the same nesting as submodules, lists as
``nn.ModuleList``s and leaves as frozen ``nn.Parameter``s, so a leaf's
name in ``named_parameters()`` is its JAX path (``layers.attn.wq``,
``bot.0.w``) and carrying weights across is a copy with no renaming.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

from torch import nn


def _node(value):
    if isinstance(value, Mapping):
        return ParamTree(value)
    if isinstance(value, (list, tuple)):
        return nn.ModuleList(_node(v) for v in value)
    return nn.Parameter(value, requires_grad=False)


class ParamTree(nn.Module):
    """Nested dicts/lists of tensors as modules; leaves are parameters."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for name, value in tree.items():
            node = _node(value)
            if isinstance(node, nn.Parameter):
                self.register_parameter(name, node)
            else:
                self.add_module(name, node)

    def get(self, name: str, default=None):
        """The child ``name``, or ``default`` when there is none."""
        return getattr(self, name) if hasattr(self, name) else default

    def index(self, i: int) -> Dict[str, Any]:
        """Nested dicts of every leaf's row ``i`` (a view): one layer of a
        stacked ``[L, ...]`` tree."""
        out: Dict[str, Any] = {}
        for name, p in self.named_parameters(recurse=False):
            out[name] = p[i]
        for name, child in self.named_children():
            out[name] = child.index(i)
        return out

