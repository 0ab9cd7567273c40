"""Architecture registry: ``--arch <id>`` resolves here.

Each entry: family kind, full (published) config and reduced smoke config.
Only the architectures the port runs are listed; the rest of the JAX
package's registry (the other LMs, the MoE models, the GNNs) waits for
their modules (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, List

ARCH_IDS: List[str] = ["starcoder2-3b", "dlrm-rm2"]

_MODULE_OF = {
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    kind: str                       # 'lm' | 'recsys'
    full_config: Callable[..., Any]
    smoke_config: Callable[[], Any]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULE_OF:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP A13); "
                       f"ported: {ARCH_IDS}")
    mod = importlib.import_module(_MODULE_OF[arch_id])
    return ArchSpec(arch_id=arch_id, kind=mod.KIND,
                    full_config=mod.full_config,
                    smoke_config=mod.smoke_config)
