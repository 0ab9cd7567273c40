"""The GraphLab core abstraction in PyTorch (paper Secs. 3-4)."""
from repro_torch.core.bsp import BSPEngine
from repro_torch.core.chromatic import ChromaticEngine
from repro_torch.core.consistency import Consistency
from repro_torch.core.dynamic import DynamicEngine
from repro_torch.core.engine_base import Engine, EngineState, init_state
from repro_torch.core.graph import (DataGraph, GraphStructure, gather_scope,
                                    scatter_to_neighbors, segment_combine)
from repro_torch.core.scheduler import (FifoScheduler, MultiQueueScheduler,
                                        PriorityScheduler, Scheduler,
                                        SweepScheduler)
from repro_torch.core.sync_op import FnSyncOp, SyncOp
from repro_torch.core.update import (ApplyOut, EdgeCtx, FusedGather,
                                     VertexProgram, supports_fused_gather)

__all__ = [
    "ApplyOut", "BSPEngine", "ChromaticEngine", "Consistency", "DataGraph",
    "DynamicEngine", "EdgeCtx", "Engine", "EngineState", "FifoScheduler",
    "FnSyncOp", "FusedGather", "GraphStructure", "MultiQueueScheduler",
    "PriorityScheduler", "Scheduler", "SweepScheduler", "SyncOp",
    "VertexProgram", "gather_scope", "init_state", "scatter_to_neighbors",
    "segment_combine", "supports_fused_gather",
]
