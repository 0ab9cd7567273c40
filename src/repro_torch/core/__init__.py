"""The GraphLab core abstraction in PyTorch (paper Secs. 3-4)."""
from repro_torch.core.bsp import BSPEngine
from repro_torch.core.chromatic import ChromaticEngine
from repro_torch.core.consistency import Consistency
from repro_torch.core.distributed import (ClusterModel, SimulatedCluster,
                                          StepCost)
from repro_torch.core.dynamic import DynamicEngine
from repro_torch.core.engine_base import Engine, EngineState, init_state
from repro_torch.core.graph import (DataGraph, GraphStructure, gather_scope,
                                    scatter_to_neighbors, segment_combine)
from repro_torch.core.partition import (AtomIndex, LocalGraph,
                                        atom_meta_index, build_atoms,
                                        cut_edges, load_cluster,
                                        load_machine, overpartition,
                                        place_atoms, place_vertices,
                                        rebalance_placement)
from repro_torch.core.scheduler import (FifoScheduler, MultiQueueScheduler,
                                        PriorityScheduler, Scheduler,
                                        SweepScheduler)
from repro_torch.core.sequential import SequentialEngine
from repro_torch.core.sync_op import FnSyncOp, SyncOp
from repro_torch.core.update import (ApplyOut, EdgeCtx, FusedGather,
                                     VertexProgram, supports_fused_gather)

__all__ = [
    "ApplyOut", "AtomIndex", "BSPEngine", "ChromaticEngine", "ClusterModel",
    "Consistency", "DataGraph", "DynamicEngine", "EdgeCtx", "Engine",
    "EngineState", "FifoScheduler", "FnSyncOp", "FusedGather",
    "GraphStructure", "LocalGraph", "MultiQueueScheduler",
    "PriorityScheduler", "Scheduler", "SequentialEngine", "SimulatedCluster",
    "StepCost", "SweepScheduler", "SyncOp", "VertexProgram",
    "atom_meta_index", "build_atoms", "cut_edges", "gather_scope",
    "init_state", "load_cluster", "load_machine", "overpartition",
    "place_atoms", "place_vertices", "rebalance_placement",
    "scatter_to_neighbors", "segment_combine", "supports_fused_gather",
]
