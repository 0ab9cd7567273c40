"""The distributed engines (DESIGN §3.7): a vertex program run over S
machines with two-phase atom placement and a versioned ghost exchange
(paper Secs. 4.1, 4.2, 5.1).

  ``dist.exchange``  the collectives (``all_to_all``, ``psum``) behind one
                     interface; ``InProcessExchange`` holds S machines in
                     one process, on one card or on the CPU.
  ``dist.engine``    ``DistributedEngine``, the chromatic sweep engine.
  ``dist.locking``   ``DistributedLockingEngine``, the pipelined locking
                     engine.
  ``dist.wire``      the default f32 wire and the rank codec.
"""
from repro_torch.dist.engine import (DistState, DistributedEngine, Layout,
                                     ShardEngineBase, build_layout)
from repro_torch.dist.exchange import Exchange, InProcessExchange
from repro_torch.dist.locking import DistributedLockingEngine
from repro_torch.dist.wire import WireConfig

__all__ = [
    "DistState", "DistributedEngine", "DistributedLockingEngine",
    "Exchange", "InProcessExchange", "Layout", "ShardEngineBase",
    "WireConfig", "build_layout",
]
