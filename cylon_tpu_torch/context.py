"""CylonContext — the entry point object (counterpart of cylon_tpu.context).

Reference: cpp/src/cylon/ctx/cylon_context.hpp:29-146 (Init/
InitDistributed, GetRank/GetWorldSize, GetNextSequence). In the port:

* the context owns one torch ``device``. ``device=None`` means
  ``"cuda"``, and a context asked for CUDA on a machine without it raises
  a typed error: nothing quietly carries on on the CPU. Tests pass
  ``device="cpu"``, where every kernel wrapper runs its plain version;
* a distributed context is a *virtual world* of W shards on that one
  device (config.VirtualWorldConfig): per-shard work runs on tensors
  with a leading shard dimension, and the collectives are tensor ops
  (parallel/comm.py);
* ``get_next_sequence`` survives as the op-sequence counter;
* the context owns one ``MemoryPool`` (memory.py), as in the JAX
  package: the routing guards read its budget.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .config import CommConfig, CommType, LocalConfig, VirtualWorldConfig
from .memory import MemoryPool
from .status import Code, CylonError


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device on a machine without CUDA is an
    error, never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CylonError(
            Code.ExecutionError,
            "CUDA is not available; pass device='cpu' "
            "explicitly to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise CylonError(Code.Invalid, f"unsupported device {dev}")
    return dev


class CylonContext:
    """Holds the device, the (virtual) world size, the op sequence
    counter and the device's memory pool."""

    def __init__(self, config: Optional[CommConfig] = None,
                 distributed: bool = False, device=None):
        self._sequence = 0
        self._lock = threading.Lock()
        if config is None:
            config = VirtualWorldConfig() if distributed else LocalConfig()
        self.comm_config = config
        ct = config.comm_type()
        self.distributed = distributed and ct != CommType.LOCAL
        self._world = config.world_size \
            if self.distributed and ct == CommType.VIRTUAL else 1
        self.device = resolve_device(device)
        self.memory_pool = MemoryPool(self.device)

    # -- reference API (cylon_context.hpp) --

    @staticmethod
    def Init(device=None) -> "CylonContext":
        """Local (single-shard) context. Reference: CylonContext::Init."""
        return CylonContext(LocalConfig(), distributed=False, device=device)

    @staticmethod
    def InitDistributed(config: Optional[CommConfig] = None,
                        device=None) -> "CylonContext":
        """Distributed context (reference: cylon_context.cpp:32-43): a
        virtual world of ``config.world_size`` shards on ``device``."""
        return CylonContext(config or VirtualWorldConfig(),
                            distributed=True, device=device)

    def get_world_size(self) -> int:
        return self._world

    def get_rank(self) -> int:
        """One process drives every shard of the virtual world: rank 0."""
        return 0

    def get_next_sequence(self) -> int:
        """Monotonic op id (reference: cylon_context.cpp:94-99)."""
        with self._lock:
            self._sequence += 1
            return self._sequence

    def is_distributed(self) -> bool:
        return self.distributed
