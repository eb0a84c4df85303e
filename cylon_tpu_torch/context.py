"""CylonContext — the entry point object (counterpart of cylon_tpu.context).

Reference: cpp/src/cylon/ctx/cylon_context.hpp:29-146 (Init/
InitDistributed, GetRank/GetWorldSize, GetNextSequence, Barrier). In the
port:

* the context owns one torch ``device``. ``device=None`` means
  ``"cuda"``, and a context asked for CUDA on a machine without it raises
  a typed error: nothing quietly carries on on the CPU. Tests pass
  ``device="cpu"``, where every kernel wrapper runs its plain version;
* a distributed context is a world of W shards in P processes of V
  shards each (W = P * V), with one collective backend
  (``self.comm``, parallel/comm.py). ``VirtualWorldConfig(W)`` is the
  *virtual world*, P = 1 and V = W: every shard on this process's
  device, the collectives tensor ops. ``MultiHostConfig`` joins P
  processes through ``torch.distributed`` (NCCL or gloo), as the JAX
  package's ``MultiHostConfig`` does through ``jax.distributed``:
  process p owns the global shards ``[p * V, (p + 1) * V)``, and its
  tables hold those shards' rows only;
* ``get_next_sequence`` survives as the op-sequence counter;
* the context owns one ``MemoryPool`` (memory.py), as in the JAX
  package: the routing guards read its budget, agreed across processes
  (``comm_budget_bytes``), and registers it with the telemetry layer.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import (CommConfig, CommType, LocalConfig, MultiHostConfig,
                     VirtualWorldConfig)
from . import telemetry as _telemetry
from .memory import MemoryPool
from .parallel.comm import ProcessGroupComm, VirtualComm
from .status import Code, CylonError


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device on a machine without CUDA is an
    error, never a silent CPU run. A CUDA device always carries its index
    (``cuda`` becomes ``cuda:<current device>``), so a thread that has
    not touched CUDA yet (the query service's worker) allocates and
    launches on the context's card without ``torch.cuda.set_device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CylonError(
            Code.ExecutionError,
            "CUDA is not available; pass device='cpu' "
            "explicitly to run the plain PyTorch versions on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise CylonError(Code.Invalid, f"unsupported device {dev}")
    return dev


def _env_int(value: Optional[int], name: str) -> Optional[int]:
    if value is not None:
        return int(value)
    env = os.environ.get(name)
    return None if env is None else int(env)


def _join_process_group(cfg: MultiHostConfig, device) -> tuple:
    """(process count, rank, device, backend, whether this call created
    the group): ``init_process_group`` unless a default group already
    exists (the JAX package's ``_distributed_initialized`` guard). The
    device is ``cuda:{rank % device_count}`` unless the caller names one;
    the backend NCCL on CUDA and gloo on the CPU unless the config names
    one. An NCCL request off CUDA is an error."""
    import torch.distributed as dist

    if not dist.is_available():
        raise CylonError(Code.ExecutionError,
                         "torch.distributed is not available")
    created = not dist.is_initialized()
    if created:
        nproc = _env_int(cfg.num_processes, "WORLD_SIZE")
        rank = _env_int(cfg.process_id, "RANK")
        if nproc == 1 and rank is None:
            rank = 0
        if nproc is None or rank is None:
            raise CylonError(Code.Invalid,
                             "MultiHostConfig needs num_processes and "
                             "process_id (or WORLD_SIZE and RANK)")
    else:
        nproc, rank = dist.get_world_size(), dist.get_rank()
        if cfg.num_processes not in (None, nproc):
            raise CylonError(Code.Invalid,
                             f"a process group of {nproc} processes "
                             f"exists; the config asks for "
                             f"{cfg.num_processes}")
    if device is None:
        resolve_device("cuda")  # raises without CUDA
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    if created:
        backend = cfg.backend or ("nccl" if dev.type == "cuda" else "gloo")
    else:
        backend = dist.get_backend()
    if backend == "nccl" and (dev.type != "cuda"
                              or not dist.is_nccl_available()):
        raise CylonError(Code.Invalid,
                         f"the NCCL backend needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if created:
        if cfg.init_method is not None:
            kw = {"init_method": cfg.init_method}
        elif cfg.coordinator_address is not None:
            kw = {"init_method": f"tcp://{cfg.coordinator_address}"}
        elif nproc == 1:
            kw = {"store": dist.HashStore()}
        else:
            kw = {"init_method": "env://"}
        dist.init_process_group(backend, world_size=nproc, rank=rank, **kw)
    return nproc, rank, dev, backend, created


class CylonContext:
    """Holds the device, the world (P processes x V shards), its
    collective backend, the op sequence counter and the device's memory
    pool."""

    def __init__(self, config: Optional[CommConfig] = None,
                 distributed: bool = False, device=None):
        # the reference's string config map (cylon_context.hpp:31)
        self._config_map: Dict[str, str] = {}
        self._sequence = 0
        self._lock = threading.Lock()
        self._finalized = False
        self._owns_group = False
        if config is None:
            config = VirtualWorldConfig() if distributed else LocalConfig()
        self.comm_config = config
        ct = config.comm_type()
        self.distributed = distributed and ct != CommType.LOCAL
        if self.distributed and ct == CommType.MULTIHOST:
            nproc, rank, self.device, backend, self._owns_group = \
                _join_process_group(config, device)
            self.comm = ProcessGroupComm(nproc, rank,
                                         config.shards_per_process,
                                         self.device, backend)
        else:
            self.device = resolve_device(device)
            self.comm = VirtualComm(config.world_size if self.distributed
                                    and ct == CommType.VIRTUAL else 1)
        self.memory_pool = MemoryPool(self.device)
        # the span layer's per-span memory attrs and the flight
        # recorder's watermarks read the last context's pool; where the
        # device has no allocator stats (the CPU) the pool counts the
        # ledger's tracked-table bytes instead
        self.memory_pool.set_external_source(_telemetry.ledger.live_bytes)
        _telemetry.set_memory_pool(self.memory_pool)

    # -- reference API (cylon_context.hpp) --

    @staticmethod
    def Init(device=None) -> "CylonContext":
        """Local (single-shard) context. Reference: CylonContext::Init."""
        return CylonContext(LocalConfig(), distributed=False, device=device)

    @staticmethod
    def InitDistributed(config: Optional[CommConfig] = None,
                        device=None) -> "CylonContext":
        """Distributed context (reference: cylon_context.cpp:32-43): a
        virtual world of ``config.world_size`` shards on ``device``, or
        with a MultiHostConfig this process's part of a process group."""
        return CylonContext(config or VirtualWorldConfig(),
                            distributed=True, device=device)

    def get_world_size(self) -> int:
        """W, the number of shards over all processes (reference:
        GetWorldSize; an MPI rank maps to a shard)."""
        return self.comm.world

    def local_shard_count(self) -> int:
        """V, the shards this process owns (W in the virtual world): the
        leading dimension of every per-shard view of a local tensor."""
        return self.comm.shards

    def local_shard_indices(self) -> List[int]:
        """The global indices of this process's shards."""
        v = self.comm.shards
        return list(range(self.comm.rank * v, (self.comm.rank + 1) * v))

    def get_rank(self) -> int:
        """This process's first shard index (shard space, consistent with
        `get_neighbours`): 0 in the virtual world. For file placement use
        `get_process_rank` / `local_shard_indices`."""
        return self.local_shard_indices()[0]

    def get_process_rank(self) -> int:
        """The process's rank in the process group (the reference's
        node-rank role for per-rank file IO; 0 in the virtual world)."""
        return self.comm.rank

    def get_process_count(self) -> int:
        return self.comm.nproc

    def is_multiprocess(self) -> bool:
        """True when the world's shards are spread over more than one
        process: a table then holds only this process's rows."""
        return self.comm.nproc > 1

    def get_neighbours(self, include_self: bool = False) -> List[int]:
        """All other shard indices, optionally including this process's
        first (reference: GetNeighbours, cylon_context.cpp:77-86)."""
        me = self.get_rank()
        return [i for i in range(self.get_world_size())
                if include_self or i != me]

    def get_next_sequence(self) -> int:
        """Monotonic op id (reference: cylon_context.cpp:94-99)."""
        with self._lock:
            self._sequence += 1
            return self._sequence

    def barrier(self) -> None:
        """Wait for every process (reference: MPI_Barrier): one tiny
        all-reduce; a no-op in the virtual world and after finalize."""
        if not self._finalized:
            self.comm.barrier()

    def finalize(self) -> None:
        """End the context; a process group this context created is
        destroyed (``destroy_process_group``)."""
        if self._finalized:
            return
        self._finalized = True
        if self._owns_group:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()

    def is_distributed(self) -> bool:
        return self.distributed

    def add_config(self, key: str, value: str) -> None:
        """Reference: CylonContext::AddConfig (string config map)."""
        self._config_map[key] = value

    def get_config(self, key: str, default: str = "") -> str:
        """Reference: CylonContext::GetConfig; ``default`` when unset."""
        return self._config_map.get(key, default)

    def comm_budget_bytes(self) -> Optional[int]:
        """The memory pool's comm budget, agreed across processes as
        their minimum: two processes on one card see different free
        bytes, and exchanges routed from different budgets would wait on
        each other forever. None (the CPU) leaves no budget."""
        b = self.memory_pool.comm_budget_bytes()
        if self.comm.nproc == 1:
            return b
        none = np.iinfo(np.int64).max
        agreed = int(self.comm.all_reduce(
            np.array([none if b is None else int(b)], np.int64), "min")[0])
        return None if agreed == none else agreed

    # PascalCase aliases for reference-style call sites
    GetRank = get_rank
    GetWorldSize = get_world_size
    GetNextSequence = get_next_sequence
    Barrier = barrier
    Finalize = finalize
