"""Device-memory accounting and the comm-buffer budget (counterpart of
cylon_tpu.memory).

The reference's memory layer (cpp/src/cylon/ctx/memory_pool.hpp:25-66)
adapts a user pool into Arrow allocations. Here, as in the JAX package,
the pool's role is accounting and budgeting: report live and peak device
bytes and hand the routing guards a budget. On CUDA the numbers come
from the caching allocator: the live bytes are what it has handed out
(``allocated_bytes.all.current`` of ``torch.cuda.memory_stats``), the
limit is the card's total memory, so ``available_bytes`` is the
counterpart of the reference's ``bytes_limit - bytes_in_use``. (``torch.cuda.mem_get_info``'s free
bytes would drop as soon as the allocator reserves memory for its cache,
so they are not used.) On the CPU there are no stats, as on the
reference's CPU mesh: ``available_bytes`` and ``comm_budget_bytes`` are
None and no guard binds.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


class MemoryPool:
    """Accounting over the context's device. ``comm_fraction`` bounds the
    share of free device memory the shuffle may spend on in-flight
    exchange buffers (parallel/shuffle.py ``_budget_block_cap``)."""

    def __init__(self, device, comm_fraction: float = 0.25):
        self.device = torch.device(device)
        self.comm_fraction = comm_fraction
        # monotonic high-water mark over snapshot() observations
        self._peak_seen = 0
        # the card's memory, read once (it does not change)
        self._limit: Optional[int] = None

    def _stats(self) -> Optional[Tuple[int, int, int]]:
        """(live, peak, limit) bytes from the allocator; None off CUDA.
        Every span reads it twice (its memory attributes) and the
        exchange on every call, so it reads only what it returns: the
        allocator's nested stats (``memory_stats()`` flattens every stat
        in Python) and the cached limit."""
        if self.device.type != "cuda":
            return None
        if self._limit is None:
            self._limit = int(torch.cuda.get_device_properties(
                self.device).total_memory)
        s = torch.cuda.memory_stats_as_nested_dict(self.device)
        alloc = s.get("allocated_bytes", {}).get("all", {})
        return (int(alloc.get("current", 0)), int(alloc.get("peak", 0)),
                self._limit)

    def snapshot(self) -> Tuple[int, int, int]:
        """``(bytes_in_use, peak_bytes, bytes_limit)``; zeros on the CPU."""
        used, peak, limit = self._stats() or (0, 0, 0)
        self._peak_seen = max(self._peak_seen, used)
        return used, max(peak, self._peak_seen), limit

    def bytes_allocated(self) -> int:
        return self.snapshot()[0]

    def peak_bytes(self) -> int:
        return self.snapshot()[1]

    def bytes_limit(self) -> int:
        return self.snapshot()[2]

    def available_bytes(self) -> Optional[int]:
        """Free device bytes (limit - live); None on the CPU."""
        st = self._stats()
        if st is None:
            return None
        used, _peak, limit = st
        return limit - used

    def comm_budget_bytes(self) -> Optional[int]:
        """Byte budget for in-flight shuffle buffers."""
        avail = self.available_bytes()
        return None if avail is None else int(avail * self.comm_fraction)
