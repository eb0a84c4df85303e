"""Task-routed all-to-all — ArrowTaskAllToAll parity (counterpart of
cylon_tpu.plan.tasks; reference: arrow_task_all_to_all.h:9-57).

The reference's task-graph overlay holds task -> worker maps
(`LogicalTaskPlan`), and `ArrowTaskAllToAll` inserts tables BY TASK ID,
delivering each to the worker that owns the task. Here workers are the
world's shards: ``task_exchange`` routes every row of a batch to the
shard owning its task in ONE exchange (the same count + exchange the
joins use: K1 counts the targets, K2 scatters the rows and their task
ids, which ride as one more int32 leg). Receivers read their tasks' rows
off their own shard."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import dtypes
from ..context import CylonContext
from ..data.column import Column
from ..data.table import Table
from ..parallel import shard
from ..parallel.dist_ops import _exchange_table
from ..status import Code, CylonError


class LogicalTaskPlan:
    """task id -> owning shard (reference: LogicalTaskPlan's
    task_to_worker / worker_to_task maps, arrow_task_all_to_all.h:9-37).
    Workers ARE shards here."""

    def __init__(self, task_to_worker: Dict[int, int], world: int):
        for t, w in task_to_worker.items():
            if not (0 <= w < world):
                raise CylonError(Code.Invalid,
                                 f"task {t} mapped to worker {w} "
                                 f"outside world {world}")
        self.task_to_worker = dict(task_to_worker)
        self.world = world

    def worker_of(self, task_id: int) -> int:
        w = self.task_to_worker.get(int(task_id))
        if w is None:
            raise CylonError(Code.KeyError, f"unknown task {task_id}")
        return w

    def tasks_of(self, worker: int) -> List[int]:
        return sorted(t for t, w in self.task_to_worker.items()
                      if w == worker)


def task_exchange(table: Table, task_ids, plan: LogicalTaskPlan,
                  ctx: CylonContext = None) -> Table:
    """Deliver each row to the shard owning its task: the insert(+task
    header) / receive-callback protocol of ArrowTaskAllToAll collapses
    into one routed exchange. ``task_ids``: per-row int array (host), one
    id a row of the global table (or a slot of its distributed layout).
    Returns the routed table with the task-id column appended as
    ``__task__`` (receivers filter their own tasks locally).

    On a process group every process passes the global table and the
    global ids, as the JAX package's SPMD programs do: each keeps the ids
    of its own shards, cut as ``shard.distribute`` cuts the rows, checks
    its live ids, and the processes agree on the verdict (one
    ``all_reduce``) before any of them raises, so all raise together or
    none does."""
    ctx = ctx or table._ctx
    world, v = ctx.get_world_size(), ctx.local_shard_count()
    cap = table.capacity // v if shard.is_distributed_table(table, ctx) \
        else shard.shard_capacity(table.capacity, world)
    total = world * cap
    local = ctx.local_shard_indices()
    lo, hi = local[0] * cap, (local[-1] + 1) * cap
    t = shard.distribute(table, ctx)
    host_ids = np.asarray(task_ids).astype(np.int32)
    mine = host_ids[lo:hi] if ctx.is_multiprocess() else host_ids
    # validate LIVE rows only — dead (masked) slots may carry filler
    # ids and never route
    live = mine
    if t.row_mask is not None and host_ids.shape[0] == total:
        live = mine[t.row_mask.cpu().numpy()[: mine.shape[0]]]
    unknown = set(np.unique(live).tolist()) - set(plan.task_to_worker)
    n_unknown = int(ctx.comm.all_reduce(np.array([len(unknown)], np.int64),
                                        "sum")[0])
    if n_unknown:
        elsewhere = n_unknown - len(unknown)
        raise CylonError(Code.KeyError,
                         f"task ids not in plan: {sorted(unknown)[:8]}"
                         + (f" (and {elsewhere} on other processes)"
                            if elsewhere else ""))
    pad = total - host_ids.shape[0]
    if pad < 0:
        raise CylonError(Code.Invalid, "task_ids longer than table")
    # pad to the distributed capacity (dead rows never route); this
    # process's shards' slots
    ids = torch.from_numpy(np.concatenate(
        [host_ids, np.zeros(pad, np.int32)])[lo:hi]).to(ctx.device)
    # task -> worker lookup as a small device tensor (tasks are few)
    max_task = max(plan.task_to_worker) if plan.task_to_worker else 0
    lut = np.zeros(max_task + 1, np.int32)
    for task, w in plan.task_to_worker.items():
        lut[task] = w
    targets = torch.take(torch.from_numpy(lut).to(ctx.device),
                         ids.clamp(0, max_task).to(torch.int64))
    cols, new_emit, xout = _exchange_table(t, targets, t.emit_mask(), ctx,
                                           {"__task__": ids})
    out = Table(cols + [Column(xout["__task__"], dtypes.Int32(), None,
                               "__task__")], ctx, new_emit)
    out._shard_world = world
    return out
