"""cylon_tpu_torch — the PyTorch/CUDA port of cylon_tpu for one NVIDIA
H100.

The port keeps cylon_tpu's module layout and names; it imports torch and
numpy, never jax and nothing of cylon_tpu. It carries two paths:

* the distributed inner join: Table -> murmur-fmix key hash -> partition
  targets -> the counted padded shuffle (kernels K1 partition_hist and
  K2 partition_scatter) -> the per-shard stream join (kernels K3
  join_plan_stream and K4 join_expand_stream) -> result;
* the set ops: ``Table.union/subtract/intersect`` sort the rows by a
  full-row hash and run kernel K5 setop_stream, whose compaction is
  kernel K6 stream_compact; ``distributed_union/...`` shuffle on every
  column (K1/K2) and run the dense-ranks set op per shard;
* groupby, scalar aggregates and sort: ``Table.groupby``, ``sum``,
  ``count``, ``min``, ``max``, ``mean``, ``sort`` and their distributed
  forms ``distributed_groupby`` (per-shard partials, their exchange,
  second-phase merge) and ``distributed_sort`` (range splitters, the
  exchange, per-shard sorts), plus ``hash_partition`` and
  ``repartition``. These run torch ops; their exchanges run K1/K2;
* string columns (dictionary-encoded or varbytes, data/strings.py)
  through every op above, Arrow and Parquet I/O, and the column-model
  helpers (``project``, ``select``, ``slice``, ``merge``, ``t[...]``,
  the comparisons, the blocked local join).

A distributed context is W shards in P processes of V shards each: the
virtual world (``VirtualWorldConfig(W)``: one process, every shard on
one device, the collectives tensor ops) or a process group
(``MultiHostConfig``: ``torch.distributed``, NCCL across cards, gloo on
the CPU or for processes sharing a card), each process holding its own
shards. ``read_csv_per_rank`` / ``read_parquet_per_rank`` read each
process's shards' files, ``Table.to_pydict_local`` hands its rows out.

Every distributed op exchanges through the padded route (in chunks when
its payload passes CYLON_EXCHANGE_CHUNK_BYTES) or, for skewed, diagonal
or small count matrices, the compact route (parallel/shuffle.py). The
distributed join also runs as a ring join (``comm="ring"``: the build
side rotates around the shards) or a broadcast hash join
(``comm="broadcast"``: the build side is replicated, nothing is
exchanged), both on the per-shard K3/K4 join; ``dist_ops.shuffle(...,
salted=True)`` spreads hot keys over several shards. The context's
``memory_pool`` (memory.py) bounds the exchange buffers and picks the
blocked local join when device memory runs short.

The planned query path (``plan``): ``plan.scan(t)`` builds a lazy
pipeline (project, filter, shuffle, join, groupby, set ops, sort); the
optimizer elides exchanges whose input is already hash-placed, localizes
a groupby on its join's partitioning, prunes unused columns and pushes
filters below exchanges; ``execute(analyze=True)`` runs it and keeps an
EXPLAIN ANALYZE report on ``last_report``. Every node runs in a
``telemetry`` span, its output in the telemetry ledger, under the
``resilience`` layer's deadline, admission control and retries.

The query service (``service``): ``QueryService`` takes many LazyTable
queries from many tenants (deficit round-robin queues, dispatch-time
admission, typed backpressure) and runs them one at a time on one worker
thread; the plan cache (``service.plancache``) memoizes optimized plans
by fingerprint, in the service and in library mode alike (importing the
package installs it); ``service.ObsServer`` serves /metrics, /healthz,
/queries, /slo and /stats. ``plan.task_exchange`` routes rows to the
shards owning their tasks; ``telemetry.profiler`` records each kernel
library's build; ``arrow_builder``, ``io.dataloader`` and
``benchutils`` are the bindings-facing and benchmark edges.

Entry points run on CUDA unless the context is created with
``device="cpu"``.

    import cylon_tpu_torch as ct
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    left = ct.Table.from_pydict(ctx, {"k": keys_l, "v": vals_l})
    right = ct.Table.from_pydict(ctx, {"k": keys_r, "v": vals_r})
    out = left.distributed_join(right, "inner", on=["k"])
    rows = left.distributed_union(left2)  # left2: left's schema
    sums = out.groupby(0, [1], ["sum"])
    planned = (ct.plan.scan(left).join(ct.plan.scan(right), on="k")
               .groupby("lt-0", ["rt-3"], ["sum"]).execute())
"""
from .config import (CommConfig, CommType, CSVReadOptions, CSVWriteOptions,
                     LocalConfig, MPIConfig, MultiHostConfig,
                     VirtualWorldConfig)
from .context import CylonContext
from . import telemetry
from .data.column import Column
from .data.table import Table, concat_tables
from .io.csv import read_csv, read_csv_per_rank, write_csv
from .io.parquet import read_parquet, read_parquet_per_rank, write_parquet
from .ops.groupby import AggregationOp
from .ops.join import JoinAlgorithm, JoinConfig, JoinType
from .parallel.dist_ops import (distributed_groupby, distributed_join,
                                distributed_join_ring, distributed_set_op,
                                distributed_sort, hash_partition,
                                repartition, shuffle)
from .parallel.shard import distribute_by_key
from . import plan
from .plan import LazyTable, col
from . import resilience
from . import service
from .service import QueryService, QueryTicket
from . import table_api
from .status import (Code, CylonDataError, CylonError, CylonPlanError,
                     CylonResourceExhausted, CylonTimeoutError,
                     CylonTransientError, Status)

__all__ = [
    "CommConfig", "CommType", "CSVReadOptions", "CSVWriteOptions",
    "LocalConfig", "MPIConfig", "MultiHostConfig", "VirtualWorldConfig",
    "CylonContext", "Column", "Table", "concat_tables", "read_csv",
    "read_csv_per_rank", "write_csv",
    "JoinAlgorithm", "JoinConfig", "JoinType", "Code", "CylonError",
    "Status", "AggregationOp", "distributed_groupby", "distributed_sort",
    "hash_partition", "repartition", "read_parquet", "read_parquet_per_rank",
    "write_parquet", "CylonDataError", "CylonPlanError",
    "CylonResourceExhausted", "CylonTimeoutError", "CylonTransientError",
    "LazyTable", "QueryService", "QueryTicket", "col", "plan",
    "resilience", "service", "table_api", "telemetry",
    "distribute_by_key", "distributed_join", "distributed_join_ring",
    "distributed_set_op", "shuffle",
]
