"""Collective checker: the public operators of ``parallel/`` run on a
virtual world (counterpart of cylon_tpu.analysis.collectives — the same
guarantees, not a copy: the port has no jaxpr to read).

The JAX package traces each ``shard_map`` kernel factory abstractly and
walks its jaxpr. The port's operators are eager torch over ``[V, ...]``
per-shard views, with every collective behind the context's backend
(``ctx.comm``, parallel/comm.py). So this checker RUNS each operator of
a declared catalog on small seeded inputs, with a recording wrapper
around the context's comm and under a
``torch.utils._python_dispatch.TorchDispatchMode`` that sees every aten
op:

* ``collectives/comm-seam`` — the counterpart of ``axis-name``: no
  ``torch.distributed`` import or call outside ``parallel/comm.py`` and
  ``context.py`` (static). A collective issued past the seam runs
  outside the virtual world, the recording wrapper and the gloo staging.
* ``collectives/all-to-all-axes`` — every ``all_to_all`` send is the
  shard-major ``[V, W, ...]`` stack (``[W_src, W_dst, ...]`` in the
  virtual world, where V = W) and its result has the send's shape and
  dtype; every ``ring_shift``, ``gather_full`` and ``replicated_gather``
  input leads with the local shard count V.
* ``collectives/f64-promotion`` — no aten op returns a float64 tensor
  when none of its tensor inputs is float64: a cast (``_to_copy``) to
  float64 always counts; a factory or a dtype view that yields float64
  counts while no float64 tensor exists yet in the entry's run (after a
  float64 exists, a buffer of its dtype propagates it). On the card a
  stray float64 halves the bandwidth of every pass it touches. Anchored
  at the innermost package line that ran the op; a deliberate one (a
  float64 mean) opts out per line with
  ``# cylint: disable=collectives/f64-promotion`` and a reason.
* ``collectives/trace-error`` — an entry point that raises.
* ``collectives/uncataloged-factory`` — a public function of
  ``parallel/shuffle.py`` or ``parallel/dist_ops.py`` the catalog does
  not cover (a host-only helper opts out on its def line).

The catalog (`default_entry_points`) runs every entry at world 4 (the
world-1 set op, which runs the local set op, at world 1) on a few
hundred seeded rows: int32 keys, float32 values, and varbytes columns
where the op takes strings. The kernel route switches are forced on
while it runs: on the CPU the operators run the plain versions of K1-K6
through their real call sites, on the card (``options["device"] =
"cuda"``) the kernels themselves — a failure there is a finding, never
retried on the CPU. Option ``collectives_coverage_only`` runs just the
static rules (the fast form fixture tests drive);
``collectives_entry_module`` loads a fixture catalog (``ENTRY_POINTS``)
instead.
"""
from __future__ import annotations

import ast
import os
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from .core import AnalysisContext, Finding, attr_chain, register

CATALOG_FILES = ("parallel/shuffle.py", "parallel/dist_ops.py")
SEAM_FILES = ("parallel/comm.py", "context.py")

_SH = "parallel/shuffle.py"
_DO = "parallel/dist_ops.py"


@dataclass
class EntryPoint:
    """One catalog entry: ``run(ctx)`` calls the public function
    ``func`` of ``path`` (package-relative) on its fixed inputs, built
    on ``ctx`` (a virtual world of ``world`` shards)."""

    name: str
    path: str
    func: str
    run: Callable
    world: int = 4


# ---------------------------------------------------------------------------
# the declared catalog for cylon_tpu_torch.parallel
# ---------------------------------------------------------------------------

_ROWS = 320


def _tables(ctx, seed: int, strings: bool = False, wide: bool = False):
    """Two tables of _ROWS seeded rows each: int32 key ``k`` (64
    values; int64 with ``wide``, which a join hashes), float32 ``v``
    (``w`` on the right), and with ``strings`` a varbytes column ``s`` of
    distinct 10-40 byte values."""
    import numpy as np

    from ..data.table import Table  # cylint: disable=layering/analysis-read-only — the catalog builds the tables its operators run on (the port has no jaxpr to read abstractly)

    rng = np.random.default_rng(seed)
    out = []
    for side, val in ((0, "v"), (1, "w")):
        d = {"k": rng.integers(0, 64, _ROWS).astype(
                 np.int64 if wide else np.int32),
             val: rng.normal(size=_ROWS).astype(np.float32)}
        if strings:
            d["s"] = np.array([f"{side}-{i:05d}-" + "x" * int(m)
                               for i, m in enumerate(
                                   rng.integers(2, 32, _ROWS))])
        out.append(Table.from_pydict(ctx, d))
    return out


def _flat(ctx, seed: int):
    """Flat per-row operands of the shuffle entry points: a payload of
    int32 and float32 legs, int32 targets over the world, an emit mask
    with some dead rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = ctx.local_shard_count() * (_ROWS // 4)
    dev = ctx.device
    payload = {"d0": torch.from_numpy(
        rng.integers(-1000, 1000, n).astype(np.int32)).to(dev),
        "d1": torch.from_numpy(
        rng.normal(size=n).astype(np.float32)).to(dev)}
    targets = torch.from_numpy(rng.integers(
        0, ctx.get_world_size(), n).astype(np.int32)).to(dev)
    emit = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    return payload, targets, emit


def _join_config(how: str):
    from ..ops import join as _join

    return _join.JoinConfig(_join.JoinType[how], [0], [0])


def default_entry_points() -> List[EntryPoint]:
    """The catalog: every public function of parallel/shuffle.py and
    parallel/dist_ops.py but the host-only helpers that opt out."""
    from ..ops import groupby as _groupby
    from ..ops import setops as _setops
    from ..parallel import dist_ops as D
    from ..parallel import shard
    from ..parallel import shuffle as S

    def count_pair(ctx):
        _p, t, e = _flat(ctx, 1)
        _p2, t2, e2 = _flat(ctx, 2)
        return S.count_pair(t, e, t2, e2, ctx)

    def exchange(max_block=None):
        def run(ctx):
            p, t, e = _flat(ctx, 3)
            return S.exchange(p, t, e, ctx, max_block=max_block)
        return run

    def exchange_pair(ctx):
        p, t, e = _flat(ctx, 4)
        p2, t2, e2 = _flat(ctx, 5)
        c1, c2 = S.count_pair(t, e, t2, e2, ctx)
        return S.exchange_pair(p, t, e, c1, p2, t2, e2, c2, ctx)

    def salted(ctx):
        _p, t, e = _flat(ctx, 6)
        return S.salted_exchange_targets(t, e, ctx, 4, 2.0)

    def varlen_take(ctx):
        import torch

        a, _b = _tables(ctx, 7, strings=True)
        d = shard.distribute(a, ctx)
        vb = d._columns[2].varbytes
        n = d.capacity // ctx.local_shard_count()
        idx = torch.arange(d.capacity, device=ctx.device).remainder(n)
        idx = torch.where(idx % 3 == 0, -1, n - 1 - idx).to(torch.int32)
        return D.varlen_take_sharded(vb, idx, ctx.comm)

    def shuffle(salted_=False):
        def run(ctx):
            a, _b = _tables(ctx, 8)
            return D.shuffle(a, ["k"], salted=salted_)
        return run

    def join(how, strings=False, wide=False):
        def run(ctx):
            a, b = _tables(ctx, 9, strings, wide)
            return D.distributed_join(a, b, _join_config(how))
        return run

    def ring(how):
        def run(ctx):
            a, b = _tables(ctx, 10)
            return D.distributed_join_ring(a, b, _join_config(how))
        return run

    def bcast(ctx):
        a, b = _tables(ctx, 11)
        return D.broadcast_hash_join(a, b, _join_config("INNER"), 1)

    def setop(op, strings=False):
        def run(ctx):
            a, b = _tables(ctx, 12, strings)
            return D.distributed_set_op(a, b, _setops.SetOp[op])
        return run

    def hash_partition(ctx):
        a, _b = _tables(ctx, 13)
        return D.hash_partition(a, ["k"], 4)

    def repartition(ctx):
        a, _b = _tables(ctx, 14)
        return D.repartition(a, ctx)

    def groupby(ops, pre_aggregate=True):
        def run(ctx):
            a, _b = _tables(ctx, 15)
            return D.distributed_groupby(
                a, 0, [1] * len(ops),
                [_groupby.AggregationOp[o] for o in ops],
                pre_aggregate=pre_aggregate)
        return run

    def sort(ctx):
        a, _b = _tables(ctx, 16, strings=True)
        return D.distributed_sort(a, ["k", "s"], [True, False])

    E = EntryPoint
    return [
        E("count_pair", _SH, "count_pair", count_pair),
        E("exchange_padded", _SH, "exchange", exchange()),
        E("exchange_rounds", _SH, "exchange", exchange(max_block=8)),
        E("exchange_pair", _SH, "exchange_pair", exchange_pair),
        E("salted_targets", _SH, "salted_exchange_targets", salted),
        E("varlen_take", _DO, "varlen_take_sharded", varlen_take),
        E("shuffle", _DO, "shuffle", shuffle()),
        E("shuffle_salted", _DO, "shuffle", shuffle(True)),
        E("join_inner", _DO, "distributed_join", join("INNER")),
        E("join_full_outer", _DO, "distributed_join", join("FULL_OUTER")),
        E("join_strings", _DO, "distributed_join", join("LEFT", True)),
        # an int64 key: the hash stream (K8 on the card)
        E("join_int64_key", _DO, "distributed_join",
          join("INNER", wide=True)),
        E("ring_inner", _DO, "distributed_join_ring", ring("INNER")),
        E("ring_left", _DO, "distributed_join_ring", ring("LEFT")),
        E("broadcast_inner", _DO, "broadcast_hash_join", bcast),
        E("setop_union", _DO, "distributed_set_op", setop("UNION")),
        E("setop_intersect_strings", _DO, "distributed_set_op",
          setop("INTERSECT", True)),
        # world 1: the local set op (K5 + K6 on the card)
        E("setop_union_world1", _DO, "distributed_set_op", setop("UNION"),
          world=1),
        E("hash_partition", _DO, "hash_partition", hash_partition),
        E("repartition", _DO, "repartition", repartition),
        E("groupby_pre_aggregate", _DO, "distributed_groupby",
          groupby(("SUM", "MEAN", "MAX"))),
        E("groupby_rows", _DO, "distributed_groupby",
          groupby(("SUM", "COUNT"), pre_aggregate=False)),
        E("sort", _DO, "distributed_sort", sort),
    ]


def _load_entry_module(path: str) -> List[EntryPoint]:
    """Load ENTRY_POINTS from a fixture module file (tests)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_cylint_entries", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.ENTRY_POINTS)


# ---------------------------------------------------------------------------
# the runtime: a recording comm and a dispatch mode
# ---------------------------------------------------------------------------


class _Where:
    """Maps the Python stack to the innermost package source line (the
    analysis suite's own frames excluded)."""

    def __init__(self, package_dir: str):
        self.root = os.path.abspath(package_dir) + os.sep
        self.skip = (os.path.join(self.root, "analysis") + os.sep,)

    def __call__(self) -> Optional[Tuple[str, int]]:
        for fr in reversed(traceback.extract_stack()):
            f = os.path.abspath(fr.filename)
            if f.startswith(self.root) and not f.startswith(self.skip):
                return (f[len(self.root):].replace(os.sep, "/"),
                        fr.lineno)
        return None


class _Sink:
    """Findings of one catalog run, deduplicated by (rule, path, line)."""

    def __init__(self, entry: str, where: _Where,
                 fallback: Tuple[str, int]):
        self.entry = entry
        self.where = where
        self.fallback = fallback
        self.found: Dict[Tuple[str, str, int], str] = {}

    def add(self, rule: str, message: str) -> None:
        path, line = self.where() or self.fallback
        self.found.setdefault((rule, path, line),
                              f"{self.entry}: {message}")


# aten ops that convert a tensor's dtype
_CASTS = {"_to_copy", "to", "_convert_element_type", "type_as"}


class _RecordingComm:
    """The context's comm, its shard-major collectives checked."""

    def __init__(self, inner, sink: _Sink):
        self._inner = inner
        self._sink = sink

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _lead(self, what: str, x) -> None:
        v = self._inner.shards
        if x.dim() < 1 or x.shape[0] != v:
            self._sink.add("collectives/all-to-all-axes",
                           f"{what} input {tuple(x.shape)} does not lead "
                           f"with the local shard count {v}")

    def all_to_all(self, send):
        v, w = self._inner.shards, self._inner.world
        if send.dim() < 2 or send.shape[0] != v or send.shape[1] != w:
            self._sink.add("collectives/all-to-all-axes",
                           f"all_to_all send {tuple(send.shape)} is not "
                           f"the shard-major [{v}, {w}, ...] stack")
        out = self._inner.all_to_all(send)
        if tuple(out.shape) != tuple(send.shape) or out.dtype != send.dtype:
            self._sink.add("collectives/all-to-all-axes",
                           f"all_to_all returned {tuple(out.shape)} "
                           f"{out.dtype} for a {tuple(send.shape)} "
                           f"{send.dtype} send")
        return out

    def ring_shift(self, x):
        self._lead("ring_shift", x)
        return self._inner.ring_shift(x)

    def gather_full(self, x):
        self._lead("gather_full", x)
        return self._inner.gather_full(x)

    def replicated_gather(self, x):
        self._lead("replicated_gather", x)
        return self._inner.replicated_gather(x)


def _f64_mode(sink: _Sink):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    f64 = torch.float64

    class _F64Mode(TorchDispatchMode):
        seen = False   # a float64 tensor exists in this run

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            in64 = any(isinstance(t, torch.Tensor) and t.dtype == f64
                       for t in tree_leaves((args, kwargs)))
            out64 = any(isinstance(o, torch.Tensor) and o.dtype == f64
                        for o in tree_leaves(out))
            if out64 and not in64 and (
                    func.overloadpacket.__name__ in _CASTS
                    or not self.seen):
                sink.add("collectives/f64-promotion",
                         f"{func} returns float64 from no float64 input "
                         f"(implicit promotion: a float64 cast, factory "
                         f"or numpy float64 entering the operator)")
            self.seen = self.seen or in64 or out64
            return out

    return _F64Mode()


class _Routes:
    """The kernel route switches forced on for the catalog run, the
    previous values restored after it."""

    def __enter__(self):
        from ..ops import join as _join
        from ..ops import setops as _setops
        from ..parallel import shuffle as _shuffle

        self.saved = [(m, a, getattr(m, a)) for m, a in (
            (_join, "STREAM_PLAN"), (_setops, "STREAM_SETOP"),
            (_shuffle, "PARTITION_KERNEL"))]
        for m, a, _v in self.saved:
            setattr(m, a, True)
        return self

    def __exit__(self, *exc):
        for m, a, v in self.saved:
            setattr(m, a, v)
        return False


def _def_line(ctx: AnalysisContext, path: str, func: str) -> int:
    for f in ctx.files():
        if f.rel != path:
            continue
        for node in f.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == func:
                return node.lineno
    return 1


def run_catalog(ctx: AnalysisContext, entries: List[EntryPoint],
                device: str = "cpu") -> List[Finding]:
    """Run every entry on a fresh virtual world of its width on
    ``device``; returns the runtime findings (all-to-all-axes,
    f64-promotion, trace-error)."""
    from .. import context as _context
    from ..config import VirtualWorldConfig

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings: List[Finding] = []
    notes: List[str] = ctx.options.setdefault("notes", [])
    found: Dict[Tuple[str, str, int], str] = {}
    with _Routes():
        for e in entries:
            line = _def_line(ctx, e.path, e.func)
            sink = _Sink(e.name, _Where(pkg_dir), (e.path, line))
            try:
                wctx = _context.CylonContext.InitDistributed(
                    VirtualWorldConfig(e.world), device=device)
                wctx.comm = _RecordingComm(wctx.comm, sink)
                with _f64_mode(sink):
                    e.run(wctx)
            except Exception as exc:  # cylint: disable=errors/broad-swallow — a raising entry point becomes a trace-error Finding
                findings.append(Finding(
                    rule="collectives/trace-error", path=e.path, line=line,
                    message=f"{e.name}: {type(exc).__name__}: {exc}"))
            for key, msg in sink.found.items():
                found.setdefault(key, msg)
    findings.extend(Finding(rule=r, path=p, line=ln, message=m)
                    for (r, p, ln), m in sorted(found.items()))
    notes.append(f"collectives: {len(entries)} catalog entries run on "
                 f"{device}")
    return findings


# ---------------------------------------------------------------------------
# the static rules
# ---------------------------------------------------------------------------


def _seam_findings(ctx: AnalysisContext) -> List[Finding]:
    """``collectives/comm-seam``: torch.distributed outside the seam."""
    findings: List[Finding] = []
    for f in ctx.files():
        if f.rel in SEAM_FILES:
            continue
        lines: Set[int] = set()
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Import):
                if any(a.name == "torch.distributed" or
                       a.name.startswith("torch.distributed.")
                       for a in node.names):
                    lines.add(node.lineno)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mod = node.module or ""
                if mod == "torch.distributed" or \
                        mod.startswith("torch.distributed.") or \
                        (mod == "torch" and
                         any(a.name == "distributed" for a in node.names)):
                    lines.add(node.lineno)
            elif isinstance(node, ast.Attribute):
                chain = attr_chain(node)
                if chain is not None and chain[:2] == ("torch",
                                                       "distributed"):
                    lines.add(node.lineno)
        for line in sorted(lines):
            findings.append(Finding(
                rule="collectives/comm-seam", path=f.rel, line=line,
                message="torch.distributed outside parallel/comm.py and "
                        "context.py: a collective issued past the comm "
                        "seam runs outside the virtual world and the "
                        "recording wrapper — go through ctx.comm"))
    return findings


def _coverage_findings(ctx: AnalysisContext, covered) -> List[Finding]:
    """One ``collectives/uncataloged-factory`` finding per public
    function of the catalog files the entry points miss."""
    findings: List[Finding] = []
    for f in ctx.files():
        if f.rel not in CATALOG_FILES:
            continue
        for node in f.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and not node.name.startswith("_") and \
                    (f.rel, node.name) not in covered:
                findings.append(Finding(
                    rule="collectives/uncataloged-factory", path=f.rel,
                    line=node.lineno,
                    message=f"{node.name} is not in the collectives "
                            f"entry-point catalog: its collectives are "
                            f"never run under the checks — add an "
                            f"EntryPoint (or disable this rule on the def "
                            f"line if it issues no collective)"))
    return findings


@register("collectives")
def check_collectives(ctx: AnalysisContext) -> List[Finding]:
    entry_module = ctx.options.get("collectives_entry_module")
    findings = _seam_findings(ctx)
    if ctx.options.get("collectives_coverage_only"):
        covered = {(e.path, e.func) for e in default_entry_points()}
        return findings + _coverage_findings(ctx, covered)
    entries = _load_entry_module(entry_module) if entry_module \
        else default_entry_points()
    findings += run_catalog(ctx, entries,
                            str(ctx.options.get("device", "cpu")))
    if entry_module is None:
        covered = {(e.path, e.func) for e in entries}
        findings += _coverage_findings(ctx, covered)
    return findings
