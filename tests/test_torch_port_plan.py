"""The planned query path of cylon_tpu_torch against cylon_tpu's on the
CPU: the same ``LazyTable`` pipelines (the cases of tests/test_plan.py:
same keys, changed keys, co-partitioned ingest, string keys, filter
pushdown, projection pruning, filter-only columns, the unoptimized path,
re-execution, set ops and sort, world 1, the table_api roundtrip, the
registry rebind) run through both packages on inputs made from one numpy
seed. For each pipeline these are equal in the two packages:

* the optimized plan text (``ir.format_plan``) and ``PlanStats``;
* ``plan_fingerprint()``, as strings;
* ``verify_plan``'s messages on the optimized plan and on the same plan
  with a join-side exchange deleted;
* ``collect_phases().count("plan.shuffle")`` and
  ``count("shuffle.exchange")``;
* the ordered span names, filtered to ``plan.``, ``shuffle.`` and
  ``join.`` (the ``#seq`` suffix dropped: each package numbers its own
  operations);
* the result rows, bit for bit, except float sums, which agree within
  1e-5 x sum(|x|) of their group (the reference's group sums of |x|
  bound them).

The JAX side runs on the 4-device CPU mesh (``dist_ctx``), the port on
the virtual world of 4 shards; every case runs once per package, in a
module-scoped cache.
"""
import re
import types

import numpy as np
import pytest

import cylon_tpu as jct
from cylon_tpu import plan as jplan
from cylon_tpu import table_api as japi
from cylon_tpu import telemetry as jtel
from cylon_tpu.parallel import dist_ops as jdist
from cylon_tpu.plan import ir as jir
from cylon_tpu.plan import verify as jverify

import cylon_tpu_torch as tct
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import table_api as tapi
from cylon_tpu_torch import telemetry as ttel
from cylon_tpu_torch.parallel import dist_ops as tdist
from cylon_tpu_torch.plan import ir as tir
from cylon_tpu_torch.plan import verify as tverify

SUM_RTOL = 1e-5
LABEL_PREFIXES = ("plan.", "shuffle.", "join.")
# the port's stage spans of its local join and local set op, which the JAX
# package does not open (tests/test_torch_port_stage_spans.py and
# tests/test_torch_port_setop_spans.py hold them)
PORT_ONLY_SPANS = ("join.prepare", "join.plan.hash", "join.plan.sort",
                   "join.plan.stream", "join.rebuild", "setop",
                   "setop.prepare", "setop.hash", "setop.sort",
                   "setop.stream", "setop.materialize", "setop.dense")


@pytest.fixture(scope="module", autouse=True)
def _forget_learned_statistics():
    """Both packages' statistics warehouses learn from every query run
    here: forget it all when the module ends, so that no later test file
    in this process plans with it (the JAX package's plan cache too)."""
    yield
    from cylon_tpu.service import plancache

    for tel in (jtel, ttel):
        tel.stats.reset()
        tel.querylog.reset()
    plancache.global_cache().clear()


def _pkgs(request):
    """The two packages side by side: (name, namespace) pairs."""
    jctx = {4: request.getfixturevalue("dist_ctx"),
            0: request.getfixturevalue("local_ctx")}
    tctx = {4: tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(4),
                                                device="cpu"),
            0: tct.CylonContext.Init(device="cpu")}
    return {
        "jax": types.SimpleNamespace(ct=jct, plan=jplan, api=japi,
                                     tel=jtel, dist=jdist, ir=jir,
                                     verify=jverify, ctx=jctx),
        "torch": types.SimpleNamespace(ct=tct, plan=tplan, api=tapi,
                                       tel=ttel, dist=tdist, ir=tir,
                                       verify=tverify, ctx=tctx)}


def make_tables(P, ctx, n=4000, seed=0, absval=False):
    """test_plan.make_tables's arrays; ``absval`` takes |v| (the bound of
    a float sum's tolerance)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n).astype(np.float32)
    left = P.ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, n // 4, n).astype(np.int32),
        "v": np.abs(v) if absval else v,
        "z": rng.integers(0, 50, n).astype(np.int32)})
    right = P.ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, n // 4, n).astype(np.int32),
        "w": rng.integers(0, 100, n).astype(np.int32)})
    return left, right


def _string_tables(P, ctx):
    rng = np.random.default_rng(7)
    n = 800
    ks = np.array([f"a{v:03d}" for v in rng.integers(0, 60, n)], object)
    left = P.ct.Table.from_pydict(ctx, {"k": ks, "v": np.arange(n)})
    right = P.ct.Table.from_pydict(ctx, {
        "k": np.array([f"a{v:03d}" for v in rng.integers(0, 80, n)],
                      object),
        "w": np.arange(n) * 2})
    return left, right


def _setop_tables(P, ctx):
    rng = np.random.default_rng(17)
    n = 1000
    a = P.ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, n, n).astype(np.int32),
        "g": rng.integers(0, 1 << 10, n).astype(np.int32)})
    b = P.ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, n, n).astype(np.int32),
        "g": rng.integers(0, 1 << 10, n).astype(np.int32)})
    return a, b


# Each case: (P, ctx, absval) -> (LazyTable to optimize and execute,
# execute() keyword arguments, a runner or None). A runner replaces the
# plain execute: it returns the result Table (it may execute twice).

def _same_keys(P, ctx, absval):
    l, r = make_tables(P, ctx)
    return P.plan.scan(l).join(P.plan.scan(r), on="k") \
        .groupby("lt-0", ["rt-4"], ["sum"]), {}, None


def _changed_keys(P, ctx, absval):
    l, r = make_tables(P, ctx)
    return P.plan.scan(l).join(P.plan.scan(r), on="k") \
        .groupby("lt-2", ["rt-4"], ["sum"]), {}, None


def _copartitioned(P, ctx, absval):
    l, r = make_tables(P, ctx, seed=5)
    lp = P.ct.distribute_by_key(l, ctx, ["k"])
    rp = P.ct.distribute_by_key(r, ctx, ["k"])
    return P.plan.scan(lp).join(P.plan.scan(rp), on="k") \
        .groupby("lt-0", ["rt-4"], ["sum"]), {}, None


def _string_keys(P, ctx, absval):
    l, r = _string_tables(P, ctx)
    return P.plan.scan(l).join(P.plan.scan(r), on="k") \
        .groupby("lt-0", ["rt-3"], ["count"]), {}, None


def _filter_pushdown(P, ctx, absval):
    l, r = make_tables(P, ctx, seed=9)
    return P.plan.scan(l).shuffle("k").filter(P.plan.col("z") < 25) \
        .join(P.plan.scan(r), on="k"), {}, None


def _projection_pruning(P, ctx, absval):
    l, r = make_tables(P, ctx, seed=11)
    return P.plan.scan(l).join(P.plan.scan(r), on="k") \
        .groupby("lt-0", ["rt-4"], ["mean"]), {}, None


def _filter_only_columns(P, ctx, absval):
    l, r = make_tables(P, ctx, seed=27, absval=absval)
    return P.plan.scan(l).filter(P.plan.col("z") < 25) \
        .join(P.plan.scan(r), on="k") \
        .groupby("lt-0", ["lt-1"], ["sum"]), {}, None


def _unoptimized(P, ctx, absval):
    l, r = make_tables(P, ctx, seed=13)
    return P.plan.scan(l).join(P.plan.scan(r), on="k") \
        .groupby("lt-0", ["rt-4"], ["sum"]), {"optimize": False}, None


def _reexecution(P, ctx, absval):
    l, r = make_tables(P, ctx, seed=15)
    pipe = P.plan.scan(l).join(P.plan.scan(r), on="k")

    def run():
        first = pipe.execute()
        second = pipe.execute()
        assert _rows(first) == _rows(second)
        return second
    return pipe, {}, run


def _union(P, ctx, absval):
    a, b = _setop_tables(P, ctx)
    return P.plan.scan(a).union(P.plan.scan(b)), {}, None


def _subtract_intersect(P, ctx, absval):
    a, b = _setop_tables(P, ctx)
    return P.plan.scan(a).subtract(P.plan.scan(b)) \
        .intersect(P.plan.scan(a)), {}, None


def _sort(P, ctx, absval):
    a, _b = _setop_tables(P, ctx)
    return P.plan.scan(a).sort("k"), {}, None


def _world1(P, ctx, absval):
    l, r = make_tables(P, P.ctx[0], seed=19)
    return P.plan.scan(l).join(P.plan.scan(r), on="k") \
        .groupby("lt-0", ["rt-4"], ["sum"]), {}, None


def _table_api(P, ctx, absval):
    l, r = make_tables(P, ctx, seed=21)
    P.api.put_table("port-plan-left", l)
    P.api.put_table("port-plan-right", r)
    lazy = P.api.lazy_table("port-plan-left").join(
        P.api.lazy_table("port-plan-right"), on="k")

    def run():
        P.api.execute_plan(lazy, "port-plan-out")
        out = P.api.get_table("port-plan-out")
        for tid in ("port-plan-left", "port-plan-right", "port-plan-out"):
            P.api.remove_table(tid)
        return out
    return lazy, {}, run


def _registry_rebind(P, ctx, absval):
    l, _r = make_tables(P, ctx, seed=33)
    P.api.put_table("port-rebind-me", P.ct.distribute_by_key(l, ctx, ["k"]))
    lazy = P.api.lazy_table("port-rebind-me").shuffle("k")

    def run():
        # the witnessed input skips the exchange; rebound to a fresh
        # table the kept Shuffle exchanges
        lazy.execute()
        fresh, _ = make_tables(P, ctx, seed=35)
        P.api.put_table("port-rebind-me", fresh)
        out = lazy.execute()
        P.api.remove_table("port-rebind-me")
        return out
    return lazy, {}, run


CASES = {
    "same_keys": _same_keys,
    "changed_keys": _changed_keys,
    "copartitioned_ingest": _copartitioned,
    "string_keys": _string_keys,
    "filter_pushdown": _filter_pushdown,
    "projection_pruning": _projection_pruning,
    "filter_only_columns": _filter_only_columns,
    "unoptimized": _unoptimized,
    "reexecution": _reexecution,
    "union": _union,
    "subtract_intersect": _subtract_intersect,
    "sort": _sort,
    "world1": _world1,
    "table_api_roundtrip": _table_api,
    "registry_rebind": _registry_rebind,
}
# cases whose result holds float sums, with the float columns' positions
FLOAT_SUMS = {"filter_only_columns": [1]}


def _rows(t):
    """The result as a sorted list of row tuples (numpy scalars kept, so
    floats compare bit for bit)."""
    d = t.to_pydict()
    cols = [list(np.asarray(v)) for v in d.values()]
    return sorted(zip(*cols), key=lambda r: tuple(map(str, r)))


def _delete_join_shuffle(root, ir):
    """A copy of ``root`` with the first exchange below a join removed
    (the mutation verify_plan must reject)."""
    import copy

    root = copy.deepcopy(root)
    for node in ir.walk(root):
        if isinstance(node, ir.Join):
            for i, c in enumerate(node.children):
                if isinstance(c, ir.Shuffle):
                    node.children[i] = c.children[0]
                    return root
    return root


def _run_case(P, name):
    world = 0 if name == "world1" else 4
    ctx = P.ctx[world]
    pipe, kw, runner = CASES[name](P, P.ctx[4], False)
    root, stats = pipe.optimized()
    w = 1 if world == 0 else 4
    out = {"plan": P.ir.format_plan(root), "stats": stats.summary(),
           "stats_fields": {k: v for k, v in vars(stats).items()},
           "fingerprint": str(pipe.plan_fingerprint()),
           "verify": (P.verify.verify_plan(root, w),
                      P.verify.verify_plan(
                          _delete_join_shuffle(root, P.ir), w))}
    with P.tel.collect_phases() as cp:
        res = runner() if runner is not None else pipe.execute(**kw)
    out["counts"] = (cp.count("plan.shuffle"), cp.count("shuffle.exchange"))
    out["labels"] = [x for x in (re.sub(r"#\d+$", "", lab)
                                 for lab in cp.labels
                                 if lab.startswith(LABEL_PREFIXES))
                     if x not in PORT_ONLY_SPANS]
    out["rows"] = _rows(res)
    if name == "sort":
        # a sort fixes the order: the key column in output order
        out["order"] = list(np.asarray(res.to_pydict()["k"]))
    if name in FLOAT_SUMS:
        apipe, _kw, _r = CASES[name](P, P.ctx[4], True)
        out["abs_rows"] = _rows(apipe.execute())
    assert ctx is not None
    return out


@pytest.fixture(scope="module")
def results(request):
    pk = _pkgs(request)
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = {k: _run_case(P, name) for k, P in pk.items()}
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_optimized_plan_text_and_stats(results, name):
    r = results(name)
    assert r["torch"]["plan"] == r["jax"]["plan"]
    assert r["torch"]["stats"] == r["jax"]["stats"]
    assert r["torch"]["stats_fields"] == r["jax"]["stats_fields"]


@pytest.mark.parametrize("name", list(CASES))
def test_plan_fingerprint(results, name):
    r = results(name)
    assert r["torch"]["fingerprint"] == r["jax"]["fingerprint"]


@pytest.mark.parametrize("name", list(CASES))
def test_verify_messages(results, name):
    r = results(name)
    assert r["torch"]["verify"] == r["jax"]["verify"]
    assert r["torch"]["verify"][0] == []


@pytest.mark.parametrize("name", list(CASES))
def test_exchange_counts(results, name):
    r = results(name)
    assert r["torch"]["counts"] == r["jax"]["counts"]


@pytest.mark.parametrize("name", list(CASES))
def test_span_label_sequence(results, name):
    r = results(name)
    assert r["torch"]["labels"] == r["jax"]["labels"]


@pytest.mark.parametrize("name", list(CASES))
def test_result_rows(results, name):
    r = results(name)
    got, exp = r["torch"]["rows"], r["jax"]["rows"]
    assert len(got) == len(exp)
    floats = FLOAT_SUMS.get(name)
    if not floats:
        assert got == exp
        return
    bound = r["jax"]["abs_rows"]
    assert len(bound) == len(exp)
    for g, e, b in zip(got, exp, bound):
        for i, (x, y) in enumerate(zip(g, e)):
            if i in floats:
                assert abs(float(x) - float(y)) <= SUM_RTOL * float(b[i]) \
                    + 1e-30, (g, e, b)
            else:
                assert x == y, (g, e)


def test_sort_order(results):
    r = results("sort")
    assert r["torch"]["order"] == r["jax"]["order"]
    assert r["torch"]["order"] == sorted(r["torch"]["order"])


def test_known_shuffle_counts(results):
    """The counts test_plan.py pins for the reference hold in both:
    join -> groupby on the join key runs one exchange stage, on another
    key two, co-partitioned inputs none, world 1 none."""
    expect = {"same_keys": 1, "changed_keys": 2, "copartitioned_ingest": 0,
              "world1": 0}
    for name, n in expect.items():
        assert results(name)["torch"]["counts"][0] == n, name
