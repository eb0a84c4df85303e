"""The query service of cylon_tpu_torch against cylon_tpu's on the CPU:
the cases of tests/test_service.py (the plan/fingerprint cache, the
library-mode memo, the QueryService scheduler), each run through both
packages on inputs made from one numpy seed, plus the checks that join
them:

* fingerprints equal as strings across the packages for the same plans
  (and across two port subprocesses of different PYTHONHASHSEED);
* cache hit/miss/eviction counts, ``dispatch_seq`` orders, outcomes and
  error types, gauges and outcome counters: each package gives the
  reference test's numbers;
* result rows: group keys bit-equal, float sums within 1e-5 x sum |x|
  of their group;
* bench.py ``bench_service_pipeline``'s sequence at 512 rows a side: the
  cache counts both packages give (chip_smoke.py phase 24a holds the
  card to them), and no kernel factory built over the served queries;
* a cached template reaches no Table and no torch tensor, and pins no
  table after the query's tables are dropped.

The JAX side runs on the 4-device CPU mesh (``dist_ctx``), the port on
the virtual world of 4 shards with ``device="cpu"``.
"""
import gc
import os
import subprocess
import sys
import textwrap
import threading
import types
import weakref

import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu import plan as jplan
from cylon_tpu import table_api as japi
from cylon_tpu import telemetry as jtel
from cylon_tpu.plan import ir as jir
from cylon_tpu.resilience import inject as jinject
from cylon_tpu.service import plancache as jcache
from cylon_tpu.service.scheduler import QueryService as JService

import cylon_tpu_torch as tct
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import table_api as tapi
from cylon_tpu_torch import telemetry as ttel
from cylon_tpu_torch.plan import ir as tir
from cylon_tpu_torch.resilience import inject as tinject
from cylon_tpu_torch.service import plancache as tcache
from cylon_tpu_torch.service.scheduler import QueryService as TService

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_RTOL = 1e-5
PKG_NAMES = ("jax", "torch")


@pytest.fixture(scope="module")
def tctx():
    return tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(4),
                                            device="cpu")


@pytest.fixture(params=PKG_NAMES)
def pk(request, tctx):
    return _pkg(request.param, request.getfixturevalue("dist_ctx"), tctx)


def _pkg(name, jctx, tctx):
    if name == "jax":
        return types.SimpleNamespace(
            name=name, ct=jct, plan=jplan, tel=jtel, ir=jir, inject=jinject,
            cache=jcache, Service=JService, api=japi, ctx=jctx)
    return types.SimpleNamespace(
        name=name, ct=tct, plan=tplan, tel=ttel, ir=tir, inject=tinject,
        cache=tcache, Service=TService, api=tapi, ctx=tctx)


@pytest.fixture
def both(request, tctx):
    jctx = request.getfixturevalue("dist_ctx")
    return [_pkg(n, jctx, tctx) for n in PKG_NAMES]


@pytest.fixture(autouse=True)
def _clean():
    yield
    for inj in (jinject, tinject):
        inj.disarm()
    for cache in (jcache, tcache):
        cache.global_cache().clear()


@pytest.fixture(scope="module", autouse=True)
def _forget_learned_statistics():
    """Both packages' statistics warehouses and query logs learn from
    every query here: forget them when the module ends."""
    yield
    for tel in (jtel, ttel):
        tel.stats.reset()
        tel.querylog.reset()


def _arrays(n=512, seed=0, kdtype=np.int32):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, max(n // 4, 1), n).astype(kdtype),
            "v": rng.normal(size=n).astype(np.float32),
            "z": rng.integers(0, 50, n).astype(np.int32)}
    right = {"k": rng.integers(0, max(n // 4, 1), n).astype(kdtype),
             "w": rng.normal(size=n).astype(np.float32)}
    return left, right


def _tables(pk, n=512, seed=0, kdtype=np.int32):
    la, ra = _arrays(n, seed, kdtype)
    return (pk.ct.Table.from_pydict(pk.ctx, la),
            pk.ct.Table.from_pydict(pk.ctx, ra))


def _pipe(pk, left, right):
    return pk.plan.scan(left).join(pk.plan.scan(right), on="k") \
        .groupby("lt-2", ["rt-4"], ["sum"])


def _rows(table):
    d = table.to_pydict()
    ks = sorted(d)
    return ks, sorted(zip(*(np.asarray(d[k]).tolist() for k in ks)))


def _counter(pk, prefix):
    return sum(v for k, v in pk.tel.metrics_snapshot().items()
               if k.startswith(prefix) and isinstance(v, int))


def _group_sums(la, ra):
    """numpy groupby of the numpy join for _pipe: {z: (sum w, sum |w|)}
    over the z values with at least one matching row."""
    out = {}
    for z, k in zip(la["z"].tolist(), la["k"].tolist()):
        hit = ra["w"][ra["k"] == k].astype(np.float64)
        if hit.size:
            s, a = out.get(z, (0.0, 0.0))
            out[z] = (s + hit.sum(), a + np.abs(hit).sum())
    return out


def _check_groups(table, la, ra):
    """A _pipe result against numpy: group keys exact, sums within
    SUM_RTOL of sum |w| of the group."""
    exp = _group_sums(la, ra)
    d = table.to_pydict()
    keys, sums = (np.asarray(d[c]) for c in list(d)[:2])
    assert sorted(keys.tolist()) == sorted(exp)
    for z, s in zip(keys.tolist(), sums.tolist()):
        ref, scale = exp[z]
        assert abs(s - ref) <= SUM_RTOL * scale + 1e-30, (z, s, ref)


# ---------------------------------------------------------------------------
# fingerprint determinism + collision sensitivity
# ---------------------------------------------------------------------------


def test_fingerprint_equal_shape_different_tables_hits(both):
    fps = []
    for pk in both:
        l0, r0 = _tables(pk, seed=1)
        l1, r1 = _tables(pk, seed=2)
        a = pk.cache.fingerprint(_pipe(pk, l0, r0)._node, 4)
        assert a == pk.cache.fingerprint(_pipe(pk, l1, r1)._node, 4)
        fps.append(a)
    assert fps[0] == fps[1]


def _semantic_fps(pk):
    left, right = _tables(pk, seed=3)
    P = pk.plan
    fp = pk.cache.fingerprint
    l64, r64 = _tables(pk, seed=3, kdtype=np.int64)
    arr = np.arange(16, dtype=np.int32)
    named_k = pk.ct.Table.from_pydict(pk.ctx, {"k": arr})
    named_q = pk.ct.Table.from_pydict(pk.ctx, {"q": arr})
    sh = pk.ct.shuffle(left, [0])
    return {
        "base": fp(_pipe(pk, left, right)._node, 4),
        "int64_key": fp(_pipe(pk, l64, r64)._node, 4),
        "other_keys": fp(P.scan(left).join(P.scan(right), left_on="z",
                                           right_on="k")
                         .groupby("lt-2", ["rt-4"], ["sum"])._node, 4),
        "world8": fp(_pipe(pk, left, right)._node, 8),
        "p01": fp(P.scan(left).project(["k", "v"])._node, 4),
        "p10": fp(P.scan(left).project(["v", "k"])._node, 4),
        "gt3": fp(P.scan(left).filter(P.col("v") > 3.0)._node, 4),
        "gt4": fp(P.scan(left).filter(P.col("v") > 4.0)._node, 4),
        "lt3": fp(P.scan(left).filter(P.col("v") < 3.0)._node, 4),
        "witness": fp(P.scan(sh).sort("k")._node, 4),
        "no_witness": fp(P.scan(left).sort("k")._node, 4),
        "named_k": fp(P.scan(named_k)._node, 4),
        "named_q": fp(P.scan(named_q)._node, 4),
    }


def test_fingerprint_misses_on_semantic_changes(pk):
    f = _semantic_fps(pk)
    base = f["base"]
    assert f["int64_key"] != base
    assert f["other_keys"] != base
    assert f["world8"] != base
    assert f["p01"] != f["p10"]
    assert len({f["gt3"], f["gt4"], f["lt3"]}) == 3
    assert f["witness"] != f["no_witness"]
    assert f["named_k"] != f["named_q"]


def test_fingerprints_equal_across_packages(both):
    """The same plans fingerprint to the same strings in both packages
    (the type strings are numpy names in both)."""
    jf, tf = (_semantic_fps(pk) for pk in both)
    assert jf == tf


def test_fingerprint_stable_across_processes(dist_ctx):
    """No id()/hash-seed dependence: two fresh port interpreters with
    PYTHONHASHSEED 0 and 1 (and other table contents) derive the
    reference's string for the canonical pipeline."""
    jpk = _pkg("jax", dist_ctx, None)
    left, right = _tables(jpk, seed=5)
    here = jcache.fingerprint(_pipe(jpk, left, right)._node, 4)
    prog = textwrap.dedent("""
        import numpy as np
        import cylon_tpu_torch as ct
        from cylon_tpu_torch import plan
        from cylon_tpu_torch.service.plancache import fingerprint
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                              device="cpu")
        rng = np.random.default_rng(99)
        n = 512
        left = ct.Table.from_pydict(ctx, {
            "k": rng.integers(0, n // 4, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32),
            "z": rng.integers(0, 50, n).astype(np.int32)})
        right = ct.Table.from_pydict(ctx, {
            "k": rng.integers(0, n // 4, n).astype(np.int32),
            "w": rng.normal(size=n).astype(np.float32)})
        p = plan.scan(left).join(plan.scan(right), on="k") \\
            .groupby("lt-2", ["rt-4"], ["sum"])
        print(fingerprint(p._node, 4))
    """)
    outs = []
    for seed in ("0", "1"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=ROOT)
        r = subprocess.run([sys.executable, "-c", prog],
                           capture_output=True, text=True, timeout=300,
                           env=env, cwd=ROOT)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.strip().splitlines()[-1])
    assert outs[0] == outs[1] == here


# ---------------------------------------------------------------------------
# plan cache semantics
# ---------------------------------------------------------------------------


def test_cache_hit_skips_optimize_and_matches_eager(pk):
    l0, r0 = _tables(pk, seed=7)
    l1, r1 = _tables(pk, seed=8)
    pk.cache.global_cache().clear()
    m0 = _counter(pk, "cylon_plan_cache_misses_total")
    h0 = _counter(pk, "cylon_plan_cache_hits_total")
    a = _pipe(pk, l0, r0).execute()
    assert _counter(pk, "cylon_plan_cache_misses_total") == m0 + 1
    b = _pipe(pk, l1, r1).execute()
    assert _counter(pk, "cylon_plan_cache_hits_total") == h0 + 1
    with pk.cache.disabled():
        fresh = _pipe(pk, l1, r1).execute()
    assert _rows(b) == _rows(fresh)
    with pk.cache.disabled():
        assert _rows(a) == _rows(_pipe(pk, l0, r0).execute())
    _check_groups(b, *_arrays(seed=8))


def test_cache_hit_preserves_stats_and_explain(pk):
    left, right = _tables(pk, seed=9)
    pk.cache.global_cache().clear()
    p = _pipe(pk, left, right)
    root1, stats1 = p.optimized()
    root2, stats2 = p.optimized()
    assert stats2 is not stats1
    assert stats1.shuffles_inserted == stats2.shuffles_inserted
    assert stats1.shuffles_elided == stats2.shuffles_elided
    assert pk.ir.format_plan(root1) == pk.ir.format_plan(root2)


def _entries(pk):
    cache = pk.cache.global_cache()
    with cache._lock:
        return list(cache._entries.values())


def test_cache_does_not_pin_tables(pk):
    left, right = _tables(pk, seed=10)
    pk.cache.global_cache().clear()
    _pipe(pk, left, right).optimized()
    entries = _entries(pk)
    assert entries
    for tmpl, _stats, _epoch, _vec in entries:
        for node in pk.ir.walk(tmpl):
            if node.kind == "scan":
                assert node.table is None and node.table_id is None


def _reachable(obj):
    """Every object a template reaches through plan nodes and the
    containers they hold (not through classes or functions)."""
    seen, todo, out = set(), [obj], []
    while todo:
        o = todo.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        out.append(o)
        if isinstance(o, dict):
            todo += list(o.keys()) + list(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            todo += list(o)
        elif type(o).__module__.startswith("cylon_tpu_torch"):
            todo += list(getattr(o, "__dict__", {}).values())
            todo += [getattr(o, s) for s in getattr(type(o), "__slots__",
                                                    ()) if hasattr(o, s)]
    return out


def test_template_reaches_no_tensor_and_pins_nothing(tctx):
    """A cached template holds no Table and no torch tensor (a deepcopy
    of one would copy device memory), and once the query's tables are
    dropped, weakrefs to them die although the entry stays cached."""
    pk = _pkg("torch", None, tctx)
    left, right = _tables(pk, seed=15)
    tcache.global_cache().clear()
    out = _pipe(pk, left, right).execute()
    entries = _entries(pk)
    assert len(entries) == 1
    for tmpl, _stats, _epoch, _vec in entries:
        objs = _reachable(tmpl)
        assert len(objs) > 5
        bad = [type(o).__name__ for o in objs
               if isinstance(o, (torch.Tensor, tct.Table))]
        assert not bad, bad
    refs = [weakref.ref(left), weakref.ref(right), weakref.ref(out)]
    del left, right, out
    gc.collect()
    assert all(r() is None for r in refs)
    assert len(tcache.global_cache()) == 1


def test_cache_bounded_lru_evicts(pk, monkeypatch):
    monkeypatch.setenv("CYLON_PLAN_CACHE_MAX", "2")
    left, _right = _tables(pk, seed=11)
    pk.cache.global_cache().clear()
    e0 = _counter(pk, "cylon_plan_cache_evictions_total")
    for cols in (["k"], ["v"], ["z"], ["k", "v"]):
        pk.plan.scan(left).project(cols).optimized()
    assert len(pk.cache.global_cache()) == 2
    assert _counter(pk, "cylon_plan_cache_evictions_total") == e0 + 2


def test_cache_disabled_by_env(pk, monkeypatch):
    monkeypatch.setenv("CYLON_PLAN_CACHE_MAX", "0")
    left, right = _tables(pk, seed=12)
    pk.cache.global_cache().clear()
    h0 = _counter(pk, "cylon_plan_cache_hits_total")
    _pipe(pk, left, right).optimized()
    _pipe(pk, left, right).optimized()
    assert _counter(pk, "cylon_plan_cache_hits_total") == h0
    assert len(pk.cache.global_cache()) == 0


def test_poisoned_cache_entry_rejected_on_hit(pk):
    assert os.environ.get("CYLON_TPU_VERIFY_PLANS") == "1"
    left, right = _tables(pk, seed=13)
    pk.cache.global_cache().clear()
    _pipe(pk, left, right).execute()
    (tmpl, _stats, _epoch, _vec), = _entries(pk)
    poisoned = False
    for node in pk.ir.walk(tmpl):
        if node.kind == "groupby" and not node.local_ok:
            node.local_ok = True
            poisoned = True
    assert poisoned
    with pytest.raises(pk.ct.CylonPlanError):
        _pipe(pk, left, right).execute()
    assert len(pk.cache.global_cache()) == 0
    res = _pipe(pk, left, right).execute()
    with pk.cache.disabled():
        assert _rows(res) == _rows(_pipe(pk, left, right).execute())


def test_library_mode_execute_memoized(pk):
    left, right = _tables(pk, seed=14)
    pk.cache.global_cache().clear()
    h0 = _counter(pk, "cylon_plan_cache_hits_total")
    for _ in range(3):
        _pipe(pk, left, right).execute()
    assert _counter(pk, "cylon_plan_cache_hits_total") == h0 + 2


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def test_service_results_match_direct_execution(pk):
    tabs = {t: _tables(pk, seed=20 + i) for i, t in enumerate(("a", "b"))}
    direct = {t: _rows(_pipe(pk, *tabs[t]).execute()) for t in tabs}
    svc = pk.Service(start=False)
    tickets = [(t, svc.submit(_pipe(pk, *tabs[t]), tenant=t))
               for t in tabs for _ in range(2)]
    svc.drain(timeout=600)
    for t, tk in tickets:
        assert tk.outcome == "ok"
        assert tk.wait_s is not None and tk.wait_s >= 0
        got = tk.result(timeout=60)
        assert _rows(got) == direct[t]
        _check_groups(got, *_arrays(seed=20 + ("a", "b").index(t)))
    svc.close()


def test_service_backpressure_typed_before_enqueue(pk, monkeypatch):
    monkeypatch.setenv("CYLON_SERVICE_QUEUE_MAX", "2")
    left, right = _tables(pk, seed=22)
    svc = pk.Service(start=False)
    svc.submit(_pipe(pk, left, right), tenant="a")
    svc.submit(_pipe(pk, left, right), tenant="a")
    with pytest.raises(pk.ct.CylonResourceExhausted, match="queue full"):
        svc.submit(_pipe(pk, left, right), tenant="b")
    last = pk.tel.flight.admissions()[-1]
    assert last["action"] == "shed" and last["tenant"] == "b"
    assert "queue full" in last["reason"]
    assert svc.depth("b") == 0 and svc.depth() == 2
    monkeypatch.setenv("CYLON_SERVICE_QUEUE_MAX", "256")
    svc.drain(timeout=600)
    svc.close()


def _drr_fair(pk):
    left, right = _tables(pk, seed=23)
    svc = pk.Service(start=False)
    a = [svc.submit(pk.plan.scan(left).sort("k"), tenant="a")
         for _ in range(6)]
    b = svc.submit(pk.plan.scan(right).sort("k"), tenant="b")
    svc.drain(timeout=600)
    svc.close()
    return [t.dispatch_seq for t in a], b.dispatch_seq


def test_service_drr_fair_share(both):
    """Six cheap queries of tenant a before tenant b's one: b dispatches
    within the first two slots, a in submission order, and the two
    packages dispatch in the same order."""
    got = [_drr_fair(pk) for pk in both]
    for seqs, b_seq in got:
        assert b_seq <= 2
        assert seqs == sorted(seqs)
    assert got[0] == got[1]


def _drr_cost(pk):
    big_l, big_r = _tables(pk, n=4096, seed=24)
    small_l, _ = _tables(pk, n=64, seed=25)
    svc = pk.Service(start=False)
    exp = svc.submit(_pipe(pk, big_l, big_r), tenant="expensive")
    cheap = [svc.submit(pk.plan.scan(small_l).sort("k"), tenant="cheap")
             for _ in range(3)]
    svc.drain(timeout=600)
    svc.close()
    return {"expensive": [exp.dispatch_seq],
            "cheap": [c.dispatch_seq for c in cheap]}


def test_service_drr_cost_weighted(both, monkeypatch):
    """Byte-weighted DRR with a 1,024-byte quantum: the cheap tenant's
    three sorts overtake the expensive join in both packages — the order
    chip_smoke.py phase 24c holds the card to."""
    monkeypatch.setenv("CYLON_SERVICE_QUANTUM_BYTES", "1024")
    got = [_drr_cost(pk) for pk in both]
    assert got[0] == got[1] == chip_smoke.REFERENCE_DRR_SEQ


def test_service_shed_typed_others_unaffected(pk):
    left, right = _tables(pk, seed=26)
    big_l, big_r = _tables(pk, n=1 << 16, seed=27)
    direct = _rows(_pipe(pk, left, right).execute())
    marker_spans = []

    def sink(s):
        if s.name == "plan.admission":
            marker_spans.append(s)

    svc = pk.Service(start=False)
    pk.inject.arm("pool:262144:oom")
    pk.tel.add_sink(sink)
    try:
        ok_t = svc.submit(_pipe(pk, left, right), tenant="good")
        shed_t = svc.submit(pk.plan.scan(big_l).join(pk.plan.scan(big_r),
                                                     on="k"),
                            tenant="greedy")
        svc.drain(timeout=600)
    finally:
        pk.tel.remove_sink(sink)
        pk.inject.disarm()
    assert ok_t.outcome == "ok"
    assert _rows(ok_t.result(timeout=60)) == direct
    assert shed_t.outcome == "shed"
    with pytest.raises(pk.ct.CylonResourceExhausted,
                       match="shed by admission controller"):
        shed_t.result(timeout=60)
    sheds = [d for d in pk.tel.flight.admissions()
             if d.get("action") == "shed"]
    assert sheds and sheds[-1]["tenant"] == "greedy"
    assert marker_spans
    m = marker_spans[-1]
    assert m.attrs["decision"] == "shed" and m.attrs["tenant"] == "greedy"
    svc.close()


def test_service_deadline_timeout_outcome(pk):
    left, right = _tables(pk, seed=28)
    svc = pk.Service(start=False)
    tk = svc.submit(_pipe(pk, left, right), tenant="late", deadline_s=1e-6)
    svc.drain(timeout=600)
    assert tk.outcome == "timeout"
    with pytest.raises(pk.ct.CylonTimeoutError):
        tk.result(timeout=60)
    svc.close()


def test_service_error_outcome_typed(pk):
    left, right = _tables(pk, seed=29)
    direct = _rows(_pipe(pk, left, right).execute())
    svc = pk.Service(start=False)
    pk.inject.arm("exchange:1+:transient")
    try:
        bad = svc.submit(_pipe(pk, left, right), tenant="t")
        svc.drain(timeout=600)
    finally:
        pk.inject.disarm()
    assert bad.outcome == "error"
    with pytest.raises(pk.ct.CylonTransientError):
        bad.result(timeout=60)
    good = svc.submit(_pipe(pk, left, right), tenant="t")
    svc.drain(timeout=600)
    assert good.outcome == "ok"
    assert _rows(good.result(timeout=60)) == direct
    svc.close()


def test_service_missing_input_error_typed(pk):
    """chip_smoke.py phase 24c's error: a scan of a registered table that
    is removed before the query runs fails its ticket with a typed
    KeyError in both packages; the next query runs."""
    left, right = _tables(pk, seed=37)
    direct = _rows(_pipe(pk, left, right).execute())
    pk.api.put_table("svc-gone", right)
    svc = pk.Service(start=False)
    bad = svc.submit(pk.plan.scan(left).join(pk.plan.scan("svc-gone"),
                                             on="k"), tenant="t")
    pk.api.remove_table("svc-gone")
    good = svc.submit(_pipe(pk, left, right), tenant="t")
    svc.drain(timeout=600)
    svc.close()
    assert bad.outcome == "error"
    with pytest.raises(pk.ct.CylonError) as ei:
        bad.result(timeout=60)
    assert ei.value.code == pk.ct.Code.KeyError
    assert good.outcome == "ok" and _rows(good.result()) == direct


def test_service_tenant_rides_root_spans_and_report(pk):
    left, right = _tables(pk, seed=30)
    pk.tel.flight.reset()
    svc = pk.Service(name="svc-test", start=False)
    tk = svc.submit(_pipe(pk, left, right), tenant="acme", analyze=True)
    svc.drain(timeout=600)
    rep = tk.report()
    assert rep is not None
    assert rep.span.attrs["tenant"] == "acme"
    assert rep.span.attrs["query_id"] == tk.query_id
    assert rep.span.attrs["service"] == "svc-test"
    ring = [s for s in pk.tel.flight.recent() if s.name == "plan.query"]
    assert ring and ring[-1].attrs.get("tenant") == "acme"
    svc.close()


def test_service_queue_gauges_and_outcome_counters(pk):
    left, right = _tables(pk, seed=31)
    key_ok = 'cylon_queries_total{outcome="ok",tenant="gauge-t"}'
    key_depth = 'cylon_service_queue_depth{tenant="gauge-t"}'
    ok0 = pk.tel.metrics_snapshot().get(key_ok, 0)
    svc = pk.Service(start=False)
    for _ in range(3):
        svc.submit(_pipe(pk, left, right), tenant="gauge-t")
    assert pk.tel.metrics_snapshot()[key_depth] == 3
    svc.drain(timeout=600)
    snap = pk.tel.metrics_snapshot()
    assert snap[key_depth] == 0
    assert snap[key_ok] == ok0 + 3
    svc.close()


def test_service_close_paused_fails_queued_tickets(pk):
    left, right = _tables(pk, seed=36)
    svc = pk.Service(start=False)
    tk = svc.submit(_pipe(pk, left, right), tenant="orphan")
    svc.close()
    assert tk.done() and tk.outcome == "error" and svc.depth() == 0
    with pytest.raises(pk.ct.CylonPlanError, match="closed before"):
        tk.result(timeout=1)


def test_service_submit_after_close_and_bad_arg(pk):
    left, right = _tables(pk, seed=32)
    svc = pk.Service()
    with pytest.raises(pk.ct.CylonPlanError, match="LazyTable"):
        svc.submit(left)
    svc.close()
    with pytest.raises(pk.ct.CylonPlanError, match="closed"):
        svc.submit(_pipe(pk, left, right))


def test_service_concurrent_submitters_hammer(pk):
    """Barrier-started submitter threads hammer one QueryService: results
    bit-identical to sequential execution, per-tenant counters balanced,
    queues drained, every optimize a hit or a miss, no ledger leaks."""
    n_threads, per_thread = 4, 3
    tabs = {i: _tables(pk, seed=40 + i) for i in range(n_threads)}
    direct = {i: _rows(_pipe(pk, *tabs[i]).execute())
              for i in range(n_threads)}
    gc.collect()
    held = pk.tel.ledger.leak_count()
    snap0 = pk.tel.metrics_snapshot()
    ok0 = {i: snap0.get(f'cylon_queries_total{{outcome="ok",tenant="t{i}"}}',
                        0) for i in range(n_threads)}
    pk.cache.global_cache().clear()
    h0 = _counter(pk, "cylon_plan_cache_hits_total")
    m0 = _counter(pk, "cylon_plan_cache_misses_total")
    svc = pk.Service(name="hammer")
    barrier = threading.Barrier(n_threads)
    results, errors = {}, []

    def submitter(i):
        try:
            barrier.wait(timeout=60)
            tickets = [svc.submit(_pipe(pk, *tabs[i]), tenant=f"t{i}")
                       for _ in range(per_thread)]
            results[i] = [_rows(t.result(timeout=600)) for t in tickets]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((i, e))

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    svc.drain(timeout=600)
    svc.close()
    assert not errors, errors
    for i in range(n_threads):
        assert results[i] == [direct[i]] * per_thread
    snap = pk.tel.metrics_snapshot()
    for i in range(n_threads):
        assert snap[f'cylon_queries_total{{outcome="ok",tenant="t{i}"}}'] \
            == ok0[i] + per_thread
        assert snap[f'cylon_service_queue_depth{{tenant="t{i}"}}'] == 0
    dh = _counter(pk, "cylon_plan_cache_hits_total") - h0
    dm = _counter(pk, "cylon_plan_cache_misses_total") - m0
    assert dh + dm == n_threads * per_thread
    assert 1 <= dm <= n_threads
    del results
    gc.collect()
    assert pk.tel.ledger.leak_count() == held


def test_service_no_ledger_leaks(pk):
    left, right = _tables(pk, seed=33)
    gc.collect()
    held = pk.tel.ledger.leak_count()
    svc = pk.Service(start=False)
    tickets = [svc.submit(_pipe(pk, left, right), tenant="leakcheck")
               for _ in range(3)]
    svc.drain(timeout=600)
    for tk in tickets:
        tk.result(timeout=60)
    svc.close()
    del tickets, tk, svc
    gc.collect()
    assert pk.tel.ledger.leak_count() == held


# ---------------------------------------------------------------------------
# bench.py bench_service_pipeline's sequence (chip_smoke.py phase 24a)
# ---------------------------------------------------------------------------


def _service_sequence(pk):
    """bench_service_pipeline at 512 rows a side on an empty cache and
    warehouse: (hits, misses) of the warm-up, the 8 executes under
    ``disabled()``, the 8 served queries; the factory builds over the
    served queries; the served results."""
    rng = np.random.default_rng(11)
    n = 512
    la = {"k": rng.integers(0, n // 4, n).astype(np.int32),
          "v": rng.normal(size=n).astype(np.float32),
          "z": rng.integers(0, 50, n).astype(np.int32)}
    ra = {"k": rng.integers(0, n // 4, n).astype(np.int32),
          "w": rng.normal(size=n).astype(np.float32)}
    left = pk.ct.Table.from_pydict(pk.ctx, la)
    right = pk.ct.Table.from_pydict(pk.ctx, ra)

    def query():
        return pk.plan.scan(left).join(pk.plan.scan(right), on="k") \
            .groupby("lt-0", ["rt-4"], ["sum"])

    def counts():
        return (_counter(pk, "cylon_plan_cache_hits_total"),
                _counter(pk, "cylon_plan_cache_misses_total"))

    pk.cache.global_cache().clear()
    pk.tel.stats.reset()
    out = {}
    c = counts()
    query().execute()
    out["warmup"] = tuple(np.subtract(counts(), c).tolist())
    c = counts()
    with pk.cache.disabled():
        for _ in range(8):
            query().execute()
    out["sequential"] = tuple(np.subtract(counts(), c).tolist())
    c = counts()
    b0 = _counter(pk, "cylon_kernel_factory_builds_total")
    svc = pk.Service(start=False)
    tickets = [svc.submit(query(), tenant=f"t{i % 2}") for i in range(8)]
    svc.start()
    svc.drain(timeout=600)
    results = [tk.result(timeout=600) for tk in tickets]
    svc.close()
    out["service"] = tuple(np.subtract(counts(), c).tolist())
    builds = _counter(pk, "cylon_kernel_factory_builds_total") - b0
    return out, builds, [_rows(r) for r in results], la, ra


def test_service_pipeline_sequence_counts(both):
    """The cache counts of bench_service_pipeline's sequence are the
    reference's in the port (and chip_smoke.REFERENCE_SERVICE_CACHE);
    no kernel factory builds over the served queries in either package
    (the reference counts jit factories, the port its library loads, so
    only the 0 compares); every served result equals numpy."""
    got = [_service_sequence(pk) for pk in both]
    (jc, jb, jrows, la, ra), (tc, tb, trows, _la, _ra) = got
    assert jc == tc == chip_smoke.REFERENCE_SERVICE_CACHE
    assert jb == 0 and tb == 0
    exp = {}
    for k in np.unique(la["k"]).tolist():
        w = ra["w"][ra["k"] == k].astype(np.float64)
        if w.size:
            c = int((la["k"] == k).sum())
            exp[k] = (c * w.sum(), c * np.abs(w).sum())
    for rows in (jrows[0], trows[0]):
        _ks, tuples = rows
        assert sorted(k for k, _s in tuples) == sorted(exp)
        for k, s in tuples:
            assert abs(s - exp[k][0]) <= SUM_RTOL * exp[k][1] + 1e-30
    assert all(r == trows[0] for r in trows)
