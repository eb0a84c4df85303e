"""The observability endpoint of cylon_tpu_torch against cylon_tpu's on
the CPU: the endpoint cases of tests/test_obs.py (routes and payloads,
503 after close, the CYLON_OBS_PORT knob, port 0, the concurrent scrape
hammer) and the service cases of tests/test_stats.py (the snapshot saved
on close, the replica that warm-starts through ``start()``, the /stats
route), each run through both packages.

The payloads are compared across the packages with times, ids and byte
counts masked: the same keys, and the same tenants, outcomes, plan
fingerprints, admission actions and row counts.

The scrape hammer checks the leaks of its own queries (the tracked
tables alive before and after it), not the process total: a process
that runs other test files first (pytest-xdist's ``--dist loadfile``
puts several files in one worker) may hold their tables.
"""
import gc
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import cylon_tpu as jct
from cylon_tpu import plan as jplan
from cylon_tpu import telemetry as jtel
from cylon_tpu.service import ObsServer as JObs
from cylon_tpu.service import obs_http as jobs_http
from cylon_tpu.service import plancache as jcache
from cylon_tpu.service.scheduler import QueryService as JService

import cylon_tpu_torch as tct
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import telemetry as ttel
from cylon_tpu_torch.service import ObsServer as TObs
from cylon_tpu_torch.service import obs_http as tobs_http
from cylon_tpu_torch.service import plancache as tcache
from cylon_tpu_torch.service.scheduler import QueryService as TService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_NAMES = ("jax", "torch")
# digest and payload fields that differ run to run or package to package
# by design: times, ids, byte and memory counts
MASKED = ("ms", "_s", "time", "ts", "t0", "id", "bytes", "hbm", "peak",
          "wall", "seq", "age", "uptime", "limit", "in_use")


@pytest.fixture(scope="module")
def tctx():
    return tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(4),
                                            device="cpu")


def _pkg(name, jctx, tctx):
    if name == "jax":
        return types.SimpleNamespace(
            name=name, ct=jct, plan=jplan, tel=jtel, cache=jcache,
            Service=JService, Obs=JObs, http=jobs_http, ctx=jctx)
    return types.SimpleNamespace(
        name=name, ct=tct, plan=tplan, tel=ttel, cache=tcache,
        Service=TService, Obs=TObs, http=tobs_http, ctx=tctx)


@pytest.fixture(params=PKG_NAMES)
def pk(request, tctx):
    return _pkg(request.param, request.getfixturevalue("dist_ctx"), tctx)


@pytest.fixture
def both(request, tctx):
    jctx = request.getfixturevalue("dist_ctx")
    return [_pkg(n, jctx, tctx) for n in PKG_NAMES]


@pytest.fixture(autouse=True)
def _clean():
    for tel in (jtel, ttel):
        tel.stats.reset()
    yield
    for tel in (jtel, ttel):
        tel.stats.reset()
        tel.querylog.reset()
        tel.slo.reset()
    for cache in (jcache, tcache):
        cache.global_cache().clear()


def _tables(pk, n=512, seed=0, key_space=None):
    rng = np.random.default_rng(seed)
    ks = key_space or max(n // 4, 1)
    left = pk.ct.Table.from_pydict(pk.ctx, {
        "k": rng.integers(0, ks, n).astype(np.int32),
        "v": rng.normal(size=n).astype(np.float32)})
    right = pk.ct.Table.from_pydict(pk.ctx, {
        "k": rng.integers(0, ks, n).astype(np.int32),
        "w": rng.normal(size=n).astype(np.float32)})
    return left, right


def _pipe(pk, left, right):
    return pk.plan.scan(left).join(pk.plan.scan(right), on="k") \
        .groupby("lt-1", ["rt-2"], ["sum"])


def _get(obs, route):
    with urllib.request.urlopen(obs.url(route), timeout=30) as r:
        return r.status, r.read().decode("utf-8")


def _mask(doc):
    """A payload with every time, id, byte and memory field masked."""
    if isinstance(doc, dict):
        return {k: "*" if any(m in k for m in MASKED) else _mask(v)
                for k, v in sorted(doc.items())}
    if isinstance(doc, list):
        return [_mask(v) for v in doc]
    if isinstance(doc, float):
        return "*"
    return doc


# ---------------------------------------------------------------------------
# the observability endpoint
# ---------------------------------------------------------------------------


def _routes_run(pk, monkeypatch):
    """One served query with an ObsServer up: every route's status and
    parsed payload."""
    monkeypatch.setenv("CYLON_SLO_P95_MS", "60000")
    left, right = _tables(pk, seed=9)
    pk.tel.querylog.reset()
    pk.tel.slo.reset()
    svc = pk.Service(name="obs-test")
    obs = pk.Obs(service=svc, port=0).start()
    out = {}
    try:
        tk = svc.submit(_pipe(pk, left, right), tenant="route-t")
        svc.drain(timeout=600)
        tk.result(timeout=60)
        status, prom = _get(obs, "/metrics")
        assert status == 200
        assert "# TYPE cylon_phase_latency_ms histogram" in prom
        assert any(l.startswith("cylon_slo_latency_p95_ms")
                   and 'tenant="route-t"' in l for l in prom.splitlines())
        out["/metrics"] = sorted({l.split("{")[0].split(" ")[0]
                                  for l in prom.splitlines()
                                  if l.startswith("# TYPE cylon_slo")
                                  or l.startswith("# TYPE cylon_queries")
                                  or l.startswith("# TYPE cylon_service")})
        for route in ("/healthz", "/queries", "/slo"):
            status, body = _get(obs, route)
            assert status == 200
            out[route] = json.loads(body)
        hz = out["/healthz"]
        assert hz["ok"] and hz["service"]["worker_alive"] is True
        assert hz["service"]["queue_depth"] == 0
        assert any(d["tenant"] == "route-t" for d in out["/queries"])
        assert "route-t" in out["/slo"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(obs, "/nope")
        assert ei.value.code == 404
    finally:
        obs.close()
        svc.close()
    assert not any(t.name == "cylon-obs" for t in threading.enumerate())
    return out


def test_endpoint_routes_and_payloads(pk, monkeypatch):
    _routes_run(pk, monkeypatch)


def test_endpoint_payloads_equal_across_packages(both, monkeypatch):
    """The same served query gives the same payloads in both packages,
    times, ids and byte counts masked (the pool block of /healthz is
    the port's CPU pool, zeros, and masked with the rest)."""
    docs = [_routes_run(pk, monkeypatch) for pk in both]
    for route in ("/metrics", "/slo", "/queries"):
        assert _mask(docs[0][route]) == _mask(docs[1][route]), route
    hz = [_mask({k: v for k, v in d["/healthz"].items() if k != "pool"})
          for d in docs]
    assert hz[0] == hz[1]
    assert [sorted(d["/healthz"].get("pool", {})) for d in docs] == \
        [["bytes_in_use", "bytes_limit", "peak_bytes"]] * 2


def test_healthz_503_after_close(pk):
    svc = pk.Service(name="dead-test")
    obs = pk.Obs(service=svc, port=0).start()
    try:
        svc.close()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(obs, "/healthz")
        assert ei.value.code == 503
    finally:
        obs.close()


def test_service_arms_endpoint_from_knob(pk, monkeypatch):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    monkeypatch.setenv("CYLON_OBS_PORT", str(port))
    svc = pk.Service(name="knob-test")
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            assert json.loads(r.read())["ok"] is True
    finally:
        svc.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5)


def test_endpoint_disabled_at_port_zero(pk, monkeypatch):
    monkeypatch.setenv("CYLON_OBS_PORT", "0")
    svc = pk.Service(name="noobs-test")
    try:
        assert svc._obs is None
        assert not any(t.name == "cylon-obs" for t in threading.enumerate())
    finally:
        svc.close()


def test_concurrent_scrape_hammer(pk):
    """Scrape threads hammer /metrics, /queries, /healthz, /slo and
    /stats while submitters drive queries through the service: every
    response parses, every query completes, and once the results are
    dropped the process holds no more tracked tables than before."""
    left, right = _tables(pk, seed=11)
    direct = _pipe(pk, left, right).execute().to_pydict()
    gc.collect()
    held = pk.tel.ledger.leak_count()
    svc = pk.Service(name="hammer-obs")
    obs = pk.Obs(service=svc, port=0).start()
    n_scrapers, n_submitters, per = 4, 3, 3
    errors, results = [], []
    stop = threading.Event()
    barrier = threading.Barrier(n_scrapers + n_submitters)
    routes = ("/metrics", "/queries", "/healthz", "/slo", "/stats")

    def scraper(i):
        barrier.wait(timeout=30)
        k = 0
        while not stop.is_set() or k < len(routes):
            route = routes[k % len(routes)]
            try:
                status, body = _get(obs, route)
                assert status == 200
                if route == "/metrics":
                    assert body.startswith("# TYPE")
                else:
                    json.loads(body)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append((route, repr(e)))
                break
            k += 1

    def submitter(i):
        try:
            barrier.wait(timeout=30)
            tickets = [svc.submit(_pipe(pk, left, right), tenant=f"ham-{i}")
                       for _ in range(per)]
            for tk in tickets:
                results.append(tk.result(timeout=600).to_pydict())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(("submit", repr(e)))

    threads = [threading.Thread(target=scraper, args=(i,))
               for i in range(n_scrapers)] + \
              [threading.Thread(target=submitter, args=(i,))
               for i in range(n_submitters)]
    for t in threads:
        t.start()
    for t in threads[n_scrapers:]:
        t.join(timeout=600)
    stop.set()
    for t in threads[:n_scrapers]:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == n_submitters * per
    want = {k: np.asarray(v).tolist() for k, v in direct.items()}
    for got in results:
        assert {k: np.asarray(v).tolist() for k, v in got.items()} == want
    obs.close()
    svc.close()
    del results, direct, got
    gc.collect()
    assert pk.tel.ledger.leak_count() == held


# ---------------------------------------------------------------------------
# the service and the statistics warehouse (tests/test_stats.py)
# ---------------------------------------------------------------------------


def _seed_store(s, n_obs=3):
    for i in range(n_obs):
        s._observe_node("pfp", "nfp", "join",
                        {"bytes": 1000.0 + i, "rows": 10 + i},
                        ("bytes", "rows"), 2000.0, float(i))
    return s


def test_never_started_close_preserves_snapshot(pk, tmp_path, monkeypatch):
    path = str(tmp_path / "stats.jsonl")
    st = pk.tel.stats
    _seed_store(st.STORE)
    st.save(path)
    learned = open(path).read()
    st.reset()
    monkeypatch.setenv("CYLON_STATS_PATH", path)
    svc = pk.Service(name="never-started", start=False)
    svc.close()
    svc.close()
    assert open(path).read() == learned
    assert not os.path.exists(path + ".1")
    svc2 = pk.Service(name="started")
    svc2.close()
    s2 = st.StatsStore()
    assert s2.load(path) == 1


def test_snapshot_equal_across_packages(both, tmp_path):
    """The same observations save the same snapshot lines in both
    packages (the replica of either can load the other's)."""
    lines = []
    for pk in both:
        path = str(tmp_path / f"{pk.name}.jsonl")
        st = pk.tel.stats
        st.reset()
        _seed_store(st.STORE)
        st.save(path)
        lines.append([_mask(json.loads(l)) for l in open(path)])
        st.reset()
    assert lines[0] == lines[1]


def test_cross_process_warm_start(dist_ctx, tmp_path, monkeypatch):
    """The replica warm-start pin, across the packages: the reference
    learns a query shape and saves its snapshot; fresh port processes
    (hash seeds 0 and 1) load it through ``QueryService.start()``, key
    their first query by the reference's fingerprint and admit it on
    measured statistics."""
    monkeypatch.setenv("CYLON_STATS_MIN_OBS", "2")
    jpk = _pkg("jax", dist_ctx, None)
    left, right = _tables(jpk, n=1024, seed=12, key_space=256)
    for _ in range(3):
        _pipe(jpk, left, right).execute()
    here_fp = _pipe(jpk, left, right).plan_fingerprint()
    path = str(tmp_path / "stats.jsonl")
    assert jtel.stats.save(path) == path
    prog = textwrap.dedent("""
        import json
        import numpy as np
        import cylon_tpu_torch as ct
        from cylon_tpu_torch import plan
        from cylon_tpu_torch.service import QueryService
        from cylon_tpu_torch.telemetry import querylog
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                              device="cpu")
        rng = np.random.default_rng(777)
        n = 1024
        left = ct.Table.from_pydict(ctx, {
            "k": rng.integers(0, 256, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32)})
        right = ct.Table.from_pydict(ctx, {
            "k": rng.integers(0, 256, n).astype(np.int32),
            "w": rng.normal(size=n).astype(np.float32)})
        p = plan.scan(left).join(plan.scan(right), on="k") \\
            .groupby("lt-1", ["rt-2"], ["sum"])
        svc = QueryService(name="replica")
        tk = svc.submit(p, tenant="warm")
        svc.drain(timeout=600)
        tk.result(timeout=60)
        svc.close()
        d = querylog.recent()[-1]
        print(json.dumps({"fp": d["plan_fp"],
                          "est_source": d["est_source"],
                          "outcome": d["outcome"]}))
    """)
    for seed in ("0", "1"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=ROOT,
                   CYLON_STATS_PATH=path, CYLON_STATS_MIN_OBS="2")
        r = subprocess.run([sys.executable, "-c", prog],
                           capture_output=True, text=True, timeout=300,
                           env=env, cwd=ROOT)
        assert r.returncode == 0, r.stderr
        doc = json.loads(r.stdout.strip().splitlines()[-1])
        assert doc == {"fp": here_fp, "est_source": "measured",
                       "outcome": "ok"}


def _stats_doc(pk):
    left, right = _tables(pk, n=1024, seed=13)
    _pipe(pk, left, right).execute()
    obs = pk.Obs(service=None, port=0).start()
    try:
        status, body = _get(obs, "/stats")
    finally:
        obs.close()
    assert status == 200
    doc = json.loads(body)
    assert doc["plan_count"] >= 1
    assert {e["kind"] for e in doc["nodes"]} >= {"join", "groupby"}
    assert "join" in doc["qerror"] and "p95" in doc["qerror"]["join"]
    assert doc["config"]["min_obs"] >= 1
    assert doc["drift_events"] == []
    return doc


def test_stats_route_served(pk):
    _stats_doc(pk)


def test_render_stats_equal_across_packages(both):
    """/stats (``render_stats``) after the same query: the same
    fingerprints, node kinds, observation counts and configuration in
    both packages (the q-error block by its keys: its histograms count
    every query the process ran)."""
    docs = []
    for pk in both:
        pk.tel.stats.reset()
        doc = _stats_doc(pk)
        assert pk.http.render_stats() == pk.tel.stats.state()
        # the q-error histograms accumulate over the process's queries
        doc["qerror"] = {k: sorted(v) for k, v in doc["qerror"].items()}
        docs.append(_mask(doc))
    assert docs[0] == docs[1]
