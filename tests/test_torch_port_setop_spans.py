"""The stage spans, the host-sync site and the route counter of the
port's local set op, on the CPU.

* A world-1 ``distributed_union`` (the local set op) opens one ``setop``
  span holding its stages, nested and in order: ``setop.prepare``, then
  on the stream route (forced on the CPU, where K5 and K6 run their
  plain versions) ``setop.hash``, ``setop.sort``, ``setop.stream`` and
  ``setop.materialize``; on the dense-ranks route ``setop.dense``; after
  a hash collision the stream stages and then ``setop.dense``.
* The stream route's counts fetch counts once a call at
  ``cylon_host_syncs_total{site="setop.count"}``.
* ``cylon_setop_route_total{route=}`` tells the three routes apart.
"""
import re

import numpy as np
import pytest

import cylon_tpu_torch as ct
from cylon_tpu_torch import telemetry as tel
from cylon_tpu_torch.ops import hash as H
from cylon_tpu_torch.ops import setops as SO

N = 3000
STREAM = ("setop.hash", "setop.sort", "setop.stream", "setop.materialize")
TREES = {
    "stream": ("setop", [(s, []) for s in ("setop.prepare",) + STREAM]),
    "dense": ("setop", [("setop.prepare", []), ("setop.dense", [])]),
    "collision": ("setop", [(s, []) for s in ("setop.prepare",) + STREAM[:3]
                            + ("setop.dense",)]),
}
SYNC = 'cylon_host_syncs_total{site="setop.count"}'


@pytest.fixture
def ctx():
    return ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(1),
                                           device="cpu")


@pytest.fixture(params=sorted(TREES))
def route(request, monkeypatch):
    """Force one route: the stream route, dense ranks, or the stream
    route with both hash avalanches forced to 0, so that every live row
    shares one run and K5 reports collisions."""
    monkeypatch.setattr(SO, "STREAM_SETOP", request.param != "dense")
    if request.param == "collision":
        monkeypatch.setattr(H, "fmix32", lambda h: h * 0)
        monkeypatch.setattr(H, "fmix32b", lambda h: h * 0)
    return request.param


def _tables(ctx):
    rng = np.random.default_rng(22)
    return [ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, N // 3, N).astype(np.int64),
        "v": rng.integers(0, 4, N).astype(np.float64)}) for _ in range(2)]


def _tree(s):
    return (s.name, [_tree(c) for c in s.children])


def _flat(tree):
    name, children = tree
    return [name] + [n for c in children for n in _flat(c)]


def _counters(prefix):
    return {k: v for k, v in tel.metrics_snapshot().items()
            if k.startswith(prefix)}


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def test_spans_nest_in_order(ctx, route):
    left, right = _tables(ctx)
    with tel.collect_phases() as cp:
        out = left.distributed_union(right)
    assert [re.sub(r"#\d+$", "", x) for x in cp.labels] == \
        _flat(TREES[route])
    assert _tree(cp.spans[0]) == TREES[route]
    want = {(k, v) for t in (left, right)
            for k, v in zip(*t.to_pydict().values())}
    got = list(zip(*out.to_pydict().values()))
    assert len(got) == len(set(got)) and set(got) == want


def test_the_stream_fetch_counts_once(ctx, route):
    left, right = _tables(ctx)
    before = _counters("cylon_host_syncs_total")
    left.distributed_union(right)
    got = _delta(before, _counters("cylon_host_syncs_total"))
    assert got.get(SYNC, 0) == (0 if route == "dense" else 1), got


@pytest.mark.parametrize("op", ["union", "subtract", "intersect"])
def test_the_route_counter_names_the_route(ctx, route, op):
    left, right = _tables(ctx)
    before = _counters("cylon_setop_route_total")
    getattr(left, op)(right)
    assert _delta(before, _counters("cylon_setop_route_total")) == \
        {f'cylon_setop_route_total{{route="{route}"}}': 1}
