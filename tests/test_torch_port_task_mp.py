"""``plan.task_exchange`` on a process group on the CPU: W = 4 shards as 2
processes of 2 shards each (tests/torch_port_mp_child.py ``tasks``,
joined by gloo through a ``file://`` rendezvous). Every process passes
the global table and the global task ids.

Each process's shards, the ``__task__`` column included, are held
against the port's virtual world at W = 4 (bit for bit, rows in the same
order) and against cylon_tpu's ``task_exchange`` on ``dist_ctx`` (the
same rows in the same order on every shard). With one unknown task id
among process 0's rows, every process raises ``KeyError`` (the processes
agree through one all-reduce before any raises), and a task exchange
after it runs in step on both. The children have a timeout: a process
that hangs fails the test.
"""
import numpy as np
import pytest

import cylon_tpu as jct
from cylon_tpu.parallel.task_plan import LogicalTaskPlan as JPlan
from cylon_tpu.parallel.task_plan import task_exchange as jexchange

import cylon_tpu_torch as tct

import torch_port_mp_child as child

CHILD_TIMEOUT = 240
ROUTES = ("default", "kernel")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both routes' groups, started at once."""
    base = tmp_path_factory.mktemp("task_mp")
    procs = {r: child.start(base / r, 2, 2, "tasks", r) for r in ROUTES}
    yield base, procs
    for group in procs.values():
        for p in group:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs(started, reference, virtual):
    """{route: [each process's result]}; the children run while this
    process computes the reference and the virtual world."""
    base, procs = started
    return {r: child.finish(base / r, group, CHILD_TIMEOUT)
            for r, group in procs.items()}


@pytest.fixture(scope="module")
def virtual():
    """{route: export} of the port's virtual world at W = 4."""
    ctx = tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(4),
                                           device="cpu")
    cols, tasks, mapping, _bad = child.task_inputs()
    from cylon_tpu_torch.plan.tasks import LogicalTaskPlan, task_exchange

    out = {}
    for route in ROUTES:
        child.set_route(route)
        try:
            out[route] = child.export(task_exchange(
                tct.Table.from_pydict(ctx, cols), tasks,
                LogicalTaskPlan(mapping, 4), ctx), ctx)
        finally:
            child.set_route("default")
    return out


@pytest.fixture(scope="module")
def reference(request):
    """cylon_tpu's routed table on dist_ctx: (emit mask, columns)."""
    jctx = request.getfixturevalue("dist_ctx")
    cols, tasks, mapping, _bad = child.task_inputs()
    out = jexchange(jct.Table.from_pydict(jctx, cols), tasks,
                    JPlan(mapping, 4), jctx)
    return (np.asarray(out.emit_mask()),
            {c.name: np.asarray(c.data) for c in out._columns})


@pytest.mark.parametrize("route", ROUTES)
def test_shards_equal_virtual_world(runs, virtual, route):
    parts = runs[route]
    child.assert_same_export([p["routed"] for p in parts], virtual[route])
    child.assert_same_export([p["after"] for p in parts], virtual[route])
    assert virtual[route]["names"][-1] == "__task__"


@pytest.mark.parametrize("route", ROUTES)
def test_shards_equal_reference(runs, reference, route):
    """Shard for shard, in slot order, the rows equal cylon_tpu's; every
    row sits on its task's owner."""
    emit, cols = reference
    cap = emit.shape[0] // 4
    got = child.merged([p["routed"] for p in runs[route]])
    sid = np.flatnonzero(emit) // cap
    assert np.array_equal(got["sid"], sid)
    for name, a in cols.items():
        assert np.array_equal(child.float_bits(got["cols"][name]),
                              child.float_bits(a[emit])), name
    _cols, _tasks, mapping, _bad = child.task_inputs()
    owner = np.array([mapping[t] for t in got["cols"]["__task__"]])
    assert np.array_equal(owner, got["sid"])


@pytest.mark.parametrize("route", ROUTES)
def test_unknown_id_raises_on_every_process(runs, route):
    """Only process 0's shards hold the unknown id; both processes raise
    KeyError, process 1 naming the id as elsewhere, and neither hangs."""
    (c0, m0), (c1, m1) = (p["unknown"] for p in runs[route])
    assert c0 == c1 == "KeyError"
    assert f"task ids not in plan: [{child.TASK_COUNT + 4}]" in m0
    assert "task ids not in plan: []" in m1 and "1 on other processes" in m1
