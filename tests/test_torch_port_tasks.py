"""The task-routed exchange of cylon_tpu_torch (``plan.tasks``,
``parallel.task_plan``) against cylon_tpu's on the CPU: the same tables
and task ids, made from one numpy seed, go through both packages'
``task_exchange`` at world 4 and 8; the output's emit mask and every
shard's live rows, the ``__task__`` column included, must be equal, in
order. Also: ``LogicalTaskPlan``'s maps and errors, a distributed table
whose dead rows carry filler ids, unknown task ids and over-long id
arrays, each typed as in the reference. ``_exchange_table``'s old callers
(every distributed op) are held by the other port test files.
"""
import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.parallel import shard as jshard
from cylon_tpu.parallel.task_plan import LogicalTaskPlan as JPlan
from cylon_tpu.parallel.task_plan import task_exchange as jexchange

import cylon_tpu_torch as tct
from cylon_tpu_torch.parallel import shard as tshard
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch.parallel.task_plan import LogicalTaskPlan as TPlan
from cylon_tpu_torch.parallel.task_plan import task_exchange as texchange
from cylon_tpu_torch.plan import tasks as ttasks

TASKS = 6


@pytest.fixture(scope="module")
def tctxs():
    return {w: tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(w),
                                                device="cpu")
            for w in (4, 8)}


def _jctx(request, world):
    return request.getfixturevalue("dist_ctx" if world == 4 else "dist_ctx8")


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return {"v": np.arange(n, dtype=np.int64),
            "z": rng.normal(size=n).astype(np.float32),
            "k": rng.integers(-50, 50, n).astype(np.int32)}, \
        rng.integers(0, TASKS, n)


def _shards(table, world):
    """(emit mask, per-shard live rows of every column as numpy) of a
    table of either package."""
    emit = np.asarray(table.emit_mask()) if not isinstance(
        table.emit_mask(), torch.Tensor) else table.emit_mask().numpy()
    cols = []
    for c in table._columns:
        d = c.data
        cols.append(d.numpy() if isinstance(d, torch.Tensor)
                    else np.asarray(d))
    cap = emit.shape[0] // world
    out = []
    for s in range(world):
        sl = slice(s * cap, (s + 1) * cap)
        live = emit[sl]
        out.append([c[sl][live] for c in cols])
    return emit, out


def _assert_equal_shards(jout, tout, world):
    assert [c.name for c in jout._columns] == \
        [c.name for c in tout._columns]
    assert tout._columns[-1].name == "__task__"
    assert tout._columns[-1].data.dtype == torch.int32
    je, js = _shards(jout, world)
    te, ts = _shards(tout, world)
    assert np.array_equal(je, te)
    for a, b in zip(js, ts):
        for ca, cb in zip(a, b):
            assert ca.dtype == cb.dtype
            assert np.array_equal(ca.view(np.uint8), cb.view(np.uint8))


def test_task_plan_maps_and_errors():
    for Plan in (JPlan, TPlan):
        plan = Plan({0: 0, 1: 2, 2: 2, 3: 1}, 4)
        assert plan.worker_of(1) == 2
        assert plan.tasks_of(2) == [1, 2]
        assert plan.tasks_of(3) == []
        with pytest.raises(Exception) as ei:
            plan.worker_of(9)
        assert ei.value.code.name == "KeyError"
        with pytest.raises(Exception) as ei:
            Plan({0: 7}, 4)
        assert ei.value.code.name == "Invalid"
    assert ttasks.LogicalTaskPlan is TPlan
    assert tct.plan.task_exchange is texchange


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("n", [4000, 37])
def test_task_exchange_matches_reference(request, tctxs, world, n):
    jctx, tctx = _jctx(request, world), tctxs[world]
    arrays, tasks = _arrays(n, 5 + world + n)
    mapping = {t: (3 * t + 1) % world for t in range(TASKS)}
    jt = jct.Table.from_pydict(jctx, arrays)
    tt = tct.Table.from_pydict(tctx, arrays)
    jout = jexchange(jt, tasks, JPlan(mapping, world), jctx)
    tout = texchange(tt, tasks, TPlan(mapping, world), tctx)
    assert tout.row_count == n == jout.row_count
    _assert_equal_shards(jout, tout, world)
    # every live row sits on the shard owning its task, the payload is
    # the input as a multiset
    emit, shards = _shards(tout, world)
    for s, cols in enumerate(shards):
        assert {mapping[t] for t in cols[-1].tolist()} <= {s}
    assert sorted(np.concatenate([c[0] for c in shards]).tolist()) == \
        list(range(n))


def test_task_exchange_kernel_route_matches(request, tctxs, monkeypatch):
    """The K1/K2 route (forced on the CPU: the kernels' plain versions
    through the real call sites) gives the reference's shards too."""
    monkeypatch.setattr(tshuffle, "PARTITION_KERNEL", True)
    jctx, tctx = _jctx(request, 4), tctxs[4]
    arrays, tasks = _arrays(3000, 17)
    mapping = {t: t % 4 for t in range(TASKS)}
    jout = jexchange(jct.Table.from_pydict(jctx, arrays), tasks,
                     JPlan(mapping, 4), jctx)
    tout = texchange(tct.Table.from_pydict(tctx, arrays), tasks,
                     TPlan(mapping, 4), tctx)
    _assert_equal_shards(jout, tout, 4)


def test_task_exchange_dead_rows_carry_filler_ids(request, tctxs):
    """A distributed table's dead (padding) rows may carry any id: only
    live ids are checked, and dead rows never route."""
    world = 4
    jctx, tctx = _jctx(request, world), tctxs[world]
    arrays, tasks = _arrays(4001, 23)
    mapping = {t: t % world for t in range(TASKS)}
    jt = jshard.distribute(jct.Table.from_pydict(jctx, arrays), jctx)
    tt = tshard.distribute(tct.Table.from_pydict(tctx, arrays), tctx)
    assert jt.capacity == tt.capacity > 4001
    emit = tt.emit_mask().numpy()
    assert np.array_equal(emit, np.asarray(jt.emit_mask()))
    ids = np.full(tt.capacity, 999, np.int64)
    ids[::7] = -3
    ids[emit] = tasks
    jout = jexchange(jt, ids, JPlan(mapping, world), jctx)
    tout = texchange(tt, ids, TPlan(mapping, world), tctx)
    assert tout.row_count == 4001
    _assert_equal_shards(jout, tout, world)


def test_task_exchange_unknown_and_long_ids(request, tctxs):
    world = 4
    jctx, tctx = _jctx(request, world), tctxs[world]
    arrays, tasks = _arrays(200, 29)
    mapping = {t: t % world for t in range(TASKS)}
    bad = tasks.copy()
    bad[17] = TASKS + 3
    for ct, ctx, Plan, ex in ((jct, jctx, JPlan, jexchange),
                              (tct, tctx, TPlan, texchange)):
        t = ct.Table.from_pydict(ctx, arrays)
        with pytest.raises(ct.CylonError, match="task ids not in plan") as ei:
            ex(t, bad, Plan(mapping, world), ctx)
        assert ei.value.code == ct.Code.KeyError
        with pytest.raises(ct.CylonError, match="longer than table") as ei:
            ex(t, np.zeros(10_000, np.int64), Plan(mapping, world), ctx)
        assert ei.value.code == ct.Code.Invalid


def test_exchange_table_extra_legs(tctxs):
    """``_exchange_table``'s extra legs ride the same exchange as the
    columns: each row's leg lands beside its row, and the columns are
    bit-identical to the exchange without extras."""
    from cylon_tpu_torch.parallel import dist_ops as tdist

    tctx = tctxs[4]
    arrays, _tasks = _arrays(1000, 31)
    t = tshard.distribute(tct.Table.from_pydict(tctx, arrays), tctx)
    targets = torch.from_numpy(
        (np.arange(t.capacity) * 7 % 4).astype(np.int32))
    tag = torch.arange(t.capacity, dtype=torch.int32) * 3
    cols0, emit0, x0 = tdist._exchange_table(t, targets, t.emit_mask(), tctx)
    cols1, emit1, x1 = tdist._exchange_table(t, targets, t.emit_mask(), tctx,
                                             {"tag": tag})
    assert x0 == {} and torch.equal(emit0, emit1)
    for a, b in zip(cols0, cols1):
        assert torch.equal(a.data, b.data)
    live = emit1
    assert torch.equal(x1["tag"][live],
                       cols1[0].data[live].to(torch.int32) * 3)
    with pytest.raises(tct.CylonError, match="names a payload leaf"):
        tdist._exchange_table(t, targets, t.emit_mask(), tctx, {"d0": tag})
