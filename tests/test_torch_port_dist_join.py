"""cylon_tpu_torch's shuffle and distributed join against cylon_tpu's on
the virtual CPU mesh: the count matrix and every shard row by row, then
the joined rows as bitwise multisets."""
import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.parallel import dist_ops as jdist
from cylon_tpu.parallel import shard as jshard
from cylon_tpu.parallel import shuffle as jshuffle

import cylon_tpu_torch as tct
from cylon_tpu_torch.interop import from_reference_arrays
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.ops import kernels as K
from cylon_tpu_torch.parallel import dist_ops as tdist
from cylon_tpu_torch.parallel import shuffle as tshuffle

from test_torch_port_join import assert_rows_bit_equal


@pytest.fixture
def route(request):
    """'plan': the port's CPU defaults (stable-sort partition, plan-route
    join); 'kernel': the kernel wrappers forced, which run K1-K4's plain
    versions on the CPU."""
    old = tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL
    forced = request.param == "kernel"
    tjoin.STREAM_PLAN = True if forced else None
    tshuffle.PARTITION_KERNEL = True if forced else None
    yield request.param
    tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL = old


def _arrays(seed, n_left=420, n_right=390):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, 150, n_left).astype(np.int32),
            "v": rng.normal(size=n_left).astype(np.float32)}
    right = {"k": rng.integers(0, 150, n_right).astype(np.int32),
             "x": rng.normal(size=n_right).astype(np.float32),
             "y": rng.integers(-9, 9, n_right).astype(np.int64)}
    lvalid = {"k": rng.random(n_left) < 0.9, "v": rng.random(n_left) < 0.9}
    return left, right, lvalid


def _pair(jctx, tctx, arrays, valid):
    jt = jct.Table([jct.Column.from_numpy(a, n, valid.get(n))
                    for n, a in arrays.items()], jctx)
    tt = tct.Table([tct.Column.from_numpy(a, n, valid.get(n), "cpu")
                    for n, a in arrays.items()], tctx)
    return jt, tt


def _tctx(world):
    return tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(world),
                                            device="cpu")


def _jctx(request, world):
    if world == 4:
        return request.getfixturevalue("dist_ctx")
    if world == 8:
        return request.getfixturevalue("dist_ctx8")
    return jct.CylonContext.InitDistributed(jct.TPUConfig(world_size=world))


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_shuffle_matches_cylon_tpu(request, world, route):
    jctx, tctx = _jctx(request, world), _tctx(world)
    left, _right, lvalid = _arrays(world)
    jt, tt = _pair(jctx, tctx, left, lvalid)

    # the count matrix
    jd = jshard.distribute(jt, jctx)
    jtargets = jshard.pin(jdist._partition_targets_dist(
        jctx, [jd._columns[0]]), jctx)
    jcounts = np.asarray(jshuffle._count_fn(jctx.mesh)(jtargets,
                                                       jd.emit_mask()))
    td = tdist.shard.distribute(tt, tctx)
    ttargets = tdist._partition_targets_dist(world, [td._columns[0]])
    tcounts, _ = tshuffle.count_pair(ttargets, td.emit_mask(), ttargets,
                                     td.emit_mask(), tctx)
    assert np.array_equal(jcounts, tcounts)

    # every shard, row by row
    js = jdist.shuffle(jt, ["k"])
    ts = tdist.shuffle(tt, ["k"])
    assert js.capacity == ts.capacity
    je = np.asarray(js.emit_mask())
    assert np.array_equal(je, ts.emit_mask().numpy())
    for jc, tc in zip(js._columns, ts._columns):
        assert np.array_equal(np.asarray(jc.data)[je], tc.data.numpy()[je])
        assert np.array_equal(np.asarray(jc.valid_mask())[je],
                              tc.valid_mask().numpy()[je])


@pytest.mark.parametrize("world", [1, 4, 8])
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_distributed_join_matches_cylon_tpu(request, world, how, route):
    jctx, tctx = _jctx(request, world), _tctx(world)
    left, right, lvalid = _arrays(100 + world)
    jl, tl = _pair(jctx, tctx, left, lvalid)
    jr, tr = _pair(jctx, tctx, right, {})
    exp = jl.distributed_join(jr, how, on=["k"]).to_pandas()
    got = tl.distributed_join(tr, how, on=["k"]).to_pandas()
    assert_rows_bit_equal(got, exp, msg=f"world {world} {how} {route}")


@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_forced_exchange_on_one_shard(route):
    """force_exchange runs the one-shard padded exchange (identity for a
    dense table) and the join still equals the local join."""
    tctx = _tctx(1)
    left, right, lvalid = _arrays(7)
    _jl, tl = _pair(None, tctx, left, lvalid)
    _jr, tr = _pair(None, tctx, right, {})
    exp = tl.join(tr, "inner", on=["k"]).to_pandas()
    got = tl.distributed_join(tr, "inner", on=["k"],
                              force_exchange=True).to_pandas()
    assert_rows_bit_equal(got, exp)


def test_interop_carries_a_distributed_reference_table(dist_ctx):
    """A cylon_tpu table after shard.distribute (padded shards, emit mask)
    crosses into the port through numpy; the port's join on it matches."""
    tctx = _tctx(4)
    left, right, lvalid = _arrays(21)
    jl, _ = _pair(dist_ctx, tctx, left, lvalid)
    jr, _ = _pair(dist_ctx, tctx, right, {})
    jld = jshard.distribute(jl, dist_ctx)
    jrd = jshard.distribute(jr, dist_ctx)

    def carry(t):
        return from_reference_arrays(
            tctx, [np.asarray(c.data) for c in t._columns],
            [None if c.validity is None else np.asarray(c.validity)
             for c in t._columns],
            None if t.row_mask is None else np.asarray(t.row_mask),
            world=4, names=t.column_names)

    tl, tr = carry(jld), carry(jrd)
    assert tl.capacity == jld.capacity
    assert np.array_equal(tl.emit_mask().numpy(),
                          np.asarray(jld.emit_mask()))
    exp = jl.distributed_join(jr, "inner", on=["k"]).to_pandas()
    got = tl.distributed_join(tr, "inner", on=["k"]).to_pandas()
    assert_rows_bit_equal(got, exp)


@pytest.mark.parametrize("forced", [None, True])
def test_partition_on_the_card_never_takes_the_sort(monkeypatch, forced):
    """On a CUDA device the partition takes K1/K2 up to their bucket
    limit; below it the stable sort runs there only when PARTITION_KERNEL
    is False. Past the limit every device takes the stable sort, even
    when PARTITION_KERNEL is True (the JAX package's route past its
    kernel's limit). On the CPU the default is the sort."""
    monkeypatch.setattr(tshuffle, "PARTITION_KERNEL", forced)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    limit = K.MAX_BUCKETS - 1
    assert tshuffle.use_partition_kernel(limit, cuda)
    assert tshuffle.use_partition_kernel(limit + 1, cuda) is False
    assert tshuffle.use_partition_kernel(limit, cpu) is bool(forced)
    assert tshuffle.use_partition_kernel(limit + 1, cpu) is False
    monkeypatch.setattr(tshuffle, "PARTITION_KERNEL", False)
    assert not tshuffle.use_partition_kernel(limit, cuda)
    assert not tshuffle.use_partition_kernel(limit + 1, cuda)
