"""Virtual worlds of 256 shards and more: past K1/K2's bucket limit
(``kernels.MAX_BUCKETS`` buckets, world + 1 with the dead bucket) the
partition takes the stable sort on every device, even when
``shuffle.PARTITION_KERNEL`` is True, as cylon_tpu takes its sort route
past its kernel's limit. The route follows the world size, never a
failure (``cylon_partition_path_total{path=}`` counts a padded
exchange's route).

At world 256 on the CPU, with PARTITION_KERNEL True (the plain K1/K2
would get 257 buckets): a join and a sort launch neither partition
wrapper, every shard equals the sort route's (PARTITION_KERNEL False)
bit for bit, and the rows equal the world-4 result as a bit-exact
multiset. (On the card, chip_smoke.py phase 29 runs this at full size.)
"""
import numpy as np
import pytest
import torch

import cylon_tpu_torch as tct
from cylon_tpu_torch.ops import kernels as K
from cylon_tpu_torch.parallel import dist_ops as tdist
from cylon_tpu_torch.parallel import shuffle as tshuffle

ROWS = 3000


@pytest.mark.parametrize("forced", [None, True])
@pytest.mark.parametrize("world", [255, 256, 512])
def test_route_by_world(monkeypatch, forced, world):
    monkeypatch.setattr(tshuffle, "PARTITION_KERNEL", forced)
    fits = world + 1 <= K.MAX_BUCKETS
    assert tshuffle.use_partition_kernel(world, torch.device("cuda")) \
        is fits
    assert tshuffle.use_partition_kernel(world, torch.device("cpu")) \
        is (fits and forced is True)


def _tables(ctx):
    rng = np.random.default_rng(56)
    v = rng.normal(size=ROWS).astype(np.float32)
    v[::13] = -0.0
    left = tct.Table.from_pydict(ctx, {
        "k": rng.integers(0, ROWS // 2, ROWS).astype(np.int32), "v": v})
    right = tct.Table.from_pydict(ctx, {
        "k": rng.integers(0, ROWS // 2, ROWS).astype(np.int32),
        "w": rng.integers(-99, 99, ROWS).astype(np.int64)})
    return left, right


def _ops(ctx):
    left, right = _tables(ctx)
    return {"join": left.distributed_join(right, "inner", on=["k"],
                                          force_exchange=True),
            "sort": tdist.distributed_sort(left, "k")}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32) if a.dtype == np.float32 else a


def _shards(t) -> tuple:
    """The emit mask and every column's live values in slot order."""
    return (t.emit_mask().numpy(),
            {k: _bits(v) for k, v in t.to_pydict().items()})


def _multiset(t) -> list:
    d = t.to_pydict()
    return sorted(zip(*(_bits(v).tolist() for v in d.values())))


@pytest.fixture(scope="module")
def results():
    """Each route's results and the calls of the partition wrappers and
    of the stable sort's partition (``shuffle._bucket_sort``) it
    made."""
    spied = ((K, "partition_hist"), (K, "partition_scatter"),
             (tshuffle, "_bucket_sort"))
    real = {name: getattr(mod, name) for mod, name in spied}

    def spy(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    old = tshuffle.PARTITION_KERNEL
    out = {}
    try:
        for mod, name in spied:
            setattr(mod, name, spy(name))
        for route, forced, world in (("forced", True, 256),
                                     ("sort", False, 256),
                                     ("world4", True, 4)):
            calls = dict.fromkeys(real, 0)
            tshuffle.PARTITION_KERNEL = forced
            out[route] = (_ops(tct.CylonContext.InitDistributed(
                tct.VirtualWorldConfig(world), device="cpu")), calls)
    finally:
        tshuffle.PARTITION_KERNEL = old
        for mod, name in spied:
            setattr(mod, name, real[name])
    return out


def test_world_256_launches_no_partition_kernel(results):
    _ops256, calls = results["forced"]
    assert calls["partition_hist"] == calls["partition_scatter"] == 0
    assert calls["_bucket_sort"] > 0
    # the same switch at world 4 runs the kernel wrappers, not the sort
    _ops4, calls = results["world4"]
    assert calls["partition_hist"] > 0 and calls["partition_scatter"] > 0
    assert calls["_bucket_sort"] == 0


@pytest.mark.parametrize("op", ["join", "sort"])
def test_world_256_equals_sort_route(results, op):
    got, exp = results["forced"][0], results["sort"][0]
    (ge, gv), (ee, ev) = _shards(got[op]), _shards(exp[op])
    assert np.array_equal(ge, ee)
    for k in ev:
        assert np.array_equal(gv[k], ev[k]), k


@pytest.mark.parametrize("op", ["join", "sort"])
def test_world_256_rows_equal_world_4(results, op):
    got = results["forced"][0][op]
    assert got.row_count > 0
    assert _multiset(got) == _multiset(results["world4"][0][op])
    if op == "sort":
        keys = got.to_pydict()["k"]
        assert np.array_equal(keys, np.sort(keys))
