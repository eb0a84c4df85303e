"""cylon_tpu_torch's broadcast hash join against cylon_tpu's on the
virtual CPU mesh (mirrors tests/test_adaptive_join.py:74-166 and :437):
every shard's rows equal the reference broadcast join's, bit for bit, as
multisets (probe rows never leave their shard, so the placement is
fixed), for both build sides, world 4 and 8, world 1, an empty build
side and varbytes keys; an illegal build side falls back to the shuffle
join; no exchange runs; the probe side's witness survives."""
import numpy as np
import pytest

from cylon_tpu.data import strings as jstrings
from cylon_tpu.parallel import dist_ops as jdist

import cylon_tpu_torch as tct
from cylon_tpu_torch.data import strings as tstrings
from cylon_tpu_torch.ops import kernels as K
from cylon_tpu_torch.parallel import dist_ops as tdist

from test_torch_port_ring_join import (FallbackSpy, assert_shards_equal,
                                       canon, jctx, pair, reference_shards,
                                       route, tctx)  # noqa: F401


def _data(n, m, seed, dtype=np.int32, key_space=64):
    rng = np.random.default_rng(seed)
    return ({"k": rng.integers(0, key_space, n).astype(dtype),
             "v": rng.normal(size=n).astype(np.float32)},
            {"k": rng.integers(0, key_space, m).astype(dtype),
             "w": rng.normal(size=m).astype(np.float32)})


def _check(request, world, left, right, how, build_side, key):
    jc = jctx(request, world)
    jl, tl = pair(jc, tctx(world), left)
    jr, tr = pair(jc, tctx(world), right)
    got = tl.distributed_join(tr, how, on="k", comm="broadcast",
                              build_side=build_side)
    # the cache is test_torch_port_ring_join's: its keys must not meet
    # the ring tests' own (("varbytes", how) is in both files)
    ref = reference_shards(("broadcast", key), lambda: jl.distributed_join(
        jr, how, on="k", comm="broadcast", build_side=build_side), world)
    assert_shards_equal(got, ref, world, str(key))
    return got


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_broadcast_bit_identity_matrix(request, how, dtype, route):
    left, right = _data(2048, 64, 7, dtype)
    _check(request, 4, left, right, how, 1, ("matrix", how, dtype))


@pytest.mark.parametrize("how", ["inner", "right"])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_broadcast_build_side_left(request, how, route):
    left, right = _data(64, 2048, 8)
    _check(request, 4, left, right, how, 0, ("build0", how))


@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_broadcast_world8(request, route):
    left, right = _data(4096, 32, 10)
    _check(request, 8, left, right, "inner", 1, "world8")


def test_broadcast_world1_is_local_join():
    left, right = _data(512, 32, 11)
    ctx = tct.CylonContext.Init(device="cpu")
    tl, tr = (tct.Table.from_pydict(ctx, d) for d in (left, right))
    got = tl.distributed_join(tr, "inner", on="k", comm="broadcast",
                              build_side=1)
    assert canon(got.to_pandas()) == canon(
        tl.join(tr, "inner", on="k").to_pandas())


@pytest.mark.parametrize("how", ["inner", "left"])
def test_broadcast_empty_build_side(request, how):
    left, _ = _data(512, 8, 12)
    empty = {"k": np.array([], np.int32), "w": np.array([], np.float32)}
    _check(request, 4, left, empty, how, 1, ("empty", how))


@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_broadcast_varbytes_keys(request, monkeypatch, route):
    monkeypatch.setattr(jstrings, "DICT_MAX_VOCAB", 0)
    monkeypatch.setattr(tstrings, "DICT_MAX_VOCAB", 0)
    rng = np.random.default_rng(13)
    left = {"k": np.array([f"key{int(x):03d}"
                           for x in rng.integers(0, 40, 768)], object),
            "v": rng.normal(size=768).astype(np.float32)}
    right = {"k": np.array([f"key{int(x):03d}"
                            for x in rng.integers(0, 40, 48)], object),
             "w": rng.normal(size=48).astype(np.float32)}
    for how in ("inner", "left"):
        _check(request, 4, left, right, how, 1, ("varbytes", how))


def test_broadcast_illegal_side_falls_back(request, monkeypatch):
    """A LEFT join may not replicate its left input: both packages take
    the shuffle join, and the rows agree."""
    left, right = _data(512, 64, 14)
    tspy = FallbackSpy(monkeypatch, tdist)
    jspy = FallbackSpy(monkeypatch, jdist)
    _check(request, 4, left, right, "left", 0, "illegal")
    assert tspy.fell_back and jspy.fell_back


@pytest.mark.parametrize("route", ["kernel"], indirect=True)
def test_broadcast_runs_no_exchange(request, monkeypatch, route):
    """No exchange, no count matrix and no partition kernel runs."""
    def boom(*a, **k):
        raise AssertionError("the broadcast join ran an exchange")

    for name in ("exchange", "exchange_pair", "count_pair"):
        monkeypatch.setattr(tdist, name, boom)
    for name in ("partition_hist", "partition_scatter"):
        monkeypatch.setattr(K, name, boom)
    left, right = _data(2048, 64, 15)
    _check(request, 4, left, right, "inner", 1, "no_exchange")


def test_broadcast_keeps_probe_witness(request):
    """The probe side's placement witness survives, shifted past the
    build columns when the probe is the right table; both packages give
    the same key positions and world (the dtype entries are each
    package's own dtype names)."""
    left, right = _data(1024, 32, 16)
    jc = jctx(request, 4)
    jl, tl = pair(jc, tctx(4), left)
    jr, tr = pair(jc, tctx(4), right)
    jp, tp = jdist.shuffle(jl, ["k"]), tdist.shuffle(tl, ["k"])
    assert tp._hash_partitioned is not None
    got = tp.distributed_join(tr, "inner", on="k", comm="broadcast",
                              build_side=1)
    assert got._hash_partitioned == tp._hash_partitioned
    exp = jp.distributed_join(jr, "inner", on="k", comm="broadcast",
                              build_side=1)
    assert got._hash_partitioned[::2] == exp._hash_partitioned[::2]
    # probe on the right: its key position moves past the left columns
    got0 = tr.distributed_join(tp, "inner", on="k", comm="broadcast",
                               build_side=0)
    exp0 = jr.distributed_join(jp, "inner", on="k", comm="broadcast",
                               build_side=0)
    assert got0._hash_partitioned[::2] == exp0._hash_partitioned[::2]
    assert got0._hash_partitioned[0] == (2,)


def test_legal_sides_equal_the_reference():
    assert {jt.name: set(v) for jt, v in tdist._BCAST_LEGAL_SIDES.items()} \
        == {jt.name: set(v) for jt, v in jdist._BCAST_LEGAL_SIDES.items()}
