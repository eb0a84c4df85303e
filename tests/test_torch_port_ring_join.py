"""cylon_tpu_torch's ring join against cylon_tpu's on the virtual CPU
mesh (mirrors tests/test_ring_join.py): every shard's rows equal the
reference's, bit for bit, as multisets (neither package fixes the row
order inside a shard), and both packages pick the same route (the ring,
or the shuffle join for FULL_OUTER and a hot key)."""
import numpy as np
import pytest

import cylon_tpu as jct
from cylon_tpu.data import strings as jstrings
from cylon_tpu.parallel import dist_ops as jdist

import cylon_tpu_torch as tct
from cylon_tpu_torch.data import strings as tstrings
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.parallel import dist_ops as tdist
from cylon_tpu_torch.parallel import shuffle as tshuffle



@pytest.fixture
def route(request):
    """'plan': the port's CPU defaults (plan-route per-shard joins);
    'kernel': the K1-K4 wrappers forced, their plain versions on the
    CPU."""
    old = tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL
    forced = True if request.param == "kernel" else None
    tjoin.STREAM_PLAN = tshuffle.PARTITION_KERNEL = forced
    yield request.param
    tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL = old


def tctx(world):
    return tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(world),
                                            device="cpu")


def jctx(request, world):
    return request.getfixturevalue({4: "dist_ctx", 8: "dist_ctx8"}[world])


def pair(jc, tc, data):
    """The same columns as a cylon_tpu and a cylon_tpu_torch table."""
    return (jct.Table.from_pydict(jc, data),
            tct.Table.from_pydict(tc, data))


def shard_frames(table, world: int) -> list:
    """Each shard's live rows as a frame: the exported live rows, in slot
    order, split by the shard of their slot."""
    emit = np.asarray(table.emit_mask())
    sid = np.flatnonzero(emit) // (emit.shape[0] // world)
    df = table.to_pandas()
    return [df[sid == i] for i in range(world)]


def canon(df) -> list:
    """A frame's rows as a sorted list of tuples of cell strings: floats
    by their bits, nulls as one token, everything else by repr (bit for
    bit, order-insensitive)."""
    import pandas as pd

    cols = []
    for c in df.columns:
        a = df[c].to_numpy()
        null = pd.isna(df[c]).to_numpy()
        if a.dtype.kind == "f":
            a = a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])
        cols.append(["<null>" if z else repr(x) for x, z in zip(a, null)])
    return sorted(zip(*cols))


_REF = {}


def reference_shards(key, fn, world: int):
    """cylon_tpu's result of a case as (column names, canonical rows of
    each shard), computed once per case (its programs compile on first
    use, which dominates these tests)."""
    if key not in _REF:
        frames = shard_frames(fn(), world)
        _REF[key] = (list(frames[0].columns), [canon(f) for f in frames])
    return _REF[key]


def assert_shards_equal(got, ref, world: int, msg=""):
    """``got``'s shards against `reference_shards`' result."""
    names, shards = ref
    frames = shard_frames(got, world)
    assert list(frames[0].columns) == names, msg
    for i, (f, e) in enumerate(zip(frames, shards)):
        assert canon(f) == e, f"{msg} shard {i}"


class FallbackSpy:
    """Records whether a package's ring join fell back to its shuffle
    join (the module-level ``distributed_join`` the ring calls)."""

    def __init__(self, monkeypatch, mod):
        self.fell_back = False
        real = mod.distributed_join

        def spy(*a, **k):
            self.fell_back = True
            return real(*a, **k)

        monkeypatch.setattr(mod, "distributed_join", spy)


@pytest.mark.parametrize("how", ["inner", "left", "right"])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_ring_matches_cylon_tpu(request, monkeypatch, how, route):
    rng = np.random.default_rng(17)
    n, m = 1000, 120
    left = {"k": rng.integers(0, 80, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32)}
    right = {"k": rng.integers(0, 80, m).astype(np.int32),
             "w": rng.normal(size=m).astype(np.float32)}
    jc = jctx(request, 4)
    jl, tl = pair(jc, tctx(4), left)
    jr, tr = pair(jc, tctx(4), right)
    spy = FallbackSpy(monkeypatch, tdist)
    got = tl.distributed_join(tr, how, on="k", comm="ring")
    assert not spy.fell_back
    ref = reference_shards(("basic", how), lambda: jl.distributed_join(
        jr, how, on="k", comm="ring"), 4)
    assert_shards_equal(got, ref, 4, f"{how} {route}")


@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_ring_multikey_and_filtered(request, route):
    rng = np.random.default_rng(23)
    n = 600
    left = {"a": rng.integers(0, 12, n).astype(np.int32),
            "b": rng.integers(0, 6, n).astype(np.int32),
            "v": rng.integers(0, 10, n).astype(np.int32)}
    right = {"a": rng.integers(0, 12, 100).astype(np.int32),
             "b": rng.integers(0, 6, 100).astype(np.int32),
             "w": rng.integers(0, 10, 100).astype(np.int32)}
    jc = jctx(request, 4)
    jl, tl = pair(jc, tctx(4), left)
    jr, tr = pair(jc, tctx(4), right)
    jf = jl.filter_mask(jl.get_column(2).data < 8)
    import torch

    tf = tl.filter_mask(torch.from_numpy(left["v"] < 8))
    for how in ("inner", "left"):
        got = tf.distributed_join(tr, how, on=["a", "b"], comm="ring")
        ref = reference_shards(("multikey", how), lambda: jf.distributed_join(
            jr, how, on=["a", "b"], comm="ring"), 4)
        assert_shards_equal(got, ref, 4, f"{how} {route}")


def test_ring_outer_falls_back(request, monkeypatch):
    rng = np.random.default_rng(29)
    data_l = {"k": rng.integers(0, 10, 200).astype(np.int32)}
    data_r = {"k": rng.integers(5, 15, 200).astype(np.int32)}
    jc = jctx(request, 4)
    jl, tl = pair(jc, tctx(4), data_l)
    jr, tr = pair(jc, tctx(4), data_r)
    spy = FallbackSpy(monkeypatch, tdist)
    got = tl.distributed_join(tr, "outer", on="k", comm="ring")
    assert spy.fell_back
    ref = reference_shards("outer", lambda: jl.distributed_join(
        jr, "outer", on="k", comm="ring"), 4)
    assert_shards_equal(got, ref, 4, "outer")


@pytest.mark.parametrize("hot", [True, False])
def test_ring_skew_route_matches(request, monkeypatch, hot):
    """A hot key whose build rows all sit on one shard (one ring step a
    shard carries nearly all its output, so the step slab overshoots the
    worst shard's output past RING_SKEW_FACTOR) routes to the shuffle
    join; uniform keys stay on the ring: the same choice as the
    reference, world 8."""
    rng = np.random.default_rng(31 if hot else 32)
    n = 2000
    if hot:
        ka = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 100_000, n))
        kb = np.where((np.arange(n) < n // 8) & (rng.random(n) < 0.9), 0,
                      rng.integers(1, 100_000, n))
    else:
        ka = rng.integers(0, 100_000, n)
        kb = rng.integers(0, 100_000, n)
    jc = jctx(request, 8)
    jl, tl = pair(jc, tctx(8), {"k": ka.astype(np.int64),
                                "v": np.arange(n)})
    jr, tr = pair(jc, tctx(8), {"k": kb.astype(np.int64),
                                "w": np.arange(n)})
    tspy = FallbackSpy(monkeypatch, tdist)
    jspy = FallbackSpy(monkeypatch, jdist)
    got = tl.distributed_join(tr, "inner", on="k", comm="ring")
    ref = reference_shards(("skew", hot), lambda: jl.distributed_join(
        jr, "inner", on="k", comm="ring"), 8)
    assert tspy.fell_back == jspy.fell_back == hot
    assert_shards_equal(got, ref, 8, f"hot={hot}")


@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_ring_varbytes_key_and_payload(request, monkeypatch, route):
    """Varbytes keys and payload ride the ring as word lanes."""
    monkeypatch.setattr(jstrings, "DICT_MAX_VOCAB", 0)
    monkeypatch.setattr(tstrings, "DICT_MAX_VOCAB", 0)
    rng = np.random.default_rng(77)
    n = 300
    lk = np.array([f"acct{rng.integers(0, 120):04d}" for _ in range(n)],
                  object)
    rk = np.array([f"acct{rng.integers(0, 150):04d}" for _ in range(n)],
                  object)
    sv = np.array([f"tag-{i % 9}" for i in range(n)], object)
    jc = jctx(request, 4)
    jl, tl = pair(jc, tctx(4), {"k": lk, "v": np.arange(n), "s": sv})
    jr, tr = pair(jc, tctx(4), {"k": rk, "w": np.arange(n) * 3})
    assert tl.columns()[0].is_varbytes and tl.columns()[2].is_varbytes
    spy = FallbackSpy(monkeypatch, tdist)
    for how in ("inner", "left", "right"):
        got = tl.distributed_join(tr, how, on="k", comm="ring")
        ref = reference_shards(("varbytes", how), lambda: jl.distributed_join(
            jr, how, on="k", comm="ring"), 4)
        assert_shards_equal(got, ref, 4, f"{how} {route}")
    assert not spy.fell_back
