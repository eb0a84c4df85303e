"""cylon_tpu_torch's chunked padded exchange against cylon_tpu's on the
virtual CPU mesh (mirrors tests/test_exchange_overlap.py:66-126, :210
and :246): ``_chunk_plan`` equal to the reference's over a grid of
geometries and knob values; chunk counts, counts_in, capacity and every
shard's live rows equal to the reference's exchange under the same
knobs, and to the port's own single-shot exchange (overlap off), bit for
bit; an odd remainder chunk; the world-1 counted route; exchange_pair;
the distributed join identical under overlap 0 and 1."""
import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.parallel import shard as jshard
from cylon_tpu.parallel import shuffle as jshuffle

import cylon_tpu_torch as tct
from cylon_tpu_torch.parallel import shuffle as tshuffle

from test_torch_port_ring_join import (canon, jctx, pair, route,  # noqa
                                       tctx)


@pytest.mark.parametrize("overlap", ["0", "1", None])
@pytest.mark.parametrize("chunk_bytes", [None, "4096", "100", "1048576",
                                         "bogus"])
def test_chunk_plan_matches(monkeypatch, overlap, chunk_bytes):
    for name, v in (("CYLON_EXCHANGE_OVERLAP", overlap),
                    ("CYLON_EXCHANGE_CHUNK_BYTES", chunk_bytes)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    for block in (1, 2, 64, 1024, 1 << 16, 1 << 21, 1 << 22):
        for world in (1, 4, 8):
            for row_bytes in (0, 1, 8, 24, 100):
                assert tshuffle._chunk_plan(block, world, row_bytes) == \
                    jshuffle._chunk_plan(block, world, row_bytes), \
                    (block, world, row_bytes)


def _inputs(world, n, seed=0, live=0.85):
    """Flat payload leaves (int32, float32, int64, bool), targets and
    emit, as numpy."""
    rng = np.random.default_rng(seed)
    payload = {"a": rng.integers(0, 1 << 30, n).astype(np.int32),
               "b": rng.normal(size=n).astype(np.float32),
               "c": rng.integers(-(1 << 60), 1 << 60, n),
               "d": rng.random(n) < 0.5}
    targets = rng.integers(0, world, n).astype(np.int32)
    return payload, targets, rng.random(n) < live


def _jax_run(jc, payload, targets, emit, counts=None):
    pin = lambda a: jshard.pin(np.asarray(a), jc)  # noqa: E731
    if counts is None:
        counts = np.asarray(jshuffle._count_fn(jc.mesh)(pin(targets),
                                                         pin(emit)))
    out, e, cap, meta = jshuffle.exchange(
        {k: pin(v) for k, v in payload.items()}, pin(targets), pin(emit),
        jc, counts=counts)
    return ({k: np.asarray(v) for k, v in out.items()}, np.asarray(e), cap,
            meta), counts


def _torch_run(tc, payload, targets, emit, counts):
    return tshuffle.exchange({k: torch.from_numpy(v)
                              for k, v in payload.items()},
                             torch.from_numpy(targets),
                             torch.from_numpy(emit), tc, counts=counts)


def _assert_same(jres, tres, what):
    jout, je, jcap, jmeta = jres
    tout, te, tcap, tmeta = tres
    assert tcap == jcap, what
    assert tmeta["mode"] == jmeta["mode"] == "padded", what
    assert tmeta["block"] == jmeta["block"], what
    assert tmeta.get("chunks", 1) == jmeta.get("chunks", 1), what
    w = tmeta["counts_in"].shape[0]
    assert np.array_equal(tmeta["counts_in"].numpy(),
                          np.asarray(jmeta["counts_in"]).reshape(w, -1)), \
        what
    te = te.numpy()
    assert np.array_equal(te, np.asarray(je)), what
    for k, v in jout.items():
        got, exp = tout[k].numpy()[te], v[te]
        assert np.array_equal(got.view(np.uint8), exp.view(np.uint8)), \
            (what, k)


def _assert_single_shot_equal(base, out):
    """The chunked result against the port's own single-shot one."""
    assert out[2] == base[2] and out[3]["block"] == base[3]["block"]
    assert torch.equal(out[1], base[1])
    assert torch.equal(out[3]["counts_in"], base[3]["counts_in"])
    for k in base[0]:
        assert torch.equal(out[0][k][out[1]], base[0][k][base[1]]), k


@pytest.mark.parametrize("n,cbytes,want", [(4096, 1 << 26, 1),
                                           (4096, 17408, 2),
                                           (16384, 4096, 32)])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_chunked_matches_reference(request, monkeypatch, n, cbytes, want,
                                   route):
    """Single-shot, two chunks, and a deep pipeline (17 bytes a row: 2
    chunks of 256 rows for a 512-row block; 32 chunks of 32 rows)."""
    jc, tc = jctx(request, 4), tctx(4)
    payload, targets, emit = _inputs(4, n)
    monkeypatch.setenv("CYLON_EXCHANGE_OVERLAP", "0")
    _jbase, counts = _jax_run(jc, payload, targets, emit)
    base = _torch_run(tc, payload, targets, emit, counts)
    monkeypatch.setenv("CYLON_EXCHANGE_OVERLAP", "1")
    monkeypatch.setenv("CYLON_EXCHANGE_CHUNK_BYTES", str(cbytes))
    jres, _ = _jax_run(jc, payload, targets, emit, counts)
    tres = _torch_run(tc, payload, targets, emit, counts)
    _assert_same(jres, tres, f"n={n} cbytes={cbytes} {route}")
    assert tres[3].get("chunks", 1) == want
    _assert_single_shot_equal(base, tres)


@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_chunked_odd_remainder(request, monkeypatch, route):
    """A chunk block that does not divide the block (a forced plan): the
    last chunk drops the rows past the block."""
    jc, tc = jctx(request, 4), tctx(4)
    payload, targets, emit = _inputs(4, 4096, seed=3)
    monkeypatch.setenv("CYLON_EXCHANGE_OVERLAP", "0")
    _jbase, counts = _jax_run(jc, payload, targets, emit)
    base = _torch_run(tc, payload, targets, emit, counts)

    def plan(block, world, row_bytes):
        return (3, -(-block // 3)) if block > 3 else (block, 1)

    monkeypatch.setattr(jshuffle, "_chunk_plan", plan)
    monkeypatch.setattr(tshuffle, "_chunk_plan", plan)
    jres, _ = _jax_run(jc, payload, targets, emit, counts)
    tres = _torch_run(tc, payload, targets, emit, counts)
    _assert_same(jres, tres, f"remainder {route}")
    assert tres[3]["chunks"] == -(-base[3]["block"] // 3)
    _assert_single_shot_equal(base, tres)


def test_chunked_world1_counted_route(monkeypatch):
    """The counted padded route chunks on a one-shard world too."""
    jc = jct.CylonContext.InitDistributed(jct.TPUConfig(world_size=1))
    tc = tctx(1)
    payload, targets, emit = _inputs(1, 2048, seed=5)
    monkeypatch.setenv("CYLON_EXCHANGE_OVERLAP", "0")
    _jbase, counts = _jax_run(jc, payload, targets, emit)
    base = _torch_run(tc, payload, targets, emit, counts)
    monkeypatch.setenv("CYLON_EXCHANGE_OVERLAP", "1")
    monkeypatch.setenv("CYLON_EXCHANGE_CHUNK_BYTES", "4096")
    jres, _ = _jax_run(jc, payload, targets, emit, counts)
    tres = _torch_run(tc, payload, targets, emit, counts)
    _assert_same(jres, tres, "world 1")
    assert tres[3]["chunks"] > 1
    _assert_single_shot_equal(base, tres)


def test_exchange_pair_routes_through_chunked(request, monkeypatch):
    """exchange_pair under chunking: each side's chunk count and rows as
    the reference's exchange_pair gives them."""
    jc, tc = jctx(request, 4), tctx(4)
    p1, t1, e1 = _inputs(4, 4096, seed=13, live=0.9)
    p2, t2, e2 = _inputs(4, 2048, seed=14, live=0.9)
    pin = lambda a: jshard.pin(np.asarray(a), jc)  # noqa: E731
    c1, c2 = jshuffle.count_pair(pin(t1), pin(e1), pin(t2), pin(e2), jc)
    monkeypatch.setenv("CYLON_EXCHANGE_OVERLAP", "1")
    monkeypatch.setenv("CYLON_EXCHANGE_CHUNK_BYTES", "4096")
    jr = jshuffle.exchange_pair(
        {k: pin(v) for k, v in p1.items()}, pin(t1), pin(e1), c1,
        {k: pin(v) for k, v in p2.items()}, pin(t2), pin(e2), c2, jc)
    tr = tshuffle.exchange_pair(
        {k: torch.from_numpy(v) for k, v in p1.items()},
        torch.from_numpy(t1), torch.from_numpy(e1), c1,
        {k: torch.from_numpy(v) for k, v in p2.items()},
        torch.from_numpy(t2), torch.from_numpy(e2), c2, tc)
    for (jo, je, jcap, jm), tres, what in zip(jr, tr, ("left", "right")):
        _assert_same(({k: np.asarray(v) for k, v in jo.items()},
                      np.asarray(je), jcap, jm), tres, what)
    assert tr[0][3].get("chunks", 1) > 1 or tr[1][3].get("chunks", 1) > 1


@pytest.mark.parametrize("overlap", ["0", "1"])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_distributed_join_identical_under_overlap(request, monkeypatch,
                                                  overlap, route):
    monkeypatch.setenv("CYLON_EXCHANGE_OVERLAP", overlap)
    monkeypatch.setenv("CYLON_EXCHANGE_CHUNK_BYTES", "4096")
    rng = np.random.default_rng(17)
    n = 4096
    left = {"k": rng.integers(0, n // 4, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rng.integers(0, n // 4, n).astype(np.int32),
             "w": rng.normal(size=n).astype(np.float32)}
    jl, tl = pair(jctx(request, 4), tctx(4), left)
    jr, tr = pair(jctx(request, 4), tctx(4), right)
    got = tl.distributed_join(tr, "inner", on="k").to_pandas()
    lctx = tct.CylonContext.Init(device="cpu")
    local = tct.Table.from_pydict(lctx, left).join(
        tct.Table.from_pydict(lctx, right), "inner", on="k").to_pandas()
    assert canon(got) == canon(local)
    assert canon(got) == canon(jl.distributed_join(jr, "inner",
                                                   on="k").to_pandas())


@pytest.mark.parametrize("nth", [1, 2, 17])
def test_fault_mid_chunk_stream(request, monkeypatch, nth):
    """F19: each chunk of a chunked exchange is one ``exchange`` fault
    arrival under the retry policy, as in the reference's pipeline
    (shuffle.py:644): an injected transient fault at arrival ``nth`` of a
    32-chunk exchange retries that chunk alone; both packages count the
    same arrivals, and the landing equals the unfaulted exchange."""
    from cylon_tpu.resilience import inject as jinject
    from cylon_tpu_torch.resilience import inject as tinject

    jc, tc = jctx(request, 4), tctx(4)
    payload, targets, emit = _inputs(4, 16384, seed=3)
    monkeypatch.setenv("CYLON_EXCHANGE_OVERLAP", "1")
    monkeypatch.setenv("CYLON_EXCHANGE_CHUNK_BYTES", "4096")
    monkeypatch.setenv("CYLON_RETRY_BACKOFF_S", "0.001")
    _jbase, counts = _jax_run(jc, payload, targets, emit)
    base = _torch_run(tc, payload, targets, emit, counts)
    arrivals = []
    for inj, run in ((jinject, lambda: _jax_run(jc, payload, targets, emit,
                                                counts)[0]),
                     (tinject, lambda: _torch_run(tc, payload, targets,
                                                  emit, counts))):
        inj.arm(f"exchange:{nth}:transient")
        try:
            res = run()
            st = inj.state()
        finally:
            inj.disarm()
        assert [f["arrival"] for f in st["fired"]] == [nth]
        arrivals.append(st["arrivals"]["exchange"])
        if inj is tinject:
            tres = res
        else:
            jres = res
    assert arrivals[0] == arrivals[1] == 33
    _assert_same(jres, tres, f"fault at {nth}")
    assert tres[3]["chunks"] == 32
    _assert_single_shot_equal(base, tres)
