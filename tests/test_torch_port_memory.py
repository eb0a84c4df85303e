"""cylon_tpu_torch's knob registry and memory pool against cylon_tpu's:
the four knobs of the exchange layer with the reference's names,
defaults, floors and parse policy; the pool's CPU answers (no stats, no
budget, as on the reference's CPU mesh); the comm budget shrinking the
exchange's block cap as the reference's does (shard by shard through
the compact route it forces); the local join picking the blocked join
when the pool runs short, with the reference's forced blocked join's
rows."""
import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.parallel import shard as jshard
from cylon_tpu.parallel import shuffle as jshuffle
from cylon_tpu.telemetry import knobs as jknobs

import cylon_tpu_torch as tct
from cylon_tpu_torch.data import table as ttable
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch.telemetry import knobs as tknobs

from test_torch_port_ring_join import canon, jctx, tctx

KNOBS = ("CYLON_SKEW_WARN_FACTOR", "CYLON_EXCHANGE_OVERLAP",
         "CYLON_EXCHANGE_CHUNK_BYTES", "CYLON_SALT_FACTOR")


@pytest.mark.parametrize("name", KNOBS)
def test_knobs_match_reference(monkeypatch, name):
    t, j = tknobs.KNOBS[name], jknobs.KNOBS[name]
    assert (t.default, t.kind, t.lo) == (j.default, j.kind, j.lo)
    assert tknobs.default(name) == jknobs.default(name)
    for raw in (None, "", "abc", "0", "1", "-5", "3.7", "yes", "off",
                "1e3", "65536", " On "):
        assert t.parse(raw) == j.parse(raw), raw
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
        assert tknobs.get(name) == jknobs.get(name), raw


def test_undeclared_knob_raises():
    with pytest.raises(KeyError):
        tknobs.get("CYLON_NOT_A_KNOB")


def test_cpu_pool_has_no_budget(request):
    for ctx in (tct.CylonContext.Init(device="cpu"), tctx(4)):
        pool = ctx.memory_pool
        assert pool.available_bytes() is None
        assert pool.comm_budget_bytes() is None
        assert pool.snapshot() == (0, 0, 0)
    ref = jctx(request, 4).memory_pool
    assert ref.available_bytes() is None and ref.comm_budget_bytes() is None


def test_padded_route_matches_reference():
    """The routing rule, budget included, over a grid of count matrices,
    budgets, buffer factors and block caps."""
    rng = np.random.default_rng(3)
    for world in (1, 4, 8):
        for scale in (0, 3, 900, 5000, 300_000):
            counts = rng.integers(0, scale + 1, (world, world))
            for row_bytes in ((4,), (4, 8), (1, 4, 8)):
                tp = {f"x{i}": torch.zeros(2, dtype={1: torch.bool,
                                                     4: torch.int32,
                                                     8: torch.int64}[b])
                      for i, b in enumerate(row_bytes)}
                jp = {k: v.numpy() for k, v in tp.items()}
                for budget in (None, 0, 1 << 12, 200_000, 1 << 24):
                    for bf in (4, 8):
                        for mb in (None, 256, 1 << 12):
                            assert tshuffle._padded_route(
                                counts, tp, world, budget, bf, mb) == \
                                jshuffle._padded_route(
                                    counts, jp, world, budget, bf, mb), \
                                (world, scale, row_bytes, budget, bf, mb)


def test_budget_binds_the_exchange(request, monkeypatch):
    """A comm budget below 4 x W x block x row bytes shrinks the block
    cap: the padded route gives way to two compact rounds in both
    packages, and every shard's live rows agree."""
    jc, tc = jctx(request, 4), tctx(4)
    budget = 200_000   # 8-byte rows: a cap of 1024 rows, not 2048
    monkeypatch.setattr(jc.memory_pool, "comm_budget_bytes",
                        lambda: budget)
    monkeypatch.setattr(tc.memory_pool, "comm_budget_bytes",
                        lambda: budget)
    rng = np.random.default_rng(4)
    n = 24_000
    payload = {"a": rng.integers(0, 1 << 30, n).astype(np.int32),
               "b": rng.normal(size=n).astype(np.float32)}
    targets = rng.integers(0, 4, n).astype(np.int32)
    emit = np.ones(n, bool)
    pin = lambda a: jshard.pin(np.asarray(a), jc)  # noqa: E731
    counts = np.asarray(jshuffle._count_fn(jc.mesh)(pin(targets),
                                                     pin(emit)))
    ok, block, mb = tshuffle._padded_route(
        counts, {k: torch.from_numpy(v) for k, v in payload.items()}, 4,
        budget)
    assert not ok and block == 2048 and mb == 1024
    jo, je, jcap, jm = jshuffle.exchange(
        {k: pin(v) for k, v in payload.items()}, pin(targets), pin(emit),
        jc, counts=counts)
    seen = []
    real = tshuffle._compact_body

    def spy(world, block, rounds, *a):
        seen.append((block, rounds))
        return real(world, block, rounds, *a)

    monkeypatch.setattr(tshuffle, "_compact_body", spy)
    to, te, tcap, tm = tshuffle.exchange(
        {k: torch.from_numpy(v) for k, v in payload.items()},
        torch.from_numpy(targets), torch.from_numpy(emit), tc,
        counts=counts)
    assert seen == [(1024, 2)]
    assert tm["mode"] == jm["mode"] == "compact" and tcap == jcap
    je = np.asarray(je)
    assert np.array_equal(te.numpy(), je)
    for k in payload:
        assert np.array_equal(to[k].numpy()[je], np.asarray(jo[k])[je])


def test_join_picks_blocked_when_memory_runs_short(monkeypatch):
    """With the pool's free bytes stubbed below twice the plan estimate,
    a probe side past 2^20 rows runs blocked (blocks of 2^20 rows), and
    the rows equal the reference's forced blocked join's."""
    rng = np.random.default_rng(5)
    n = (1 << 20) + 4096
    left = {"k": rng.integers(0, 100_000, n).astype(np.int32),
            "v": rng.integers(0, 1 << 30, n).astype(np.int32)}
    right = {"k": rng.integers(0, 100_000, 200).astype(np.int32),
             "w": rng.normal(size=200).astype(np.float32)}
    ctx = tct.CylonContext.Init(device="cpu")
    tl, tr = (tct.Table.from_pydict(ctx, d) for d in (left, right))
    monkeypatch.setattr(ctx.memory_pool, "available_bytes", lambda: 1000)
    blocks = []
    real = ttable.join_blocked

    def spy(left, right, config, probe_block_rows):
        blocks.append(probe_block_rows)
        return real(left, right, config, probe_block_rows)

    monkeypatch.setattr(ttable, "join_blocked", spy)
    got = tl.join(tr, "inner", on="k")
    assert blocks == [1 << 20]
    jc = jct.CylonContext.Init()
    jl, jr = (jct.Table.from_pydict(jc, d) for d in (left, right))
    exp = jl.join(jr, "inner", on="k", probe_block_rows=1 << 20)
    assert canon(got.to_pandas()) == canon(exp.to_pandas())
