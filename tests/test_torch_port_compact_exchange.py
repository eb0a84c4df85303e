"""cylon_tpu_torch's compact exchange route against cylon_tpu's on the
virtual CPU mesh.

The compact route takes every count matrix that the padded route
rejects: skew, a diagonal matrix (rows already on their target shard),
and small tables, where ``world * pow2(max_pair)`` outgrows twice the
compact capacity (1-row tables, empty sides, fewer rows than W^2).
Tolerance 0: every shard's live rows bit for bit, row for row, and
``counts_in``, the capacity and ``meta["mode"]`` equal to the JAX
package's; joins on such inputs equal as bitwise row multisets
(tests/test_torch_port_small_inputs.py holds world 8's joins and the
set ops on them)."""
import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.parallel import shard as jshard
from cylon_tpu.parallel import shuffle as jshuffle

import cylon_tpu_torch as tct
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.parallel import shuffle as tshuffle

from test_torch_port_join import assert_rows_bit_equal


@pytest.fixture
def route(request):
    """'plan': the stable-sort partition and the plan-route join; 'kernel':
    the K1-K4 wrappers forced (their plain versions on the CPU)."""
    old = tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL
    forced = True if request.param == "kernel" else None
    tjoin.STREAM_PLAN = tshuffle.PARTITION_KERNEL = forced
    yield request.param
    tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL = old


@pytest.fixture(scope="module")
def tctxs():
    return {w: tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(w),
                                                device="cpu")
            for w in (1, 4, 8)}


def _jctx(request, world):
    return request.getfixturevalue({4: "dist_ctx", 8: "dist_ctx8"}[world])


def _layout(world, n):
    """The padded per-shard capacity both packages give n rows."""
    return world * (-(-(-(-max(n, 1) // world)) // 8) * 8)


# name -> (live rows, target kind, max_block)
CASES = {
    "one_row": (1, "hash", None),
    "empty": (0, "hash", None),
    "fewer_than_w2": (5, "hash", None),
    "diagonal": (40, "diagonal", None),
    "source_skew": (200, "source_skew", None),
    "uniform_padded": (400, "hash", None),
    "rounds": (200, "source_skew", 4),
}


def _case_arrays(world, name):
    """Flat [W * cap] payload (int32, float64 with -0.0/NaN, bool),
    targets and emit of one case."""
    n, kind, mb = CASES[name]
    total = _layout(world, n)
    cap = total // world
    rng = np.random.default_rng(len(name) * 31 + world)
    x = rng.integers(-100, 100, total).astype(np.int32)
    y = rng.normal(size=total)
    y[rng.random(total) < 0.1] = -0.0
    y[rng.random(total) < 0.05] = np.nan
    b = rng.random(total) < 0.5
    emit = np.zeros(total, bool)
    if kind == "source_skew":
        # every live row on shard 0: one source sends to all targets
        emit[:min(n, cap)] = True
    else:
        emit[np.arange(total) % cap < -(-n // world)] = True
        emit[np.flatnonzero(emit)[n:]] = False
    if kind == "diagonal":
        targets = (np.arange(total) // cap).astype(np.int32)
    else:
        targets = rng.integers(0, world, total).astype(np.int32)
    return {"x": x, "y": y, "b": b}, targets, emit, mb


_JAX_EXCHANGE = {}


def _jax_exchange(jctx, key, payload, targets, emit, mb):
    if key not in _JAX_EXCHANGE:
        pin = lambda a: jshard.pin(np.asarray(a), jctx)
        out, e, cap, meta = jshuffle.exchange(
            {k: pin(v) for k, v in payload.items()}, pin(targets), pin(emit),
            jctx, max_block=mb)
        _JAX_EXCHANGE[key] = ({k: np.asarray(v) for k, v in out.items()},
                              np.asarray(e), cap, meta["mode"],
                              np.asarray(meta["counts_in"]))
    return _JAX_EXCHANGE[key]


def _check_exchange(jres, tres, world, what):
    jout, je, jcap, jmode, jci = jres
    tout, te, tcap, tmeta = tres
    assert tmeta["mode"] == jmode, what
    assert tcap == jcap, what
    assert np.array_equal(tmeta["counts_in"].numpy(),
                          jci.reshape(world, world)), what
    assert np.array_equal(te.numpy(), je), what
    for k, v in jout.items():
        got = tout[k].numpy()[je]
        exp = v[je]
        assert got.dtype == exp.dtype, what
        assert np.array_equal(got.view(np.uint8), exp.view(np.uint8)), \
            (what, k)


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_exchange_matches_cylon_tpu(request, tctxs, world, case, route):
    """Every shard's live rows, counts_in, capacity and mode."""
    payload, targets, emit, mb = _case_arrays(world, case)
    jres = _jax_exchange(_jctx(request, world), (world, case), payload,
                         targets, emit, mb)
    tres = tshuffle.exchange({k: torch.from_numpy(v)
                              for k, v in payload.items()},
                             torch.from_numpy(targets),
                             torch.from_numpy(emit), tctxs[world],
                             max_block=mb)
    _check_exchange(jres, tres, world, f"{case} world {world} {route}")
    # the route each case is built to take (fewer_than_w2 takes either,
    # by the world and the draw)
    expect = {"uniform_padded": "padded",
              "fewer_than_w2": tres[3]["mode"]}.get(case, "compact")
    assert tres[3]["mode"] == expect


def test_rounds_case_runs_several_rounds(monkeypatch, tctxs):
    """The max_block case moves its rows in more than one round."""
    seen = []
    real = tshuffle._compact_body

    def spy(world, block, rounds, *a):
        seen.append(rounds)
        return real(world, block, rounds, *a)

    monkeypatch.setattr(tshuffle, "_compact_body", spy)
    payload, targets, emit, mb = _case_arrays(4, "rounds")
    tshuffle.exchange({k: torch.from_numpy(v) for k, v in payload.items()},
                      torch.from_numpy(targets), torch.from_numpy(emit),
                      tctxs[4], max_block=mb)
    assert seen and seen[0] > 1


@pytest.mark.parametrize("n", range(1, 39))
def test_small_tables_at_world_8(dist_ctx8, tctxs, n):
    """n rows of uniform int32 keys shuffled by key hash at world 8 (every
    n here took the compact route's raise before it was ported), shard
    by shard against the JAX package."""
    rng = np.random.default_rng(n)
    k = rng.integers(0, 1 << 30, n).astype(np.int32)
    jt = jct.Table.from_pydict(dist_ctx8, {"k": k})
    tt = tct.Table.from_pydict(tctxs[8], {"k": k})
    from cylon_tpu.parallel import dist_ops as jdist
    from cylon_tpu_torch.parallel import dist_ops as tdist

    js, ts = jdist.shuffle(jt, ["k"]), tdist.shuffle(tt, ["k"])
    assert js.capacity == ts.capacity
    je = np.asarray(js.emit_mask())
    assert np.array_equal(je, ts.emit_mask().numpy())
    assert np.array_equal(np.asarray(js._columns[0].data)[je],
                          ts._columns[0].data.numpy()[je])


# -- joins and set ops on small and empty inputs --------------------------

SMALL = {"one_row_self": (1, 1), "empty_left": (0, 6), "few": (3, 14)}


def _small_arrays(case):
    nl, nr = SMALL[case]
    if case == "one_row_self":
        left = {"k": np.zeros(1, np.int32), "v": np.ones(1, np.float32)}
        return left, dict(left)
    rng = np.random.default_rng(nl * 7 + nr)
    return ({"k": rng.integers(0, 4, nl).astype(np.int32),
             "v": rng.normal(size=nl).astype(np.float32)},
            {"k": rng.integers(0, 4, nr).astype(np.int32),
             "v": rng.normal(size=nr).astype(np.float32)})


_JAX_SMALL = {}


def _jax_small(request, world, case, op):
    key = (world, case, op)
    if key not in _JAX_SMALL:
        jctx = _jctx(request, world)
        la, ra = _small_arrays(case)
        jl = jct.Table.from_pydict(jctx, la)
        jr = jct.Table.from_pydict(jctx, ra)
        if op in ("union", "subtract", "intersect"):
            res = getattr(jl, f"distributed_{op}")(jr)
        else:
            res = jl.distributed_join(jr, op, on=["k"])
        _JAX_SMALL[key] = res.to_pandas()
    return _JAX_SMALL[key]


def check_small_join(request, tctxs, world, case, how, route):
    la, ra = _small_arrays(case)
    tl = tct.Table.from_pydict(tctxs[world], la)
    tr = tct.Table.from_pydict(tctxs[world], ra)
    got = tl.distributed_join(tr, how, on=["k"]).to_pandas()
    assert_rows_bit_equal(got, _jax_small(request, world, case, how),
                          msg=f"{case} world {world} {how} {route}")


@pytest.mark.parametrize("case", list(SMALL))
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_small_distributed_join(request, tctxs, case, how, route):
    """World 4 (world 8: tests/test_torch_port_small_inputs.py)."""
    check_small_join(request, tctxs, 4, case, how, route)
