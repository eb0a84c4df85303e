"""cylon_tpu_torch's distributed set ops against cylon_tpu's on the
virtual CPU mesh: at world 4 and 8 on both partition routes, every shard
holds the same rows in the same order, bit for bit; at world 1 the forced
exchange matches too, and the unforced op short-circuits to the local
set op."""
import numpy as np
import pytest

import cylon_tpu as jct
from cylon_tpu.ops import setops as jsetops
from cylon_tpu.parallel import dist_ops as jdist

import cylon_tpu_torch as tct
from cylon_tpu_torch.ops import setops as tsetops
from cylon_tpu_torch.parallel import dist_ops as tdist
from cylon_tpu_torch.parallel import shuffle as tshuffle

from test_torch_port_setops import OPS, _filter, _pair, assert_same_tables, \
    row_set


@pytest.fixture
def route(request):
    """'plan': the stable-sort partition; 'kernel': K1/K2's wrappers
    forced (their plain versions on the CPU)."""
    old = tshuffle.PARTITION_KERNEL
    tshuffle.PARTITION_KERNEL = True if request.param == "kernel" else None
    yield request.param
    tshuffle.PARTITION_KERNEL = old


def _dist_arrays(seed, n):
    rng = np.random.default_rng(seed)
    arrays = {"k": rng.integers(0, 120, n).astype(np.int32),
              "g": rng.integers(0, 3, n).astype(np.int64),
              "f": rng.choice(np.array([0.0, -0.0, 1.5], np.float32), n)}
    return arrays, {"g": rng.random(n) < 0.9}, rng.random(n) < 0.9


_JAX_DIST = {}


@pytest.fixture(scope="module", autouse=True)
def _release_reference_tables():
    """The cached results are tracked tables of the JAX package's ledger:
    drop them when the module ends, so that no later test file in this
    process (pytest-xdist's ``--dist loadfile`` runs several files in one
    worker) sees them live (ROADMAP queue 3, F6)."""
    yield
    _JAX_DIST.clear()


def _jax_dist(request, world, op, build):
    key = (world, op)
    if key not in _JAX_DIST:
        jctx = request.getfixturevalue({4: "dist_ctx", 8: "dist_ctx8"}[world])
        jl, jr = build(jctx)
        _JAX_DIST[key] = getattr(jl, f"distributed_{op}")(jr)
    return _JAX_DIST[key]


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_distributed_set_op_matches_cylon_tpu(request, world, op, route):
    """Every shard holds the same rows in the same order, bit for bit."""
    tctx = tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(world),
                                            device="cpu")

    def build(jctx):
        la, lv, lkeep = _dist_arrays(10 + world, 420)
        ra, rv, rkeep = _dist_arrays(20 + world, 390)
        jl, tl = _filter(*_pair(jctx, tctx, la, lv), lkeep)
        jr, tr = _filter(*_pair(jctx, tctx, ra, rv), rkeep)
        return (jl, jr) if jctx is not None else (tl, tr)

    jres = _jax_dist(request, world, op, build)
    tl, tr = build(None)
    tres = getattr(tl, f"distributed_{op}")(tr)
    assert tres._shard_world == world
    assert_same_tables(jres, tres, f"world {world} {op} {route}")


@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_forced_exchange_on_one_shard(route):
    """force_exchange at world 1 runs the one-shard exchange and the
    per-shard dense-ranks op, row for row the JAX package's."""
    jctx = jct.CylonContext.InitDistributed(jct.TPUConfig(world_size=1))
    tctx = tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(1),
                                            device="cpu")
    la, lv, _k = _dist_arrays(31, 200)
    ra, rv, _k = _dist_arrays(32, 150)
    jl, tl = _pair(jctx, tctx, la, lv)
    jr, tr = _pair(jctx, tctx, ra, rv)
    for op in (tsetops.SetOp.UNION, tsetops.SetOp.INTERSECT):
        jres = jdist.distributed_set_op(jl, jr, jsetops.SetOp(int(op)),
                                        force_exchange=True)
        tres = tdist.distributed_set_op(tl, tr, op, force_exchange=True)
        assert_same_tables(jres, tres, op.name)


def test_world_one_short_circuits_to_the_local_set_op(monkeypatch):
    tctx = tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(1),
                                            device="cpu")
    la, lv, _k = _dist_arrays(41, 100)
    ra, rv, _k = _dist_arrays(42, 100)
    _j, tl = _pair(None, tctx, la, lv)
    _j, tr = _pair(None, tctx, ra, rv)
    calls = []
    real = tdist.table_mod.set_op

    def spy(*a):
        calls.append(a[2])
        return real(*a)

    monkeypatch.setattr(tdist.table_mod, "set_op", spy)
    out = tl.distributed_subtract(tr)
    assert calls == [tsetops.SetOp.SUBTRACT]
    assert np.array_equal(row_set(out), row_set(real(
        tl, tr, tsetops.SetOp.SUBTRACT)))
