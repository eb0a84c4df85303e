"""cylon_tpu_torch's salted shuffle against cylon_tpu's on the virtual
CPU mesh (mirrors tests/test_adaptive_join.py:566-600 and :675): the
salted targets and the salted and raw count matrices equal the JAX
package's ``_salted_targets_fn`` bit for bit at world 4 and 8; each
shard's rows equal the reference's salted shuffle in order; uniform keys
are untouched; salt factors 0 and 1 turn salting off; a salted output
carries no witness."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.parallel import dist_ops as jdist
from cylon_tpu.parallel import shard as jshard
from cylon_tpu.parallel import shuffle as jshuffle

from cylon_tpu_torch.parallel import dist_ops as tdist
from cylon_tpu_torch.parallel import shard as tshard
from cylon_tpu_torch.parallel import shuffle as tshuffle

from test_torch_port_ring_join import jctx, pair, route, tctx  # noqa: F401


def _zipf(n, seed):
    rng = np.random.default_rng(seed)
    k = np.where(rng.random(n) < 0.7, 7,
                 rng.integers(0, 1000, n)).astype(np.int32)
    return {"k": k, "v": np.arange(n, dtype=np.float32)}


def _shard_rows(table, world):
    return np.asarray(table.emit_mask()).reshape(world, -1).sum(1).tolist()


def _assert_same_layout(got, exp):
    """Same capacity and emit mask, every live slot's data and validity
    bit for bit (each shard's rows in order)."""
    te, je = got.emit_mask().numpy(), np.asarray(exp.emit_mask())
    assert np.array_equal(te, je)
    for tc, jc in zip(got._columns, exp._columns):
        a, b = tc.data.numpy()[te], np.asarray(jc.data)[je]
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
        assert np.array_equal(tc.valid_mask().numpy()[te],
                              np.asarray(jc.valid_mask())[je])


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("salt", [2, 4])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_salted_targets_match(request, world, salt, route):
    """Targets, salted and raw count matrices, with a filtered emit mask
    (dead rows count at W)."""
    jc, tc = jctx(request, world), tctx(world)
    data = _zipf(3000, 27)
    jt, tt = pair(jc, tc, data)
    jt = jt.filter_mask(jnp.asarray(data["v"] % 5 != 0))
    tt = tt.filter_mask(torch.from_numpy(data["v"] % 5 != 0))
    jd, td = jshard.distribute(jt, jc), tshard.distribute(tt, tc)
    jtg = jshard.pin(jdist._partition_targets_dist(jc, [jd._columns[0]]),
                     jc)
    t2, both = jshuffle._salted_targets_fn(jc.mesh, salt)(
        jtg, jd.emit_mask(), jnp.float32(2.0))
    ttg = tdist._partition_targets_dist(world, [td._columns[0]])
    assert np.array_equal(ttg.numpy(), np.asarray(jtg))
    got, salted, raw = tshuffle.salted_exchange_targets(
        ttg, td.emit_mask(), tc, salt, 2.0)
    both = np.asarray(both)
    assert np.array_equal(salted, both[0]) and np.array_equal(raw, both[1])
    assert np.array_equal(got.numpy(), np.asarray(t2))
    assert (salted != raw).any()


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_salted_shuffle_shard_by_shard(request, world, route):
    jc, tc = jctx(request, world), tctx(world)
    data = _zipf(8192, 27)
    jt, tt = pair(jc, tc, data)
    plain = tdist.shuffle(tt, ["k"])
    got = tdist.shuffle(tt, ["k"], salted=True)
    exp = jdist.shuffle(jt, ["k"], salted=True)
    _assert_same_layout(got, exp)
    assert got._hash_partitioned is None
    assert plain._hash_partitioned is not None
    assert max(_shard_rows(got, world)) < max(_shard_rows(plain, world))


def test_salted_uniform_keys_untouched(request):
    """No hot destination: the salted shuffle is the plain one."""
    rng = np.random.default_rng(28)
    data = {"k": rng.integers(0, 4096, 4096).astype(np.int32),
            "v": np.arange(4096, dtype=np.float32)}
    jt, tt = pair(jctx(request, 4), tctx(4), data)
    plain = tdist.shuffle(tt, ["k"])
    salted = tdist.shuffle(tt, ["k"], salted=True)
    _assert_same_layout(salted, jdist.shuffle(jt, ["k"], salted=True))
    assert _shard_rows(plain, 4) == _shard_rows(salted, 4)
    for a, b in zip(plain._columns, salted._columns):
        assert torch.equal(a.data, b.data)


@pytest.mark.parametrize("factor", ["0", "1"])
def test_salt_factor_below_two_disables(request, monkeypatch, factor):
    monkeypatch.setenv("CYLON_SALT_FACTOR", factor)
    data = _zipf(4096, 30)
    jt, tt = pair(jctx(request, 4), tctx(4), data)
    plain = tdist.shuffle(tt, ["k"])
    salted = tdist.shuffle(tt, ["k"], salted=True)
    _assert_same_layout(salted, jdist.shuffle(jt, ["k"], salted=True))
    assert _shard_rows(plain, 4) == _shard_rows(salted, 4)
    assert salted._hash_partitioned is not None
