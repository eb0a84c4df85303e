"""cylon_tpu_torch key bits and hashes are bit-identical to cylon_tpu's:
the same rows land on the same shards in both packages."""
import numpy as np
import pytest
import torch

from cylon_tpu.data.column import Column as JColumn
from cylon_tpu.ops import hash as jhash
from cylon_tpu.ops import order as jorder
from cylon_tpu.parallel import dist_ops as jdist

from cylon_tpu_torch.data.column import Column as TColumn
from cylon_tpu_torch.ops import hash as thash
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.ops import order as torder
from cylon_tpu_torch.parallel import dist_ops as tdist

DTYPES = [np.int32, np.int64, np.float32, np.float64]


def _values(dt, n, rng):
    if np.dtype(dt).kind == "f":
        x = rng.normal(size=n).astype(dt) * 1000
        x[:8] = [0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 0.0, -0.0]
        return x
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, dtype=np.int64).astype(dt)
    x[:3] = [0, info.min, info.max]
    return x


def _cols(dt, nulls, seed, n=257):
    rng = np.random.default_rng(seed)
    x = _values(dt, n, rng)
    valid = rng.random(n) < 0.8 if nulls else None
    return (JColumn.from_numpy(x, "c", valid),
            TColumn.from_numpy(x, "c", valid, "cpu"))


def _u(a, width=None):
    """Either package's bits as the unsigned numpy view of their width."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    w = width or a.dtype.itemsize
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[w])


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("nulls", [False, True])
def test_ordered_bits_and_hash_column(dt, nulls):
    jc, tc = _cols(dt, nulls, seed=1)
    assert np.array_equal(_u(jorder.ordered_bits(jc)),
                          _u(torder.ordered_bits(tc)))
    assert np.array_equal(_u(jorder.sort_keys([jc])[0]),
                          _u(torder.sort_keys([tc])[0]))
    assert np.array_equal(_u(jhash.hash_column(jc)),
                          _u(thash.hash_column(tc)))


@pytest.mark.parametrize("dts", [(np.int32,), (np.float64,),
                                 (np.int64, np.float32),
                                 (np.float32, np.int32)],
                         ids=lambda d: "-".join(np.dtype(x).name for x in d))
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_hash_columns_and_targets(dts, nulls, world):
    pairs = [_cols(dt, nulls, seed=10 + i) for i, dt in enumerate(dts)]
    jcols = [p[0] for p in pairs]
    tcols = [p[1] for p in pairs]
    assert np.array_equal(_u(jhash.hash_columns(jcols)),
                          _u(thash.hash_columns(tcols)))
    jt = np.asarray(jhash.partition_targets(jcols, world))
    tt = thash.partition_targets(tcols, world).numpy()
    assert np.array_equal(jt, tt)

    class _Ctx:  # _partition_targets_dist reads only the world size
        @staticmethod
        def get_world_size():
            return world

    jd = np.asarray(jdist._partition_targets_dist(_Ctx, jcols))
    td = tdist._partition_targets_dist(world, tcols).numpy()
    assert np.array_equal(jd, td)


@pytest.mark.parametrize("two", [False, True])
def test_hash2_streams(two):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n = 300
    lanes = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
             for _ in range(2 if two else 1)]
    live = rng.random(n) < 0.7
    jh1, jh2 = jhash.hash2_streams([jnp.asarray(x) for x in lanes],
                                   jnp.asarray(live))
    th1, th2 = thash.hash2_streams(
        [torch.from_numpy(x.view(np.int32)) for x in lanes],
        torch.from_numpy(live))
    assert np.array_equal(np.asarray(jh1), th1.numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(jh2), th2.numpy().astype(np.uint32))


def test_key_bits_feed_the_join_unchanged():
    """The join's key bits are ordered_bits_raw of the key column."""
    x = _values(np.float32, 100, np.random.default_rng(4))
    (bits,), _kv = tjoin.key_bits([torch.from_numpy(x)[None]], [None])
    import jax.numpy as jnp

    assert np.array_equal(_u(jorder.ordered_bits_raw(jnp.asarray(x))),
                          _u(bits[0]))
