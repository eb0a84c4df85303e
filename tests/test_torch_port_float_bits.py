"""Float bits on distributed outputs: the port keeps them, the JAX
package's export does not.

Two known faults of the reference (ROADMAP queue 3), left alone and
pinned here so that they show instead of being avoided:

* F2: cylon_tpu's ``Table.compact`` gathers a row-sharded array with
  ``jnp.take``, which on the CPU mesh turns -0.0 into +0.0, so every
  distributed result exported through ``to_pandas`` loses the sign of
  its zeros. The port's outputs are held bit for bit against a numpy
  oracle that keeps the sign bits, and against the reference with the
  port's -0.0 mapped to +0.0.
* F3: cylon_tpu's scalar min/max of a sharded column drop a shard whose
  partial is NaN; its local min/max propagate NaN, as the port does on
  both layouts.
"""
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
from cylon_tpu.parallel import dist_ops as jdist

import cylon_tpu_torch as tct
from cylon_tpu_torch.parallel import dist_ops as tdist

from test_torch_port_join import assert_rows_bit_equal

N_NEG_ZERO = 19


@pytest.fixture(scope="module")
def tctx():
    return tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(4),
                                            device="cpu")


def _arrays():
    """64 rows: int32 k in [0, 16), float32 p with 19 -0.0 values."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, 16, 64).astype(np.int32)
    p = rng.normal(size=64).astype(np.float32)
    p[rng.choice(64, N_NEG_ZERO, replace=False)] = -0.0
    return k, p


def _neg_zeros(x) -> int:
    x = np.asarray(x, np.float32)
    return int(((x == 0) & np.signbit(x)).sum())


def _positive_zeros(df: pd.DataFrame) -> pd.DataFrame:
    out = df.copy()
    for c in out.columns:
        if out[c].dtype.kind == "f":
            out[c] = np.where(out[c].to_numpy() == 0,
                              np.zeros((), out[c].dtype), out[c].to_numpy())
    return out


def test_shuffle_keeps_negative_zero(dist_ctx, tctx):
    k, p = _arrays()
    got = tdist.shuffle(tct.Table.from_pydict(tctx, {"k": k, "p": p}),
                        ["k"]).to_pandas()
    oracle = pd.DataFrame({"k": k, "p": p})
    assert_rows_bit_equal(got, oracle)
    assert _neg_zeros(got["p"]) == N_NEG_ZERO
    ref = jdist.shuffle(jct.Table.from_pydict(dist_ctx, {"k": k, "p": p}),
                        ["k"]).to_pandas()
    assert _neg_zeros(ref["p"]) == 0  # F2: the reference's export
    assert_rows_bit_equal(_positive_zeros(got), ref)


def _numpy_inner_join(left, right, lkey, rkey):
    """The inner join's rows (left columns, then right), float keys equal
    as floats (-0.0 == +0.0), every value's bits kept."""
    pairs = [(i, j) for i in range(len(left[lkey]))
             for j in range(len(right[rkey]))
             if left[lkey][i] == right[rkey][j]]
    li = np.array([i for i, _ in pairs], np.int64)
    ri = np.array([j for _, j in pairs], np.int64)
    cols = {f"lt-{c}": a[li] for c, a in enumerate(left.values())}
    cols.update({f"rt-{len(left) + c}": a[ri]
                 for c, a in enumerate(right.values())})
    return pd.DataFrame(cols)


@pytest.mark.parametrize("on", ["k", "p"])
def test_distributed_join_keeps_negative_zero(dist_ctx, tctx, on):
    """On the int key (-0.0 a payload) and on the float key (-0.0 and
    +0.0 equal keys, each row keeping its own sign)."""
    k, p = _arrays()
    left, right = {"k": k, "p": p}, {"k": k[::-1].copy(),
                                     "w": p[::-1].copy()}
    rkey = "k" if on == "k" else "w"
    got = tct.Table.from_pydict(tctx, left).distributed_join(
        tct.Table.from_pydict(tctx, right), "inner",
        left_on=[on], right_on=[rkey]).to_pandas()
    oracle = _numpy_inner_join(left, right, on, rkey)
    got.columns = oracle.columns
    assert_rows_bit_equal(got, oracle)
    assert _neg_zeros(got["lt-1"]) > 0
    ref = jct.Table.from_pydict(dist_ctx, left).distributed_join(
        jct.Table.from_pydict(dist_ctx, right), "inner",
        left_on=[on], right_on=[rkey]).to_pandas()
    ref.columns = oracle.columns
    assert _neg_zeros(ref["lt-1"]) == 0  # F2
    assert_rows_bit_equal(_positive_zeros(got), ref)


@pytest.mark.parametrize("op", ["min", "max"])
def test_sharded_min_max_keep_nan(dist_ctx, local_ctx, tctx, op):
    x = np.array([1.0, np.nan, -3.0, 2.0, 0.5, 7.0, 8.0, 9.0], np.float32)
    cols = lambda ct: [ct.Column.from_numpy(x, "x", np.ones(8, bool))]
    got = getattr(tdist.shard.distribute(tct.Table(
        [tct.Column.from_numpy(x, "x", np.ones(8, bool), "cpu")], tctx),
        tctx), op)("x")
    local_ref = getattr(jct.Table(cols(jct), local_ctx), op)("x")
    from cylon_tpu.parallel import shard as jshard

    dist_ref = getattr(jshard.distribute(jct.Table(cols(jct), dist_ctx),
                                         dist_ctx), op)("x")
    assert np.isnan(got._columns[0].data.numpy()).all()
    assert np.isnan(np.asarray(local_ref._columns[0].data)).all()
    # F3: the reference's sharded reduction drops shard 0's NaN partial
    assert not np.isnan(np.asarray(dist_ref._columns[0].data)).any()
