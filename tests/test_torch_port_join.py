"""cylon_tpu_torch's local join against cylon_tpu's: the plan arrays bit
for bit, and the joined rows as multisets, for all four join types."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import assert_rows_equal

import cylon_tpu as jct
from cylon_tpu.ops import join as jjoin
from cylon_tpu.ops import order as jorder

import cylon_tpu_torch as tct
from cylon_tpu_torch.ops import join as tjoin

JOIN_TYPES = ["inner", "left", "right", "outer"]


def _row_bits(df) -> np.ndarray:
    """A frame's rows as int64 bit patterns (null flag + value bits per
    column, floats by their bits), sorted: a canonical multiset."""
    import pandas as pd

    cols = []
    for c in df.columns:
        a = df[c].to_numpy()
        null = pd.isna(df[c]).to_numpy()
        if a.dtype.kind == "f":
            bits = a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])
        else:
            bits = np.where(null, 0, a)
        cols += [null.astype(np.int64), np.where(null, 0, bits).astype(
            np.int64)]
    arr = np.stack(cols, 1) if cols else np.zeros((len(df), 0), np.int64)
    return arr[np.lexsort(arr.T[::-1])] if len(arr) else arr


def assert_rows_bit_equal(got_df, exp_df, msg=""):
    """Order-insensitive row multisets, equal bit for bit (tolerance 0:
    payload floats are gathered, never computed); conftest's
    assert_rows_equal is the rounded form of the same check."""
    assert_rows_equal(got_df, exp_df, msg=msg)
    assert np.array_equal(_row_bits(got_df), _row_bits(exp_df)), msg


@pytest.fixture(scope="module")
def tctx():
    return tct.CylonContext.Init(device="cpu")


def _arrays(seed, n_left=200, n_right=170, two_keys=False):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, 60, n_left).astype(np.int32),
            "v": rng.normal(size=n_left).astype(np.float32),
            "w": rng.integers(-5, 5, n_left).astype(np.int64)}
    right = {"k": rng.integers(0, 60, n_right).astype(np.int32),
             "x": rng.normal(size=n_right).astype(np.float64)}
    if two_keys:
        left["k2"] = rng.integers(0, 3, n_left).astype(np.int64)
        right["k2"] = rng.integers(0, 3, n_right).astype(np.int64)
    valid = {"left": {"k": rng.random(n_left) < 0.9,
                      "v": rng.random(n_left) < 0.8},
             "right": {"k": rng.random(n_right) < 0.9}}
    return left, right, valid


def _tables(jctx, tctx, arrays, valid):
    jcols = [jct.Column.from_numpy(a, n, valid.get(n))
             for n, a in arrays.items()]
    tcols = [tct.Column.from_numpy(a, n, valid.get(n), "cpu")
             for n, a in arrays.items()]
    return jct.Table(jcols, jctx), tct.Table(tcols, tctx)


def _joined(jctx, tctx, seed, two_keys=False):
    left, right, valid = _arrays(seed, two_keys=two_keys)
    jl, tl = _tables(jctx, tctx, left, valid["left"])
    jr, tr = _tables(jctx, tctx, right, valid["right"])
    return jl, tl, jr, tr


@pytest.mark.parametrize("jt", list(jjoin.JoinType), ids=lambda t: t.name)
@pytest.mark.parametrize("two_keys", [False, True])
def test_join_plan_keys_arrays_bit_equal(jt, two_keys):
    rng = np.random.default_rng(int(jt) + 5 * two_keys)
    na, nb = 150, 130
    lk = [rng.integers(0, 40, na).astype(np.int32)]
    rk = [rng.integers(0, 40, nb).astype(np.int32)]
    if two_keys:
        lk.append(rng.integers(-2, 2, na).astype(np.int64))
        rk.append(rng.integers(-2, 2, nb).astype(np.int64))
    lkv, rkv = rng.random(na) < 0.9, rng.random(nb) < 0.9
    lemit, remit = rng.random(na) < 0.95, rng.random(nb) < 0.95
    ref = jjoin.join_plan_keys(
        tuple(jorder.ordered_bits_raw(jnp.asarray(x)) for x in lk),
        jnp.asarray(lkv), jnp.asarray(lemit),
        tuple(jorder.ordered_bits_raw(jnp.asarray(x)) for x in rk),
        jnp.asarray(rkv), jnp.asarray(remit), jt)
    lbits, _ = tjoin.key_bits([torch.from_numpy(x)[None] for x in lk],
                              [None] * len(lk))
    rbits, _ = tjoin.key_bits([torch.from_numpy(x)[None] for x in rk],
                              [None] * len(rk))
    got = tjoin.join_plan_keys(
        lbits, torch.from_numpy(lkv)[None], torch.from_numpy(lemit)[None],
        rbits, torch.from_numpy(rkv)[None], torch.from_numpy(remit)[None],
        jt)
    for name, r, g in zip(("counts2", "lo", "m", "bperm", "un_mask"), ref,
                          got):
        assert np.array_equal(np.asarray(r), g[0].numpy()), name


@pytest.mark.parametrize("how", JOIN_TYPES)
@pytest.mark.parametrize("two_keys", [False, True])
def test_local_join_matches_cylon_tpu(local_ctx, tctx, how, two_keys):
    jl, tl, jr, tr = _joined(local_ctx, tctx, seed=3, two_keys=two_keys)
    on = ["k", "k2"] if two_keys else ["k"]
    exp = jl.join(jr, how, on=on).to_pandas()
    got = tl.join(tr, how, on=on).to_pandas()
    assert_rows_bit_equal(got, exp, msg=f"{how} two_keys={two_keys}")


@pytest.mark.parametrize("how", JOIN_TYPES)
@pytest.mark.parametrize("algorithm", ["sort", "hash"])
def test_stream_route_equals_plan_route(tctx, how, algorithm):
    """Inside the port: the stream route (plain K3/K4) gives the rows of
    the plan route, for one key (sort mode) and two keys (hash mode)."""
    _jl, tl, _jr, tr = _joined(None, tctx, seed=11,
                               two_keys=algorithm == "hash")
    on = ["k", "k2"] if algorithm == "hash" else ["k"]
    old = tjoin.STREAM_PLAN
    try:
        tjoin.STREAM_PLAN = False
        plan = tl.join(tr, how, algorithm, on=on).to_pandas()
        tjoin.STREAM_PLAN = True
        stream = tl.join(tr, how, algorithm, on=on).to_pandas()
    finally:
        tjoin.STREAM_PLAN = old
    assert_rows_bit_equal(stream, plan, msg=f"{how}/{algorithm}")


def test_read_csv_matches_cylon_tpu(local_ctx, tctx, tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "t.csv"
    with open(path, "w") as f:
        f.write("k,v,w\n")
        for i in range(50):
            v = "" if i % 7 == 0 else f"{rng.normal():.6f}"
            f.write(f"{rng.integers(0, 9)},{v},{rng.integers(-3, 3)}\n")
    exp = jct.read_csv(local_ctx, str(path)).to_pandas()
    got = tct.read_csv(tctx, str(path))
    assert_rows_bit_equal(got.to_pandas(), exp)
    out = tmp_path / "o.csv"
    got.to_csv(str(out))
    assert_rows_bit_equal(tct.read_csv(tctx, str(out)).to_pandas(), exp)
