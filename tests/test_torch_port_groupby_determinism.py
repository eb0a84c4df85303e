"""Float group sums of cylon_tpu_torch are bit-equal to cylon_tpu's on
the CPU and equal across runs (F17).

The JAX package sums a group with ``jax.ops.segment_sum(...,
indices_are_sorted=True)``, which adds the group's rows in row order. The
port's float sums go through K7 (``kernels.segment_sum``), which adds in
the same order on both devices: on the CPU its plain version, checked
here against cylon_tpu's ``Table.groupby`` (world 1) and
``distributed_groupby`` (world 4, and after a distributed join) bit for
bit, NaN where the reference has NaN; float32 and float64 SUM and MEAN's
float64 sum, over values spread across twelve orders of magnitude (so
that any other order changes the last bits), -0.0, NaN, a skewed group
holding 40% of the rows, a group whose values are all null, and key gaps.
The same cases on the card, run twice, are in
tests/test_torch_port_gpu.py.
"""
import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.parallel import dist_ops as jdist

import cylon_tpu_torch as tct
from cylon_tpu_torch.ops import kernels as K
from cylon_tpu_torch.parallel import dist_ops as tdist

N = 600
HOT = 3      # the skewed group's key
NULLS = 11   # the key whose values are all null
OPS = (["x", "z", "x", "z", "y"], ["sum", "sum", "mean", "mean", "sum"])


def _arrays(seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    g = (rng.integers(0, 20, n) * 2 + 1).astype(np.int32)   # odd keys only
    g[rng.random(n) < 0.4] = HOT
    scale = rng.choice(np.array([1e-6, 1.0, 1e6]), n)
    x = (rng.normal(size=n) * scale).astype(np.float32)
    x[rng.random(n) < 0.1] = -0.0
    x[rng.random(n) < 0.01] = np.nan
    z = rng.normal(size=n) * scale * 1e3
    z[rng.random(n) < 0.05] = -0.0
    arrays = {"g": g, "x": x, "z": z,
              "y": rng.integers(-1000, 1000, n).astype(np.int32)}
    valid = {"x": (rng.random(n) < 0.9) & (g != NULLS),
             "z": (rng.random(n) < 0.9) & (g != NULLS)}
    return arrays, valid


def _jtable(jctx, arrays, valid):
    return jct.Table([jct.Column.from_numpy(a, k, valid.get(k))
                      for k, a in arrays.items()], jctx)


def _ttable(tctx, arrays, valid):
    return tct.Table([tct.Column.from_numpy(a, k, valid.get(k), "cpu")
                      for k, a in arrays.items()], tctx)


def _live(table, pkg):
    """[(data, valid)] of each column's live rows, flat, as numpy."""
    if pkg is tct:
        live = table.emit_mask().numpy()
        return [(c.data.numpy()[live], c.valid_mask().numpy()[live])
                for c in table._columns]
    live = np.asarray(table.emit_mask())
    return [(np.asarray(c.data)[live], np.asarray(c.valid_mask())[live])
            for c in table._columns]


def assert_bits_equal(a_cols, b_cols, what: str):
    """Every column bit for bit on its valid rows; NaN where the other has
    NaN (a NaN's payload is not a result)."""
    assert len(a_cols) == len(b_cols), what
    for ci, ((ad, av), (bd, bv)) in enumerate(zip(a_cols, b_cols)):
        assert np.array_equal(av, bv), (what, ci)
        a, b = ad[av], bd[bv]
        assert a.dtype == b.dtype, (what, ci, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            nan = np.isnan(a)
            assert np.array_equal(nan, np.isnan(b)), (what, ci)
            a, b = a[~nan], b[~nan]
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), \
            (what, ci, a[a != b][:4], b[a != b][:4])


@pytest.fixture(scope="module")
def tctxs():
    return {1: tct.CylonContext.Init(device="cpu"),
            4: tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(4),
                                                device="cpu")}


def _cases(request, tctxs, world, seed):
    arrays, valid = _arrays(seed)
    jctx = request.getfixturevalue("local_ctx" if world == 1
                                   else "dist_ctx")
    cols, ops = OPS
    aidx = [list(arrays).index(c) for c in cols]
    return (lambda: _jtable(jctx, arrays, valid).groupby(0, aidx, ops),
            lambda: _ttable(tctxs[world], arrays, valid).groupby(
                0, aidx, ops))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("world", [1, 4])
def test_groupby_sums_bit_equal_to_cylon_tpu(request, tctxs, world, seed):
    """Table.groupby at world 1 (local) and world 4 (per-shard partials,
    their exchange, the merge): every float sum and mean of the port
    equals the JAX package's bit for bit, row for row; two runs of the
    port are equal."""
    ref, port = _cases(request, tctxs, world, seed)
    exp = _live(ref(), jct)
    got1, got2 = _live(port(), tct), _live(port(), tct)
    assert_bits_equal(exp, got1, f"world {world} seed {seed} vs cylon_tpu")
    assert_bits_equal(got1, got2, f"world {world} seed {seed} run to run")
    # the all-null group has an invalid sum and an invalid mean
    keys, _kv = got1[0]
    row = np.flatnonzero(keys == NULLS)
    assert len(row) == 1 and not any(v[row[0]] for _d, v in got1[1:5])


@pytest.mark.parametrize("pre_aggregate", [True, False])
def test_distributed_groupby_bit_equal(request, tctxs, pre_aggregate):
    """distributed_groupby at world 4 with and without per-shard
    partials, bit-equal to the JAX package's."""
    arrays, valid = _arrays(7)
    cols, ops = OPS
    aidx = [list(arrays).index(c) for c in cols]
    jops = [jct.AggregationOp[o.upper()] for o in ops]
    tops = [tct.AggregationOp[o.upper()] for o in ops]
    exp = jdist.distributed_groupby(
        _jtable(request.getfixturevalue("dist_ctx"), arrays, valid), 0,
        aidx, jops, pre_aggregate=pre_aggregate)
    got = tdist.distributed_groupby(_ttable(tctxs[4], arrays, valid), 0,
                                    aidx, tops, pre_aggregate=pre_aggregate)
    assert_bits_equal(_live(exp, jct), _live(got, tct),
                      f"pre_aggregate={pre_aggregate}")


def test_join_then_groupby_bit_equal(request, tctxs):
    """bench.py's eager pipeline at a small size, world 4: the join's
    float32 payload summed by key, bit-equal to the JAX package's."""
    rng = np.random.default_rng(9)
    n = 400
    left = {"k": rng.integers(0, n // 4, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rng.integers(0, n // 4, n).astype(np.int32),
             "w": (rng.normal(size=n)
                   * rng.choice(np.array([1e-6, 1e6]), n)).astype(
                       np.float32)}

    def pipeline(pkg, dist, ctx):
        mk = (lambda a: pkg.Table.from_pydict(ctx, a))
        j = mk(left).distributed_join(mk(right), "inner", on=["k"])
        return dist.distributed_groupby(j, [0], [3, 3], [
            pkg.AggregationOp.SUM, pkg.AggregationOp.MEAN])

    exp = pipeline(jct, jdist, request.getfixturevalue("dist_ctx"))
    got = [_live(pipeline(tct, tdist, tctxs[4]), tct) for _ in range(2)]
    assert_bits_equal(_live(exp, jct), got[0], "join -> groupby")
    assert_bits_equal(got[0], got[1], "join -> groupby run to run")


def _sorted_groups(seed: int, w: int, n: int, dtype):
    """[W, n] sorted inputs of K7: group lengths from 0 to 1/3 of a shard,
    live rows first, dead rows carrying the last group's id."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(w, n)) * rng.choice(
        np.array([1e-3, 1.0, 1e3]), (w, n))).astype(dtype)
    live = rng.integers(0, n + 1, w)
    live[0] = n
    emit = np.arange(n)[None, :] < live[:, None]
    starts = rng.random((w, n)) < 0.2
    starts[:, 0] = True
    starts[:, n // 3] = False          # some long runs
    gid = np.cumsum(starts & emit, 1) - 1
    return (torch.from_numpy(x), torch.from_numpy(gid.astype(np.int64)),
            torch.from_numpy(emit))


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_segment_sum_is_a_row_order_sum(dtype):
    """K7's CPU route and plain version equal a sequential numpy sum of
    each group's live rows (np.add.at adds in index order)."""
    w, n = 3, 257
    x, gid, emit = _sorted_groups(5, w, n, dtype)
    s = n
    got = K.segment_sum(x, gid, emit, s)
    ref = np.zeros(w * s, dtype)
    e = emit.numpy()
    np.add.at(ref, (gid.numpy() + np.arange(w)[:, None] * s)[e],
              x.numpy()[e])
    assert got.dtype == x.dtype and got.shape == (w, s)
    assert np.array_equal(got.numpy().reshape(-1).view(np.uint8),
                          ref.view(np.uint8))
    assert torch.equal(K.plain_segment_sum(x, gid, emit, s), got)


def test_segment_sum_takes_floats_only():
    x, gid, emit = _sorted_groups(1, 1, 8, np.float32)
    with pytest.raises(tct.CylonError):
        K.segment_sum(x.to(torch.int32), gid, emit, 8)
    with pytest.raises(tct.CylonError):
        K.segment_sum(x, gid.to(torch.int32), emit, 8)
