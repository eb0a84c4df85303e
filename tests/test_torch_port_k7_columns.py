"""K7's list form and the group-by's boundary aggregates on the CPU.

``kernels.segment_sum`` takes a list of float columns, each with its own
accumulator type, and sums every group of every column in row order.
Checked here: each column of one list call equals a separate
``plain_segment_sum`` of it and a sequential numpy sum (``np.add.at`` adds
in index order) bit for bit, a float32 column summed into float64 equals
the sum of its float64 copy, at 1, 4, 64 and 4,096 groups, W = 1 and 4,
with -0.0 and NaN in the values (NaN where the other has NaN).

``sorted_segment_aggregate`` takes first rows, counts and integer sums
from the group boundaries instead of per-slot atomics; its ``rep``, COUNT
(all-valid and masked), integer SUM (int32 and int64, wrapping),
``group_valid`` and each aggregate's validity (the any-valid test) are
held bit for bit against ``cylon_tpu``'s ``sorted_segment_aggregate`` on
the same presorted rows, with nulls and dead rows, at 1, 4 and 64
groups, one shard at a time and four shards in one call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu.ops import groupby as jgb

import cylon_tpu_torch as tct
from cylon_tpu_torch.ops import groupby as tgb
from cylon_tpu_torch.ops import kernels as K


def _k7_inputs(seed: int, w: int, n: int, groups: int):
    """[W, n] sorted K7 inputs: a live prefix a shard (the first shard
    all live, one shard with none when W > 1), ``groups`` runs of random
    lengths over it, dead rows carrying the last id; values across ten
    orders of magnitude (finite in float16) with -0.0 and NaN."""
    rng = np.random.default_rng(seed)
    live = rng.integers(0, n + 1, w)
    live[0] = n
    if w > 1:
        live[-1] = 0
    emit = np.arange(n)[None, :] < live[:, None]
    gid = np.zeros((w, n), np.int64)
    for r in range(w):
        cuts = np.sort(rng.choice(np.arange(1, max(live[r], 1)),
                                  min(groups, max(live[r], 1)) - 1,
                                  replace=False))
        ids = np.zeros(n, np.int64)
        ids[cuts] = 1
        gid[r] = np.cumsum(ids * (np.arange(n) < live[r]))
    x = rng.normal(size=(w, n)) * rng.choice(np.array([1e-6, 1.0, 1e4]),
                                             (w, n))
    x[rng.random((w, n)) < 0.05] = -0.0
    x[rng.random((w, n)) < 0.002] = np.nan
    return x, torch.from_numpy(gid), torch.from_numpy(emit)


def _numpy_row_order(x: np.ndarray, gid, emit, s: int) -> np.ndarray:
    w = x.shape[0]
    out = np.zeros(w * s, x.dtype)
    e = emit.numpy()
    with np.errstate(over="ignore", invalid="ignore"):   # float16 sums
        np.add.at(out, (gid.numpy() + np.arange(w)[:, None] * s)[e], x[e])
    return out.reshape(w, s)


def _same(a, b) -> bool:
    """Bit for bit, NaN where the other has NaN (a NaN's payload is not a
    result: the host's and numpy's differ)."""
    a, b = (x.numpy() if isinstance(x, torch.Tensor) else x for x in (a, b))
    nan = np.isnan(a)
    return a.dtype == b.dtype and np.array_equal(nan, np.isnan(b)) \
        and np.array_equal(a[~nan].view(np.uint8), b[~nan].view(np.uint8))


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("groups", [1, 4, 64, 4096])
def test_list_form_equals_one_plain_sum_a_column(w, groups):
    """One list call over float16, float32 and float64 columns, the
    float32 one twice (into float32 and into float64) and the float16 one
    into float64: every column equals its own plain sum, the single-column
    call, and numpy's index-order sum, bit for bit."""
    n = 9000
    x, gid, emit = _k7_inputs(groups * 7 + w, w, n, groups)
    s = groups
    h, f, d = (torch.from_numpy(x.astype(t)) for t in
               (np.float16, np.float32, np.float64))
    cols = [h, f, f, d, h]
    accs = [torch.float16, torch.float32, torch.float64, torch.float64,
            torch.float64]
    got = K.segment_sum(cols, gid, emit, s, accs)
    plain = K.plain_segment_sum(cols, gid, emit, s, accs)
    assert len(got) == len(cols)
    for c, (col, acc) in enumerate(zip(cols, accs)):
        assert got[c].dtype == acc and got[c].shape == (w, s)
        ref = _numpy_row_order(col.to(acc).numpy(), gid, emit, s)
        assert _same(got[c], ref), c
        assert _same(got[c], plain[c]), c
        assert _same(got[c], K.segment_sum(col.to(acc), gid, emit, s)), c
    # float32 into float64 is the sum of the float64 copy
    assert _same(got[2], K.segment_sum(f.to(torch.float64), gid, emit, s))


def test_list_form_refuses_narrowing_and_non_floats():
    x, gid, emit = _k7_inputs(3, 1, 64, 4)
    f = torch.from_numpy(x.astype(np.float32))
    with pytest.raises(tct.CylonError):
        K.segment_sum([f], gid, emit, 4, [torch.float16])
    with pytest.raises(tct.CylonError):
        K.segment_sum([f.to(torch.int32)], gid, emit, 4)
    with pytest.raises(tct.CylonError):
        K.segment_sum([f, f], gid, emit, 4, [torch.float32])
    with pytest.raises(tct.CylonError):
        K.plain_segment_sum([f.to(torch.float64)], gid, emit, 4,
                            [torch.float32])


# --------------------------------------------------------------------------
# the group-by's boundary aggregates against cylon_tpu
# --------------------------------------------------------------------------

I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)
OPS = ("COUNT", "COUNT", "SUM", "SUM", "SUM", "MIN", "MEAN", "SUM")
# (column, all-valid): a masked int32 column, an all-valid one, int64
# and float32 columns with nulls
COLS = (0, 1, 0, 1, 2, 2, 3, 3)


def _shard(seed: int, n: int, groups: int):
    """One shard's keys, emit and value columns (int32 near its limits so
    that sums wrap, int64 likewise, float32), with validity masks."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, groups, n).astype(np.int32)
    emit = rng.random(n) < 0.8
    a = rng.integers(I32.max - 50, I32.max, n, dtype=np.int32)
    a[rng.random(n) < 0.5] *= -1
    b = rng.integers(-100, 100, n).astype(np.int32)
    c = rng.integers(I64.max // 4, I64.max // 2, n, dtype=np.int64)
    f = (rng.normal(size=n) * 1e3).astype(np.float32)
    va = rng.random(n) < 0.7
    vc = rng.random(n) < 0.6
    vf = rng.random(n) < 0.9
    if groups > 1:   # a group whose values are all null
        va[key == 1] = vc[key == 1] = vf[key == 1] = False
    return key, emit, [a, b, c, f], [va, None, vc, vf]


def _reference(key, emit, vals, valids, s):
    pre = jgb.presort_groups((jnp.asarray(key),), jnp.asarray(emit),
                             tuple(jnp.asarray(v) for v in vals),
                             tuple(None if m is None else jnp.asarray(m)
                                   for m in valids))
    values_s, valids_s, emit_s, iota_s, gid_s, _ng = pre
    rep, gv, res = jgb.sorted_segment_aggregate(
        gid_s, emit_s, iota_s, tuple(values_s[c] for c in COLS),
        tuple(valids_s[c] for c in COLS), s,
        tuple(jgb.AggregationOp[o] for o in OPS), COLS,
        tuple(valids[c] is None for c in COLS))
    return ([np.asarray(rep), np.asarray(gv)]
            + [np.asarray(x) for r in res for x in r])


def _port(shards, s):
    """The port on [W, n] inputs (one call for every shard): the same
    arrays as _reference's, each [W, s]."""
    t = lambda xs: torch.from_numpy(np.stack(xs))   # noqa: E731
    keys = t([k for k, _e, _v, _m in shards])
    emit = t([e for _k, e, _v, _m in shards])
    ncol = len(shards[0][2])
    vals = [t([sh[2][c] for sh in shards]) for c in range(ncol)]
    valids = [None if shards[0][3][c] is None
              else t([sh[3][c] for sh in shards]) for c in range(ncol)]
    pre = tgb.presort_groups([keys], emit, vals, valids)
    values_s, valids_s, emit_s, iota_s, gid_s, _ng = pre
    rep, gv, res = tgb.sorted_segment_aggregate(
        gid_s, emit_s, iota_s, [values_s[c] for c in COLS],
        [valids_s[c] for c in COLS], s,
        [tgb.AggregationOp[o] for o in OPS], COLS,
        [valids[c] is None for c in COLS])
    return [rep, gv] + [x for r in res for x in r]


@pytest.mark.parametrize("groups", [1, 4, 64])
def test_boundary_aggregates_bit_equal_to_cylon_tpu(groups):
    """rep, group_valid, COUNT (masked and all-valid), the integer SUMs
    (wrapping), MIN, MEAN, the float SUM and every validity: the port's
    [4, n] call equals cylon_tpu's call on each shard bit for bit; one
    shard has no live row."""
    n, s = 700, 64
    shards = [_shard(groups * 10 + i, n, groups) for i in range(4)]
    shards[2] = (shards[2][0], np.zeros(n, bool)) + shards[2][2:]
    got = _port(shards, s)
    for i, sh in enumerate(shards):
        exp = _reference(*sh, s)
        assert len(got) == len(exp)
        for j, (a, b) in enumerate(zip(got, exp)):
            a = a[i].numpy()
            what = (i, j, "rep/group_valid" if j < 2 else OPS[(j - 2) // 2])
            if j == 0:   # rep: row ids, int32 in the reference
                a, b = a.astype(np.int64), b.astype(np.int64)
            assert a.shape == b.shape and a.dtype == b.dtype, \
                (what, a.dtype, b.dtype)
            if a.dtype.kind == "f":
                nan = np.isnan(a)
                assert np.array_equal(nan, np.isnan(b)), what
                a, b = a[~nan], b[~nan]
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), what


def test_group_bounds_of_empty_and_dead_shards():
    """A group's rows are [first, end), the next group's first row or
    the shard's live count ending it, which also fills the slots of groups
    that do not exist; a shard with no live row and a shard of no rows
    have no groups (rep n, every count 0)."""
    gid = torch.tensor([[0, 0, 1, 1, 1], [-1, -1, -1, -1, -1]])
    emit = torch.tensor([[True, True, True, True, False],
                         [False] * 5])
    first, end = tgb._group_bounds(tgb._start_slots(gid, emit, 4), emit, 4)
    assert first.tolist() == [[0, 2, 4, 4], [0, 0, 0, 0]]
    assert end.tolist() == [[2, 4, 4, 4], [0, 0, 0, 0]]
    one = tgb.AggregationOp.COUNT
    for g, e in ((gid, emit), (torch.zeros(2, 0, dtype=torch.int64),
                               torch.zeros(2, 0, dtype=torch.bool))):
        n = g.shape[1]
        iota = torch.arange(n).expand(2, n)
        rep, gv, [(cnt, _v)] = tgb.sorted_segment_aggregate(
            g, e, iota, [g], [None], 4, [one], [0], [True])
        want = [[2, 2, 0, 0], [0, 0, 0, 0]] if n else [[0] * 4] * 2
        assert cnt.tolist() == want
        assert rep.tolist()[1] == [n] * 4 and not gv[1].any()
