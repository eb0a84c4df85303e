"""cylon_tpu_torch's sort, distributed sort, hash_partition and
repartition against cylon_tpu's on the CPU.

Tolerances (the same in PERF.md):
* ``Table.sort``: the key columns bit for bit in order, and whole rows
  equal as multisets within each run of equal keys (the JAX package's
  ``lexsort_indices`` does not ask ``lax.sort`` for a stable sort, so
  the order of ties is not part of its contract);
* ``distributed_sort``: the splitters equal, and every shard's live rows
  bit for bit, row for row (its per-shard sort is stable);
* ``hash_partition`` and ``repartition``: every partition or shard bit
  for bit, row for row.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.parallel import dist_ops as jdist
from cylon_tpu.parallel import shard as jshard

import cylon_tpu_torch as tct
from cylon_tpu_torch.ops import order as torder
from cylon_tpu_torch.parallel import dist_ops as tdist
from cylon_tpu_torch.parallel import shuffle as tshuffle


@pytest.fixture(scope="module")
def tctxs():
    out = {w: tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(w),
                                               device="cpu")
           for w in (1, 4, 8)}
    out[0] = tct.CylonContext.Init(device="cpu")
    return out


def _jctx(request, world):
    if world == 0:
        return request.getfixturevalue("local_ctx")
    if world == 1:
        return jct.CylonContext.InitDistributed(jct.TPUConfig(world_size=1))
    return request.getfixturevalue({4: "dist_ctx", 8: "dist_ctx8"}[world])


def _arrays(seed, n=300):
    """k (int32), b (int64 with the top bit set), f (float32: -0.0, +0.0,
    NaN, nullable), s (int16, nullable), v (float64 payload)."""
    rng = np.random.default_rng(seed)
    f = rng.choice(np.array([-1.5, 0.0, -0.0, 2.25, np.nan, 7.0],
                            np.float32), n)
    arrays = {"k": rng.integers(-20, 20, n).astype(np.int32),
              "b": rng.choice(np.array([-(1 << 63), -1, 0, 1 << 62,
                                        (1 << 63) - 1], np.int64), n),
              "f": f,
              "s": rng.integers(0, 5, n).astype(np.int16),
              "v": rng.normal(size=n)}
    valid = {"f": rng.random(n) < 0.9, "s": rng.random(n) < 0.8}
    return arrays, valid


def _pair(jctx, tctx, arrays, valid):
    jt = jct.Table([jct.Column.from_numpy(a, k, valid.get(k))
                    for k, a in arrays.items()], jctx)
    tt = tct.Table([tct.Column.from_numpy(a, k, valid.get(k), "cpu")
                    for k, a in arrays.items()], tctx)
    return jt, tt


def _rows(t, live):
    """[(validity, data bytes) per column] of the live rows, host."""
    return [(np.asarray(c.valid_mask())[live],
             np.asarray(c.data if not torch.is_tensor(c.data)
                        else c.data.numpy())[live]) for c in t._columns]


def _row_bytes(cols, i):
    return tuple((bool(v[i]), d[i].tobytes() if v[i] else b"")
                 for v, d in cols)


def assert_sorted_equal(jt, tt, key_idx, what=""):
    """Keys bit for bit in order; rows as multisets within runs of equal
    keys."""
    assert jt.row_count == tt.row_count, what
    je = np.asarray(jt.emit_mask())
    te = tt.emit_mask().numpy()
    jc, tc = _rows(jt, je), _rows(tt, te)
    for i in key_idx:
        assert np.array_equal(jc[i][0], tc[i][0]), (what, i)
        a = np.where(jc[i][0], jc[i][1], 0)
        b = np.where(tc[i][0], tc[i][1], 0)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (what, i)
    n = int(je.sum())
    keys = [_row_bytes([jc[i] for i in key_idx], r) for r in range(n)]
    start = 0
    for r in range(1, n + 1):
        if r == n or keys[r] != keys[start]:
            ja = sorted(_row_bytes(jc, x) for x in range(start, r))
            ta = sorted(_row_bytes(tc, x) for x in range(start, r))
            assert ja == ta, (what, start, r)
            start = r


SORTS = {
    "one_key": (["k"], True),
    "two_keys": (["s", "k"], True),
    "mixed_ascending": (["s", "f", "k"], [False, True, False]),
    "top_bit_int64": (["b"], True),
    "float_zeros_nan_desc": (["f"], False),
}


@pytest.mark.parametrize("case", list(SORTS))
def test_table_sort_matches_cylon_tpu(local_ctx, tctxs, case):
    arrays, valid = _arrays(3)
    jt, tt = _pair(local_ctx, tctxs[0], arrays, valid)
    by, asc = SORTS[case]
    exp, got = jt.sort(by, asc), tt.sort(by, asc)
    idx = [list(arrays).index(c) for c in by]
    assert_sorted_equal(exp, got, idx, case)


def test_table_sort_of_a_filtered_table(local_ctx, tctxs):
    """A row mask compacts before the sort; take() reads live rows."""
    arrays, valid = _arrays(4)
    keep = np.random.default_rng(0).random(300) < 0.7
    jt, tt = _pair(local_ctx, tctxs[0], arrays, valid)
    import jax.numpy as jnp

    exp = jt.filter_mask(jnp.asarray(keep)).sort("k")
    got = tt.filter_mask(torch.from_numpy(keep)).sort("k")
    assert_sorted_equal(exp, got, [0], "filtered")
    idx = np.array([3, 0, -1, 7])
    e, g = exp.take(idx), got.take(idx)
    for jc, tc in zip(e._columns, g._columns):
        assert np.array_equal(np.asarray(jc.valid_mask()),
                              tc.valid_mask().numpy())
        v = np.asarray(jc.valid_mask())
        assert np.array_equal(np.asarray(jc.data)[v], tc.data.numpy()[v])


def assert_shards_equal(jt, tt, what=""):
    """The flat layout, shard by shard: capacity, row mask, live rows."""
    assert jt.capacity == tt.capacity, what
    je = np.asarray(jt.emit_mask())
    assert np.array_equal(je, tt.emit_mask().numpy()), what
    for ci, (a, b) in enumerate(zip(_rows(jt, je), _rows(tt, je))):
        assert np.array_equal(a[0], b[0]), (what, ci)
        x, y = np.where(a[0], a[1], 0), np.where(b[0], b[1], 0)
        assert x.dtype == y.dtype, (what, ci)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), \
            (what, ci)


def _splitters_pair(jctx, tctx, jt, tt, by, asc):
    """Both packages' splitter tuples on the distributed layout, as
    Python ints of the unsigned lanes."""
    jd = jshard.distribute(jt, jctx)
    td = tdist.shard.distribute(tt, tctx)
    idx = [td._col_index(c) for c in by]
    asc = asc if isinstance(asc, list) else [asc] * len(by)
    jl = [l for i, a in zip(idx, asc)
          for l in jdist._dist_order_lanes(jctx, jd._columns[i], a)]
    tl = torder.sort_keys([td._columns[i] for i in idx], asc)
    js = jdist._range_splitters(jctx, [jshard.pin(l, jctx) for l in jl],
                                jshard.pin(jd.emit_mask(), jctx))
    ts = tdist._range_splitters(tctx, tl, td.emit_mask())
    return ([tuple(int(x) for x in t) for t in js],
            [tuple(int(x) for x in t) for t in ts])


_JAX_SORTS = {}


@pytest.fixture(scope="module", autouse=True)
def _release_reference_tables():
    """The cached results are tracked tables of the JAX package's ledger:
    drop them when the module ends, so that no later test file in this
    process (pytest-xdist's ``--dist loadfile`` runs several files in one
    worker) sees them live (ROADMAP queue 3, F6)."""
    yield
    _JAX_SORTS.clear()

DIST_SORTS = {
    "one_key": (["k"], True),
    "two_keys_mixed": (["s", "k"], [False, True]),
    "top_bit_int64": (["b"], True),
    "float_zeros_nan": (["f"], True),
}


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("case", list(DIST_SORTS))
@pytest.mark.parametrize("route", [None, True], ids=["sort", "kernel"])
def test_distributed_sort_matches_cylon_tpu(request, monkeypatch, tctxs,
                                            world, case, route):
    monkeypatch.setattr(tshuffle, "PARTITION_KERNEL", route)
    jctx = _jctx(request, world)
    arrays, valid = _arrays(20 + world)
    jt, tt = _pair(jctx, tctxs[world], arrays, valid)
    by, asc = DIST_SORTS[case]
    if (world, case) not in _JAX_SORTS:
        _JAX_SORTS[world, case] = (
            _splitters_pair(jctx, tctxs[world], jt, tt, by, asc),
            jdist.distributed_sort(jt, by, asc))
    (js, ts), exp = _JAX_SORTS[world, case]
    assert js == ts
    got = tdist.distributed_sort(tt, by, asc)
    assert got._shard_world == world
    assert_shards_equal(exp, got, f"{case} world {world}")


@pytest.mark.parametrize("force", [False, True])
def test_distributed_sort_on_one_shard(tctxs, force):
    """World 1: force_exchange runs the whole composition, else the local
    sort; both give the local sort's rows in order."""
    jctx = jct.CylonContext.InitDistributed(jct.TPUConfig(world_size=1))
    arrays, valid = _arrays(7)
    jt, tt = _pair(jctx, tctxs[1], arrays, valid)
    exp = jdist.distributed_sort(jt, ["k", "s"], force_exchange=force)
    got = tdist.distributed_sort(tt, ["k", "s"], force_exchange=force)
    assert (got._shard_world == 1) is force
    assert_sorted_equal(exp, got, [0, 3], f"world 1 force {force}")


def test_splitter_sort_with_nulls_and_skew(dist_ctx8, tctxs):
    """The JAX package's own skew case (tests/test_distributed.py): float
    keys, 10% null, 40% one hot value, world 8; splitters and shards
    equal, and the global order numpy's."""
    rng = np.random.default_rng(22)
    n = 12_000
    k = rng.normal(size=n).astype(np.float32)
    k[rng.random(n) < 0.1] = np.nan     # nulls last
    k[rng.random(n) < 0.4] = 7.25       # heavy tie skew
    jt = jct.Table.from_pandas(dist_ctx8, pd.DataFrame({"k": k}))
    tt = tct.Table.from_pandas(tctxs[8], pd.DataFrame({"k": k}))
    js, ts = _splitters_pair(dist_ctx8, tctxs[8], jt, tt, ["k"], True)
    assert js == ts
    exp = jct.distributed_sort(jt, "k")
    got = tct.distributed_sort(tt, "k")
    assert_shards_equal(exp, got, "skew")
    np.testing.assert_array_equal(got.to_pandas()["k"].to_numpy(),
                                  np.sort(k))


def test_splitters_compare_unsigned():
    """Keys with the top bit set: the lanes ride in signed containers, so
    the target rule must compare unsigned values."""
    lanes = [torch.tensor([0, 5, -1, -(1 << 31)], dtype=torch.int32)]
    splitters = [(np.uint32(5),), (np.uint32(1 << 31),)]
    assert tdist._splitter_targets(lanes, splitters).tolist() == [0, 1, 2,
                                                                  2]
    wide = [torch.tensor([1, -1], dtype=torch.int64)]
    assert tdist._splitter_targets(
        wide, [(np.uint64(2),)]).tolist() == [0, 1]


# -- hash_partition / repartition -------------------------------------------


@pytest.mark.parametrize("world", [0, 4])
@pytest.mark.parametrize("parts", [1, 5])
def test_hash_partition_matches_cylon_tpu(request, tctxs, world, parts):
    arrays, valid = _arrays(40 + parts)
    jt, tt = _pair(_jctx(request, world), tctxs[world], arrays, valid)
    if world:
        jt = jshard.distribute(jt, jt._ctx)
        tt = tdist.shard.distribute(tt, tt._ctx)
    exp = jdist.hash_partition(jt, ["k", "s"], parts)
    got = tdist.hash_partition(tt, ["k", "s"], parts)
    assert sorted(exp) == sorted(got) == list(range(parts))
    for p in range(parts):
        assert_shards_equal(exp[p], got[p], f"partition {p}")


@pytest.mark.parametrize("world", [4, 8])
def test_repartition_matches_cylon_tpu(request, tctxs, world):
    arrays, valid = _arrays(50 + world)
    jctx = _jctx(request, world)
    jt, tt = _pair(jctx, tctxs[world], arrays, valid)
    keep = np.random.default_rng(1).random(300) < 0.6
    import jax.numpy as jnp

    jt = jt.filter_mask(jnp.asarray(keep))
    tt = tt.filter_mask(torch.from_numpy(keep))
    exp = jdist.repartition(jt, jctx)
    got = tdist.repartition(tt, tctxs[world])
    assert got._shard_world == world
    assert_shards_equal(exp, got, f"world {world}")


@pytest.mark.parametrize("nulls_last", [True, False])
@pytest.mark.parametrize("ascending", [True, False])
def test_sort_keys_and_dense_ranks_match_cylon_tpu(ascending, nulls_last):
    """order.sort_keys (per-key direction, null placement) bit for bit,
    and order.dense_ranks' group ids, against the JAX package's."""
    from cylon_tpu.ops import order as jorder

    arrays, valid = _arrays(60)
    names = ["k", "b", "f", "s"]
    jcols = [jct.Column.from_numpy(arrays[c], c, valid.get(c))
             for c in names]
    tcols = [tct.Column.from_numpy(arrays[c], c, valid.get(c), "cpu")
             for c in names]
    asc = [ascending, not ascending, ascending, True]
    jk = jorder.sort_keys(jcols, asc, nulls_last)
    tk = torder.sort_keys(tcols, asc, nulls_last)
    for a, b in zip(jk, tk):
        a = np.asarray(a)
        assert np.array_equal(a, b.numpy().view(a.dtype))
    jgid, _ = jorder.dense_ranks(jk)
    tgid, _ = torder.dense_ranks(tk)
    assert np.array_equal(np.asarray(jgid), tgid.numpy())
