"""The plain versions of kernels K1-K4 in cylon_tpu_torch against the JAX
package's Pallas kernels, run in interpret mode on the CPU, bit for bit;
K8's plain version and wrapper checks against the former torch formula;
K9's plain version against the JAX package's lanes and row hash, and its
wrapper checks; K10's wrapper checks, and the sort stages (plain and
through K10's plain version) against the operands the JAX package's
``jax.lax.sort`` hands its Pallas kernels.

K3/K4 run eagerly under the Pallas interpreter (block_rows=8, ~300 rows a
side): one module-scoped fixture per case computes both packages' plans
once. The LEFT case is held against the JAX package's XLA plan (its
interpreter twin would double this file's time)."""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import hash as jhash
from cylon_tpu.ops import join as jjoin
from cylon_tpu.ops import setops as jsetops
from cylon_tpu.ops import tpu_kernels as tk
from cylon_tpu.parallel import shuffle as jshuffle

from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.ops import kernels as K
from cylon_tpu_torch.ops.hash import hash2_streams
from cylon_tpu_torch.ops.order import unsigned
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch.status import Code, CylonError
from test_torch_port_gpu import (HASH_KEY_CASES, PERMUTE_JOIN_CASES,
                                 SETOP_HASH_CASES, assert_hash_keys_equal,
                                 assert_setop_hash_equal,
                                 assert_sort_stage_equal, hash_key_case,
                                 hash_key_sides, permute_join_case,
                                 setop_hash_case)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# K1 / K2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4, 8])
def test_partition_hist_plain_matches_pallas(world):
    rng = np.random.default_rng(world)
    t = rng.integers(0, world + 1, 5000).astype(np.int32)
    ref = np.asarray(tk.partition_hist(jnp.asarray(t), world + 1,
                                       interpret=True))
    got = K.partition_hist(_t(t)[None], world + 1)[0].numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("nb", [1, 5, 9])
def test_partition_hist_plain_matches_pallas_out_of_range_ragged(nb):
    """Ids below 0 and at or past nbuckets are never counted, and the last
    tile is ragged (n not a multiple of the 4,096-row tile)."""
    rng = np.random.default_rng(30 + nb)
    n = 2 * K.PARTITION_TILE + 777
    t = rng.integers(-3, nb + 3, n).astype(np.int32)
    ref = np.asarray(tk.partition_hist(jnp.asarray(t), nb, interpret=True))
    got = K.partition_hist(_t(t)[None], nb)[0].numpy()
    assert got.shape == (3, nb) and got.sum() < n
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("legs_as", ["stack", "sequence"])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_partition_scatter_plain_matches_pallas(world, legs_as):
    rng = np.random.default_rng(10 + world)
    t = rng.integers(0, world + 1, 5000).astype(np.int32)
    legs = [rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(
        np.uint32) for _ in range(3)]
    ref = tk.partition_scatter(jnp.asarray(t), [jnp.asarray(x) for x in legs],
                               world + 1, interpret=True)
    tt = _t(t)[None]
    tlegs = [_t(x.view(np.int32))[None] for x in legs]
    counts = K.partition_hist(tt, world + 1)[:, :, :world].sum(
        1, dtype=torch.int32)
    got = K.partition_scatter(
        tt, torch.stack(tlegs) if legs_as == "stack" else tlegs, world + 1,
        counts)
    assert got.shape == (3, 1, 5000)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g[0].numpy().view(np.uint32))


@pytest.mark.parametrize("bad", ["counts_shape", "counts_dtype", "leg_shape",
                                 "leg_dtype", "stack_shape"])
def test_partition_scatter_rejects_malformed_inputs(bad):
    t = torch.zeros(2, 10, dtype=torch.int32)
    legs = [torch.zeros(2, 10, dtype=torch.int32) for _ in range(2)]
    counts = torch.zeros(2, 4, dtype=torch.int32)
    if bad == "counts_shape":
        counts = torch.zeros(2, 5, dtype=torch.int32)
    elif bad == "counts_dtype":
        counts = counts.to(torch.int64)
    elif bad == "leg_shape":
        legs[1] = torch.zeros(2, 11, dtype=torch.int32)
    elif bad == "leg_dtype":
        legs[0] = legs[0].to(torch.int64)
    else:
        legs = torch.zeros(2, 2, 11, dtype=torch.int32)
    with pytest.raises(CylonError):
        K.partition_scatter(t, legs, 5, counts)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_kernel_partition_matches_bucket_sort(world):
    """The port's kernel partition (plain K1 + K2) and its sort partition
    both equal the JAX package's `_bucket_sort`: leaves with the dead
    tail, counts_out and start, across 4/8/2/1-byte leaves and bool."""
    rng = np.random.default_rng(20 + world)
    n = 5000
    cols = {"a": rng.integers(-2**31, 2**31, n).astype(np.int32),
            "b": rng.normal(size=n).astype(np.float64),
            "c": rng.integers(-100, 100, n).astype(np.int16),
            "d": rng.integers(-100, 100, n).astype(np.int8),
            "e": rng.random(n) < 0.5}
    targets = rng.integers(0, world, n).astype(np.int32)
    emit = rng.random(n) < 0.8
    ref, rc, rs = jshuffle._bucket_sort(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(targets),
        jnp.asarray(emit), world)
    payload = {k: _t(v)[None] for k, v in cols.items()}
    for fn in (tshuffle._kernel_partition, tshuffle._bucket_sort):
        got, gc, gs = fn(payload, _t(targets)[None], _t(emit)[None], world)
        assert np.array_equal(np.asarray(rc), gc[0].numpy())
        assert np.array_equal(np.asarray(rs), gs[0].numpy())
        for k in cols:
            assert np.array_equal(np.asarray(ref[k]), got[k][0].numpy()), k


# ---------------------------------------------------------------------------
# K3 / K4
# ---------------------------------------------------------------------------

CASES = {
    "inner_sort": (jjoin.JoinType.INNER, False),
    "inner_hash_two_keys": (jjoin.JoinType.INNER, True),
}


def _inputs(seed, hash_mode):
    rng = np.random.default_rng(seed)
    na, nb = 300, 280
    nk = 2 if hash_mode else 1
    lk = [rng.integers(0, 90, na).astype(np.int32) for _ in range(nk)]
    rk = [rng.integers(0, 90, nb).astype(np.int32) for _ in range(nk)]
    lkval = [rng.random(na) < 0.9] + [None] * (nk - 1)
    lemit = rng.random(na) < 0.95
    remit = rng.random(nb) < 0.95
    ldat = [lk[0], rng.normal(size=na).astype(np.float32),
            rng.integers(0, 1 << 20, na).astype(np.int64)]
    lval = [lkval[0], None, rng.random(na) < 0.8]
    rdat = [rk[0], rng.normal(size=nb).astype(np.float32)]
    rval = [None, rng.random(nb) < 0.7]
    return lk, lkval, lemit, rk, remit, ldat, lval, rdat, rval


def _j(x):
    return None if x is None else jnp.asarray(x)


def _r(x):
    return None if x is None else _t(x)[None]


@pytest.fixture(scope="module", params=sorted(CASES))
def plans(request):
    jt, hash_mode = CASES[request.param]
    lk, lkval, lemit, rk, remit, ldat, lval, rdat, rval = _inputs(
        7 + int(jt), hash_mode)
    nk = len(lk)
    jargs = ([_j(x) for x in ldat], [_j(x) for x in lval],
             [_j(x) for x in rdat], [_j(x) for x in rval])
    a_desc, b_desc = jjoin.plan_lane_descs(*jargs, jt)
    jc, ja, jb = jjoin.plan_program_stream(
        tuple(_j(x) for x in lk), tuple(_j(x) for x in lkval),
        _j(lemit), tuple(_j(x) for x in rk), (None,) * nk, _j(remit),
        *(tuple(a) for a in jargs), (False,) * nk, jt, a_desc=a_desc,
        b_desc=b_desc, block_rows=8, hash_mode=hash_mode, interpret=True)
    jc = np.asarray(jc)
    cap_e = jjoin.stream_expand_capacity(int(jc[0]), 8)
    jexp = tk.join_expand_stream(jnp.asarray(jc), ja, jb, cap_e,
                                 block_rows=8, interpret=True)

    targs = ([_r(x) for x in ldat], [_r(x) for x in lval],
             [_r(x) for x in rdat], [_r(x) for x in rval])
    t_desc = tjoin.plan_lane_descs(*targs, jt)
    lbits, lkv = tjoin.key_bits([_r(x) for x in lk], [_r(x) for x in lkval])
    rbits, rkv = tjoin.key_bits([_r(x) for x in rk], [None] * nk)
    tc, ta, tb = tjoin.plan_program_stream(
        lbits, lkv, _r(lemit), rbits, rkv, _r(remit), *targs, jt,
        a_desc=t_desc[0], b_desc=t_desc[1], hash_mode=hash_mode)
    texp = K.join_expand_stream(tc, ta, tb, cap_e)
    return dict(desc=((a_desc, b_desc), t_desc), counts=(jc, tc[0].numpy()),
                a=(ja, ta), b=(jb, tb), exp=(jexp, texp))


def test_lane_descs_match(plans):
    jd, td = plans["desc"]
    assert jd == td


def test_plan_counts_match(plans):
    jc, tc = plans["counts"]
    assert np.array_equal(jc, tc), (jc, tc)


def test_plan_groups_match_over_counted_prefix(plans):
    jc, _ = plans["counts"]
    n_emit, n_blive = int(jc[1]), int(jc[2])
    for (js, ts), cnt in ((plans["a"], n_emit), (plans["b"], n_blive)):
        assert len(js) == len(ts)
        for x, y in zip(js, ts):
            ref = np.asarray(x).reshape(-1)[:cnt]
            assert np.array_equal(ref, y[0].numpy()[:cnt].view(np.uint32))


def test_expand_outputs_match(plans):
    (jaidx, jbidx, jal, jbl), (taidx, tbidx, tal, tbl) = plans["exp"]
    assert np.array_equal(np.asarray(jaidx), taidx[0].numpy())
    assert np.array_equal(np.asarray(jbidx), tbidx[0].numpy())
    for x, y in zip(tuple(jal) + tuple(jbl), tuple(tal) + tuple(tbl)):
        assert np.array_equal(np.asarray(x), y[0].numpy().view(np.uint32))


@pytest.mark.parametrize("hash_mode", [False, True])
def test_left_stream_matches_xla_plan(hash_mode):
    """LEFT through the port's plain K3/K4 gives the same (lidx, ridx)
    pairs as the JAX package's XLA plan route."""
    jt = jjoin.JoinType.LEFT
    lk, lkval, lemit, rk, remit, ldat, lval, rdat, rval = _inputs(
        8, hash_mode)
    nk = len(lk)
    counts2, lo, m, bperm, un_mask = jjoin.plan_program(
        tuple(_j(x) for x in lk), tuple(_j(x) for x in lkval), _j(lemit),
        tuple(_j(x) for x in rk), (None,) * nk, _j(remit), (False,) * nk,
        jt)
    cap = int(np.asarray(counts2)[0])
    *_, jl, jr = jjoin.materialize_program(
        lo, m, bperm, un_mask, _j(lemit), (), (), (), (), jt, cap, 0)
    jl, jr = np.asarray(jl), np.asarray(jr)
    ref = sorted(zip(jl[jl >= 0].tolist(), jr[jl >= 0].tolist()))

    targs = ([_r(x) for x in ldat], [_r(x) for x in lval],
             [_r(x) for x in rdat], [_r(x) for x in rval])
    a_desc, b_desc = tjoin.plan_lane_descs(*targs, jt)
    lbits, lkv = tjoin.key_bits([_r(x) for x in lk], [_r(x) for x in lkval])
    rbits, rkv = tjoin.key_bits([_r(x) for x in rk], [None] * nk)
    tc, ta, tb = tjoin.plan_program_stream(
        lbits, lkv, _r(lemit), rbits, rkv, _r(remit), *targs, jt,
        a_desc=a_desc, b_desc=b_desc, hash_mode=hash_mode)
    assert int(tc[0, 0]) == cap
    tl, tr, _al, _bl = K.join_expand_stream(
        tc, ta, tb, tjoin.stream_expand_capacity(cap, 8))
    tl, tr = tl[0].numpy(), tr[0].numpy()
    assert sorted(zip(tl[tl >= 0].tolist(), tr[tl >= 0].tolist())) == ref



# ---------------------------------------------------------------------------
# K8 join_hash_keys
# ---------------------------------------------------------------------------

def _old_hash_keys(abits, akv, aemit, bbits, bkv, bemit):
    """The hash branch of ``stream_sort_keys`` as it was before K8: the
    tag by ``_pack_tag``, the hi/lo split, ``hash2_streams``, the packed
    key."""
    aemit, bemit = tjoin._vm(aemit, akv), tjoin._vm(bemit, bkv)
    na, nb = akv.shape[1], bkv.shape[1]
    live = torch.cat([aemit & akv, bemit & bkv], 1)
    emit = torch.cat([aemit, bemit], 1)
    tag = tjoin._pack_tag(tjoin._side_flags(na, nb, live), emit, live)
    kb = []
    for a, b in zip(abits, bbits):
        cat = torch.cat([a, b], 1)
        if cat.element_size() == 8:
            kb += [(cat >> 32) & 0xFFFFFFFF, cat & 0xFFFFFFFF]
        else:
            kb.append(unsigned(cat))
    h1, h2 = hash2_streams(kb, live)
    return dict(tag=tag, kb=kb, h1=h1, h2=h2,
                key=((h2 << 32) | tag) ^ -(1 << 63))


@pytest.mark.parametrize("case", sorted(HASH_KEY_CASES))
def test_plain_join_hash_keys_matches_old_formula(case):
    """K8's plain version, and ``stream_sort_keys`` in hash mode through
    the wrapper, equal the former torch formula bit for bit."""
    args = hash_key_case(case, 3000, "cpu")
    a, b = hash_key_sides(*args)
    ref = _old_hash_keys(*a, *b)
    assert_hash_keys_equal(K.plain_join_hash_keys(*a, *b), ref)
    lb, lkv, lem, rb, rkv, rem, jt = args
    keys = tjoin.stream_sort_keys(lb, lkv, lem, rb, rkv, rem, (), (), (),
                                  (), jt, hash_mode=True)
    assert_hash_keys_equal(keys, ref)
    assert keys["na"] == a[1].shape[1] and keys["nb"] == b[1].shape[1]


def _bad_hash_inputs(what):
    lb, lkv, lem, rb, rkv, rem, _jt = hash_key_case("masks", 300, "cpu")
    if what == "float_key":
        return (lb[0].double(),), lkv, lem, (rb[0].double(),), rkv, rem
    if what == "dtypes_differ":
        return lb, lkv, lem, (rb[0].to(torch.int32),), rkv, rem
    if what == "validity_not_bool":
        return lb, lkv.to(torch.uint8), lem, rb, rkv, rem
    if what == "shape":
        return lb, lkv[:, 1:], lem, rb, rkv, rem
    if what == "emit_shape":
        return lb, lkv, lem, rb, rkv, rem[:, 1:]
    if what == "device":
        return lb, lkv, lem, rb, rkv.to("meta"), rem
    if what == "seven_lanes":
        return lb * 4, lkv, lem, rb * 4, rkv, rem
    raise KeyError(what)


@pytest.mark.parametrize("what", ["float_key", "dtypes_differ",
                                  "validity_not_bool", "shape", "emit_shape",
                                  "device", "seven_lanes"])
def test_join_hash_keys_rejects(what):
    with pytest.raises(CylonError):
        K.join_hash_keys(*_bad_hash_inputs(what))


# ---------------------------------------------------------------------------
# K9 setop_hash_rows
# ---------------------------------------------------------------------------


def _jax_setop_hash(ld, lv, le, rd, rv, re, descs, w):
    """Shard ``w`` of the JAX package's stream program before its sort:
    its tag, the lanes of ``cylon_tpu.ops.setops._col_lanes`` and
    ``hash2_streams``, as uint32 numpy arrays (tag, h1, h2, lanes...)."""
    def col(x, v):
        data = jnp.asarray(x[w].numpy())
        valid = None if v is None else jnp.asarray(v[w].numpy())
        return types.SimpleNamespace(
            data=data, validity=valid,
            valid_mask=lambda: jnp.ones(data.shape, bool) if valid is None
            else valid)

    lanes = []
    for (kind, _), a, av, b, bv in zip(descs, ld, lv, rd, rv):
        pa = jsetops._col_lanes(col(a, av), bv is not None, kind)
        pb = jsetops._col_lanes(col(b, bv), av is not None, kind)
        lanes += [jnp.concatenate([x, y]) for x, y in zip(pa, pb)]
    nl, nr = ld[0].shape[1], rd[0].shape[1]
    emit = [np.ones(m, bool) if e is None else e[w].numpy()
            for e, m in ((le, nl), (re, nr))]
    live = jnp.asarray(np.concatenate(emit))
    tag = (jnp.concatenate([jnp.full(nl, jnp.uint32(1 << 31)),
                            jnp.zeros(nr, jnp.uint32)])
           | (live.astype(jnp.uint32) << 29)
           | jnp.arange(nl + nr, dtype=jnp.uint32))
    h1, h2 = jhash.hash2_streams(lanes, live)
    return [np.asarray(x) for x in [tag, h1, h2] + lanes], np.asarray(live)


@pytest.mark.parametrize("case", sorted(SETOP_HASH_CASES))
def test_plain_setop_hash_rows_matches_jax(case):
    """K9's plain version, and the wrapper on the CPU, equal the JAX
    package's tag, ``_col_lanes`` and ``hash2_streams`` on the same rows,
    shard by shard, bit for bit."""
    args = setop_hash_case(case, 3000, "cpu")
    got = K.setop_hash_rows(*args)
    assert_setop_hash_equal(got, K.plain_setop_hash_rows(*args))
    h1, h2, stack, side, live = got
    nl = args[0][0].shape[1]
    for w in range(stack.shape[1]):
        ref, jlive = _jax_setop_hash(*args, w)
        mine = [stack[0, w], h1[w], h2[w]] + list(stack[1:, w])
        assert len(mine) == len(ref)
        for x, y in zip(mine, ref):
            assert np.array_equal(x.numpy().astype(np.int64) & 0xFFFFFFFF,
                                  y.astype(np.int64))
        assert np.array_equal(live[w].numpy(), jlive)
        assert side[w, :nl].all() and not side[w, nl:].any()


def _bad_setop_hash_inputs(what):
    ld, lv, le, rd, rv, re, descs = setop_hash_case("twelve_lanes", 300,
                                                    "cpu")
    if what == "no_columns":
        return [], [], le, [], [], re, ()
    if what == "descs_count":
        return ld, lv, le, rd, rv, re, descs + (("d", False),)
    if what == "dtypes_differ":
        return ld, lv, le, [rd[0].to(torch.int32)] + rd[1:], rv, re, descs
    if what == "kind":
        return ld, lv, le, rd, rv, re, (("d", True),) + descs[1:]
    if what == "validity_not_bool":
        return ld, [lv[0].to(torch.uint8)] + lv[1:], le, rd, rv, re, descs
    if what == "validity_without_lane":
        return ld, lv, le, rd, rv, re, ((descs[0][0], False),) + descs[1:]
    if what == "shape":
        return [ld[0][:, 1:]] + ld[1:], lv, le, rd, rv, re, descs
    if what == "world":
        return ld, lv, le, [x.expand(2, -1) for x in rd], rv, re, descs
    if what == "emit_shape":
        return ld, lv, le, rd, rv, re[:, 1:], descs
    if what == "emit_not_bool":
        return ld, lv, le.to(torch.int32), rd, rv, re, descs
    if what == "device":
        return ld, lv, le, rd, rv, re.to("meta"), descs
    if what == "thirteen_lanes":
        x = torch.zeros(1, 4, dtype=torch.int64)
        return ([x] * 6 + [x.to(torch.int32)], [None] * 7, None,
                [x] * 6 + [x.to(torch.int32)], [None] * 7, None,
                (("w", False),) * 6 + (("d", False),))
    if what == "rows_2_29":
        x = torch.zeros(1, 1, dtype=torch.int32).expand(1, 1 << 28)
        return [x], [None], None, [x], [None], None, (("d", False),)
    raise KeyError(what)


@pytest.mark.parametrize("what", [
    "no_columns", "descs_count", "dtypes_differ", "kind",
    "validity_not_bool", "validity_without_lane", "shape", "world",
    "emit_shape", "emit_not_bool", "device", "thirteen_lanes", "rows_2_29"])
def test_setop_hash_rows_rejects(what):
    with pytest.raises(CylonError) as err:
        K.setop_hash_rows(*_bad_setop_hash_inputs(what))
    assert err.value.code == Code.Invalid


# ---------------------------------------------------------------------------
# K10 permute_rows and the sort stages
# ---------------------------------------------------------------------------


def _bad_permute_inputs(what):
    x = torch.zeros(2, 8, dtype=torch.int64)
    rec = torch.zeros(2, 8, 8, dtype=torch.int32)
    idx = torch.zeros(2, 8, dtype=torch.int64)
    return {
        "no_streams": ([],),
        "stream_dtype": ([x, x.to(torch.float32)],),
        "stream_int16": ([x.to(torch.int16)],),
        "stream_shape": ([x, x[:, 1:]],),
        "stream_dim": ([x, x[0]],),
        "eighteen_words": ([x] * (K.MAX_ROW_WORDS + 1),),
        "words_for_streams": ([x, x], None, 3),
        "record_dtype": (rec.to(torch.int64), None, 5),
        "record_width": (torch.zeros(2, 8, 6, dtype=torch.int32), None, 5),
        "record_words": (rec, None, 4),
        "record_past_max": (torch.zeros(2, 8, 24, dtype=torch.int32),),
        "index_dtype": ([x], idx.to(torch.int32)),
        "index_shape": ([x], idx[:, 1:]),
        "key_past_words": ([x], None, None, False, 2),
        "key_three_words": ([x, x, x], None, None, False, 3),
        "rows_2_29": ([torch.zeros(1, 1, dtype=torch.int32).expand(
            1, 1 << 29)],),
        "device": ([x], idx.to("meta")),
    }[what]


@pytest.mark.parametrize("what", [
    "no_streams", "stream_dtype", "stream_int16", "stream_shape",
    "stream_dim", "eighteen_words", "words_for_streams", "record_dtype",
    "record_width", "record_words", "record_past_max", "index_dtype",
    "index_shape", "key_past_words", "key_three_words", "rows_2_29", "device"])
def test_permute_rows_rejects(what):
    with pytest.raises(CylonError) as err:
        K.permute_rows(*_bad_permute_inputs(what))
    assert err.value.code == Code.Invalid


class _Sorted(Exception):
    """Raised by a stand-in for a Pallas kernel once it holds its sorted
    inputs."""


def _capture_kernel(monkeypatch, name):
    """Replace the JAX package's Pallas kernel ``name`` with one that keeps
    the sorted operands it is handed and stops the program."""
    got = {}

    def keep(*args, **kw):
        got.update(args=args, kw=kw)
        raise _Sorted

    monkeypatch.setattr(tk, name, keep)
    return got


def _u32(x):
    return np.asarray(x).reshape(-1).view(np.uint32)


@pytest.mark.parametrize("hash_mode", [False, True])
def test_plain_stream_sort_matches_jax_sort(monkeypatch, hash_mode):
    """``plain_stream_sort`` (the CPU's sort stage) and the record route
    through K10's plain version hand K3 the operands that the JAX
    package's ``jax.lax.sort`` hands its Pallas plan kernel
    (cylon_tpu/ops/join.py:632, :645) on the same rows: key bits, tags,
    hashes, verify and payload lanes, bit for bit."""
    jt = jjoin.JoinType.LEFT
    lk, lkval, lemit, rk, remit, ldat, lval, rdat, rval = _inputs(
        25, hash_mode)
    nk = len(lk)
    jargs = ([_j(x) for x in ldat], [_j(x) for x in lval],
             [_j(x) for x in rdat], [_j(x) for x in rval])
    a_desc, b_desc = jjoin.plan_lane_descs(*jargs, jt)
    got = _capture_kernel(monkeypatch, "join_plan_stream")
    with pytest.raises(_Sorted):
        jjoin.plan_program_stream(
            tuple(_j(x) for x in lk), tuple(_j(x) for x in lkval),
            _j(lemit), tuple(_j(x) for x in rk), (None,) * nk, _j(remit),
            *(tuple(a) for a in jargs), (False,) * nk, jt, a_desc=a_desc,
            b_desc=b_desc, block_rows=8, hash_mode=hash_mode, interpret=True)
    ref = {"bits_s": got["args"][0], "tag_s": got["args"][1],
           "lanes": list(got["kw"]["lanes"])}
    if hash_mode:
        ref.update(bits2_s=got["kw"]["bits2_s"],
                   verify_lanes=list(got["kw"]["verify_lanes"]))

    targs = ([_r(x) for x in ldat], [_r(x) for x in lval],
             [_r(x) for x in rdat], [_r(x) for x in rval])
    lbits, lkv = tjoin.key_bits([_r(x) for x in lk], [_r(x) for x in lkval])
    rbits, rkv = tjoin.key_bits([_r(x) for x in rk], [None] * nk)

    def keys():
        return tjoin.stream_sort_keys(lbits, lkv, _r(lemit), rbits, rkv,
                                      _r(remit), *targs, jt, a_desc, b_desc,
                                      hash_mode)

    for kw in (tjoin.stream_sort(keys()), tjoin.record_stream_sort(keys())):
        assert set(kw) - set(ref) == {"na", "nb", "emit_unmatched_a",
                                      "n_a_lanes", "n_b_lanes"}
        for name, want in ref.items():
            mine = kw[name] if isinstance(want, list) else [kw[name]]
            want = want if isinstance(want, list) else [want]
            assert len(mine) == len(want) > 0 or name == "lanes", name
            for x, y in zip(mine, want):
                assert x.dtype == torch.int32 and x.shape == (1, len(_u32(y)))
                assert np.array_equal(_u32(x.numpy()), _u32(y)), name


@pytest.mark.parametrize("lanes", [1, 3, 12])
def test_plain_setop_stream_sort_matches_jax_sort(monkeypatch, lanes):
    """``plain_setop_stream_sort`` (through ``setop_stream_inputs``) and
    the record route through K10's plain version hand K5 the operands
    that the JAX package's ``jax.lax.sort`` hands its Pallas set-op kernel
    (cylon_tpu/ops/setops.py:239) on the same lanes: h1, h2, the tag and
    the lanes, bit for bit; rows repeat, so equal hashes meet."""
    rng = np.random.default_rng(239 + lanes)
    nl, nr = 700, 523
    lane_l = [rng.integers(0, 6, nl).astype(np.uint32) for _ in range(lanes)]
    lane_r = [rng.integers(0, 6, nr).astype(np.uint32) for _ in range(lanes)]
    lemit, remit = rng.random(nl) < 0.9, rng.random(nr) < 0.8
    got = _capture_kernel(monkeypatch, "setop_stream")
    with pytest.raises(_Sorted):
        jsetops._setop_stream_program.__wrapped__(
            [jnp.asarray(x) for x in lane_l], [jnp.asarray(x) for x in lane_r],
            jnp.asarray(lemit), jnp.asarray(remit),
            (("d", False),) * lanes, jsetops.SetOp.UNION, 8, True)
    ref = [got["args"][0], got["args"][1], got["args"][2],
           *got["args"][3]]

    def t(xs):
        return [_t(x.view(np.int32))[None] for x in xs]

    hashed = K.setop_stack_hash(t(lane_l), t(lane_r), _t(lemit)[None],
                                _t(remit)[None])
    from cylon_tpu_torch.ops import setops as tsetops
    for h1_s, h2_s, stack in (tsetops.setop_stream_sort(*hashed),
                              tsetops.record_setop_stream_sort(*hashed)):
        mine = [h1_s, h2_s, *stack]
        assert len(mine) == len(ref) == 3 + lanes
        for x, y in zip(mine, ref):
            assert x.dtype == torch.int32
            assert np.array_equal(_u32(x.numpy()), _u32(y))


@pytest.mark.parametrize("case", sorted(PERMUTE_JOIN_CASES))
def test_record_stream_sort_matches_plain(case):
    """The join's record route through K10's plain version equals
    ``plain_stream_sort`` on the card tests' cases, bit for bit."""
    args = permute_join_case(case, "cpu")
    assert_sort_stage_equal(
        tjoin.record_stream_sort(tjoin.stream_sort_keys(*args)),
        tjoin.plain_stream_sort(tjoin.stream_sort_keys(*args)))


@pytest.mark.parametrize("case", sorted(SETOP_HASH_CASES))
def test_record_setop_stream_sort_matches_plain(case):
    """The set op's record route through K10's plain version equals
    ``plain_setop_stream_sort`` on K9's cases, bit for bit."""
    from cylon_tpu_torch.ops import setops as tsetops

    hashed = K.setop_hash_rows(*setop_hash_case(case, 3000, "cpu"))
    assert_sort_stage_equal(tsetops.record_setop_stream_sort(*hashed),
                            tsetops.plain_setop_stream_sort(*hashed))
