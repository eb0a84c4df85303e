"""cylon_tpu_torch's set ops against cylon_tpu's on the CPU.

* the stream route: the port's program (sort + plain K5/K6) against the
  JAX package's program with its Pallas kernel under the interpreter
  (block_rows=8), on the lanes the JAX package built from the same
  tables; the port's plain K5 alone on the JAX package's sorted stream;
  the public API with STREAM_SETOP=True on both sides;
* K6's plain version against the interpreted ``stream_compact``;
* the dense-ranks route (STREAM_SETOP=False on both sides) row for row.

The distributed set ops are in test_torch_port_dist_setops.py.

Everything compared is integer or bit arithmetic: every comparison is
exact (tolerance 0). The JAX interpreter runs once per op (a
module-scoped fixture) to keep the file near a minute.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.ops import hash as jhash
from cylon_tpu.ops import setops as jsetops
from cylon_tpu.ops import tpu_kernels as tk

import cylon_tpu_torch as tct
from cylon_tpu_torch import dtypes as tdtypes
from cylon_tpu_torch.interop import from_reference_arrays
from cylon_tpu_torch.ops import hash as thash
from cylon_tpu_torch.ops import kernels as K
from cylon_tpu_torch.ops import setops as tsetops
from cylon_tpu_torch.util import capacity

OPS = ["union", "subtract", "intersect"]


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return x.astype(np.uint8)
    return x.view(f"u{x.dtype.itemsize}")


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_tables(jt, tt, what=""):
    """Equal capacity and emit mask, and at every live row equal data
    bits and validity, column by column (row for row, in order)."""
    assert jt.capacity == tt.capacity, what
    je, te = _np(jt.emit_mask()), _np(tt.emit_mask())
    assert np.array_equal(je, te), what
    assert len(jt._columns) == len(tt._columns)
    for jc, tc in zip(jt._columns, tt._columns):
        assert np.array_equal(_bits(_np(jc.data))[je],
                              _bits(_np(tc.data))[te]), (what, tc.name)
        assert np.array_equal(_np(jc.valid_mask())[je],
                              _np(tc.valid_mask())[te]), (what, tc.name)


def row_set(t) -> np.ndarray:
    """The live rows as a sorted array of canonical bits: floats with -0.0
    as +0.0, null cells zeroed, validity as a column."""
    e = _np(t.emit_mask())
    cols = []
    for c in t._columns:
        x, v = _np(c.data)[e], _np(c.valid_mask())[e]
        if x.dtype.kind == "f":
            x = np.where(x == 0, np.zeros((), x.dtype), x)
        cols += [np.where(v, _bits(x), 0).astype(np.uint64),
                 v.astype(np.uint64)]
    rows = np.stack(cols, 1) if cols else np.zeros((0, 0), np.uint64)
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


def _pair(jctx, tctx, arrays, valid):
    jt = jct.Table([jct.Column.from_numpy(a, n, valid.get(n))
                    for n, a in arrays.items()], jctx)
    tt = tct.Table([tct.Column.from_numpy(a, n, valid.get(n), "cpu")
                    for n, a in arrays.items()], tctx)
    return jt, tt


def _filter(jt, tt, keep):
    return jt.filter_mask(jnp.asarray(keep)), tt.filter_mask(_t(keep))


def _mixed(seed, n):
    """Rows drawn from a small pool (duplicates within and across
    tables) over every lane kind: float32 with nulls (random data under
    the nulls), int64, float64, bool, int8, int16, float16 (1.25 vs 1.5),
    and zeros of either sign in every float column."""
    pool = np.random.default_rng(99)
    p = 40
    base = {
        "f": pool.choice(np.array([0.0, 1.5, -2.25], np.float32), p),
        "i": pool.integers(-2, 2, p).astype(np.int64),
        "d": pool.choice(np.array([0.0, 3.5], np.float64), p),
        "t": pool.random(p) < 0.5,
        "b8": pool.integers(-2, 2, p).astype(np.int8),
        "s16": pool.integers(-300, 300, p).astype(np.int16),
        "h": pool.choice(np.array([1.25, 1.5, 0.0], np.float16), p),
    }
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, p, n)
    arrays = {k: v[pick].copy() for k, v in base.items()}
    for k in ("f", "d", "h"):  # flip the sign of some zeros
        x = arrays[k]
        flip = (x == 0) & (rng.random(n) < 0.5)
        x[flip] = -x[flip]
    fvalid = rng.random(n) < 0.85
    arrays["f"] = np.where(fvalid, arrays["f"],
                           rng.normal(size=n).astype(np.float32))
    return arrays, {"f": fvalid}, rng.random(n) < 0.9


# the columns of the narrow case: the interpreter's time grows with the
# lanes, so only UNION runs every lane kind through it
NARROW = ("f", "b8", "h")


def _mixed_tables(jctx, tctx, narrow=False):
    la, lv, lkeep = _mixed(1, 300)
    ra, rv, rkeep = _mixed(2, 280)
    if narrow:
        la, ra = ({k: a[k] for k in NARROW} for a in (la, ra))
    jl, tl = _filter(*_pair(jctx, tctx, la, lv), lkeep)
    jr, tr = _filter(*_pair(jctx, tctx, ra, rv), rkeep)
    return jl, tl, jr, tr


@pytest.fixture
def stream_off():
    old = jsetops.STREAM_SETOP, tsetops.STREAM_SETOP
    jsetops.STREAM_SETOP = tsetops.STREAM_SETOP = False
    yield
    jsetops.STREAM_SETOP, tsetops.STREAM_SETOP = old


# ---------------------------------------------------------------------------
# the stream route, one interpreted JAX run per op
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=OPS)
def stream_case(request):
    """Both packages' public set op on the mixed tables with
    STREAM_SETOP=True. The JAX program's inputs and outputs and the
    port's K5 inputs are recorded on the way."""
    op = request.param
    jctx = jct.CylonContext.Init()
    tctx = tct.CylonContext.Init(device="cpu")
    jl, tl, jr, tr = _mixed_tables(jctx, tctx, narrow=op != "union")
    rec = {}
    real_program = jsetops._setop_stream_program
    real_k5 = K.setop_stream

    def jax_program(*args):
        rec["j_args"] = args
        rec["j_out"] = real_program.__wrapped__(*args)
        return rec["j_out"]

    def port_k5(*args, **kw):
        rec["t_k5"] = (args, kw)
        return real_k5(*args, **kw)

    old = jsetops.STREAM_SETOP, tsetops.STREAM_SETOP
    try:
        jsetops.STREAM_SETOP = tsetops.STREAM_SETOP = True
        jsetops._setop_stream_program = types.SimpleNamespace(
            __wrapped__=jax_program)
        K.setop_stream = port_k5
        jres = getattr(jl, op)(jr)
        tres = getattr(tl, op)(tr)
    finally:
        jsetops._setop_stream_program = real_program
        K.setop_stream = real_k5
        jsetops.STREAM_SETOP, tsetops.STREAM_SETOP = old
    return dict(op=tsetops.SetOp[op.upper()], jres=jres, tres=tres, **rec,
                tables=(tl, tr))


def _jax_sorted_stream(lane_l, lane_r, lemit, remit):
    """The JAX program's sort, eagerly: (h1, h2, tag, lanes...)."""
    nl, nr = lemit.shape[0], remit.shape[0]
    n = nl + nr
    lanes = [jnp.concatenate([a, b]) for a, b in zip(lane_l, lane_r)]
    live = jnp.concatenate([lemit, remit])
    tag = (jnp.concatenate([jnp.full(nl, jnp.uint32(1 << 31)),
                            jnp.zeros(nr, jnp.uint32)])
           | (live.astype(jnp.uint32) << 29)
           | jnp.arange(n, dtype=jnp.uint32))
    h1 = jnp.zeros(n, jnp.uint32)
    h2 = jnp.full(n, jnp.uint32(0x9E3779B9))
    for ln in lanes:
        h1 = h1 * jnp.uint32(31) + jhash.fmix32(ln)
        h2 = h2 * jnp.uint32(33) + jhash.fmix32b(ln)
    h1 = jnp.where(live, jhash.fmix32(h1), jnp.uint32(0xFFFFFFFF))
    h2 = jnp.where(live, jhash.fmix32b(h2), jnp.uint32(0xFFFFFFFF))
    return [np.asarray(x) for x in
            jax.lax.sort((h1, h2, tag) + tuple(lanes), num_keys=3)]


def _assert_streams_match(j_out, counts, streams):
    jc, js = j_out
    jc = np.asarray(jc)
    assert np.array_equal(jc, counts[0].numpy()), (jc, counts)
    n_out = int(jc[0])
    assert len(js) == streams.shape[0]
    for x, y in zip(js, streams):
        flat = np.asarray(x).reshape(-1)
        assert flat.shape[0] == y.shape[1]  # the same stream length
        assert np.array_equal(flat[:n_out], y[0].numpy()[:n_out].view(
            np.uint32))


def test_lane_descs_match(stream_case):
    tl, tr = stream_case["tables"]
    assert tsetops.setop_lane_descs(tl._columns, tr._columns) \
        == stream_case["j_args"][4]


def test_stream_program_matches_pallas(stream_case):
    """(a) The port's program on the JAX package's lanes: the sorted
    stream K5 receives, K5's counts, and the compacted streams over
    [0, n_out)."""
    lane_l, lane_r, lemit, remit, _descs, _op, br, _i = stream_case["j_args"]
    assert br == 8
    nl, nr = lemit.shape[0], remit.shape[0]

    def lanes(xs):
        return [_t(np.asarray(x).view(np.int32))[None] for x in xs]

    seen = {}
    real = K.setop_stream

    def spy(*args, **kw):
        seen["args"] = args
        return real(*args, **kw)

    K.setop_stream = spy
    try:
        counts, streams = tsetops._setop_stream_program(
            lanes(lane_l), lanes(lane_r), _t(np.asarray(lemit))[None],
            _t(np.asarray(remit))[None], stream_case["op"],
            tsetops.stream_out_len(nl, nr))
    finally:
        K.setop_stream = real
    ref = _jax_sorted_stream(lane_l, lane_r, lemit, remit)
    h1, h2, streams_s = seen["args"][:3]
    for j, t in zip(ref, [h1[0], h2[0]] + list(streams_s[:, 0])):
        assert np.array_equal(j, t.numpy().view(np.uint32))
    _assert_streams_match(stream_case["j_out"], counts, streams)
    assert int(counts[0, 1]) == 0


def test_plain_k5_on_pallas_sorted_stream(stream_case):
    """(a) The port's K5 alone, on the JAX package's sorted stream."""
    lane_l, lane_r, lemit, remit = stream_case["j_args"][:4]
    h1, h2, tag, *lanes = [_t(x.view(np.int32))[None] for x in
                           _jax_sorted_stream(lane_l, lane_r, lemit, remit)]
    out_len = tsetops.stream_out_len(lemit.shape[0], remit.shape[0])
    counts, streams = K.setop_stream(h1, h2, torch.stack([tag] + lanes),
                                     int(stream_case["op"]), out_len)
    _assert_streams_match(stream_case["j_out"], counts, streams)
    # past n_out the port's streams are zero
    n_out = int(counts[0, 0])
    assert not streams[:, :, n_out:].any()


def test_public_api_stream_route_matches(stream_case):
    """(c) STREAM_SETOP=True on both sides: the same live rows in the
    same order, and the same capacity."""
    t_args = stream_case["t_k5"][0]
    # the tag and every lane of the case rode the sort (UNION: every lane
    # kind)
    assert t_args[2].shape[0] == 1 + (10 if stream_case["op"] == 0 else 4)
    assert_same_tables(stream_case["jres"], stream_case["tres"],
                       stream_case["op"].name)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,br,ns,density", [
    (1000, 8, 1, 0.4),
    (5000, 8, 2, 0.9),
    (16384, 8, 3, 0.5),
    (40000, 16, 2, 0.03),
    (4096, 8, 1, 0.0),
    (4096, 8, 1, 1.0),
])
def test_stream_compact_plain_matches_pallas(n, br, ns, density):
    """(b) The count, the compacted prefix and the zero tail."""
    rng = np.random.default_rng(7)
    mask = rng.random(n) < density
    streams = [rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
               for _ in range(ns)]
    jouts, jcnt = tk.stream_compact(
        jnp.asarray(mask), [jnp.asarray(s) for s in streams], block_rows=br,
        interpret=True)
    out, cnt = K.stream_compact(
        _t(mask)[None], torch.stack([_t(s.view(np.int32))[None]
                                     for s in streams]))
    cnt = int(cnt[0])
    assert cnt == int(jcnt) == mask.sum()
    assert out.shape == (ns, 1, n)
    for j, o, s in zip(jouts, out, streams):
        got = o[0].numpy().view(np.uint32)
        assert np.array_equal(got[:cnt], np.asarray(j)[:cnt])
        assert np.array_equal(got[:cnt], s[mask])
        assert not got[cnt:].any() and not np.asarray(j)[cnt:].any()


def test_stream_compact_plain_float32_int32_bit_exact():
    rng = np.random.default_rng(9)
    mask = rng.random(1000) < 0.5
    vals = rng.normal(size=1000).astype(np.float32)
    ints = rng.integers(-2**31, 2**31, 1000, dtype=np.int32)
    (jf, ji), jcnt = tk.stream_compact(
        jnp.asarray(mask), [jnp.asarray(vals), jnp.asarray(ints)],
        interpret=True)
    out, cnt = K.stream_compact(
        _t(mask)[None], torch.stack([_t(vals.view(np.int32))[None],
                                     _t(ints)[None]]), out_len=1200)
    cnt = int(cnt[0])
    assert cnt == int(jcnt)
    assert out.shape == (2, 1, 1200) and not out[:, :, cnt:].any()
    assert np.array_equal(out[0, 0, :cnt].numpy().view(np.float32),
                          np.asarray(jf)[:cnt])
    assert np.array_equal(out[1, 0, :cnt].numpy(), np.asarray(ji)[:cnt])


# ---------------------------------------------------------------------------
# the public API on the dense-ranks route, and the route's edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
def test_dense_route_matches_row_for_row(stream_off, op):
    """(c) STREAM_SETOP=False on both sides: equal row for row (the first
    occurrence of each row, in table order, bits of -0.0 kept)."""
    jl, tl, jr, tr = _mixed_tables(jct.CylonContext.Init(),
                                   tct.CylonContext.Init(device="cpu"))
    jres, tres = getattr(jl, op)(jr), getattr(tl, op)(tr)
    assert tres.row_mask is None
    assert_same_tables(jres, tres, op)


@pytest.mark.parametrize("op", OPS)
def test_stream_route_equals_dense_route(op):
    """The port's two routes give the same row set on the mixed tables;
    the stream route is the default only on CUDA."""
    _jl, tl, _jr, tr = _mixed_tables(jct.CylonContext.Init(),
                                     tct.CylonContext.Init(device="cpu"))
    old = tsetops.STREAM_SETOP
    try:
        tsetops.STREAM_SETOP = None
        dense = getattr(tl, op)(tr)
        tsetops.STREAM_SETOP = True
        stream = getattr(tl, op)(tr)
    finally:
        tsetops.STREAM_SETOP = old
    assert dense.row_mask is None and stream.row_mask is not None
    assert np.array_equal(row_set(dense), row_set(stream))


def test_stream_route_applicability():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    descs = (("d", False),)
    old = tsetops.STREAM_SETOP
    try:
        tsetops.STREAM_SETOP = None
        assert tsetops.setop_stream_applicable(10, descs, cuda)
        assert not tsetops.setop_stream_applicable(10, descs, cpu)
        assert not tsetops.setop_stream_applicable(0, descs, cuda)
        assert not tsetops.setop_stream_applicable(1 << 29, descs, cuda)
        assert not tsetops.setop_stream_applicable(10, None, cuda)
        tsetops.STREAM_SETOP = False
        assert not tsetops.setop_stream_applicable(10, descs, cuda)
        tsetops.STREAM_SETOP = True
        assert tsetops.setop_stream_applicable(10, descs, cpu)
    finally:
        tsetops.STREAM_SETOP = old


def test_lane_budget():
    """Over MAX_SETOP_LANES lanes the stream route does not apply."""
    tctx = tct.CylonContext.Init(device="cpu")
    wide = tct.Table.from_pydict(tctx, {f"c{i}": np.arange(4, dtype=np.int64)
                                        for i in range(7)})
    assert tsetops.setop_lane_descs(wide._columns, wide._columns) is None
    ok = tct.Table.from_pydict(tctx, {f"c{i}": np.arange(4, dtype=np.int64)
                                      for i in range(6)})
    assert len(tsetops.setop_lane_descs(ok._columns, ok._columns)) == 6


@pytest.mark.parametrize("op", OPS)
def test_empty_side(stream_off, op):
    jctx, tctx = jct.CylonContext.Init(), tct.CylonContext.Init(device="cpu")
    jl, tl = _pair(jctx, tctx, {"a": np.arange(10, dtype=np.int32)}, {})
    jr, tr = _pair(jctx, tctx, {"a": np.arange(5, 15, dtype=np.int32)}, {})
    jl, tl = _filter(jl, tl, np.zeros(10, bool))
    jres, tres = getattr(jl, op)(jr), getattr(tl, op)(tr)
    assert_same_tables(jres, tres, op)
    tsetops.STREAM_SETOP = True
    assert np.array_equal(row_set(getattr(tl, op)(tr)), row_set(tres))


def test_float16_bit_exact_and_signed_zero():
    """float16 lanes are bitcast: 1.25 and 1.5 stay distinct rows; -0.0
    equals 0.0."""
    tctx = tct.CylonContext.Init(device="cpu")
    left = tct.Table.from_pydict(tctx, {
        "h": np.array([1.25, 1.5, 2.0, -0.0], dtype=np.float16)})
    right = tct.Table.from_pydict(tctx, {
        "h": np.array([1.5, 0.0, 3.0], dtype=np.float16)})
    old = tsetops.STREAM_SETOP
    try:
        tsetops.STREAM_SETOP = True
        u, i = left.union(right), left.intersect(right)
    finally:
        tsetops.STREAM_SETOP = old
    assert u.row_count == 5
    assert sorted(u.to_pydict()["h"].tolist()) == [0.0, 1.25, 1.5, 2.0, 3.0]
    assert sorted(i.to_pydict()["h"].tolist()) == [0.0, 1.5]


def test_collision_falls_back_to_dense_ranks(monkeypatch):
    """With both hash avalanches forced to 0 every live row shares one
    run: K5 reports collisions and the port recomputes on the dense-ranks
    route, row for row the JAX package's."""
    monkeypatch.setattr(thash, "fmix32", lambda h: h * 0)
    monkeypatch.setattr(thash, "fmix32b", lambda h: h * 0)
    rng = np.random.default_rng(4)
    jctx, tctx = jct.CylonContext.Init(), tct.CylonContext.Init(device="cpu")
    jl, tl = _pair(jctx, tctx, {"a": rng.integers(0, 9, 150).astype(
        np.int32)}, {})
    jr, tr = _pair(jctx, tctx, {"a": rng.integers(0, 9, 150).astype(
        np.int32)}, {})
    seen = []
    real = K.setop_stream

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(int(out[0][0, 1]))
        return out

    monkeypatch.setattr(K, "setop_stream", spy)
    monkeypatch.setattr(tsetops, "STREAM_SETOP", True)
    monkeypatch.setattr(jsetops, "STREAM_SETOP", False)
    tres = tl.union(tr)
    assert seen and seen[0] > 0
    assert_same_tables(jl.union(jr), tres)


def test_capacity_clamp():
    """A union of distinct rows where capacity(n_out) passes the stream
    length (n = 100,000: 102,400 > 102,144): the capacity is clamped to
    the stream length, as in the JAX package, and every row is there."""
    nl = nr = 50_000
    tctx = tct.CylonContext.Init(device="cpu")
    left = tct.Table.from_pydict(tctx, {"a": np.arange(nl, dtype=np.int32)})
    right = tct.Table.from_pydict(tctx, {
        "a": np.arange(nl, nl + nr, dtype=np.int32)})
    out_len = tsetops.stream_out_len(nl, nr)
    assert out_len == 102_144 < capacity(nl + nr)
    old = tsetops.STREAM_SETOP
    try:
        tsetops.STREAM_SETOP = True
        got = left.union(right)
    finally:
        tsetops.STREAM_SETOP = old
    assert got.capacity == out_len and got.row_count == nl + nr
    assert np.array_equal(np.sort(got.to_pydict()["a"]),
                          np.arange(nl + nr, dtype=np.int32))
    jctx = jct.CylonContext.Init()
    jl = jct.Table.from_pydict(jctx, {"a": np.arange(nl, dtype=np.int32)})
    jr = jct.Table.from_pydict(jctx, {
        "a": np.arange(nl, nl + nr, dtype=np.int32)})
    old = jsetops.STREAM_SETOP
    try:
        jsetops.STREAM_SETOP = False
        ref = jl.union(jr)
    finally:
        jsetops.STREAM_SETOP = old
    assert np.array_equal(row_set(ref), row_set(got))


def test_promoted_columns(stream_off):
    """int32 against int64 promotes both sides (Column.astype)."""
    jctx, tctx = jct.CylonContext.Init(), tct.CylonContext.Init(device="cpu")
    rng = np.random.default_rng(5)
    a = {"k": rng.integers(0, 20, 100).astype(np.int32)}
    b = {"k": rng.integers(0, 20, 90).astype(np.int64)}
    jl, tl = _pair(jctx, tctx, a, {})
    jr, tr = _pair(jctx, tctx, b, {})
    for op in OPS:
        tres = getattr(tl, op)(tr)
        assert tres._columns[0].data.dtype == torch.int64
        assert_same_tables(getattr(jl, op)(jr), tres, op)


def test_string_columns_raise_not_ported():
    """Dictionary string columns now take part in set ops (their codes
    ride the lane route as 4-byte lanes) and give cylon_tpu's rows, row
    for row; a cast of a string column is refused as in cylon_tpu."""
    jctx = jct.CylonContext.Init()
    tctx = tct.CylonContext.Init(device="cpu")
    a = {"s": np.array(["x", "y", "x", None, "z"], dtype=object),
         "k": np.arange(5, dtype=np.int32) % 2}
    b = {"s": np.array(["y", "w", None], dtype=object),
         "k": np.array([1, 0, 1], np.int32)}
    jl, tl = _pair(jctx, tctx, a, {})
    jr, tr = _pair(jctx, tctx, b, {})
    assert tl._columns[0].dictionary is not None
    for op in OPS:
        tres = getattr(tl, op)(tr)
        assert_same_tables(getattr(jl, op)(jr), tres, op)
        assert tres.to_pydict()["s"].tolist() == \
            getattr(jl, op)(jr).to_pydict()["s"].tolist()
    with pytest.raises(tct.CylonError, match="cannot cast string column"):
        tl._columns[0].astype(tdtypes.Int64())


def test_interop_carries_every_lane_kind():
    """from_reference_arrays keeps every fixed-width kind and its
    validity as given; a NaN stays a value."""
    tctx = tct.CylonContext.Init(device="cpu")
    arrays, valid, _keep = _mixed(3, 50)
    arrays["d"][3] = np.nan
    t = from_reference_arrays(tctx, list(arrays.values()),
                              [valid.get(k) for k in arrays], None,
                              names=list(arrays))
    for (k, a), c in zip(arrays.items(), t._columns):
        assert c.data.dtype == tdtypes.torch_dtype(a.dtype)
        assert np.array_equal(_bits(c.data.numpy()), _bits(a))
        if k in valid:
            assert np.array_equal(c.validity.numpy(), valid[k])
        else:
            assert c.validity is None
