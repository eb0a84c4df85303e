"""cylon_tpu_torch kernels K1-K10 against their plain PyTorch versions on
the card, bit for bit.

Needs CUDA: every test here is marked ``gpu`` and skips without a card.
This file imports neither jax nor cylon_tpu, so it also runs on a machine
that has only torch; there, skip the JAX package's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""
import ctypes

import numpy as np
import pytest
import torch

import cylon_tpu_torch as ct
from cylon_tpu_torch.ops import join as J
from cylon_tpu_torch.ops import kernels as K
from cylon_tpu_torch.ops import order as O
from cylon_tpu_torch.ops import setops as SO
from cylon_tpu_torch.parallel import shuffle as S
from cylon_tpu_torch.parallel.comm import VirtualComm
from cylon_tpu_torch.status import CylonError

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _plan_equal(ref, got):
    """Counts equal, and groups A/B equal over their counted prefixes."""
    (c0, a0, b0), (c1, a1, b1) = ref, got
    assert torch.equal(c0, c1), (c0, c1)
    for w in range(c0.shape[0]):
        ne, nb = int(c0[w, 1]), int(c0[w, 2])
        for x, y in zip(a0, a1):
            assert torch.equal(x[w, :ne], y[w, :ne])
        for x, y in zip(b0, b1):
            assert torch.equal(x[w, :nb], y[w, :nb])


@pytest.mark.parametrize("world", [2, 4, 8, 255])
def test_partition_kernels_match_plain(cuda, world):
    rng = np.random.default_rng(world)
    n = 70_001
    t = rng.integers(0, world + 1, (3, n)).astype(np.int32)
    t = torch.from_numpy(t).to(cuda)
    legs = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 3, n),
                                         dtype=np.int64).astype(np.int32)
                            ).to(cuda)
    hist = K.partition_hist(t, world + 1)
    assert torch.equal(hist, K.plain_partition_hist(t, world + 1))
    counts = hist[:, :, :world].sum(1, dtype=torch.int32)
    out = K.partition_scatter(t, legs, world + 1, counts)
    torch.cuda.synchronize()
    assert torch.equal(out, K.plain_partition_scatter(t, legs, world + 1,
                                                      counts))


def test_tile_constants_match_sources(cuda):
    """The wrappers' tile sizes are the sources' own."""
    def c_int(lib, fn):
        f = getattr(K.load_library(lib), fn)
        f.argtypes, f.restype = [], ctypes.c_int
        return f()

    assert c_int("partition", "tile_rows") == K.PARTITION_TILE
    assert c_int("join_stream", "plan_tile_rows") == K.PLAN_TILE
    assert c_int("join_stream", "expand_tile_rows") == K.EXPAND_TILE
    assert c_int("join_hash_keys", "hash_key_columns") == K.MAX_HASH_LANES
    assert c_int("setop_hash_rows", "setop_hash_lanes") == K.MAX_SETOP_LANES
    assert c_int("permute_rows", "permute_row_words") == K.MAX_ROW_WORDS


def test_partition_past_the_bucket_limit_takes_the_sort(cuda):
    """Past K1/K2's bucket limit the partition takes the stable sort on
    the card (the JAX package's route past its kernel's limit), even with
    PARTITION_KERNEL True: no K1/K2 launch, and the layout is the sort's.
    (It raised before the sort route was taken there.)"""
    world = K.MAX_BUCKETS
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.integers(0, world, (world, 40)).astype(
        np.int32)).to(cuda)
    x = torch.from_numpy(rng.normal(size=(world, 40)).astype(
        np.float32)).to(cuda)
    emit = t % 7 != 0
    old = S.PARTITION_KERNEL
    S.PARTITION_KERNEL = True
    K.reset_launches()
    try:
        got = S._padded_partition(VirtualComm(world), 1, {"x": x}, t, emit)
    finally:
        S.PARTITION_KERNEL = old
    assert K.LAUNCHES["partition_hist"] == K.LAUNCHES[
        "partition_scatter"] == 0
    exp, counts, start = S._bucket_sort({"x": x}, t, emit, world)
    torch.cuda.synchronize()
    assert torch.equal(got[0]["x"], exp["x"])
    assert torch.equal(got[2], start)


def _join_inputs(dev, rng, w, na, nb, hash_mode, two_keys):
    keys = 2 if two_keys else 1
    lk = [torch.from_numpy(rng.integers(0, na // 3, (w, na)).astype(
        np.int32)).to(dev) for _ in range(keys)]
    rk = [torch.from_numpy(rng.integers(0, na // 3, (w, nb)).astype(
        np.int32)).to(dev) for _ in range(keys)]
    lval = torch.from_numpy(rng.random((w, na)) < 0.9).to(dev)
    lemit = torch.from_numpy(rng.random((w, na)) < 0.95).to(dev)
    remit = torch.from_numpy(rng.random((w, nb)) < 0.95).to(dev)
    lbits, lkv = J.key_bits(lk, [lval] + [None] * (keys - 1))
    rbits, rkv = J.key_bits(rk, [None] * keys)
    ldat = (lk[0], torch.from_numpy(rng.normal(size=(w, na)).astype(
        np.float32)).to(dev))
    rdat = (rk[0], torch.from_numpy(rng.normal(size=(w, nb)).astype(
        np.float32)).to(dev))
    lv = (lval, torch.ones_like(lval))
    rv = (torch.ones_like(remit), torch.ones_like(remit))
    return lbits, lkv, lemit, rbits, rkv, remit, ldat, lv, rdat, rv


# K8's cases: (key dtypes, world, masks, join type); the key columns'
# u32 lanes number 2, 3, 6, 2, 3 and 3
HASH_KEY_CASES = {
    "int64": ((np.int64,), 1, False, J.JoinType.INNER),
    "int32_int64": ((np.int32, np.int64), 1, False, J.JoinType.INNER),
    "six_lanes": ((np.int64, np.float64, np.int16, np.bool_), 1, True,
                  J.JoinType.LEFT),
    "masks": ((np.int64,), 1, True, J.JoinType.INNER),
    "right": ((np.int32, np.int64), 1, True, J.JoinType.RIGHT),
    "world2": ((np.int64, np.int32), 2, True, J.JoinType.INNER),
}


def hash_key_case(case, rows, dev):
    """K8's inputs of one case, as a join hands them to
    ``stream_sort_keys``: (lbits, lkv, lemit, rbits, rkv, remit, join
    type), ``rows`` rows a side over the shards (the right side a third
    more), keys drawn with repeats and every sign."""
    dtypes, w, masks, jt = HASH_KEY_CASES[case]
    rng = np.random.default_rng(sorted(HASH_KEY_CASES).index(case))
    sides = []
    for n in (rows // w, rows // w + rows // (3 * w)):
        keys = []
        for dt in dtypes:
            if dt == np.bool_:
                x = rng.random((w, n)) < 0.5
            elif np.issubdtype(dt, np.floating):
                x = rng.normal(size=(w, n)).astype(dt)
                x[rng.random((w, n)) < 0.05] = -0.0
            else:
                info = np.iinfo(dt)
                x = rng.integers(info.min, info.max, (w, n), dtype=dt,
                                 endpoint=True)
                x[:, ::3] = x[:, :1]    # repeats across the shard
            keys.append(torch.from_numpy(x).to(dev))
        valid = [torch.from_numpy(rng.random((w, n)) < 0.9).to(dev)
                 if masks else None for _ in dtypes]
        emit = torch.from_numpy(rng.random((w, n)) < 0.85).to(dev) \
            if masks else None
        bits, kv = J.key_bits(keys, valid)
        sides.append((bits, kv, emit))
    (lb, lkv, lem), (rb, rkv, rem) = sides
    return lb, lkv, lem, rb, rkv, rem, jt


def hash_key_sides(lb, lkv, lem, rb, rkv, rem, jt):
    """K8's (a, b) argument triples: RIGHT probes with the right side."""
    a, b = (lb, lkv, lem), (rb, rkv, rem)
    return (b, a) if jt == J.JoinType.RIGHT else (a, b)


def assert_hash_keys_equal(got, ref):
    """K8's five outputs bit for bit, int64 [W, n] each."""
    assert len(got["kb"]) == len(ref["kb"])
    for x, y in zip([got[k] for k in ("tag", "h1", "h2", "key")] + got["kb"],
                    [ref[k] for k in ("tag", "h1", "h2", "key")] + ref["kb"]):
        assert x.dtype == y.dtype == torch.int64 and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", sorted(HASH_KEY_CASES))
def test_join_hash_keys_match_plain(cuda, case):
    """K8 at 2^23 rows a side (over the shards) against its plain version
    on the card, all five outputs bit for bit."""
    args = hash_key_case(case, 1 << 23, cuda)
    a, b = hash_key_sides(*args)
    K.reset_launches()
    got = K.join_hash_keys(*a, *b)
    ref = K.plain_join_hash_keys(*a, *b)
    torch.cuda.synchronize()
    assert K.LAUNCHES["join_hash_keys"] == 1
    assert_hash_keys_equal(got, ref)


def test_join_hash_keys_rejects_on_card(cuda):
    """The wrapper raises on a float key, keys and validity on two
    devices, and a validity of the wrong width."""
    lb, lkv, lem, rb, rkv, rem, _jt = hash_key_case("masks", 4096, cuda)
    bad = [((lb[0].double(),), lkv, lem, (rb[0].double(),), rkv, rem),
           (lb, lkv.cpu(), lem, rb, rkv, rem),
           (lb, lkv[:, 1:], lem, rb, rkv, rem)]
    for args in bad:
        with pytest.raises(CylonError):
            K.join_hash_keys(*args)


def test_hash_route_join_launches_k8_on_card(cuda):
    """A world-1 join on an int64 key takes the hash stream: K8 launches
    once, and the rows equal the CPU's (the plain version's)."""
    rng = np.random.default_rng(8)
    n = 300_000
    la = {"k": rng.integers(0, n, n), "v": rng.random(n)}
    ra = {"k": rng.integers(0, n, n + 77), "w": rng.random(n + 77)}
    gctx, cctx = _ctx_pair(cuda, 0)
    for how in ("inner", "left", "right"):
        K.reset_launches()
        got = _table(gctx, la).join(_table(gctx, ra), how, on=["k"])
        torch.cuda.synchronize()
        assert K.LAUNCHES["join_hash_keys"] == 1, (how, K.LAUNCHES)
        exp = _table(cctx, la).join(_table(cctx, ra), how, on=["k"])
        assert np.array_equal(_row_multiset(got), _row_multiset(exp)), how


# K9's cases: (column dtypes, world, the side(s) whose even-numbered
# columns have nulls, emit masks, each side's rows as (a, b) in rows * a +
# b); "dict" is a dictionary string column's int32 codes
SETOP_HASH_CASES = {
    "int64": (("int64",), 1, None, False, ((1, 3), (1, 0))),
    "float64": (("float64",), 1, None, False, ((1, 3), (1, 0))),
    "float32": (("float32",), 1, None, False, ((1, 3), (1, 0))),
    "int32": (("int32",), 1, None, False, ((1, 3), (1, 0))),
    "int16": (("int16",), 1, None, False, ((1, 3), (1, 0))),
    "int8": (("int8",), 1, None, False, ((1, 3), (1, 0))),
    "uint8": (("uint8",), 1, None, False, ((1, 3), (1, 0))),
    "float16": (("float16",), 1, None, False, ((1, 3), (1, 0))),
    "bool": (("bool", "int32"), 1, None, False, ((1, 3), (1, 0))),
    "dict": (("dict", "int64"), 1, None, False, ((1, 3), (1, 0))),
    "left_validity": (("int64", "float32", "int8"), 1, "left", False,
                      ((1, 0), (1, 5))),
    "right_validity": (("float64", "uint16"), 1, "right", True,
                       ((1, 1), (0.5, 7))),
    "emit_world2": (("int64", "float64"), 2, None, True, ((1, 0), (1, 0))),
    "twelve_lanes": (("int64", "float64", "float16", "bool", "dict",
                      "uint64"), 1, "both", True, ((1, 9), (0.75, 1))),
    "ragged": (("int32", "float64"), 3, "left", True, ((0, 1001), (0, 77))),
    "empty_left": (("int64", "float32"), 1, "right", True, ((0, 0), (1, 1))),
}
_NAN64 = (0x7FF8000000000001, 0xFFF0000000000123, 0x7FF0000000000000)
_NAN32 = (0x7FC00001, 0xFF800123, 0x7F800000)
_NAN16 = (0x7E01, 0xFC05, 0x7C00)


def _draw_column(rng, name, w, n):
    """A column of dtype ``name`` with repeats, every sign, and for floats
    -0.0, +0.0 and NaNs with payloads (and infinities)."""
    if name == "bool":
        return rng.random((w, n)) < 0.5
    if name == "dict":
        return rng.integers(0, 50, (w, n)).astype(np.int32)
    dt = np.dtype(name)
    if dt.kind == "f":
        x = rng.normal(size=(w, n)).astype(dt)
        x[rng.random((w, n)) < 0.05] = -0.0
        x[rng.random((w, n)) < 0.05] = 0.0
        nans = {8: (_NAN64, np.uint64), 4: (_NAN32, np.uint32),
                2: (_NAN16, np.uint16)}[dt.itemsize]
        bits = x.view(nans[1])
        for i, pattern in enumerate(nans[0]):
            bits[:, i::97] = pattern
        return x
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, (w, n), dtype=dt, endpoint=True)
    x[:, ::3] = x[:, :1]    # repeats across the shard
    return x


def setop_hash_case(case, rows, dev):
    """K9's arguments of one case: (ldata, lvalid, lemit, rdata, rvalid,
    remit, descs), the sides' rows ``rows * a + b`` over the shards."""
    names, w, nulls, masks, sizes = SETOP_HASH_CASES[case]
    rng = np.random.default_rng(sorted(SETOP_HASH_CASES).index(case))
    sides = []
    for which, (a, b) in zip(("left", "right"), sizes):
        n = int(rows * a + b) // w
        data = [torch.from_numpy(_draw_column(rng, nm, w, n)).to(dev)
                for nm in names]
        has = nulls in (which, "both")
        valid = [torch.from_numpy(rng.random((w, n)) < 0.8).to(dev)
                 if has and i % 2 == 0 else None for i in range(len(names))]
        emit = torch.from_numpy(rng.random((w, n)) < 0.85).to(dev) \
            if masks else None
        sides.append((data, valid, emit))
    (ld, lv, le), (rd, rv, re) = sides
    def kind(x):
        return "b" if x.dtype == torch.bool else \
            {1: "n", 2: "n", 4: "d", 8: "w"}[x.element_size()]

    descs = tuple((kind(x), a is not None or b is not None)
                  for x, a, b in zip(ld, lv, rv))
    return ld, lv, le, rd, rv, re, descs


def assert_setop_hash_equal(got, ref):
    """K9's five outputs (h1, h2, stack, side, live) bit for bit."""
    assert len(got) == len(ref) == 5
    for x, y in zip(got, ref):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.shape, y.shape)
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", sorted(SETOP_HASH_CASES))
def test_setop_hash_rows_match_plain(cuda, case):
    """K9 at ~2^20 rows a side against its plain version on the card,
    all five outputs bit for bit."""
    args = setop_hash_case(case, 1 << 20, cuda)
    K.reset_launches()
    got = K.setop_hash_rows(*args)
    ref = K.plain_setop_hash_rows(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["setop_hash_rows"] == 1
    assert_setop_hash_equal(got, ref)
    if case == "twelve_lanes":
        assert got[2].shape[0] == 1 + K.MAX_SETOP_LANES


def test_setop_hash_rows_rejects_on_card(cuda):
    """The wrapper raises on inputs on two devices and on a lane kind
    that is not the column's."""
    ld, lv, le, rd, rv, re, descs = setop_hash_case("int64", 4096, cuda)
    bad = [(ld, lv, le, [rd[0].cpu()], rv, re, descs),
           (ld, lv, le, rd, rv, re, (("d", False),))]
    for args in bad:
        with pytest.raises(CylonError):
            K.setop_hash_rows(*args)


def _set_op_rows(table):
    """A table's live rows as one int64 [2 x columns, m] tensor in
    lexicographic order: each column's bits (0 at a null) and its
    validity."""
    live = torch.nonzero(table.emit_mask()).flatten()
    keys = []
    for c in table.columns():
        x = c.data[live]
        bits = x.to(torch.int64) if x.dtype == torch.bool \
            else x.view(ct.dtypes.bits_container(x.dtype)).to(torch.int64)
        valid = c.valid_mask()[live]
        keys += [torch.where(valid, bits, 0), valid.to(torch.int64)]
    perm = torch.arange(len(live), device=live.device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return torch.stack([k[perm] for k in keys])


def set_op_tables(dev, n: int):
    """Two tables of n rows (int64 k, float64 v, a dictionary string
    column s, an int16 column h with nulls on the right), drawn with
    repeats; the right's first quarter copies the left's."""
    g = torch.Generator(device=dev)
    g.manual_seed(2 ** 31 + 23)

    def draw(high, dtype=torch.int64):
        return [torch.randint(0, high, (n,), generator=g, device=dev,
                              dtype=dtype) for _ in "lr"]

    k, s, h = draw(max(n // 4, 1)), draw(3, torch.int32), \
        draw(5, torch.int16)
    v = [x.double() / 4 for x in draw(4)]
    hv = [None, torch.rand(n, generator=g, device=dev) >= 0.1]
    q = n // 4
    for cols in (k, v, s, h):
        cols[1][:q] = cols[0][:q]
    vocab = np.array(["ab", "cd", "ef"])
    ctx = ct.CylonContext.Init(device=dev)
    return tuple(ct.Table([
        ct.Column(k[i], ct.dtypes.Int64(), None, "k"),
        ct.Column(v[i], ct.dtypes.Double(), None, "v"),
        ct.Column(s[i], ct.dtypes.String(), None, "s", dictionary=vocab),
        ct.Column(h[i], ct.dtypes.Int16(), hv[i], "h")], ctx)
        for i in range(2))


@pytest.mark.parametrize("op", ["union", "subtract", "intersect"])
def test_set_ops_launch_k9_once_on_card(cuda, op):
    """A local set op of 2^23 rows a side (``set_op_tables``) takes the
    stream route on the card and launches K9 once; its rows equal the
    dense-ranks route's."""
    from cylon_tpu_torch import telemetry as tel

    left, right = set_op_tables(cuda, 1 << 23)

    def routes():
        return {key: val for key, val in tel.metrics_snapshot().items()
                if key.startswith("cylon_setop_route_total")}

    was = routes()
    K.reset_launches()
    out = getattr(left, op)(right)
    torch.cuda.synchronize()
    assert K.LAUNCHES["setop_hash_rows"] == 1, K.LAUNCHES
    assert K.LAUNCHES["setop_stream"] == 1, K.LAUNCHES
    now = routes()
    assert {key: now[key] - was.get(key, 0) for key in now
            if now[key] != was.get(key, 0)} == \
        {'cylon_setop_route_total{route="stream"}': 1}
    old = SO.STREAM_SETOP
    SO.STREAM_SETOP = False
    try:
        dense = getattr(left, op)(right)
    finally:
        SO.STREAM_SETOP = old
    got, exp = _set_op_rows(out), _set_op_rows(dense)
    assert got.shape[1] > 0
    assert torch.equal(got, exp)


@pytest.mark.parametrize("jt,hash_mode", [
    (J.JoinType.INNER, False), (J.JoinType.LEFT, False),
    (J.JoinType.INNER, True)])
def test_join_kernels_match_plain(cuda, jt, hash_mode):
    rng = np.random.default_rng(int(jt) + 10 * hash_mode)
    args = _join_inputs(cuda, rng, 3, 40_000, 50_000, hash_mode, hash_mode)
    a_desc, b_desc = J.plan_lane_descs(*args[6:], jt)
    kw = J.stream_sort(J.stream_sort_keys(*args, jt, a_desc, b_desc,
                                          hash_mode))
    got = K.join_plan_stream(**kw)
    ref = K.plain_join_plan_stream(**kw)
    torch.cuda.synchronize()
    _plan_equal(ref, got)
    cap_e = J.stream_expand_capacity(int(ref[0][:, 0].max()), 8)
    e_got = K.join_expand_stream(ref[0], ref[1], ref[2], cap_e)
    e_ref = K.plain_join_expand_stream(ref[0], ref[1], ref[2], cap_e)
    torch.cuda.synchronize()
    assert torch.equal(e_got[0], e_ref[0])
    assert torch.equal(e_got[1], e_ref[1])
    for x, y in zip(e_got[2] + e_got[3], e_ref[2] + e_ref[3]):
        assert torch.equal(x, y)


def _setop_stream(dev, rng, w, n, lanes, keys, live_frac, collide=False,
                  key=None):
    """K5's inputs (h1, h2, the [1 + lanes, W, n] stack of tag and lanes),
    sorted by (h1, h2, tag): each element draws one of ``keys`` row keys
    (or takes ``key``), whose lanes and 2x32-bit hash come from fixed
    random tables (equal keys, equal hashes); dead rows get all-ones
    hashes. ``collide`` gives keys 0 and 1 one hash (a collision)."""
    table = rng.integers(-2**31, 2**31, (keys, max(lanes, 1)),
                         dtype=np.int64)
    hashes = rng.integers(0, 2**32 - 1, (keys, 2), dtype=np.int64)
    if collide:
        hashes[1] = hashes[0]
    if key is None:
        key = rng.integers(0, keys, (w, n))
    live = rng.random((w, n)) < live_frac
    side = rng.random((w, n)) < 0.5
    h = np.where(live[..., None], hashes[key], 2**32 - 1)
    tag = ((side.astype(np.int64) << 31) | (live.astype(np.int64) << 29)
           | np.arange(n))
    h1, h2, tg = (torch.from_numpy(x).to(dev) for x in (h[..., 0], h[..., 1],
                                                         tag))
    perm = O.lexsort_indices([_u32(h1), _u32(h2), _u32(tg)])
    lane_vals = torch.from_numpy(table[key][..., :lanes].astype(
        np.int32)).to(dev).permute(2, 0, 1)
    streams = torch.cat([_u32(tg).unsqueeze(0), lane_vals])
    return (_u32(h1).gather(1, perm), _u32(h2).gather(1, perm),
            streams.gather(2, perm.unsqueeze(0).expand_as(
                streams)).contiguous())


def _u32(x):
    """int64 values in [0, 2^32) -> int32 bits."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


@pytest.mark.parametrize("op", [0, 1, 2])
@pytest.mark.parametrize("w,n,lanes,keys,live_frac", [
    (1, 20_000, 1, 1, 1.0),        # one run across ten tiles
    (3, 70_001, 2, 5_000, 0.9),    # ragged, three shards
    (2, 9_999, 0, 300, 0.8),       # no lanes
    (1, 50_000, 12, 2_000, 0.95),  # the lane budget
    (2, 10_000, 2, 50, 0.0),       # every row dead
])
def test_setop_stream_matches_plain(cuda, op, w, n, lanes, keys, live_frac):
    rng = np.random.default_rng(op + n)
    args = _setop_stream(cuda, rng, w, n, lanes, keys, live_frac)
    out_len = n + 3 * 128
    got = K.setop_stream(*args, op, out_len)
    ref = K.plain_setop_stream(*args, op, out_len)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]), (got[0], ref[0])
    assert torch.equal(got[1], ref[1])
    if live_frac == 0.0:
        assert not got[0].any()


def test_setop_stream_counts_collisions(cuda):
    rng = np.random.default_rng(5)
    args = _setop_stream(cuda, rng, 2, 30_000, 2, 40, 0.9, collide=True)
    got = K.setop_stream(*args, 0)
    ref = K.plain_setop_stream(*args, 0, 30_000)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and int(got[0][:, 1].min()) > 0
    assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("lanes", [0, 1, 12])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_stream_compact_matches_plain(cuda, lanes, density):
    rng = np.random.default_rng(int(density * 10) + lanes)
    w, n = 3, 70_001
    mask = torch.from_numpy(rng.random((w, n)) < density).to(cuda)
    streams = torch.from_numpy(rng.integers(-2**31, 2**31, (lanes, w, n),
                                            dtype=np.int64).astype(
                                                np.int32)).to(cuda)
    for out_len in (n, n + 5_000):
        got = K.stream_compact(mask, streams, out_len)
        ref = K.plain_stream_compact(mask, streams, out_len)
        torch.cuda.synchronize()
        assert torch.equal(got[1], ref[1])
        assert torch.equal(got[0], ref[0])


@pytest.mark.parametrize("name", ["union", "subtract", "intersect"])
def test_set_op_kernel_route_equals_dense_route(cuda, name):
    """The public set op on the card: the default (kernel) route launches
    K5 and K6 and gives the dense-ranks route's rows."""
    rng = np.random.default_rng(3)
    ctx = ct.CylonContext.Init()

    def table(n):
        k = rng.integers(0, 500, n).astype(np.int32)
        g = rng.normal(size=n).astype(np.float32).round(0)
        valid = rng.random(n) < 0.9
        return ct.Table([ct.Column.from_numpy(k, "k", None, cuda),
                         ct.Column.from_numpy(g, "g", valid, cuda)], ctx)

    a, b = table(60_000), table(50_000)
    K.reset_launches()
    got = getattr(a, name)(b)
    assert K.LAUNCHES["setop_stream"] == 1
    assert K.LAUNCHES["stream_compact"] == 1
    old = SO.STREAM_SETOP
    try:
        SO.STREAM_SETOP = False
        ref = getattr(a, name)(b)
    finally:
        SO.STREAM_SETOP = old

    def rows(t):
        t = t.compact()
        k, g = t._columns
        v = g.valid_mask()
        x = torch.stack([k.data.to(torch.int64), v.to(torch.int64),
                         torch.where(v, g.data + 0.0, 0.0).view(
                             torch.int32).to(torch.int64)], 1)
        return x[O.lexsort_indices([x[:, 0], x[:, 1], x[:, 2]])]

    assert torch.equal(rows(got), rows(ref))


# ---------------------------------------------------------------------------
# look-back stress: K2, K3, K5 and K6 carry their scans across tiles by
# decoupled look-back, whose faults are races, so each case runs the kernel
# 20 times and every run must equal the plain version
# ---------------------------------------------------------------------------

STRESS_RUNS = 20


def _edge_run(case, tile):
    """Stream run length of an edge case: a whole tile, half a tile, or
    two short of a tile (boundaries drift across tile edges)."""
    return {"edge_tile": tile, "edge_half": tile // 2,
            "edge_short": tile - 2}[case]


def _stress_keys(rng, case, w):
    """(lk, rk, lemit, remit) as numpy for one stress case."""
    tile = K.PLAN_TILE
    if case == "w8_1000_tiles":  # >= 1,000 tiles a shard at W = 8
        na = nb = 1000 * tile // 2 + 3
    elif case == "ragged":       # n not a multiple of the tile
        na, nb = 100_001, 77_777
    elif case.startswith("edge"):
        na = nb = 20 * tile
    elif case == "hot_run":      # the hot key's run: ~450 tiles
        na = nb = 700_000
    else:
        na = nb = 300_000
    lk = rng.integers(0, na // 3, (w, na)).astype(np.int32)
    rk = rng.integers(0, na // 3, (w, nb)).astype(np.int32)
    lemit = rng.random((w, na)) < 0.95
    remit = rng.random((w, nb)) < 0.95
    if case == "hot_run":        # one run spanning hundreds of tiles
        lk[rng.random((w, na)) < 0.9] = 7
        rk[rng.random((w, nb)) < 0.9] = 7
    elif case.startswith("edge"):
        # every row live and runs of exactly `run` stream elements (half
        # from each side), so run boundaries fall on tile edges
        run = _edge_run(case, tile)
        lk = np.broadcast_to(np.arange(na) // (run // 2), (w, na)).astype(
            np.int32)
        rk = np.broadcast_to(np.arange(nb) // (run // 2), (w, nb)).astype(
            np.int32)
        lemit = np.ones((w, na), bool)
        remit = np.ones((w, nb), bool)
    elif case == "all_dead":
        lemit[:] = False
        remit[:] = False
    return lk, rk, lemit, remit


PLAN_STRESS = [
    # case, world, join type, hash mode
    ("w8_1000_tiles", 8, J.JoinType.INNER, False),
    ("hot_run", 2, J.JoinType.INNER, False),
    ("edge_tile", 3, J.JoinType.INNER, False),
    ("edge_half", 3, J.JoinType.INNER, False),
    ("edge_short", 3, J.JoinType.LEFT, False),
    ("ragged", 3, J.JoinType.INNER, False),
    ("all_dead", 2, J.JoinType.INNER, False),
    ("uniform", 4, J.JoinType.LEFT, False),
    ("uniform", 4, J.JoinType.INNER, True),
    ("hot_run", 2, J.JoinType.LEFT, True),
]


@pytest.mark.parametrize("case,world,jt,hash_mode", PLAN_STRESS)
def test_plan_stream_lookback_stress(cuda, case, world, jt, hash_mode):
    rng = np.random.default_rng(len(case) + world)
    lk, rk, lemit, remit = _stress_keys(rng, case, world)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    lbits, lkv = J.key_bits([t(lk)], [None])
    rbits, rkv = J.key_bits([t(rk)], [None])
    ldat = (t(lk), t(rng.normal(size=lk.shape).astype(np.float32)))
    rdat = (t(rk), t(rng.normal(size=rk.shape).astype(np.float32)))
    lv = rv = (None, None)
    a_desc, b_desc = J.plan_lane_descs(ldat, lv, rdat, rv, jt)
    kw = J.stream_sort(J.stream_sort_keys(
        lbits, lkv, t(lemit), rbits, rkv, t(remit), ldat, lv, rdat, rv, jt,
        a_desc, b_desc, hash_mode))
    if case == "w8_1000_tiles":
        assert kw["bits_s"].shape[1] >= 1000 * K.PLAN_TILE
    ref = K.plain_join_plan_stream(**kw)
    for _ in range(STRESS_RUNS):
        got = K.join_plan_stream(**kw)
        torch.cuda.synchronize()
        _plan_equal(ref, got)


@pytest.mark.parametrize("op", [0, 1, 2])
@pytest.mark.parametrize("case", ["w8_1000_tiles", "hot_run", "edge_tile",
                                  "edge_half", "ragged", "all_dead"])
def test_setop_stream_lookback_stress(cuda, case, op):
    rng = np.random.default_rng(op + len(case))
    tile = K.SETOP_TILE
    w, n, keys, live, key = 2, 300_000, 50_000, 0.9, None
    if case == "w8_1000_tiles":
        w, n = 8, 1000 * tile + 5
        keys = n // 2
    elif case == "hot_run":      # one run over all 356 tiles
        n, keys = 1_000_000, 1
    elif case.startswith("edge"):
        run = _edge_run(case, tile)
        n, live = 20 * tile, 1.0
        keys = n // run
        key = np.broadcast_to(np.arange(n) // run, (w, n))
    elif case == "ragged":
        w, n = 3, 100_001
    else:
        live = 0.0
    args = _setop_stream(cuda, rng, w, n, 2, keys, live, key=key)
    out_len = n + 3 * 128
    ref = K.plain_setop_stream(*args, op, out_len)
    for _ in range(STRESS_RUNS):
        got = K.setop_stream(*args, op, out_len)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]), (got[0], ref[0])
        assert torch.equal(got[1], ref[1])


def _scatter_ids(rng, case, w, n, nb):
    """[W, n] bucket ids in [0, nb) for one K2 stress case."""
    if case == "one_bucket":     # every row in one live bucket
        return np.full((w, n), nb // 2 - (nb == 2), np.int32)
    if case == "all_dead":       # every row in the dead (last) bucket
        return np.full((w, n), nb - 1, np.int32)
    if case == "alternating":    # neighbours in different buckets
        return np.broadcast_to(np.arange(n) % nb, (w, n)).astype(np.int32)
    return rng.integers(0, nb, (w, n)).astype(np.int32)


SCATTER_STRESS = [
    # case, nbuckets, W, n (none a multiple of the tile), legs
    ("one_bucket", 2, 4, 300_001, "sequence"),
    ("all_dead", 5, 1, 1_000_003, "stack"),
    ("alternating", 5, 8, 250_007, "sequence"),
    ("uniform", 5, 4, 1_000_003, "stack"),
    ("uniform", 9, 8, 300_001, "sequence"),
    ("alternating", 9, 1, 70_001, "stack"),
    ("uniform", 256, 4, 200_003, "sequence"),
    ("one_bucket", 256, 1, 100_001, "stack"),
    ("all_dead", 256, 8, 50_001, "sequence"),
    ("uniform", 2, 1, 4_096 * 300 + 17, "stack"),
]


@pytest.mark.parametrize("case,nb,w,n,legs_as", SCATTER_STRESS)
def test_partition_scatter_lookback_stress(cuda, case, nb, w, n, legs_as):
    rng = np.random.default_rng(nb + w + len(case))
    t = torch.from_numpy(_scatter_ids(rng, case, w, n, nb)).contiguous().to(
        cuda)
    legs = torch.from_numpy(rng.integers(-2**31, 2**31, (3, w, n),
                                         dtype=np.int64).astype(np.int32)
                            ).to(cuda)
    if legs_as == "sequence":
        legs = [x.clone() for x in legs]
    counts = K.plain_partition_hist(t, nb)[:, :, :nb - 1].sum(
        1, dtype=torch.int32)
    ref = K.plain_partition_scatter(t, legs, nb, counts)
    for _ in range(STRESS_RUNS):
        got = K.partition_scatter(t, legs, nb, counts)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


def test_partition_scatter_more_legs_than_one_pass(cuda):
    """More legs than one pass takes: the launcher runs one pass per
    group of MAX_SCATTER_LEGS legs."""
    rng = np.random.default_rng(11)
    w, n, nb = 4, 100_003, 5
    t = torch.from_numpy(rng.integers(0, nb, (w, n)).astype(np.int32)).to(
        cuda)
    legs = [torch.from_numpy(rng.integers(-2**31, 2**31, (w, n),
                                          dtype=np.int64).astype(np.int32)
                             ).to(cuda)
            for _ in range(K.MAX_SCATTER_LEGS + 7)]
    counts = K.partition_hist(t, nb)[:, :, :nb - 1].sum(1, dtype=torch.int32)
    got = K.partition_scatter(t, legs, nb, counts)
    torch.cuda.synchronize()
    assert torch.equal(got, K.plain_partition_scatter(t, legs, nb, counts))


def _compact_mask(rng, density, w, n):
    if density == "alternating":
        return np.broadcast_to(np.arange(n) % 2 == 0, (w, n)).copy()
    return rng.random((w, n)) < density


@pytest.mark.parametrize("lanes,first_mask", [(0, -1), (1, K.IDX_MASK),
                                              (12, K.IDX_MASK)])
@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("density", [0.0, 1e-4, 0.3, 1.0, "alternating"])
def test_stream_compact_lookback_stress(cuda, density, w, lanes, first_mask):
    rng = np.random.default_rng(w + lanes)
    n = 1_000_003 if lanes < 12 else 300_007
    mask = torch.from_numpy(_compact_mask(rng, density, w, n)).to(cuda)
    streams = torch.from_numpy(rng.integers(-2**31, 2**31, (lanes, w, n),
                                            dtype=np.int64).astype(
                                                np.int32)).to(cuda)
    for out_len in (n, n + 5 * K.COMPACT_TILE + 123):
        ref = K.plain_stream_compact(mask, streams, out_len, first_mask)
        for _ in range(STRESS_RUNS):
            got = K.stream_compact(mask, streams, out_len, first_mask)
            torch.cuda.synchronize()
            assert torch.equal(got[1], ref[1])
            assert torch.equal(got[0], ref[0])


# ---------------------------------------------------------------------------
# K4 stress: tiles of outputs, a 32-ary search per tile and a window of
# starts. K4 has no cross-block state, so its result cannot depend on
# scheduling; each case runs twice, the allocator's cache dirtied before
# each run, so that an output slot the kernel leaves unwritten shows.
# ---------------------------------------------------------------------------

def _dirty(dev, nbytes):
    """Fill and free a block of device memory, so that the next
    allocations likely start from garbage rather than from an earlier
    result."""
    junk = torch.full((max(nbytes // 4, 1),), 0x5A5A5A5A, dtype=torch.int32,
                      device=dev)
    del junk


def _expand_sides(rng, case, w):
    """Probe side (keys, key validity, emit) and build keys, numpy [W, n],
    of one K4 stress case."""
    na, nb, kmax = 100_000, 100_000, 60_000
    if case == "one_tile":
        na, nb, kmax = 600, 500, 700
    pk = rng.integers(0, kmax, (w, na)).astype(np.int32)
    bk = rng.integers(0, kmax, (w, nb)).astype(np.int32)
    pval = np.ones((w, na), bool)
    pemit = rng.random((w, na)) < 0.95
    if case == "heavy":          # runs of 12,000 outputs: ~6 tiles each
        pk[:, :3] = 7
        bk[:, :12_000] = 7
    elif case == "empty_shard":  # one shard emits no probe row
        pemit[w // 2] = False
    elif case == "left_dead":    # nulls, unmatched keys, both key ends
        pval = rng.random((w, na)) < 0.8
        pk[:, 100:5_000] += kmax
        pk[:, :2], bk[:, :2] = [0, kmax - 1], [0, kmax - 1]
        pval[:, :2] = True
    elif case == "uneven":       # n_out differs by ~2x from shard to shard
        for s in range(w):
            pk[s] %= kmax // (1 + s % 3)
            bk[s] %= kmax // (1 + s % 3)
    elif case == "few_runs":     # 1, 20, 31, 33, ... emitting probe rows
        pemit[:] = False
        for s in range(w):
            e = (1, 20, 31, 33)[s % 4]
            pemit[s, :e] = True
            pk[s, 0] = 7
        bk[:, :3_000] = 7
    return pk, pval, pemit, bk


def _expand_plan(dev, rng, case, w, jt, hash_mode, La, Lb):
    """K3's plan (the plain version, so that K4's test does not rest on
    K3) over a case's join, with max(La, Lb) random payload lanes."""
    pk, pval, pemit, bk = _expand_sides(rng, case, w)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    pbits, pkv = J.key_bits([t(pk)], [t(pval)])
    bbits, bkv = J.key_bits([t(bk)], [None])
    p = (pbits, pkv, t(pemit), (t(pk),), (None,))
    b = (bbits, bkv, torch.ones_like(t(bk), dtype=torch.bool), (t(bk),),
         (None,))
    left, right = (b, p) if jt == J.JoinType.RIGHT else (p, b)
    kw = J.stream_sort(J.stream_sort_keys(
        *left[:3], *right[:3], left[3], left[4], right[3], right[4], jt, (),
        (), hash_mode))
    n = kw["bits_s"].shape[1]
    kw["lanes"] = [t(rng.integers(-2**31, 2**31, (w, n), dtype=np.int64)
                     .astype(np.int32)) for _ in range(max(La, Lb))]
    kw["n_a_lanes"], kw["n_b_lanes"] = La, Lb
    return K.plain_join_plan_stream(**kw)


EXPAND_STRESS = [
    # case, world, join type, hash mode, La, Lb
    ("heavy", 1, J.JoinType.INNER, False, 4, 4),
    ("heavy", 4, J.JoinType.LEFT, True, 1, 0),
    ("heavy", 8, J.JoinType.RIGHT, False, 8, 8),
    ("straddle", 1, J.JoinType.RIGHT, True, 0, 1),
    ("straddle", 4, J.JoinType.INNER, False, 4, 4),
    ("empty_shard", 4, J.JoinType.INNER, False, 4, 4),
    ("empty_shard", 8, J.JoinType.LEFT, True, 8, 1),
    ("empty_shard", 4, J.JoinType.RIGHT, False, 0, 0),
    ("left_dead", 1, J.JoinType.LEFT, False, 4, 4),
    ("left_dead", 4, J.JoinType.LEFT, True, 1, 8),
    ("left_dead", 8, J.JoinType.RIGHT, False, 4, 0),
    ("cap_exact", 1, J.JoinType.INNER, False, 4, 4),
    ("cap_exact", 4, J.JoinType.LEFT, True, 1, 1),
    ("one_tile", 1, J.JoinType.INNER, True, 8, 4),
    ("one_tile", 4, J.JoinType.RIGHT, False, 1, 1),
    ("uneven", 8, J.JoinType.INNER, False, 4, 4),
    ("uneven", 4, J.JoinType.LEFT, True, 0, 8),
    ("few_runs", 4, J.JoinType.INNER, False, 4, 4),
    ("few_runs", 8, J.JoinType.RIGHT, True, 8, 0),
]


@pytest.mark.parametrize("case,world,jt,hash_mode,La,Lb", EXPAND_STRESS)
def test_join_expand_stress(cuda, case, world, jt, hash_mode, La, Lb):
    rng = np.random.default_rng(len(case) + 10 * world + int(jt))
    counts, a, b = _expand_plan(cuda, rng, case, world, jt, hash_mode, La,
                                Lb)
    n_out = counts[:, 0].cpu()
    n_emit = counts[:, 1].cpu()
    top = int(n_out.max())
    if case == "cap_exact":      # cap_e = n_out, and a scalar tail
        caps = [top, top + 1, top + 2, top + 3]
    elif case == "one_tile":
        assert top <= K.EXPAND_TILE
        caps = [K.EXPAND_TILE]
    else:
        caps = [J.stream_expand_capacity(top, 8)]
    # each case has the shape it is named for
    if case == "heavy":
        assert int((a[2, :, 1:n_emit.min()] - a[2, :, :n_emit.min() - 1])
                   .max()) > 5 * K.EXPAND_TILE
    elif case == "straddle":
        assert any(0 < int(x) % K.EXPAND_TILE for x in n_out)
    elif case == "empty_shard":
        assert int(n_emit.min()) == 0 < int(n_emit.max())
    elif case == "left_dead":
        assert (a[1, 0, :int(n_emit[0])] % 2 == 0).any()  # dead or unmatched
    elif case == "uneven":
        assert int(n_out.max()) > 1.5 * int(n_out.min())
    elif case == "few_runs":
        assert sorted(set(n_emit.tolist()))[0] == 1 and int(n_emit.max()) < 34
    for cap_e in caps:
        ref = K.plain_join_expand_stream(counts, a, b, cap_e)
        for _ in range(2):
            _dirty(cuda, 4 * world * cap_e * (2 + La + Lb))
            got = K.join_expand_stream(counts, a, b, cap_e)
            torch.cuda.synchronize()
            assert torch.equal(got[0], ref[0])
            assert torch.equal(got[1], ref[1])
            assert len(got[2]) == La and len(got[3]) == Lb
            for x, y in zip(got[2] + got[3], ref[2] + ref[3]):
                assert torch.equal(x, y)
        if case == "left_dead":  # some valid rows have no build row
            assert bool(((ref[0] >= 0) & (ref[1] < 0)).any())
        if case == "heavy":      # bpos spans reach both ends of group B
            assert int(ref[1].max()) >= 0


# ---------------------------------------------------------------------------
# K1 stress: counts in registers (nb <= 8) or by warp peer groups (nb > 8);
# shards start off a 16-byte boundary where n is not a multiple of 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 4_095, 4_096, 4_097, 1_000_003])
@pytest.mark.parametrize("nb", [1, 2, 5, 8, 9, 17, 256])
def test_partition_hist_stress(cuda, nb, n):
    rng = np.random.default_rng(nb * 7 + n)
    w = 3
    ids = rng.integers(-2, nb + 3, (w, n)).astype(np.int32)
    t = torch.from_numpy(ids).to(cuda)
    ref = K.plain_partition_hist(t, nb)
    for _ in range(2):
        _dirty(cuda, 4 * ref.numel())
        got = K.partition_hist(t, nb)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.parametrize("nb", [5, 17])
def test_partition_hist_unaligned_base(cuda, nb):
    """A [W, n] view whose first row starts 4 bytes past an aligned
    address: every shard takes the scalar loads."""
    rng = np.random.default_rng(nb)
    w, n = 2, 3 * K.PARTITION_TILE
    flat = torch.from_numpy(rng.integers(-1, nb + 1, w * n + 1).astype(
        np.int32)).to(cuda)
    t = flat[1:].view(w, n)
    assert t.data_ptr() % 16 == 4 and t.is_contiguous()
    got = K.partition_hist(t, nb)
    torch.cuda.synchronize()
    assert torch.equal(got, K.plain_partition_hist(t, nb))


# ---------------------------------------------------------------------------
# the compact exchange route, groupby, aggregates and sort on the card,
# each against the same port on the CPU with the same inputs. Tolerance 0
# except float SUM (1e-5 * sum |x| of the group, plus 1e-30) and MEAN
# (1e-12 * sum |x| / count), kept from before K7 summed each group in row
# order; the bit-equality of the sums is pinned by
# test_group_sums_bit_reproducible_on_card.
# ---------------------------------------------------------------------------

SUM_RTOL, MEAN_RTOL = 1e-5, 1e-12


def _ctx_pair(cuda, world):
    if world == 0:
        return ct.CylonContext.Init(), ct.CylonContext.Init(device="cpu")
    cfg = ct.VirtualWorldConfig(world)
    return (ct.CylonContext.InitDistributed(cfg),
            ct.CylonContext.InitDistributed(cfg, device="cpu"))


def _table(ctx, arrays, valid=None):
    valid = valid or {}
    return ct.Table([ct.Column.from_numpy(a, k, valid.get(k), ctx.device)
                     for k, a in arrays.items()], ctx)


def _host_cols(t):
    live = t.emit_mask().cpu().numpy()
    return live, [(c.valid_mask().cpu().numpy(), c.data.cpu().numpy())
                  for c in t._columns]


def assert_layout_equal(gpu_t, cpu_t, float_kinds=None, scale=None,
                        what=""):
    """The flat (per-shard) layout: capacity, row mask, every column's
    validity and live data bit for bit; columns named in ``float_kinds``
    ({index: "sum" or "mean"}) within the float-sum tolerances, scaled by
    ``scale[index]`` (an array over the live rows: sum |x|, count)."""
    float_kinds = float_kinds or {}
    assert gpu_t.capacity == cpu_t.capacity, what
    gl, gc = _host_cols(gpu_t)
    cl, cc = _host_cols(cpu_t)
    assert np.array_equal(gl, cl), what
    for i, ((gv, gd), (cv, cd)) in enumerate(zip(gc, cc)):
        assert np.array_equal(gv[gl], cv[cl]), (what, i)
        m = gl & gv
        a, b = gd[m], cd[m]
        assert a.dtype == b.dtype, (what, i)
        if i not in float_kinds:
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), \
                (what, i)
            continue
        assert np.array_equal(np.isnan(a), np.isnan(b)), (what, i)
        s, c = scale[i]
        tol = SUM_RTOL * s + 1e-30 if float_kinds[i] == "sum" \
            else MEAN_RTOL * s / np.maximum(c, 1)
        tol = tol[gv[gl]] if np.ndim(tol) else tol
        ok = np.isnan(a) | (np.abs(a - b) <= tol)
        assert ok.all(), (what, i)


def _exchange_case(world, name):
    """Flat payload, targets, emit and max_block of a compact-route case
    (the CPU file tests/test_torch_port_compact_exchange.py holds the
    same shapes against the JAX package)."""
    n, kind, mb = {"one_row": (1, "hash", None), "empty": (0, "hash", None),
                   "few": (5, "hash", None), "diagonal": (40, "diag", None),
                   "source_skew": (200, "skew", None),
                   "rounds": (200, "skew", 4)}[name]
    cap = -(-(-(-max(n, 1) // world)) // 8) * 8
    total = world * cap
    rng = np.random.default_rng(world * 7 + len(name))
    payload = {"x": rng.integers(-100, 100, total).astype(np.int32),
               "y": rng.normal(size=total),
               "b": rng.random(total) < 0.5}
    emit = np.zeros(total, bool)
    if kind == "skew":
        emit[:min(n, cap)] = True
    else:
        emit[np.arange(total) % cap < -(-n // world)] = True
        emit[np.flatnonzero(emit)[n:]] = False
    targets = (np.arange(total) // cap if kind == "diag"
               else rng.integers(0, world, total)).astype(np.int32)
    return payload, targets, emit, mb


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("case", ["one_row", "empty", "few", "diagonal",
                                  "source_skew", "rounds"])
def test_compact_exchange_on_card(cuda, world, case):
    """Both routes' outputs on the card equal the CPU's shard by shard;
    K1/K2 partition the rows (shards of 8 rows, every row dead in
    ``empty``)."""
    payload, targets, emit, mb = _exchange_case(world, case)
    gctx, cctx = _ctx_pair(cuda, world)
    outs = []
    for ctx in (gctx, cctx):
        K.reset_launches()
        outs.append(S.exchange(
            {k: torch.from_numpy(v).to(ctx.device) for k, v in
             payload.items()}, torch.from_numpy(targets).to(ctx.device),
            torch.from_numpy(emit).to(ctx.device), ctx, max_block=mb))
        if ctx is gctx:
            # K1 counts the send matrix, then K1 + K2 partition
            torch.cuda.synchronize()
            assert K.LAUNCHES["partition_hist"] == 2
            assert K.LAUNCHES["partition_scatter"] == 1
    (go, ge, gcap, gm), (co, ce, ccap, cm) = outs
    assert gm["mode"] == cm["mode"] and gcap == ccap
    if case != "few":
        assert gm["mode"] == "compact"
    assert torch.equal(gm["counts_in"].cpu(), cm["counts_in"])
    assert torch.equal(ge.cpu(), ce)
    for k in payload:
        a, b = go[k].cpu()[ce], co[k][ce]
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), k


def _small_join_arrays(case):
    if case == "one_row_self":
        a = {"k": np.zeros(1, np.int32), "v": np.ones(1, np.float32)}
        return a, dict(a)
    nl, nr = {"empty_left": (0, 6), "few": (3, 14),
              "four_row_shards": (13, 16)}[case]
    rng = np.random.default_rng(nl + nr)
    return ({"k": rng.integers(0, 4, nl).astype(np.int32),
             "v": rng.normal(size=nl).astype(np.float32)},
            {"k": rng.integers(0, 4, nr).astype(np.int32),
             "w": rng.normal(size=nr).astype(np.float32)})


def _row_multiset(t):
    t = t.compact()
    rows = np.stack([np.where(c.valid_mask().cpu().numpy(),
                              c.data.cpu().numpy().view(
                                  f"u{c.data.element_size()}").astype(
                                      np.int64), -1)
                     for c in t._columns], 1) if t.capacity else \
        np.zeros((0, t.column_count), np.int64)
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("case", ["one_row_self", "empty_left", "few",
                                  "four_row_shards"])
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_small_distributed_join_on_card(cuda, world, case, how):
    """Small and empty inputs on the card: the compact route hands the
    join shards of 1 to 4 rows (some all dead); K1/K2 partition them and,
    where the stream route applies, K3/K4 join them. Rows equal the
    CPU's."""
    la, ra = _small_join_arrays(case)
    gctx, cctx = _ctx_pair(cuda, world)
    K.reset_launches()
    got = _table(gctx, la).distributed_join(_table(gctx, ra), how,
                                            on=["k"])
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    assert launches["partition_hist"] >= 1
    if how != "outer" and len(la["k"]) and len(ra["k"]):
        assert launches["join_plan_stream"] == 1, launches
        assert launches["join_expand_stream"] == 1, launches
    exp = _table(cctx, la).distributed_join(_table(cctx, ra), how, on=["k"])
    assert np.array_equal(_row_multiset(got), _row_multiset(exp))


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("case", ["one_row_self", "empty_left", "few"])
@pytest.mark.parametrize("op", ["union", "subtract", "intersect"])
def test_small_distributed_set_op_on_card(cuda, world, case, op):
    la, ra = _small_join_arrays(case)
    ra = {"k": ra["k"], "v": ra.get("v", ra.get("w"))}
    gctx, cctx = _ctx_pair(cuda, world)
    got = getattr(_table(gctx, la), f"distributed_{op}")(_table(gctx, ra))
    exp = getattr(_table(cctx, la), f"distributed_{op}")(_table(cctx, ra))
    assert np.array_equal(_row_multiset(got), _row_multiset(exp))


def _group_arrays(n, groups, seed=0):
    rng = np.random.default_rng(seed)
    g = (np.arange(n) if groups == n else rng.integers(0, groups, n)
         ).astype(np.int32)
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.05] = -0.0
    arrays = {"g": rng.permutation(g), "x": x,
              "y": rng.integers(-1000, 1000, n).astype(np.int32)}
    return arrays, {"x": rng.random(n) < 0.9}


def _group_scale(t, arrays, valid, col):
    """(sum |x|, count) of ``col`` per output row of the groupby ``t``
    (key column 0), over the live rows of the output."""
    live = t.emit_mask().cpu().numpy()
    keys = t._columns[0].data.cpu().numpy()[live]
    v = valid.get(col, np.ones(len(arrays[col]), bool))
    x = np.abs(np.where(v, arrays[col], 0).astype(np.float64))
    order = np.argsort(arrays["g"], kind="stable")
    gs = arrays["g"][order]
    lo = np.searchsorted(gs, keys, "left")
    hi = np.searchsorted(gs, keys, "right")
    cx = np.concatenate([[0], np.cumsum(x[order])])
    cv = np.concatenate([[0], np.cumsum(v[order])])
    return cx[hi] - cx[lo], cv[hi] - cv[lo]


@pytest.mark.parametrize("world", [0, 4])
@pytest.mark.parametrize("groups", [1, 1000, "all"])
def test_groupby_on_card(cuda, world, groups):
    """groupby(g, [x, y, x, x, x], [sum, count, mean, min, max]) with one
    group, with 1,000 groups and with as many groups as rows, on the card
    against the CPU."""
    n = 20_000
    arrays, valid = _group_arrays(n, n if groups == "all" else groups)
    gctx, cctx = _ctx_pair(cuda, world)
    ops = ["sum", "count", "mean", "min", "max"]
    got = _table(gctx, arrays, valid).groupby(0, [1, 2, 1, 1, 1], ops)
    exp = _table(cctx, arrays, valid).groupby(0, [1, 2, 1, 1, 1], ops)
    sc = _group_scale(exp, arrays, valid, "x")
    assert_layout_equal(got, exp, {1: "sum", 3: "mean"}, {1: sc, 3: sc},
                        f"world {world} groups {groups}")


@pytest.mark.parametrize("mode", ["rows", "pre_partitioned"])
def test_groupby_without_partials_on_card(cuda, mode):
    from cylon_tpu_torch.parallel import dist_ops as D

    arrays, valid = _group_arrays(5_000, 300, seed=2)
    gctx, cctx = _ctx_pair(cuda, 4)
    res = []
    for ctx in (gctx, cctx):
        t = _table(ctx, arrays, valid)
        ops = [ct.AggregationOp.SUM, ct.AggregationOp.MIN]
        if mode == "rows":
            res.append(D.distributed_groupby(t, 0, [2, 1], ops,
                                             pre_aggregate=False))
        else:
            res.append(D.distributed_groupby(D.shuffle(t, ["g"]), 0, [2, 1],
                                             ops, pre_partitioned=True))
    assert_layout_equal(res[0], res[1], what=mode)


@pytest.mark.parametrize("world", [0, 4])
@pytest.mark.parametrize("op", ["sum", "count", "min", "max", "mean"])
def test_scalar_aggregates_on_card(cuda, world, op):
    arrays, valid = _group_arrays(30_000, 50, seed=3)
    gctx, cctx = _ctx_pair(cuda, world)
    for col in ("x", "y"):
        a = getattr(_table(gctx, arrays, valid), op)(col)._columns[0]
        b = getattr(_table(cctx, arrays, valid), op)(col)._columns[0]
        ga, cb = a.data.cpu().numpy(), b.data.numpy()
        assert ga.dtype == cb.dtype
        if op in ("sum", "mean") and ga.dtype.kind == "f":
            s = np.abs(np.where(valid.get(col, True), arrays[col], 0)).sum()
            tol = SUM_RTOL * s + 1e-30 if op == "sum" \
                else MEAN_RTOL * s / len(arrays[col])
            assert np.all(np.abs(ga - cb) <= tol), (col, ga, cb)
        else:
            assert np.array_equal(ga.view(np.uint8), cb.view(np.uint8)), col


@pytest.mark.parametrize("world", [0, 1, 4, 8])
@pytest.mark.parametrize("keys", ["distinct", "all_equal", "top_bit"])
def test_sort_on_card(cuda, world, keys):
    """Table.sort (world 0) and distributed_sort (force_exchange at world
    1) on the card: bit for bit the CPU's rows, shard by shard (both
    sorts are stable), and K1/K2 in the exchange."""
    from cylon_tpu_torch.parallel import dist_ops as D

    rng = np.random.default_rng(4)
    n = 50_000
    k = {"distinct": rng.permutation(n).astype(np.int32),
         "all_equal": np.full(n, 7, np.int32),
         "top_bit": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
         }[keys]
    arrays = {"k": k, "v": rng.normal(size=n).astype(np.float32),
              "b": rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                dtype=np.int64)}
    gctx, cctx = _ctx_pair(cuda, world)
    res = []
    for ctx in (gctx, cctx):
        t = _table(ctx, arrays)
        K.reset_launches()
        if world == 0:
            res.append(t.sort(["k", "b"], [True, False]))
        else:
            res.append(D.distributed_sort(t, ["k", "b"], [True, False],
                                          force_exchange=True))
        if ctx is gctx and world > 1:
            torch.cuda.synchronize()
            assert K.LAUNCHES["partition_scatter"] == 1
    assert_layout_equal(res[0], res[1], what=f"world {world} {keys}")


@pytest.mark.parametrize("world", [4, 8])
def test_hash_partition_and_repartition_on_card(cuda, world):
    from cylon_tpu_torch.parallel import dist_ops as D

    arrays, valid = _group_arrays(10_000, 400, seed=5)
    gctx, cctx = _ctx_pair(cuda, world)
    gp = D.hash_partition(_table(gctx, arrays, valid), ["g"], 5)
    cp = D.hash_partition(_table(cctx, arrays, valid), ["g"], 5)
    for p in range(5):
        assert_layout_equal(gp[p], cp[p], what=f"partition {p}")
    assert_layout_equal(D.repartition(_table(gctx, arrays, valid), gctx),
                        D.repartition(_table(cctx, arrays, valid), cctx),
                        what="repartition")


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("n", [1, 3, 7])
def test_reshuffle_of_compact_output_on_card(cuda, world, n):
    """A shuffle of a few rows (all on source shard 0, so the compact
    route) lands in compact shards of 1 to 8 rows;
    shuffling that by another key runs K1/K2 on [W, cap] ids whose shards
    start off a 16-byte boundary, and a groupby of it merges partials of
    such shards. Rows and layout equal the CPU's."""
    from cylon_tpu_torch.parallel import dist_ops as D

    rng = np.random.default_rng(n)
    arrays = {"k": rng.integers(0, 1 << 20, n).astype(np.int32),
              "v": rng.integers(0, 3, n).astype(np.int64)}
    gctx, cctx = _ctx_pair(cuda, world)
    res = []
    for ctx in (gctx, cctx):
        first = D.shuffle(_table(ctx, arrays), ["k"])
        assert first.capacity // world <= 8
        K.reset_launches()
        second = D.shuffle(first, ["v"])
        if ctx is gctx:
            torch.cuda.synchronize()
            assert K.LAUNCHES["partition_hist"] == 2
            assert K.LAUNCHES["partition_scatter"] == 1
        res.append((first, second, D.distributed_groupby(
            first, 1, [0], [ct.AggregationOp.COUNT])))
    for g, c in zip(res[0], res[1]):
        assert_layout_equal(g, c, what=f"world {world} n {n}")


# ---------------------------------------------------------------------------
# string columns on the card: the string join at world 1 and 4 against the
# plain route, K3's hash mode at its 6-lane verify limit, and a string
# shuffle whose compact output feeds K1/K2 again. Tolerance 0.
# ---------------------------------------------------------------------------


def _key_strings(ks, width):
    """Fixed-width keys "u" + digits of ks, as bytes rows."""
    return np.array([f"u{k:0{width - 1}d}".encode() for k in ks], object)


def _string_table(ctx, ks, width, v, long_payload=False):
    from cylon_tpu_torch.data.strings import VarBytes

    n = len(ks)
    raw = b"".join(_key_strings(ks, width))
    vb = VarBytes._from_packed(raw, np.full(n, width, np.int32),
                               device=ctx.device)
    cols = [ct.Column.from_varbytes(vb, None, "k"),
            ct.Column.from_numpy(v, "v", None, ctx.device)]
    if long_payload:
        long_raw = b"".join(b"p" * 40 + s for s in _key_strings(ks, width))
        pv = VarBytes._from_packed(long_raw, np.full(n, 40 + width,
                                                     np.int32),
                                   device=ctx.device)
        cols.append(ct.Column.from_varbytes(pv, None, "p"))
    return ct.Table(cols, ctx)


def _string_rows(t):
    """Live rows as sorted (bytes of every string column, data bits of
    the rest)."""
    t = t.compact()
    cols = []
    for c in t._columns:
        if c.is_varbytes:
            cols.append(list(c.varbytes.to_host(as_str=False)))
        else:
            cols.append(c.data.cpu().numpy().view(
                f"u{c.data.element_size()}").tolist())
    return sorted(zip(*cols))


def _all_routes(value):
    J.STREAM_PLAN = value
    S.PARTITION_KERNEL = value
    SO.STREAM_SETOP = value


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("width,long_payload", [(12, False), (20, True),
                                                (40, False)])
def test_string_join_on_card(cuda, world, width, long_payload):
    """The varbytes-key inner join on the card, kernel route against the
    plain route: 12- and 20-byte keys join through K3 in hash mode (4 and
    6 verify lanes) with their words as K4 payload lanes; 40-byte keys on
    the content hash; a 52-byte payload gathers per shard."""
    rng = np.random.default_rng(width)
    n = 40_000
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world)) \
        if world > 1 else ct.CylonContext.Init()
    left = _string_table(ctx, rng.integers(0, n // 4, n), width,
                         rng.normal(size=n).astype(np.float32),
                         long_payload)
    right = _string_table(ctx, rng.integers(0, n // 4, n), width,
                          rng.normal(size=n).astype(np.float32))

    def run():
        if world > 1:
            return left.distributed_join(right, "inner", on=["k"],
                                         force_exchange=True)
        return left.join(right, "inner", on=["k"])

    seen = []
    real = K.join_plan_stream

    def spy(**kw):
        seen.append(len(kw.get("verify_lanes", ())))
        return real(**kw)

    K.reset_launches()
    K.join_plan_stream = spy
    try:
        got = run()
        torch.cuda.synchronize()
    finally:
        K.join_plan_stream = real
    assert K.LAUNCHES["join_expand_stream"] == 1
    assert seen == [{12: 4, 20: 6, 40: 4}[width]], seen
    if world > 1:
        assert K.LAUNCHES["partition_scatter"] >= 1
    _all_routes(False)
    try:
        exp = run()
    finally:
        _all_routes(None)
    assert got.row_count == exp.row_count > 0
    assert _string_rows(got) == _string_rows(exp)


def test_k3_hash_mode_six_verify_lanes(cuda):
    """K3 in hash mode with 6 verify lanes (a 5-word key plus its length)
    and 7 + 2 payload lanes, against its plain version."""
    from cylon_tpu_torch.data import table as T

    rng = np.random.default_rng(6)
    n = 30_000
    ctx = ct.CylonContext.Init()
    left = _string_table(ctx, rng.integers(0, n // 3, n), 20,
                         rng.normal(size=n).astype(np.float32))
    right = _string_table(ctx, rng.integers(0, n // 3, n), 20,
                          rng.normal(size=n).astype(np.float32))
    lk, lkv, raw = T._expanded_keys(left._columns[:1], right._columns[:1])
    rk, rkv, _ = T._expanded_keys(right._columns[:1], left._columns[:1])
    lbits, lv = J.key_bits(T._rows(lk), T._rows(lkv), raw)
    rbits, rv = J.key_bits(T._rows(rk), T._rows(rkv), raw)
    ldat, lval, _s = T.lane_payload(left._columns)
    rdat, rval, _s = T.lane_payload(right._columns, skip={0})
    ldat, lval, rdat, rval = (T._rows(x) for x in (ldat, lval, rdat, rval))
    a_desc, b_desc = J.plan_lane_descs(ldat, lval, rdat, rval,
                                       J.JoinType.INNER)
    kw = J.stream_sort(J.stream_sort_keys(
        lbits, lv, None, rbits, rv, None, ldat, lval, rdat, rval,
        J.JoinType.INNER, a_desc, b_desc, hash_mode=True))
    assert len(kw["verify_lanes"]) == 6 and len(kw["lanes"]) == 7
    _plan_equal(K.plain_join_plan_stream(**kw), K.join_plan_stream(**kw))


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("width", [12, 60])
def test_string_shuffle_compact_output_on_card(cuda, world, width):
    """A shuffle of a few string rows (all on shard 0: the compact route;
    60-byte rows move through their own word exchange) lands in compact
    shards; shuffling that again by another key runs K1/K2 on them. Rows,
    words and starts equal the CPU's."""
    from cylon_tpu_torch.parallel import dist_ops as D

    rng = np.random.default_rng(width + world)
    n = 7
    ks = rng.integers(0, 1 << 20, n)
    v = rng.integers(0, 3, n).astype(np.float32)
    res = []
    for dev in ("cuda", "cpu"):
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world),
                                              device=dev)
        t = _string_table(ctx, ks, width, v)
        first = D.shuffle(t, ["k"])
        assert first.capacity // world <= 8
        K.reset_launches()
        second = D.shuffle(first, ["v"])
        if dev == "cuda":
            torch.cuda.synchronize()
            assert K.LAUNCHES["partition_hist"] >= 2
            assert K.LAUNCHES["partition_scatter"] >= 1
        res.append((first, second))
    for g, c in zip(res[0], res[1]):
        assert torch.equal(g.emit_mask().cpu(), c.emit_mask())
        gv, cv = g._columns[0].varbytes, c._columns[0].varbytes
        assert torch.equal(gv.words.cpu(), cv.words)
        assert torch.equal(gv.starts.cpu(), cv.starts)
        assert _string_rows(g) == _string_rows(c)


# ---------------------------------------------------------------------------
# the ring and broadcast joins, the salted shuffle, the chunked exchange
# and the memory pool on the card, against the same calls on the CPU
# ---------------------------------------------------------------------------


def _shard_multisets(t, world):
    """Each shard's live rows (validity-masked data bits), sorted."""
    live = t.emit_mask().cpu().numpy()
    cap = live.shape[0] // world
    cols = np.stack([np.where(c.valid_mask().cpu().numpy(),
                              c.data.cpu().numpy().view(
                                  f"u{c.data.element_size()}").astype(
                                      np.int64), -1)
                     for c in t._columns], 1)
    out = []
    for s in range(world):
        rows = cols[s * cap:(s + 1) * cap][live[s * cap:(s + 1) * cap]]
        out.append(rows[np.lexsort(rows.T[::-1])] if len(rows) else rows)
    return out


def _join_pair(n, m, seed, keys):
    rng = np.random.default_rng(seed)
    return ({"k": rng.integers(0, keys, n).astype(np.int32),
             "v": rng.normal(size=n).astype(np.float32)},
            {"k": rng.integers(0, keys, m).astype(np.int32),
             "w": rng.normal(size=m).astype(np.float32)})


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("how", ["inner", "left", "right"])
def test_ring_join_on_card(cuda, world, how):
    """Every ring step runs K3 and K4 on the card; each shard's rows equal
    the CPU ring's."""
    la, ra = _join_pair(30_000, 20_000, world, 5_000)
    res = []
    for ctx in _ctx_pair(cuda, world):
        K.reset_launches()
        out = _table(ctx, la).distributed_join(_table(ctx, ra), how,
                                               on=["k"], comm="ring")
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
            assert K.LAUNCHES["join_plan_stream"] == world
            assert K.LAUNCHES["join_expand_stream"] == world
        res.append(out)
    assert res[0].capacity == res[1].capacity
    for a, b in zip(_shard_multisets(res[0], world),
                    _shard_multisets(res[1], world)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("how,side", [("inner", 0), ("inner", 1),
                                      ("left", 1), ("right", 0)])
def test_broadcast_join_on_card(cuda, world, how, side):
    """No partition kernel runs; K3 and K4 join each shard's probe rows
    against the replicated build side; each shard's rows equal the
    CPU's."""
    la, ra = _join_pair(40_000, 400, world, 300)
    if side == 0:
        la, ra = ra, la
    res = []
    for ctx in _ctx_pair(cuda, world):
        K.reset_launches()
        out = _table(ctx, la).distributed_join(
            _table(ctx, ra), how, on=["k"], comm="broadcast",
            build_side=side)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
            assert K.LAUNCHES["partition_hist"] == 0
            assert K.LAUNCHES["partition_scatter"] == 0
            assert K.LAUNCHES["join_plan_stream"] == 1
            assert K.LAUNCHES["join_expand_stream"] == 1
        res.append(out)
    for a, b in zip(_shard_multisets(res[0], world),
                    _shard_multisets(res[1], world)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("world", [4, 8])
def test_salted_shuffle_on_card(cuda, world):
    """The salted routing and its exchange (K1/K2) on the card land every
    row where the CPU's do."""
    from cylon_tpu_torch.parallel import dist_ops as D

    rng = np.random.default_rng(world)
    n = 50_000
    arrays = {"k": np.where(rng.random(n) < 0.7, 7, rng.integers(
        0, 1 << 20, n)).astype(np.int32),
        "v": np.arange(n, dtype=np.float32)}
    res = []
    for ctx in _ctx_pair(cuda, world):
        K.reset_launches()
        res.append(D.shuffle(_table(ctx, arrays), ["k"], salted=True))
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
            assert K.LAUNCHES["partition_hist"] >= 2
            assert K.LAUNCHES["partition_scatter"] == 1
    g, c = res
    assert g._hash_partitioned is None
    live = c.emit_mask()
    assert torch.equal(g.emit_mask().cpu(), live)
    for a, b in zip(g._columns, c._columns):
        assert torch.equal(a.data.cpu()[live], b.data[live])


@pytest.mark.parametrize("world", [1, 4, 8])
@pytest.mark.parametrize("plan", ["knob", "remainder"])
def test_chunked_exchange_on_card(cuda, world, plan, monkeypatch):
    """The chunked exchange on the card equals its single-shot form and the
    CPU's chunked exchange on every live row."""
    rng = np.random.default_rng(world)
    n = 200_000
    host = {"a": rng.integers(0, 1 << 30, n).astype(np.int32),
            "b": rng.normal(size=n).astype(np.float32),
            "c": rng.integers(-(1 << 60), 1 << 60, n),
            "d": rng.random(n) < 0.5}
    targets = rng.integers(0, world, n).astype(np.int32)
    emit = rng.random(n) < 0.9
    monkeypatch.setenv("CYLON_EXCHANGE_CHUNK_BYTES", "65536")
    if plan == "remainder":
        monkeypatch.setattr(S, "_chunk_plan", lambda block, w, rb: (
            1000, -(-block // 1000)))
    res = {}
    for (dev, ctx), overlap in (((d, c), o) for d, c in zip(
            ("cuda", "cpu"), _ctx_pair(cuda, world)) for o in ("1", "0")):
        monkeypatch.setenv("CYLON_EXCHANGE_OVERLAP", overlap)
        res[dev, overlap] = S.exchange(
            {k: torch.from_numpy(v).to(ctx.device) for k, v in host.items()},
            torch.from_numpy(targets).to(ctx.device),
            torch.from_numpy(emit).to(ctx.device), ctx)
    base = res["cpu", "0"]
    assert res["cuda", "1"][3]["chunks"] > 1
    assert res["cpu", "1"][3]["chunks"] == res["cuda", "1"][3]["chunks"]
    for key, (out, e, cap, meta) in res.items():
        assert cap == base[2] and meta["block"] == base[3]["block"], key
        assert torch.equal(e.cpu(), base[1]), key
        assert torch.equal(meta["counts_in"].cpu(), base[3]["counts_in"])
        for k in host:
            assert torch.equal(out[k].cpu()[base[1]],
                               base[0][k][base[1]]), (key, k)


def test_memory_pool_on_card(cuda):
    """On CUDA the pool reads the caching allocator: the limit is the
    card's total memory, the live bytes follow an allocation, and the
    budgets are set."""
    ctx = ct.CylonContext.Init()
    pool = ctx.memory_pool
    total = torch.cuda.get_device_properties(cuda).total_memory
    used0, _peak, limit = pool.snapshot()
    assert limit == total
    x = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    used1 = pool.bytes_allocated()
    assert used1 >= used0 + (64 << 20)
    assert pool.available_bytes() == total - used1
    assert pool.comm_budget_bytes() == int((total - used1) * 0.25)
    assert pool.peak_bytes() >= used1
    del x


def _virtual_exports(device, cases) -> dict:
    """The virtual world's export of each multi-process case at W = 4 on
    ``device`` (the card's default routes: K1-K4 launch)."""
    import torch_port_mp_child as child

    vctx = ct.CylonContext.InitDistributed(
        ct.VirtualWorldConfig(child.WORLD), device=device)
    return {case: child.run_export(ct, vctx, case) for case in cases}


def test_one_rank_nccl_group_on_card(cuda):
    """A process group of one process and four shards on NCCL (the
    default backend on CUDA, its device cuda:rank) runs every
    multi-process case as the virtual world does, shard for shard, bit
    for bit; K1-K4 launch; finalize destroys the group."""
    import torch.distributed as dist
    import torch_port_mp_child as child

    exp = _virtual_exports(cuda, child.CASES)
    pctx = ct.CylonContext.InitDistributed(ct.MultiHostConfig(
        num_processes=1, shards_per_process=child.WORLD))
    try:
        assert pctx.comm.backend == "nccl" and pctx.device.index == 0
        K.reset_launches()
        for case in child.CASES:
            child.assert_same_export([child.run_export(ct, pctx, case)],
                                     exp[case])
        missing = [k for k in ("partition_hist", "partition_scatter",
                               "join_plan_stream", "join_expand_stream")
                   if K.LAUNCHES[k] == 0]
        assert not missing, missing
    finally:
        pctx.finalize()
    assert not dist.is_initialized()


def test_two_gloo_processes_share_the_card(cuda, tmp_path):
    """Two processes of two shards each on cuda:0 (gloo, staged through
    host memory: NCCL refuses two ranks on one device) equal the virtual
    world shard for shard on every multi-process case. The processes
    load the kernels built here."""
    import torch_port_mp_child as child

    K.build()
    procs = child.start(tmp_path, 2, 2, "ops", "default", "cuda:0")
    exp = _virtual_exports(cuda, child.CASES)
    parts = child.finish(tmp_path, procs, timeout=600)
    for case in child.CASES:
        child.assert_same_export([p[case] for p in parts], exp[case])


def _pipeline_rows(ctx, world_tables):
    """The planned join -> groupby of bench_plan_pipeline at small size,
    and its (key, sum) rows sorted by key, host numpy."""
    left, right = world_tables
    out = ct.plan.scan(left).join(ct.plan.scan(right), on="k") \
        .groupby("lt-0", ["rt-4"], ["sum"]).execute()
    live = out.emit_mask()
    k = out._columns[0].data[live].cpu().numpy()
    s = out._columns[1].data[live].cpu().numpy().astype(np.float64)
    o = np.argsort(k)
    return k[o], s[o]


@pytest.mark.parametrize("world", [1, 4])
def test_planned_pipeline_on_card(cuda, world):
    """The planned pipeline on the card equals its CPU run: group keys
    exact, sums within 1e-5 x sum |x| of their group; K1-K4 launch at
    world 4 (K3/K4 at world 1)."""
    rng = np.random.default_rng(9)
    n = 40_000
    arrays = {"l": {"k": rng.integers(0, n // 4, n).astype(np.int32),
                    "v": rng.normal(size=n).astype(np.float32),
                    "z": rng.integers(0, 50, n).astype(np.int32)},
              "r": {"k": rng.integers(0, n // 4, n).astype(np.int32),
                    "w": rng.normal(size=n).astype(np.float32)}}
    res = {}
    for dev in ("cpu", "cuda"):
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world),
                                              device=dev) \
            if world > 1 else ct.CylonContext.Init(device=dev)
        tables = (ct.Table.from_pydict(ctx, arrays["l"]),
                  ct.Table.from_pydict(ctx, arrays["r"]))
        K.reset_launches()
        res[dev] = _pipeline_rows(ctx, tables)
        if dev == "cuda":
            torch.cuda.synchronize()
            need = ["join_plan_stream", "join_expand_stream"] + (
                ["partition_hist", "partition_scatter"] if world > 1 else [])
            assert all(K.LAUNCHES[k] > 0 for k in need), K.LAUNCHES
    (kc, sc), (kg, sg) = res["cpu"], res["cuda"]
    assert np.array_equal(kc, kg)
    cl = np.bincount(arrays["l"]["k"], minlength=n // 4)
    scale = np.array([cl[k] * np.abs(arrays["r"]["w"][arrays["r"]["k"] == k]
                                     ).astype(np.float64).sum() for k in kc])
    assert np.all(np.abs(sc - sg) <= 2e-5 * scale + 1e-30)


def test_spans_carry_hbm_delta_on_card(cuda):
    """On the card every span of a planned query carries the allocator's
    hbm_delta and hbm_peak, and the report samples the pool."""
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    rng = np.random.default_rng(3)
    t = ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, 500, 20_000).astype(np.int32),
        "v": rng.normal(size=20_000).astype(np.float32)})
    q = ct.plan.scan(t).join(ct.plan.scan(t), on="k")
    q.execute(analyze=True)
    spans = list(q.last_report.span.walk())
    assert len(spans) > 3
    assert all("hbm_delta" in s.attrs and "hbm_peak" in s.attrs
               for s in spans)
    assert q.last_report.span.attrs["hbm_peak"] > 0
    assert q.last_report.memory["hbm_live_bytes"] > 0
    assert q.last_report.leaks == []


def _service_rows(ctx, world_tables, queries: int = 4):
    """_pipeline_rows's query served by a QueryService (tenants t0 and t1
    in turns): every served result's (key, sum) rows."""
    from cylon_tpu_torch.service import QueryService

    left, right = world_tables
    svc = QueryService(name="gpu-test", start=False)
    tickets = [svc.submit(ct.plan.scan(left).join(ct.plan.scan(right),
                                                  on="k")
                          .groupby("lt-0", ["rt-4"], ["sum"]),
                          tenant=f"t{i % 2}") for i in range(queries)]
    svc.start()
    svc.drain(timeout=600)
    svc.close()
    assert [tk.outcome for tk in tickets] == ["ok"] * queries
    rows = []
    for tk in tickets:
        out = tk.result(timeout=60)
        assert out._columns[0].data.device == ctx.device
        live = out.emit_mask()
        k = out._columns[0].data[live].cpu().numpy()
        s = out._columns[1].data[live].cpu().numpy().astype(np.float64)
        o = np.argsort(k)
        rows.append((k[o], s[o]))
    return rows


@pytest.mark.parametrize("world", [1, 4])
def test_service_on_card(cuda, world):
    """Queries served by the QueryService's worker thread on the card
    equal the CPU's served results (keys exact, sums within 1e-5 x sum
    |x| of their group), K1-K4 launch (K3/K4 at world 1), and the
    context's device carries its index."""
    rng = np.random.default_rng(24)
    n = 40_000
    arrays = {"l": {"k": rng.integers(0, n // 4, n).astype(np.int32),
                    "v": rng.normal(size=n).astype(np.float32),
                    "z": rng.integers(0, 50, n).astype(np.int32)},
              "r": {"k": rng.integers(0, n // 4, n).astype(np.int32),
                    "w": rng.normal(size=n).astype(np.float32)}}
    res = {}
    for dev in ("cpu", "cuda"):
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world),
                                              device=dev) \
            if world > 1 else ct.CylonContext.Init(device=dev)
        if dev == "cuda":
            assert ctx.device.index is not None
        tables = (ct.Table.from_pydict(ctx, arrays["l"]),
                  ct.Table.from_pydict(ctx, arrays["r"]))
        K.reset_launches()
        res[dev] = _service_rows(ctx, tables)
        if dev == "cuda":
            torch.cuda.synchronize()
            need = ["join_plan_stream", "join_expand_stream"] + (
                ["partition_hist", "partition_scatter"] if world > 1 else [])
            assert all(K.LAUNCHES[k] >= 4 for k in need), K.LAUNCHES
    cl = np.bincount(arrays["l"]["k"], minlength=n // 4)
    for (kc, sc), (kg, sg) in zip(res["cpu"], res["cuda"]):
        assert np.array_equal(kc, kg)
        scale = np.array([cl[k] * np.abs(
            arrays["r"]["w"][arrays["r"]["k"] == k]).astype(np.float64).sum()
            for k in kc])
        assert np.all(np.abs(sc - sg) <= 2e-5 * scale + 1e-30)


def test_force_syncs_the_card(cuda, monkeypatch):
    """benchutils' timer forces a CUDA result with one synchronize of its
    card, whatever container holds it; a CPU result syncs nothing."""
    from cylon_tpu_torch import benchutils

    seen = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: (seen.append(device),
                                             real(device)))
    ctx = ct.CylonContext.Init()
    t = ct.Table.from_pydict(ctx, {"a": np.arange(10)})
    benchutils._force({"t": t, "x": [torch.ones(3, device=cuda), (t,)]})
    assert seen == [ctx.device]
    seen.clear()
    benchutils._force([torch.ones(3)])
    assert seen == []
    ms, out = benchutils.benchmark_with_repetitions(3)(lambda: t)()
    assert out is t and len(seen) == 3 and ms > 0


def test_profiler_records_a_library_load(cuda):
    """A library loaded while the profiler is on gets one record: its
    nvcc seconds in this process (0.0 when loaded from _build/) and the
    ptxas resources of each of its kernels, read from its build log."""
    from cylon_tpu_torch.telemetry import profiler

    K.build(["stream_compact"])
    K.load_library.cache_clear()
    profiler.reset()
    profiler.enable()
    try:
        lib = K.load_library("stream_compact")
    finally:
        profiler.disable()
    assert lib.cylon_library == "stream_compact"
    recs = profiler.records()
    assert len(recs) == 1 and recs[0]["factory"] == "stream_compact"
    assert recs[0]["compile_s"] == round(
        K.BUILD_SECONDS.get("stream_compact", 0.0), 6)
    assert recs[0]["flops"] is None and recs[0]["bytes_accessed"] is None
    kern = recs[0]["kernels"]
    assert kern and all(v["registers"] > 0 for v in kern.values())
    assert any("compact" in name for name in kern)
    profiler.reset()


@pytest.mark.parametrize("world", [4, 8])
def test_task_exchange_on_card(cuda, world):
    """plan.task_exchange on the card (K1/K2) equals its CPU run shard for
    shard, in order, the __task__ column included."""
    from cylon_tpu_torch.plan.tasks import LogicalTaskPlan, task_exchange

    rng = np.random.default_rng(world)
    n = 50_003
    arrays = {"v": np.arange(n, dtype=np.int64),
              "z": rng.normal(size=n).astype(np.float32)}
    tasks = rng.integers(0, 64, n)
    plan = LogicalTaskPlan({t: (t * 5) % world for t in range(64)}, world)
    out = {}
    for dev in ("cpu", "cuda"):
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world),
                                              device=dev)
        K.reset_launches()
        r = task_exchange(ct.Table.from_pydict(ctx, arrays), tasks, plan,
                          ctx)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert K.LAUNCHES["partition_hist"] > 0 \
                and K.LAUNCHES["partition_scatter"] > 0, K.LAUNCHES
        emit = r.emit_mask().cpu()
        out[dev] = (emit, [c.data.cpu() for c in r._columns])
    (ec, cc), (eg, cg) = out["cpu"], out["cuda"]
    assert torch.equal(ec, eg)
    for a, b in zip(cc, cg):
        assert torch.equal(a[ec], b[eg])


def test_collectives_catalog_on_card(cuda):
    """The analysis suite's collectives catalog on CUDA tensors at world
    4, under its dispatch mode: no finding, and K1-K9 each launch (the
    kernel route switches forced on, as on the CPU)."""
    import os

    from cylon_tpu_torch import analysis as A

    root = os.path.dirname(os.path.abspath(ct.__file__))
    K.reset_launches()
    res = A.run_checkers(A.AnalysisContext(root, {"device": "cuda"}),
                         ["collectives"])
    torch.cuda.synchronize()
    assert res.ok, res.format_text()
    assert all(K.LAUNCHES[k] > 0 for k in K.KERNELS), K.LAUNCHES
    assert J.STREAM_PLAN is None and SO.STREAM_SETOP is None \
        and S.PARTITION_KERNEL is None


def test_wrappers_do_not_sync(cuda):
    """Each kernel wrapper, at the inputs a world-4 join, a local UNION,
    a groupby's float SUM and a world-1 join on an int64 key (the hash
    stream) give it, launches under set_sync_debug_mode("error") (which
    does raise on a sync): the runtime side of hostsync/in-launch."""
    import chip_smoke

    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    left, right, _h = chip_smoke.make_tables(ct, dctx, 100_000, 0)
    lctx = ct.CylonContext.Init()
    a, b, _h = chip_smoke.make_setop_tables(ct, lctx, 100_000, 3)
    rng = np.random.default_rng(9)
    wide = _table(lctx, {"k": rng.integers(0, 50_000, 100_000),
                         "v": rng.random(100_000)})
    with chip_smoke.Recorder(K) as rec:
        left.distributed_join(right, "inner", on=["k"], force_exchange=True)
        a.union(b)
        left.groupby(0, [1], ["sum"])
        wide.join(wide, "inner", on=["k"])
    torch.cuda.synchronize()
    assert sorted(rec.calls) == sorted(K.KERNELS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.ones(1, device=cuda).item()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = chip_smoke.wrappers_sync_free(K, rec.calls)
    assert all(v >= 1 for v in launched.values())


def test_write_csv_of_a_cuda_table(cuda, tmp_path):
    """A world-4 CUDA table (masked rows, a null) writes through the host
    library in one fetch, byte for byte as its CPU twin does."""
    from cylon_tpu_torch import native

    rng = np.random.default_rng(26)
    n = 30_011
    v = rng.normal(size=n)
    v[::17] = np.nan
    arrays = {"k": rng.integers(-9, 9, n).astype(np.int32), "v": v,
              "f": rng.normal(size=n).astype(np.float32),
              "u": rng.integers(0, 2**40, n).astype(np.uint64)}
    texts = {}
    for dev in ("cpu", "cuda"):
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                              device=dev)
        t = ct.Table.from_pydict(ctx, arrays)
        t = t[t["k"] > -5]
        before = native.CALLS["write_csv"]
        t.to_csv(str(tmp_path / f"{dev}.csv"))
        assert native.CALLS["write_csv"] == before + 1
        texts[dev] = (tmp_path / f"{dev}.csv").read_text()
    assert texts["cpu"] == texts["cuda"]
    assert len(texts["cuda"].splitlines()) == 1 + int(
        (arrays["k"] > -5).sum())


def test_distribute_by_key_on_card(cuda):
    """distribute_by_key on CUDA: the host library places the rows (its
    call counted), every shard equals the CPU run's, and the witness lets
    distributed_join skip that side's exchange."""
    from cylon_tpu_torch import native
    from cylon_tpu_torch.parallel import dist_ops as D
    from cylon_tpu_torch.parallel import shard as SH

    rng = np.random.default_rng(27)
    n = 200_003
    arrays = {"k": rng.integers(0, n, n).astype(np.int32),
              "v": rng.normal(size=n).astype(np.float32)}
    other = {"k": rng.integers(0, n, n).astype(np.int32),
             "w": rng.normal(size=n).astype(np.float32)}
    out = {}
    for dev in ("cpu", "cuda"):
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                              device=dev)
        before = native.CALLS["hash_partition"]
        d = SH.distribute_by_key(ct.Table.from_pydict(ctx, arrays), ctx,
                                 ["k"])
        assert native.CALLS["hash_partition"] == before + 1
        assert D.shuffle(d, ["k"]) is d
        j = d.distributed_join(ct.Table.from_pydict(ctx, other), "inner",
                               on=["k"])
        out[dev] = ([c.data.cpu() for c in d._columns],
                    d.emit_mask().cpu(), j.row_count)
    (cc, ec, rc), (cg, eg, rg) = out["cpu"], out["cuda"]
    assert torch.equal(ec, eg) and rc == rg
    for a, b in zip(cc, cg):
        assert torch.equal(a, b)


def test_c_binding_on_card(cuda, tmp_path):
    """The C binding on ``cuda``: its join launches K3 and K4, and its row
    count and file equal its run on the CPU."""
    import json

    from cylon_tpu_torch import cbind

    rng = np.random.default_rng(28)
    paths = []
    for side in ("l", "r"):
        n = 20_000
        k = rng.integers(0, 5000, n)
        v = rng.normal(size=n)
        p = tmp_path / f"{side}.csv"
        p.write_text("k,v\n" + "".join(f"{a},{b!r}\n" for a, b in zip(k, v)))
        paths.append(str(p))
    rows, texts = {}, {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / f"{dev}.csv"
        stdout = cbind.execute(*paths, str(out), dev)
        rows[dev] = int(stdout.split("rows=")[1].split()[0])
        texts[dev] = sorted(out.read_text().splitlines())
        launches = json.loads(stdout.split("LAUNCHES ")[1].splitlines()[0])
        if dev == "cuda":
            assert launches["join_plan_stream"] > 0
            assert launches["join_expand_stream"] > 0
    assert rows["cpu"] == rows["cuda"] > 0
    assert texts["cpu"] == texts["cuda"]


# -- the drills of scripts/torch_port on the card -------------------------

DRILL_DIR = __import__("pathlib").Path(__file__).resolve().parent.parent \
    / "scripts" / "torch_port"


def _run_drill(name, *args):
    import json
    import subprocess
    import sys

    r = subprocess.run([sys.executable, str(DRILL_DIR / f"{name}.py"),
                        *args, "--device", "cuda"], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    doc = json.loads([l for l in r.stdout.splitlines() if l.strip()][-1])
    assert doc["device"] == "cuda"
    return doc


def test_drill_smoke_telemetry_on_card(cuda):
    """The telemetry smoke on ``cuda``: the compile profiler records the
    kernel libraries the process loads, and K1-K4 run its pipeline."""
    doc = _run_drill("smoke_telemetry")
    assert doc["compiles"] >= 1 and doc["library_loads"] >= 1
    assert doc["hbm_peak"] > 0 and doc["dump_bytes_in_use"] > 0
    assert all(doc["launches"][k] > 0 for k in K.KERNELS[:4])


def test_drill_smoke_service_on_card(cuda):
    """The service smoke on ``cuda``: the process's first query loads a
    kernel library, no query after the first service query does."""
    doc = _run_drill("smoke_service")
    assert doc["first_query_builds"] >= 1
    assert doc["builds_after_first_service_query"] == 0
    assert doc["plan_cache_hits"] >= 7


def test_drill_smoke_obs_on_card(cuda):
    doc = _run_drill("smoke_obs")
    a, b = doc["trace_lines"]
    assert b < a and doc["sampled_out"] > 0


def test_drill_smoke_stats_on_card(cuda):
    """The statistics smoke on ``cuda`` reaches the CPU's decisions: the
    real comm budget is far above the clamp, which decides."""
    doc = _run_drill("smoke_stats")
    assert doc["decisions"] == ["shed", "ok", "shed"]
    assert doc["comm_budget"] > doc["clamp"]


def test_drill_chaos_on_card(cuda):
    """One chaos seed on ``cuda`` in a fresh process: all ten scenarios
    run, ``compile`` retried (a load from the on-disk cache is a build
    arrival), K1-K4 launched."""
    doc = _run_drill("chaos", "--seed", "0")
    ran = doc["scenarios"]
    assert len(ran) == 10 and not any("skipped" in v for v in ran.values())
    assert ran["compile"]["retries"] >= 1
    assert ran["persistent"]["error"] == "CylonTransientError"
    assert ran["persistent"]["dump_sites"] == ["exchange"]
    assert all(doc["launches"][k] > 0 for k in K.KERNELS[:4])


def test_drill_fuzz_differential_on_card(cuda):
    """The differential fuzzer on ``cuda`` at 6 cases: no failing seed,
    K1-K6 launched (K1/K2 in the cases on the kernel route)."""
    doc = _run_drill("fuzz_differential", "6")
    assert doc["failed_seeds"] == []
    assert all(doc["launches"][k] > 0 for k in K.KERNELS), doc["launches"]


def test_unretained_inputs_freed_on_card(cuda):
    """retain_memory(False) on ``cuda``: the shuffle join clears both
    inputs, which then hold no device tensor."""
    rng = np.random.default_rng(29)
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                          device="cuda")
    n = 100_000
    a = ct.Table.from_pydict(ctx, {"k": rng.integers(0, n, n).astype(
        np.int32), "v": rng.normal(size=n).astype(np.float32)})
    b = ct.Table.from_pydict(ctx, {"k": rng.integers(0, n, n).astype(
        np.int32), "w": rng.normal(size=n).astype(np.float32)})
    keep = a.distributed_join(b, "inner", on=["k"]).row_count
    a.retain_memory(False)
    b.retain_memory(False)
    out = a.distributed_join(b, "inner", on=["k"])
    assert out.row_count == keep > 0
    assert a.column_count == 0 and b.column_count == 0
    assert a.nbytes == 0 and b.nbytes == 0


# ---------------------------------------------------------------------------
# K7 segment_sum and bit-reproducible float group sums (F17)
# ---------------------------------------------------------------------------


def _segment_inputs(dev, rng, w, n, dtype, case):
    """[W, n] sorted K7 inputs: live rows first (a random prefix a
    shard, one shard empty in "empty_shard"), dense group ids; values
    across six orders of magnitude, so any other summation order changes
    the last bits."""
    x = rng.normal(size=(w, n)) * rng.choice(np.array([1e-3, 1.0, 1e3]),
                                             (w, n))
    live = rng.integers(0, n + 1, w)
    live[0] = n
    if case == "empty_shard":
        live[-1] = 0
    emit = np.arange(n)[None, :] < live[:, None]
    if case == "one_group":
        starts = np.zeros((w, n), bool)
    elif case == "singletons":
        starts = np.ones((w, n), bool)
    elif case == "edges":   # runs ending just before, at and after the
        # row where a start thread hands its group on (256) and the ends
        # of the block route's chunks (1,120 rows)
        lens = np.array([255, 256, 257, 1375, 1376, 1377, 2495, 2496, 2497,
                         1, 8, 9])
        ends = np.cumsum(np.tile(lens, n // int(lens.sum()) + 1))
        starts = np.zeros((w, n), bool)
        starts[:, ends[ends < n]] = True
    else:   # runs of 1 to ~n/3 rows
        starts = rng.random((w, n)) < 0.05
        starts[:, n // 3:n // 3 + n // 4] = False
    starts[:, 0] = True
    gid = np.cumsum(starts & emit, 1) - 1
    gid = np.where(emit, gid, gid.max(1, keepdims=True))
    return (torch.from_numpy(x).to(dtype).to(dev),
            torch.from_numpy(gid.astype(np.int64)).to(dev),
            torch.from_numpy(emit).to(dev))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("case,w,n", [("mixed", 4, 100_003),
                                      ("one_group", 2, 300_000),
                                      ("edges", 2, 40_000),
                                      ("singletons", 3, 50_000),
                                      ("empty_shard", 4, 7),
                                      ("mixed", 1, 1)])
def test_segment_sum_matches_plain(cuda, dtype, case, w, n):
    """K7 against its plain version (the host's row-order sum) bit for
    bit, and against itself in a second launch."""
    rng = np.random.default_rng(hash((case, w, n)) % 2**32)
    x, gid, emit = _segment_inputs(cuda, rng, w, n, dtype, case)
    s = max(n, 1)
    K.reset_launches()
    got = K.segment_sum(x, gid, emit, s)
    again = K.segment_sum(x, gid, emit, s)
    assert K.LAUNCHES["segment_sum"] == 2
    ref = K.plain_segment_sum(x, gid, emit, s)
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    assert got.dtype == dtype and got.shape == (w, s)
    assert torch.equal(got.view(bits), ref.view(bits))
    assert torch.equal(got.view(bits), again.view(bits))


def _bits_rows(t):
    live = t.emit_mask().cpu().numpy()
    return [(c.valid_mask().cpu().numpy()[live],
             c.data.cpu().numpy()[live].view(np.uint8)) for c in t._columns]


@pytest.mark.parametrize("world", [0, 4])
@pytest.mark.parametrize("what", ["groupby", "join_groupby"])
def test_group_sums_bit_reproducible_on_card(cuda, world, what):
    """The float SUM and MEAN of a groupby (world 1 and 4) and of a join
    -> groupby (world 4) run twice on the card: bit-equal to each other
    and to the CPU port's with the route switches on (same call sites,
    the kernels' plain versions)."""
    from cylon_tpu_torch.parallel import dist_ops as D

    if what == "join_groupby" and world == 0:
        pytest.skip("the join -> groupby runs at world 4")
    rng = np.random.default_rng(17)
    n = 200_000
    g = rng.integers(0, 300, n).astype(np.int32)
    x = (rng.normal(size=n) * rng.choice(np.array([1e-3, 1.0, 1e3]), n)
         ).astype(np.float32)
    # the join: 50,000 rows a side, keys in [0, 20,000): ~125,000 rows
    ka = rng.integers(0, 20_000, 50_000).astype(np.int32)
    kb = rng.integers(0, 20_000, 50_000).astype(np.int32)
    gctx, cctx = _ctx_pair(cuda, world)

    def run(ctx):
        if what == "groupby":
            return _table(ctx, {"g": g, "x": x}).groupby(
                0, [1, 1], ["sum", "mean"])
        a = _table(ctx, {"k": ka, "x": x[:50_000]})
        b = _table(ctx, {"k": kb, "y": x[-50_000:]})
        j = D.distributed_join(a, b, ct.JoinConfig(ct.JoinType.INNER, [0],
                                                   [0]))
        return D.distributed_groupby(j, [0], [3, 3], [ct.AggregationOp.SUM,
                                                      ct.AggregationOp.MEAN])

    first, second = _bits_rows(run(gctx)), _bits_rows(run(gctx))
    switches = (J.STREAM_PLAN, S.PARTITION_KERNEL)
    J.STREAM_PLAN = S.PARTITION_KERNEL = True
    try:
        cpu = _bits_rows(run(cctx))
    finally:
        J.STREAM_PLAN, S.PARTITION_KERNEL = switches
    for a, b, c in zip(first, second, cpu):
        for i in range(2):
            assert np.array_equal(a[i], b[i]) and np.array_equal(a[i], c[i])


# K7's list form: every float-sum column of a group-by in one launch

# group lengths around the list form's boundaries: 16-row chunk
# alignment, LONG (256 rows past a tile), a 1,024-row chunk and a
# 2,048-row tile
K7_EDGE_LENGTHS = np.array([1, 15, 16, 17, 255, 256, 257, 1023, 1024, 1025,
                            2047, 2048, 2049, 2303, 2304, 2305, 4097])


def _list_inputs(dev, rng, w, n, case):
    """[W, n] sorted K7 inputs (as _segment_inputs) and five columns: a
    float16, a float32 and a float64 source, the float32 one summed into
    float32 and into float64, the float16 one into float16 and float64."""
    if case == "tile_edges":
        ends = np.cumsum(np.tile(K7_EDGE_LENGTHS, n // int(
            K7_EDGE_LENGTHS.sum()) + 1))
        live = np.full(w, n)
        live[-1] = n - 3001
        emit = np.arange(n)[None, :] < live[:, None]
        starts = np.zeros((w, n), bool)
        starts[:, ends[ends < n]] = True
        starts[:, 0] = True
        gid = np.cumsum(starts & emit, 1) - 1
        gid = np.where(emit, gid, gid.max(1, keepdims=True))
        x = rng.normal(size=(w, n)) * rng.choice(
            np.array([1e-3, 1.0, 1e3]), (w, n))
        x, gid, emit = (torch.from_numpy(x).to(dev),
                        torch.from_numpy(gid.astype(np.int64)).to(dev),
                        torch.from_numpy(emit).to(dev))
    else:
        x, gid, emit = _segment_inputs(dev, rng, w, n, torch.float64, case)
    h, f = (x / 64).to(torch.float16), x.to(torch.float32)
    cols = [h, f, f, x, h]
    accs = [torch.float16, torch.float32, torch.float64, torch.float64,
            torch.float64]
    return cols, accs, gid, emit


@pytest.mark.parametrize("case,w,n", [("one_group", 1, 1 << 22),
                                      ("mixed", 4, 100_003),
                                      ("tile_edges", 2, 60_000),
                                      ("singletons", 3, 50_000),
                                      ("empty_shard", 4, 7)])
def test_segment_sum_columns_match_plain(cuda, case, w, n):
    """One list launch over five columns of three value types and
    accumulators as wide or wider: each column equals its plain version
    bit for bit, and a second launch; one launch is counted."""
    rng = np.random.default_rng(hash((case, w, n, "cols")) % 2**32)
    cols, accs, gid, emit = _list_inputs(cuda, rng, w, n, case)
    s = max(n, 1) if case != "one_group" else 1
    K.reset_launches()
    got = K.segment_sum(cols, gid, emit, s, accs)
    again = K.segment_sum(cols, gid, emit, s, accs)
    assert K.LAUNCHES["segment_sum"] == 2
    ref = K.plain_segment_sum(cols, gid, emit, s, accs)
    for c, acc in enumerate(accs):
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            acc.itemsize]
        assert got[c].dtype == acc and got[c].shape == (w, s)
        assert torch.equal(got[c].view(bits), ref[c].view(bits)), c
        assert torch.equal(got[c].view(bits), again[c].view(bits)), c


@pytest.mark.parametrize("groups", [1, 4, 64])
def test_groupby_one_k7_launch_and_boundary_aggregates(cuda, groups):
    """A SUM + MEAN (+ COUNT and an integer SUM) groupby at world 1
    launches K7 once; every output column is bit-equal run to run and to
    the CPU port's (same call sites, the kernels' plain versions)."""
    rng = np.random.default_rng(groups)
    n = 1 << 20
    arrays = {"g": rng.integers(0, groups, n).astype(np.int32),
              "x": (rng.normal(size=n) * 1e3).astype(np.float32),
              "y": rng.integers(2**31 - 100, 2**31 - 1, n).astype(np.int32)}
    valid = {"y": rng.random(n) < 0.7}
    gctx, cctx = _ctx_pair(cuda, 0)

    def run(ctx):
        return _table(ctx, arrays, valid).groupby(
            0, [1, 1, 2, 2, 2], ["sum", "mean", "count", "sum", "min"])

    K.reset_launches()
    first = run(gctx)
    torch.cuda.synchronize()
    assert K.LAUNCHES["segment_sum"] == 1, dict(K.LAUNCHES)
    second, cpu = _bits_rows(run(gctx)), _bits_rows(run(cctx))
    first = _bits_rows(first)
    assert len(first[0][0]) == groups
    for a, b, c in zip(first, second, cpu):
        for i in range(2):
            assert np.array_equal(a[i], b[i]) and np.array_equal(a[i], c[i])


TOOL_ARGS = {"scaling_sweep": ["14"], "compare_competitors": ["14"],
             "profile_shuffle": ["16"],
             "profile_dist_join": ["16", "--bcast-rows-log2", "16"],
             "profile_stream": ["16"], "profile_join": ["16"]}
TOOL_KERNELS = {"scaling_sweep": K.KERNELS[:4],
                "profile_dist_join": K.KERNELS[:4],
                "profile_shuffle": K.KERNELS[:2],
                "compare_competitors": ("join_plan_stream",
                                        "join_expand_stream", "segment_sum"),
                "profile_stream": K.KERNELS[2:4],
                "profile_join": K.KERNELS[2:4]}


@pytest.mark.parametrize("tool", sorted(TOOL_ARGS))
def test_tool_on_card(cuda, tool, tmp_path):
    """Each measuring tool of scripts/torch_port on ``cuda`` at a small
    size: exit 0, its JSON line (also written to ``--out``), its kernels
    launched."""
    import json
    import subprocess
    import sys

    out = tmp_path / f"{tool}.json"
    r = subprocess.run([sys.executable, str(DRILL_DIR / f"{tool}.py"),
                        *TOOL_ARGS[tool], "--device", "cuda", "--out",
                        str(out)], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    doc = json.loads([l for l in r.stdout.splitlines() if l.strip()][-1])
    assert doc == json.loads(out.read_text())
    assert doc.get("backend", "cuda") == "cuda"
    assert all(doc["launches"][k] > 0 for k in TOOL_KERNELS[tool]), \
        doc["launches"]


def _multiset_bits(table) -> list:
    d = table.to_pydict()
    return sorted(zip(*((v.view(np.int32) if v.dtype == np.float32 else v)
                        .tolist() for v in d.values())))


@pytest.mark.parametrize("world", [256, 512])
def test_world_past_the_bucket_limit_on_card(cuda, world):
    """A virtual world of 256 shards or more on the card takes the stable
    sort's partition (K1/K2 take world + 1 <= MAX_BUCKETS buckets): the
    join launches K3/K4 and no K1/K2, and its rows equal world 4's."""
    rng = np.random.default_rng(world)
    n = 1 << 16
    cols = ({"k": rng.integers(0, n, n).astype(np.int32),
             "v": rng.normal(size=n).astype(np.float32)},
            {"k": rng.integers(0, n, n).astype(np.int32),
             "w": rng.normal(size=n).astype(np.float32)})
    out = {}
    for w in (world, 4):
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(w),
                                              device=cuda)
        left, right = (ct.Table.from_pydict(ctx, c) for c in cols)
        K.reset_launches()
        out[w] = left.distributed_join(right, "inner", on=["k"],
                                       force_exchange=True)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        if w == world:
            assert launches["partition_hist"] == 0
            assert launches["partition_scatter"] == 0
        else:
            assert launches["partition_hist"] > 0
            assert launches["partition_scatter"] > 0
        assert launches["join_plan_stream"] > 0
        assert launches["join_expand_stream"] > 0
    assert out[world].row_count > 0
    assert _multiset_bits(out[world]) == _multiset_bits(out[4])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scalar_float_sums_repeat_on_card(cuda, dtype):
    """A scalar float SUM and MEAN on the card (a torch reduction, not
    K7's row order): the same bits in 5 runs, and within PERF.md section
    2's bound of the CPU port's (SUM 1e-5 * sum |x| + 1e-30, MEAN 1e-12 *
    sum |x| / count), on a world-4 table and a local one."""
    rng = np.random.default_rng(7)
    n = (1 << 20) + 3
    x = rng.normal(size=n).astype(dtype)
    x[::11] = -0.0
    valid = rng.random(n) < 0.9
    scale = float(np.abs(x[valid].astype(np.float64)).sum())
    bound = {"sum": 1e-5 * scale + 1e-30,
             "mean": 1e-12 * scale / int(valid.sum())}

    def table(dev, world):
        from cylon_tpu_torch.parallel import shard

        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(
            world), device=dev) if world else ct.CylonContext.Init(dev)
        t = ct.Table([ct.Column.from_numpy(x, "x", valid, ctx.device)], ctx)
        return shard.distribute(t, ctx) if world else t

    for world in (0, 4):
        t, tc = table(cuda, world), table("cpu", world)
        for op in ("sum", "mean"):
            runs = [getattr(t, op)("x").to_pydict()["x"][0]
                    for _ in range(5)]
            bits = {np.float64(v).view(np.int64).item() for v in runs}
            assert len(bits) == 1, (world, op, runs)
            cpu = getattr(tc, op)("x").to_pydict()["x"][0]
            assert abs(float(runs[0]) - float(cpu)) <= bound[op], \
                (world, op, runs[0], cpu)


STAGE_LEAVES = {
    "join": ("join.prepare", "join.plan.hash", "join.plan.sort",
             "join.plan.stream", "join.materialize", "join.rebuild"),
    "groupby": ("groupby.keys", "groupby.sort", "groupby.gather",
                "groupby.aggregate", "groupby.rebuild"),
}


# rows a side: under a profiler an op pays ~0.5-2 ms of host time outside
# its stages (its own span's bookkeeping, its argument checks, the route
# choice) with the device idle, so the stages hold 86-91% of a 2^22-row
# join or group-by and 91-98% at 2^24 on an H100; since the join's sort
# stage moves its rows as records (K10) a 2^23-row join takes ~13 ms on
# the card, of which they hold ~86%; these sizes keep the device's work
# in front, as the benchmark's cells do (98.7-99.8%)
STAGE_ROWS_LOG2 = {"join": 25, "groupby": 25}


@pytest.mark.parametrize("op", sorted(STAGE_LEAVES))
def test_stage_spans_hold_the_op_device_time(cuda, op):
    """Under torch.profiler a world-1 join on an int64 key (the hash
    stream) and a group-by time their spans on the card: the leaf stages
    hold 90-100% of the op span's device ms, and the op span's device ms
    is within 10% of the whole call timed by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from cylon_tpu_torch import telemetry as tel

    rng = np.random.default_rng(22)
    n = 1 << STAGE_ROWS_LOG2[op]
    ctx = ct.CylonContext.Init()
    if op == "join":
        left, right = (ct.Table.from_pydict(ctx, {
            "k": rng.integers(0, n, n), c: rng.random(n)})
            for c in ("v", "w"))

        def call():
            return left.distributed_join(right, "inner", on="k")
    else:
        t = ct.Table.from_pydict(ctx, {
            "g": rng.integers(0, n // 100, n).astype(np.int32),
            "v1": rng.integers(1, 6, n).astype(np.int32),
            "v3": rng.random(n)})

        def call():
            return t.groupby("g", ["v1", "v3"], ["sum", "sum"])

    call()
    torch.cuda.synchronize()
    before = tel.span_device_times()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ev[0].record()
        out = call()
        ev[1].record()
        torch.cuda.synchronize()
    assert out.row_count > 0
    whole = ev[0].elapsed_time(ev[1])
    got = tel.span_device_times()

    def delta(name):
        was = before.get(name, (0.0, 0))
        return got[name][0] - was[0], got[name][1] - was[1]

    ms, count = delta(op)
    assert count == 1
    leaves = [delta(s) for s in STAGE_LEAVES[op]]
    assert all(c == 1 for _m, c in leaves), leaves
    cover = sum(m for m, _c in leaves) / ms
    assert 0.90 <= cover <= 1.001, (cover, leaves, ms)
    assert abs(ms - whole) <= 0.10 * whole, (ms, whole)


# K10's join cases: (key columns, world, (na, nb) rows a shard, payload
# columns a side (int32 and float32: lanes), validity (key and payload
# nulls, emit masks), join type, hash mode); the hash cases' key lanes
# number 1, 2, 6 and 3, their payload lanes 0, 1, 8 and 4; "six_lanes"
# fills a record's 17 words
PERMUTE_JOIN_CASES = {
    "hash_int32": (("int32",), 1, (40_003, 52_001), 0, False,
                   J.JoinType.INNER, True),
    "hash_int64": (("int64",), 1, (70_001, 65_537), 1, False,
                   J.JoinType.INNER, True),
    "hash_six_lanes": (("int64", "float64", "int16", "bool"), 1,
                       (33_333, 44_444), 4, True, J.JoinType.LEFT, True),
    "hash_mixed_world4": (("int32", "int64"), 4, (10_007, 9_001), 2, True,
                          J.JoinType.RIGHT, True),
    "hash_empty_side": (("int64",), 1, (0, 5_003), 1, False,
                        J.JoinType.INNER, True),
    "bits": (("int32",), 1, (50_001, 61_003), 1, False, J.JoinType.INNER,
             False),
    "bits_world4": (("int32",), 4, (12_289, 8_191), 3, True,
                    J.JoinType.LEFT, False),
}


def permute_join_case(case, dev):
    """``stream_sort_keys``'s arguments of one K10 join case (keys with
    repeats, so equal hashes meet)."""
    names, w, sizes, ncols, nulls, jt, hash_mode = PERMUTE_JOIN_CASES[case]
    rng = np.random.default_rng(sorted(PERMUTE_JOIN_CASES).index(case))
    sides = []
    for n in sizes:
        keys = [torch.from_numpy(_draw_column(rng, nm, w, n)).to(dev)
                for nm in names]
        valid = [torch.from_numpy(rng.random((w, n)) < 0.9).to(dev)
                 if nulls else None for _ in names]
        bits, kv = J.key_bits(keys, valid)
        emit = torch.from_numpy(rng.random((w, n)) < 0.85).to(dev) \
            if nulls else None
        dat = [torch.from_numpy(_draw_column(
            rng, ("int32", "float32")[i % 2], w, n)).to(dev)
            for i in range(ncols)]
        val = [torch.from_numpy(rng.random((w, n)) < 0.8).to(dev)
               if nulls else None for _ in range(ncols)]
        sides.append((bits, kv, emit, dat, val))
    (lb, lkv, lem, ld, lv), (rb, rkv, rem, rd, rv) = sides
    a_desc, b_desc = J.plan_lane_descs(ld, lv, rd, rv, jt)
    return (lb, lkv, lem, rb, rkv, rem, ld, lv, rd, rv, jt, a_desc, b_desc,
            hash_mode)


def assert_sort_stage_equal(got, ref):
    """Two sort stages' outputs bit for bit: tensors (values, dtypes,
    shapes), lists of them, and the rest."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        got, ref = [got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)]
    assert len(got) == len(ref)
    for x, y in zip(got, ref):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, (x.shape,
                                                               y.shape)
            assert torch.equal(x, y)
        elif isinstance(y, list):
            assert_sort_stage_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("case", sorted(PERMUTE_JOIN_CASES))
def test_stream_sort_records_match_plain(cuda, case):
    """The join's sort stage with K10 (3 launches in hash mode, 2 in bits
    mode) against ``plain_stream_sort`` on the card, bit for bit."""
    args = permute_join_case(case, cuda)
    K.reset_launches()
    got = J.stream_sort(J.stream_sort_keys(*args))
    torch.cuda.synchronize()
    assert K.LAUNCHES["permute_rows"] == (3 if args[-1] else 2)
    assert_sort_stage_equal(got, J.plain_stream_sort(
        J.stream_sort_keys(*args)))


@pytest.mark.parametrize("case", sorted(SETOP_HASH_CASES))
def test_setop_stream_sort_records_match_plain(cuda, case):
    """The set op's sort stage with K10 (2 launches) against
    ``plain_setop_stream_sort`` on the card, bit for bit, on K9's cases
    (1 to 12 lanes, nulls, emit masks, repeated rows)."""
    hashed = K.setop_hash_rows(*setop_hash_case(case, 1 << 20, cuda))
    K.reset_launches()
    got = SO.setop_stream_sort(*hashed)
    torch.cuda.synchronize()
    assert K.LAUNCHES["permute_rows"] == 2
    assert_sort_stage_equal(got, SO.plain_setop_stream_sort(*hashed))


def test_permute_rows_matches_plain(cuda):
    """Each form of K10 (streams or records in, with and without an
    index, records or split out, either key) against its plain version,
    at every record width and W = 3."""
    g = torch.Generator(device=cuda)
    g.manual_seed(10)
    w, n = 3, 100_003
    for words in (1, 4, 5, 9, 13, K.MAX_ROW_WORDS):
        src = [torch.randint(-2**31, 2**31, (w, n), generator=g,
                             device=cuda) for _ in range(words)]
        src = [x if k % 3 else x.to(torch.int32) for k, x in enumerate(src)]
        idx = torch.argsort(torch.rand(w, n, generator=g, device=cuda), 1)
        for args in ((src, None), (src, idx)):
            for kw in ({}, {"split": True}, {"key": 1},
                       {"key": min(words, 2), "split": True}):
                got = K.permute_rows(*args, **kw)
                ref = K.plain_permute_rows(*args, **kw)
                assert_sort_stage_equal(
                    [x for x in got if x is not None],
                    [x for x in ref if x is not None])
        rec = K.plain_permute_rows(src)[0]
        for kw in ({"split": True}, {"key": min(words, 2)}):
            assert_sort_stage_equal(
                [x for x in K.permute_rows(rec, idx, words, **kw)
                 if x is not None],
                [x for x in K.plain_permute_rows(rec, idx, words, **kw)
                 if x is not None])
    torch.cuda.synchronize()


def test_permute_rows_rejects_on_card(cuda):
    """The wrapper raises on inputs on two devices and on a stream of
    another shape."""
    x = torch.zeros(1, 8, dtype=torch.int64, device=cuda)
    for args in (([x], torch.zeros(1, 8, dtype=torch.int64)),
                 ([x, x[:, 1:]], None)):
        with pytest.raises(CylonError):
            K.permute_rows(*args)


def _launch_tables(dev, case):
    n = 1 << 23
    if case.startswith("join"):
        rng = np.random.default_rng(25)
        dt = np.int64 if case == "join_int64" else np.int32
        ctx = ct.CylonContext.Init(device=dev)
        return (_table(ctx, {"k": rng.integers(0, n, n).astype(dt),
                             "v": rng.random(n)}),
                _table(ctx, {"k": rng.integers(0, n, n + 77).astype(dt),
                             "w": rng.random(n + 77).astype(np.float32)}))
    return set_op_tables(dev, n)


# K10 launches a query: a hash-stream join (an int64 key), a sort-stream
# join (one int32 key), each set op on the stream route
PERMUTE_LAUNCHES = {"join_int64": 3, "join_int32": 2, "union": 2,
                    "subtract": 2, "intersect": 2}


@pytest.mark.parametrize("case", sorted(PERMUTE_LAUNCHES))
def test_sort_stage_launches_k10_on_card(cuda, case, monkeypatch):
    """A 2^23-row local join or set op launches K10 the counted number of
    times, and its result equals the plain sort stage's bit for bit."""
    left, right = _launch_tables(cuda, case)

    def run():
        if case.startswith("join"):
            return left.join(right, "inner", on=["k"])
        return getattr(left, case)(right)

    K.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert K.LAUNCHES["permute_rows"] == PERMUTE_LAUNCHES[case], K.LAUNCHES
    monkeypatch.setattr(J, "stream_sort", J.plain_stream_sort)
    monkeypatch.setattr(SO, "setop_stream_sort", SO.plain_setop_stream_sort)
    K.reset_launches()
    ref = run()
    torch.cuda.synchronize()
    assert K.LAUNCHES["permute_rows"] == 0
    assert got.capacity == ref.capacity and got.row_count > 0
    assert torch.equal(got.emit_mask(), ref.emit_mask())
    for x, y in zip(got.columns(), ref.columns()):
        assert torch.equal(x.data, y.data)
        assert torch.equal(x.valid_mask(), y.valid_mask())


SETOP_LEAVES = ("setop.prepare", "setop.hash", "setop.sort", "setop.stream",
                "setop.materialize", "setop.dense")


def _plain_distinct_union(cols):
    """The distinct rows of [left; right], columns ``cols`` (pairs of
    tensors), in the bits' lexicographic order: -0.0 made +0.0, a stable
    sort a column from the last, the first row of each run kept."""
    xs = [torch.cat(p) for p in cols]
    xs = [torch.where(x == 0, torch.zeros_like(x), x) for x in xs]
    bits = [x.view(torch.int64) for x in xs]
    perm = torch.arange(len(xs[0]), device=xs[0].device)
    for b in reversed(bits):
        perm = perm[torch.sort(b[perm], stable=True).indices]
    same = torch.ones(len(perm) - 1, dtype=torch.bool, device=perm.device)
    for b in bits:
        s = b[perm]
        same &= s[1:] == s[:-1]
    keep = torch.ones(len(perm), dtype=torch.bool, device=perm.device)
    keep[1:] = ~same
    return [x[perm[keep]] for x in xs]


def test_union_stream_route_on_card(cuda):
    """``Table.distributed_union`` at world 1 of 2^25 rows a side (int64
    key, float64 payload, the union cell's schema, a tenth of the right
    side copying left rows) on the card: the stream route, K9, K5 and K6
    once each and no dense ranks; the rows equal the plain reference's
    bit for bit; under torch.profiler the ``setop`` leaves hold at least
    95% of the op span's device ms. (~1.5 ms of span bookkeeping with the
    card idle lies outside the leaves: with K9 a 2^23-row union takes ~14
    ms, of which the leaves hold ~89%, so the size keeps the device's
    work in front, as the cell's 2 x 1e8 rows do.)"""
    from torch.profiler import ProfilerActivity, profile

    from cylon_tpu_torch import telemetry as tel

    n = 1 << 25
    g = torch.Generator(device=cuda)
    g.manual_seed(2 ** 31 + 22)
    k = [torch.randint(0, n, (n,), generator=g, device=cuda) for _ in "lr"]
    v = [torch.rand(n, generator=g, device=cuda, dtype=torch.float64)
         for _ in "lr"]
    v[0][::1000] = 0.0
    v[1][::999] = -0.0
    k[1][: n // 10], v[1][: n // 10] = k[0][: n // 10], v[0][: n // 10]
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(1),
                                          device=cuda)
    left, right = (ct.Table([ct.Column(k[i], ct.dtypes.Int64(), None, "k"),
                             ct.Column(v[i], ct.dtypes.Double(), None, "v")],
                            ctx) for i in range(2))

    def routes():
        return {key: val for key, val in tel.metrics_snapshot().items()
                if key.startswith("cylon_setop_route_total")}

    left.distributed_union(right)
    torch.cuda.synchronize()
    before, was = tel.span_device_times(), routes()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = left.distributed_union(right)
        torch.cuda.synchronize()
    got = tel.span_device_times()
    assert K.LAUNCHES["setop_hash_rows"] == 1
    assert K.LAUNCHES["setop_stream"] == 1
    assert K.LAUNCHES["stream_compact"] == 1
    now = routes()
    assert {key: now[key] - was.get(key, 0) for key in now
            if now[key] != was.get(key, 0)} == \
        {'cylon_setop_route_total{route="stream"}': 1}

    def delta(name):
        w = before.get(name, (0.0, 0))
        return got.get(name, (0.0, 0))[0] - w[0], \
            got.get(name, (0.0, 0))[1] - w[1]

    ms, count = delta("setop")
    assert count == 1 and delta("setop.dense")[1] == 0
    cover = sum(delta(s)[0] for s in SETOP_LEAVES) / ms
    assert 0.95 <= cover <= 1.001, (cover, ms)

    live = torch.nonzero(out.emit_mask()).flatten()
    prog = [c.data[live] for c in out.columns()]
    ref = _plain_distinct_union([(k[0], k[1]), (v[0], v[1])])
    assert len(prog[0]) == len(ref[0]) < 2 * n - n // 10 + 1
    perm = torch.arange(len(prog[0]), device=cuda)
    for x in reversed(prog):
        perm = perm[torch.sort(x.view(torch.int64)[perm], stable=True
                               ).indices]
    for x, y in zip(prog, ref):
        assert torch.equal(x[perm].view(torch.int64), y.view(torch.int64))
