"""cylon_tpu_torch's string columns against cylon_tpu's on the CPU, local
side: the same seeded inputs through both packages.

* the ingest policy (dictionary, varbytes, BINARY) and host round trips
  with nulls, empty strings, non-ASCII text and non-UTF-8 bytes;
* VarBytes' device passes (content hashes, word lanes, sort prefix keys,
  takes) bit for bit, on words with the top bit set;
* joins of the four types on varbytes, dictionary and mixed keys, on the
  plan route and on the stream route (K3 in hash mode, plain versions on
  the CPU); set ops, groupby, sort (the host sort past 16 words), string
  min/max, CSV; ``exact=True`` under a forced content-hash collision.

Strings, keys, counts and orders compare exactly (tolerance 0); there is
no float arithmetic here. ``DICT_MAX_VOCAB = 0`` in both packages forces
varbytes storage.
"""
import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.data import strings as jstrings
from cylon_tpu.data.table import concat_tables as jconcat

import cylon_tpu_torch as tct
from cylon_tpu_torch import dtypes as tdtypes
from cylon_tpu_torch.data import strings as tstrings
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.ops import setops as tsetops

JOINS = ["inner", "left", "right", "outer"]


def _force_varbytes(monkeypatch):
    monkeypatch.setattr(jstrings, "DICT_MAX_VOCAB", 0)
    monkeypatch.setattr(tstrings, "DICT_MAX_VOCAB", 0)


@pytest.fixture
def ctxs():
    return jct.CylonContext.Init(), tct.CylonContext.Init(device="cpu")


@pytest.fixture(params=["plan", "stream"])
def route(request, monkeypatch):
    """'stream': the stream routes forced in the port (K3/K4 and K5/K6
    wrappers, their plain versions on the CPU); 'plan': the default CPU
    routes."""
    if request.param == "stream":
        monkeypatch.setattr(tjoin, "STREAM_PLAN", True)
        monkeypatch.setattr(tsetops, "STREAM_SETOP", True)
    return request.param


# a vocabulary over every case: empty, non-ASCII, 1-5 words (word-lane
# keys), 9-20 words (content-hash keys, past LANE_WORDS_MAX), and one row
# past SORT_PREFIX_WORDS
VOCAB = ["", "a", "bb", "héllo", "ÿþ€", "abcd", "abcde", "k" * 19,
         "m" * 20, "x" * 36, "y" * 60, "z" * 80]


def _strings(seed, n, vocab=VOCAB, null_rate=0.1):
    r = np.random.default_rng(seed)
    v = np.array(vocab, dtype=object)[r.integers(0, len(vocab), n)]
    v[r.random(n) < null_rate] = None
    return v


def _bytes_values(seed, n):
    r = np.random.default_rng(seed)
    out = np.empty(n, object)
    for i in range(n):
        out[i] = bytes(r.integers(0, 256, int(r.integers(0, 30))).astype(
            np.uint8))
    out[3] = b"\xff\x00"
    out[5] = None
    return out


def _tables(ctxs, data):
    jctx, tctx = ctxs
    return jct.Table.from_pydict(jctx, data), \
        tct.Table.from_pydict(tctx, data)


def _py(x):
    return x.item() if isinstance(x, np.generic) else x


def rows(t):
    d = t.to_pydict()
    return sorted(zip(*[[repr(_py(x)) for x in v] for v in d.values()]))


def _bits(x):
    return np.asarray(x).view(np.int32)


# ---------------------------------------------------------------------------
# ingest and export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("force", [False, True])
def test_ingest_policy_and_round_trip(ctxs, monkeypatch, force):
    """Same storage choice as cylon_tpu, same host values back (nulls,
    empty strings, non-ASCII)."""
    if force:
        _force_varbytes(monkeypatch)
    low = _strings(1, 200)
    high = np.array([f"id{i}-é" for i in range(300)], dtype=object)
    high[7] = None
    jt, tt = _tables(ctxs, {"low": np.concatenate([low, low[:100]]),
                            "high": high})
    for jc, tc in zip(jt._columns, tt._columns):
        assert (jc.dictionary is None) == (tc.dictionary is None)
        assert jc.is_varbytes == tc.is_varbytes
        if jc.dictionary is not None:
            assert list(jc.dictionary) == list(tc.dictionary)
            assert np.array_equal(np.asarray(jc.data), tc.data.numpy())
    assert tt._columns[1].is_varbytes
    jd, td = jt.to_pydict(), tt.to_pydict()
    for k in jd:
        assert jd[k].tolist() == td[k].tolist()


def test_binary_values(ctxs):
    """bytes values ingest as BINARY varbytes and come back as bytes,
    non-UTF-8 included; string min/max of BINARY return bytes."""
    vals = _bytes_values(3, 40)
    jt, tt = _tables(ctxs, {"b": vals})
    assert tt._columns[0].dtype.type == tdtypes.Type.BINARY
    assert tt.to_pydict()["b"].tolist() == jt.to_pydict()["b"].tolist()
    for op in ("min", "max"):
        assert getattr(tt, op)("b").to_pydict() == \
            getattr(jt, op)("b").to_pydict()


# ---------------------------------------------------------------------------
# VarBytes device passes, bit for bit
# ---------------------------------------------------------------------------


def _random_rows(seed, n, hi=90):
    r = np.random.default_rng(seed)
    rows_ = [bytes(r.integers(0, 256, int(r.integers(0, hi))).astype(
        np.uint8)) for _ in range(n)]
    rows_ += [b"\xff\xff\xff\xff" * 5, "héllo wörld", "", b"\x80"]
    return rows_


@pytest.mark.parametrize("hi", [22, 90])
def test_varbytes_passes_bit_exact(hi):
    """Content hashes (on words with the top bit set), word lanes, sort
    prefix keys and takes of short (lane) and long (packed) rows."""
    vals = _random_rows(hi, 200, hi)
    jv = jstrings.VarBytes.from_host(vals)
    tv = tstrings.VarBytes.from_host(vals)
    assert np.array_equal(_bits(jv.words), tv.words.numpy())
    assert (tv.words < 0).any()  # the top bit is exercised
    for a, b in zip(jv.hash_keys(), tv.hash_keys()):
        assert np.array_equal(_bits(a), b.numpy())
    valid = np.random.default_rng(0).random(len(vals)) < 0.8
    for a, b in zip(jv.hash_keys(valid), tv.hash_keys(torch.from_numpy(
            valid))):
        assert np.array_equal(_bits(a), b.numpy())
    for a, b in zip(jv.word_lanes(jv.max_words + 1),
                    tv.word_lanes(tv.max_words + 1)):
        assert np.array_equal(_bits(a), b.numpy())
    for a, b in zip(jv.sort_prefix_keys(), tv.sort_prefix_keys()):
        assert np.array_equal(_bits(a), b.numpy())
    idx = np.random.default_rng(1).integers(-1, len(vals), 300)
    jt, tt = jv.take(idx), tv.take(torch.from_numpy(idx))
    assert np.array_equal(_bits(jt.words), tt.words.numpy())
    assert np.array_equal(np.asarray(jt.starts), tt.starts.numpy())
    assert np.array_equal(np.asarray(jt.lengths), tt.lengths.numpy())
    assert list(jt.to_host(False)) == list(tt.to_host(False))
    same = tv.take(torch.arange(len(vals)))
    assert bool(tv.equals_rows(same).all())
    assert tv.equals_literal("héllo wörld").nonzero().flatten().tolist() \
        == [len(vals) - 3]


def test_word_row_map_sends_empty_rows_apart():
    """Empty rows scatter into slots of their own (one shared overflow
    slot would serialize the stores on the card); the map still covers
    exactly the words of the non-empty rows, with runs of empty rows
    around them."""
    from cylon_tpu_torch.data.strings import _word_row_map

    lens = np.array([0, 0, 5, 0, 9, 0, 0, 1, 0], np.int64)
    nw = (lens + 3) // 4
    starts = np.concatenate([[0], np.cumsum(nw)])[:-1]
    W = int(nw.sum()) + 2
    row, p = _word_row_map(torch.from_numpy(starts), torch.from_numpy(nw), W)
    covered = [(r, q) for r, q in zip(row.tolist(), p.tolist())
               if 0 <= q < nw[r]]
    assert covered == [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (7, 0)]


# ---------------------------------------------------------------------------
# joins, set ops, groupby, sort, aggregates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keys", ["varbytes", "dictionary", "mixed"])
def test_joins_match_cylon_tpu(ctxs, monkeypatch, route, keys):
    """The four join types on string keys (nulls never match), with a
    varbytes payload column; rows equal as multisets."""
    vocab = VOCAB[:7] if keys == "dictionary" else VOCAB
    a = {"k": _strings(10, 70, vocab), "v": np.arange(70, dtype=np.int32),
         "p": _strings(11, 70)}
    b = {"k": _strings(12, 60, vocab), "w": np.arange(60, dtype=np.int32)}
    jctx, tctx = ctxs
    if keys == "mixed":
        ja, ta = _tables(ctxs, a)  # dictionary keys on the left
        _force_varbytes(monkeypatch)
        jb, tb = _tables(ctxs, b)
        assert ta._columns[0].dictionary is not None
        assert tb._columns[0].is_varbytes
    else:
        if keys == "varbytes":
            _force_varbytes(monkeypatch)
        ja, ta = _tables(ctxs, a)
        jb, tb = _tables(ctxs, b)
    for how in JOINS:
        assert rows(ta.join(tb, how, on=["k"])) == \
            rows(ja.join(jb, how, on=["k"])), how


def test_short_key_join_takes_hash_mode(ctxs, monkeypatch):
    """A 12-byte key joins through K3 in hash mode with 4 verify lanes
    (3 words + the length), its payload words riding as lanes; a 5-word
    key uses all 6 verify lanes. Rows against a Python self join."""
    from cylon_tpu_torch.ops import kernels as K

    _force_varbytes(monkeypatch)
    monkeypatch.setattr(tjoin, "STREAM_PLAN", True)
    seen = []
    real = K.join_plan_stream

    def spy(**kw):
        seen.append((len(kw.get("verify_lanes", ())), len(kw["lanes"])))
        return real(**kw)

    monkeypatch.setattr(K, "join_plan_stream", spy)
    for width, lanes in ((12, 4), (20, 6)):
        keys = np.array([f"u{i:0{width - 1}d}" for i in range(50)], object)
        k = keys[np.random.default_rng(width).integers(0, 50, 80)]
        _jt, tt = _tables(ctxs, {"k": k, "v": np.arange(80.0)})
        seen.clear()
        exp = sorted((repr(k[i]), repr(float(i)), repr(k[j]),
                      repr(float(j)))
                     for i in range(80) for j in range(80) if k[i] == k[j])
        assert rows(tt.join(tt, "inner", on=["k"])) == exp
        assert seen and seen[0][0] == lanes, seen


@pytest.mark.parametrize("force", [False, True])
def test_set_ops_match_cylon_tpu(ctxs, monkeypatch, route, force):
    """Union/subtract/intersect over string and int columns (duplicates,
    nulls): dictionary strings on the lane route, varbytes on dense
    ranks."""
    if force:
        _force_varbytes(monkeypatch)
    vocab = VOCAB[:6]
    a = {"s": _strings(20, 50, vocab), "k": np.arange(50, dtype=np.int32) % 3}
    b = {"s": _strings(21, 40, vocab), "k": np.arange(40, dtype=np.int32) % 2}
    ja, ta = _tables(ctxs, a)
    jb, tb = _tables(ctxs, b)
    for op in ("union", "subtract", "intersect"):
        assert rows(getattr(ta, op)(tb)) == rows(getattr(ja, op)(jb)), op


@pytest.mark.parametrize("force", [False, True])
def test_groupby_matches_cylon_tpu(ctxs, monkeypatch, force):
    """String keys (short and long rows, nulls as a group) in key order;
    a dictionary value column's MIN/MAX; a varbytes value's COUNT."""
    if force:
        _force_varbytes(monkeypatch)
    data = {"k": _strings(30, 120), "v": np.arange(120, dtype=np.int64),
            "s": _strings(31, 120, VOCAB[:5])}
    jt, tt = _tables(ctxs, data)
    ops = ["sum", "count", "min"] if tt._columns[2].dictionary is not None \
        else ["sum", "count", "count"]
    jg = jt.groupby(0, [1, 1, 2], ops)
    tg = tt.groupby(0, [1, 1, 2], ops)
    assert tg.to_pydict().keys() == jg.to_pydict().keys()
    for k in jg.to_pydict():
        assert tg.to_pydict()[k].tolist() == jg.to_pydict()[k].tolist(), k


def test_varbytes_value_min_is_refused(ctxs, monkeypatch):
    _force_varbytes(monkeypatch)
    _jt, tt = _tables(ctxs, {"k": np.arange(5), "s": _strings(1, 5)})
    with pytest.raises(tct.CylonError, match="COUNT only"):
        tt.groupby(0, [1], ["min"])


@pytest.mark.parametrize("long_rows", [False, True])
@pytest.mark.parametrize("force", [False, True])
def test_sort_matches_cylon_tpu(ctxs, monkeypatch, force, long_rows):
    """Ascending and descending, nulls last, multi-key with an int tie
    breaker; rows past SORT_PREFIX_WORDS take the host sort in both."""
    if force:
        _force_varbytes(monkeypatch)
    vocab = VOCAB if long_rows else VOCAB[:-1]
    data = {"s": _strings(40, 90, vocab), "v": np.arange(90) % 7}
    jt, tt = _tables(ctxs, data)
    if force:
        assert tt._columns[0].varbytes.sortable_on_device != long_rows
    for by, asc in (("s", True), ("s", False), (["s", "v"], [False, True]),
                    (["v", "s"], [True, False])):
        assert tt.sort(by, asc).to_pydict()["v"].tolist() == \
            jt.sort(by, asc).to_pydict()["v"].tolist(), (by, asc)
        assert tt.sort(by, asc).to_pydict()["s"].tolist() == \
            jt.sort(by, asc).to_pydict()["s"].tolist(), (by, asc)


@pytest.mark.parametrize("force", [False, True])
def test_string_min_max_count(ctxs, monkeypatch, force):
    if force:
        _force_varbytes(monkeypatch)
    jt, tt = _tables(ctxs, {"s": _strings(50, 80)})
    for op in ("min", "max", "count"):
        assert getattr(tt, op)("s").to_pydict()["s"].tolist() == \
            getattr(jt, op)("s").to_pydict()["s"].tolist(), op
    with pytest.raises(tct.CylonError):
        tt.sum("s")


def test_concat_mixes_storages(ctxs, monkeypatch):
    """concat_tables of a dictionary and a varbytes string column gives
    varbytes with every value in order; two dictionaries unify."""
    a = {"s": _strings(60, 30, VOCAB[:4])}
    b = {"s": _strings(61, 20, VOCAB[3:7])}
    ja, ta = _tables(ctxs, a)
    jb, tb = _tables(ctxs, b)
    _force_varbytes(monkeypatch)
    jc, tc = _tables(ctxs, {"s": _strings(62, 25)})
    both = tct.concat_tables([ta, tb], ta._ctx)
    assert both._columns[0].dictionary is not None
    assert both.to_pydict()["s"].tolist() == \
        jconcat([ja, jb], ja._ctx).to_pydict()[
            "s"].tolist()
    mixed = tct.concat_tables([ta, tc, tb], ta._ctx)
    assert mixed._columns[0].is_varbytes
    assert mixed.to_pydict()["s"].tolist() == \
        jconcat([ja, jc, jb], ja._ctx).to_pydict()[
            "s"].tolist()


def test_csv_round_trip(ctxs, tmp_path, monkeypatch):
    """A CSV with a text column reads through the ingest policy (both
    storages) and writes back the same values."""
    path = tmp_path / "s.csv"
    path.write_text("k,s\n1,abc\n2,\n3,héllo\n4,abc\n5,zz\n")
    for force in (False, True):
        if force:
            _force_varbytes(monkeypatch)
        t = tct.read_csv(ctxs[1], str(path))
        assert t._columns[1].is_varbytes == force
        assert t.to_pydict()["s"].tolist() == \
            jct.read_csv(ctxs[0], str(path)).to_pydict()["s"].tolist()
        out = tmp_path / f"out{int(force)}.csv"
        t.to_csv(str(out))
        assert tct.read_csv(ctxs[1], str(out)).to_pydict()["s"].tolist() == \
            t.to_pydict()["s"].tolist()


def _colliding_hash_jax(words, starts, lengths, max_words):
    import jax.numpy as jnp

    h = jnp.full(starts.shape[0], jnp.uint32(0xC0FFEE))
    return h, h, h


def _colliding_hash_torch(words, starts, lengths, max_words):
    h = torch.full((starts.shape[0],), 0xC0FFEE, dtype=torch.int32,
                   device=words.device)
    return h, h, h


def test_exact_join_survives_forced_hash_collision(ctxs, monkeypatch,
                                                   route):
    """Every content hash forced equal: the default join merges distinct
    long keys in both packages; exact=True filters the false matches
    (INNER) or redoes the join on shared dictionary codes (outer)."""
    _force_varbytes(monkeypatch)
    monkeypatch.setattr(jstrings, "_hash_rows", _colliding_hash_jax)
    monkeypatch.setattr(tstrings, "_hash_rows", _colliding_hash_torch)
    lk = np.array([f"{'L' * 26}{i:04d}" for i in range(40)], object)
    rk = np.array([f"{'L' * 26}{i:04d}" for i in range(0, 80, 2)], object)
    ja, ta = _tables(ctxs, {"k": lk, "v": np.arange(40)})
    jb, tb = _tables(ctxs, {"k": rk, "w": np.arange(40)})
    assert ta._columns[0].varbytes.max_words > tstrings.EXACT_KEY_WORDS
    assert ta.join(tb, "inner", on="k").row_count == 40 * 40
    for how in JOINS:
        got = ta.join(tb, how, on="k", exact=True)
        assert rows(got) == rows(ja.join(jb, how, on="k", exact=True)), how
    assert ta.join(tb, "inner", on="k", exact=True).row_count == 20


def test_f4_reference_outer_split_loses_unmatched_rows(ctxs, monkeypatch):
    """F4 (a reference fault, left alone and pinned): cylon_tpu runs a
    FULL_OUTER join on its stream route (on a TPU) as LEFT plus a tail of
    the right rows whose key bits match no left row. With ``exact=True``
    on content-hash keys a collision hides unmatched right rows from that
    tail (4 + 4 keys already show it); on the 40 + 40 keys of the test
    above the tail adds none of the 20 unmatched right rows. The port
    takes the plan route for such joins, also with its stream route
    forced."""
    from cylon_tpu.data import table as jtable
    from cylon_tpu.ops import join as jjoin

    _force_varbytes(monkeypatch)
    monkeypatch.setattr(jstrings, "_hash_rows", _colliding_hash_jax)
    monkeypatch.setattr(tstrings, "_hash_rows", _colliding_hash_torch)
    monkeypatch.setattr(tjoin, "STREAM_PLAN", True)
    lk = np.array([f"{'L' * 26}{i:04d}" for i in range(40)], object)
    rk = np.array([f"{'L' * 26}{i:04d}" for i in range(0, 80, 2)], object)
    ja, ta = _tables(ctxs, {"k": lk, "v": np.arange(40)})
    jb, tb = _tables(ctxs, {"k": rk, "w": np.arange(40)})
    cfg = jjoin.JoinConfig(jjoin.JoinType.FULL_OUTER, [0], [0], exact=True)
    left_part = ja.join(jb, "left", on="k", exact=True)
    assert left_part.row_count == 40
    assert jtable._append_unmatched_right(ja, jb, cfg,
                                          left_part).row_count == 40
    assert ja.join(jb, "outer", on="k", exact=True).row_count == 60
    assert ta.join(tb, "outer", on="k", exact=True).row_count == 60
