"""cylon_tpu_torch's column-model leftovers against cylon_tpu's on the
CPU: project, select, slice, merge, ``__getitem__``, the comparisons and
the bool ops, from_list, the Arrow and Parquet round trips (strings of
both storages and BINARY included), and the blocked local join against
the one-shot join.

Everything compared is values, masks or row multisets: exact
(tolerance 0).
"""
import numpy as np
import pyarrow as pa
import pytest

import cylon_tpu as jct
from cylon_tpu.data import strings as jstrings

import cylon_tpu_torch as tct
from cylon_tpu_torch.data import strings as tstrings
from cylon_tpu_torch.io.parquet import read_parquet

from test_torch_port_strings import _strings, rows


@pytest.fixture
def ctxs():
    return jct.CylonContext.Init(), tct.CylonContext.Init(device="cpu")


def _data(seed=0, n=40):
    r = np.random.default_rng(seed)
    return {"k": r.integers(0, 10, n).astype(np.int32),
            "f": r.normal(size=n).astype(np.float64),
            "s": _strings(seed + 1, n, ["a", "bb", "héllo", ""]),
            "b": r.random(n) < 0.5}


def _pair(ctxs, data):
    return jct.Table.from_pydict(ctxs[0], data), \
        tct.Table.from_pydict(ctxs[1], data)


def _same(jt, tt):
    jd, td = jt.to_pydict(), tt.to_pydict()
    assert list(jd) == list(td)
    for k in jd:
        a, b = jd[k], td[k]
        if a.dtype.kind == "f":
            assert np.array_equal(a, b, equal_nan=True), k
        else:
            assert a.tolist() == b.tolist(), k


def test_project_slice_getitem(ctxs):
    jt, tt = _pair(ctxs, _data())
    _same(jt.project(["s", "k"]), tt.project(["s", "k"]))
    _same(jt.project([2, 0]), tt.project([2, 0]))
    _same(jt.slice(3, 17), tt.slice(3, 17))
    _same(jt[5:9], tt[5:9])
    _same(jt[4], tt[4])
    _same(jt["s"], tt["s"])
    _same(jt[["f", "k"]], tt[["f", "k"]])


def test_comparisons_and_masks(ctxs):
    """Scalar compares keep the capacity and row mask; a one-column bool
    table filters; &, | and ~ combine masks; strings compare equal or
    unequal to a str in both storages."""
    jt, tt = _pair(ctxs, _data(2))
    for op in ("__eq__", "__ne__", "__lt__", "__gt__", "__le__", "__ge__"):
        _same(getattr(jt["k"], op)(4), getattr(tt["k"], op)(4))
    _same(jt[jt["k"] > 4], tt[tt["k"] > 4])
    _same(jt[(jt["k"] > 2) & (jt["k"] < 8)], tt[(tt["k"] > 2) & (tt["k"] < 8)])
    _same(jt[(jt["k"] < 2) | (jt["k"] > 8)], tt[(tt["k"] < 2) | (tt["k"] > 8)])
    _same(jt[~(jt["k"] > 4)], tt[~(tt["k"] > 4)])
    jf, tf = jt[jt["k"] > 4], tt[tt["k"] > 4]
    _same(jf[jf["k"] < 8], tf[tf["k"] < 8])
    for lit in ("héllo", "zz", ""):
        _same(jt[jt["s"] == lit], tt[tt["s"] == lit])
        _same(jt[jt["s"] != lit], tt[tt["s"] != lit])
    with pytest.raises(tct.CylonError):
        tt["s"] < "a"


def test_varbytes_compares(ctxs, monkeypatch):
    monkeypatch.setattr(jstrings, "DICT_MAX_VOCAB", 0)
    monkeypatch.setattr(tstrings, "DICT_MAX_VOCAB", 0)
    jt, tt = _pair(ctxs, _data(3))
    assert tt._columns[2].is_varbytes
    for lit in ("héllo", "bb", ""):
        _same(jt[jt["s"] == lit], tt[tt["s"] == lit])
        _same(jt[jt["s"] != lit], tt[tt["s"] != lit])


def test_select_merge_from_list(ctxs):
    jt, tt = _pair(ctxs, _data(4))

    def pred(r):
        return r["k"] > 3 and r["s"] is not None

    _same(jt.select(pred), tt.select(pred))
    _same(jt.merge([jt.slice(0, 5), jt]), tt.merge([tt.slice(0, 5), tt]))
    cols = [[1, 2, 3], ["x", "y", None], [0.5, 1.5, 2.5]]
    _same(jct.Table.from_list(ctxs[0], ["a", "b", "c"], cols),
          tct.Table.from_list(ctxs[1], ["a", "b", "c"], cols))


@pytest.mark.parametrize("force", [False, True])
def test_arrow_and_parquet_round_trips(ctxs, tmp_path, monkeypatch, force):
    """Arrow in (string, large string, binary, dictionary arrays, nulls)
    and out, Parquet written and read back: the values of cylon_tpu, and
    the storage it picks."""
    if force:
        monkeypatch.setattr(jstrings, "DICT_MAX_VOCAB", 0)
        monkeypatch.setattr(tstrings, "DICT_MAX_VOCAB", 0)
    n = 60
    r = np.random.default_rng(5)
    at = pa.table({
        "k": pa.array(r.integers(0, 5, n).astype(np.int64)),
        "f": pa.array([None if i % 7 == 0 else float(i) for i in range(n)]),
        "s": pa.array([None if i % 5 == 0 else f"s{i % 9}é"
                       for i in range(n)]),
        "ls": pa.array([f"long-{i}" for i in range(n)],
                       type=pa.large_string()),
        "bin": pa.array([bytes([i % 256, 255 - i % 256]) if i % 4 else None
                         for i in range(n)], type=pa.binary()),
        "d": pa.array(["x", "y", "x"] * (n // 3)).dictionary_encode(),
    })
    jt = jct.Table.from_arrow(ctxs[0], at)
    tt = tct.Table.from_arrow(ctxs[1], at)
    for jc, tc in zip(jt._columns, tt._columns):
        assert jc.is_varbytes == tc.is_varbytes, tc.name
    _same(jt, tt)
    assert tt.to_arrow().equals(jt.to_arrow())
    path = str(tmp_path / "t.parquet")
    tt.to_parquet(path)
    _same(jt, read_parquet(ctxs[1], path))
    assert read_parquet(ctxs[1], [path, path]).row_count == 2 * n


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_blocked_matches_join(ctxs, how):
    """probe_block_rows splits the probe side into blocks: the rows equal
    the one-shot join's and cylon_tpu's blocked join's (string keys and
    a string payload included)."""
    jl, tl = _pair(ctxs, _data(6, 50))
    jr, tr = _pair(ctxs, _data(7, 45))
    one = tl.join(tr, how, on=["k", "s"])
    blocked = tl.join(tr, how, on=["k", "s"], probe_block_rows=16)
    assert rows(blocked) == rows(one)
    assert rows(blocked) == rows(jl.join(jr, how, on=["k", "s"],
                                         probe_block_rows=16))


def test_exports_keep_string_storage(ctxs):
    """to_numpy/to_pandas of string columns, and the Row getters."""
    jt, tt = _pair(ctxs, _data(8, 12))
    assert tt.to_pandas()["s"].tolist() == jt.to_pandas()["s"].tolist()
    got = tt.select(lambda r: r.get_string(2) == "bb").to_pydict()["k"]
    exp = jt.select(lambda r: r.get_string(2) == "bb").to_pydict()["k"]
    assert got.tolist() == exp.tolist()
