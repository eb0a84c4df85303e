"""The edge modules of cylon_tpu_torch against cylon_tpu's on the CPU:
``arrow_builder`` (tests/test_arrow_builder.py: the same raw buffers give
the same rows, the same errors), ``io.dataloader``
(tests/test_io.py::test_dataloader_partitions: the same tables,
partitions and dense blocks), ``benchutils`` (``round_sig`` on
tests/test_observatory.py's cases, the two CSV generators byte for byte,
the timing decorator), and the CSV reader's numpy path, which reads
numeric files where pyarrow is missing (the machine with the card)."""
import sys

import numpy as np
import pytest
import torch

from cylon_tpu import arrow_builder as jab
from cylon_tpu import benchutils as jbu
from cylon_tpu import table_api as japi
from cylon_tpu.dtypes import Type as JType
from cylon_tpu.io.dataloader import DataLoader as JLoader

import cylon_tpu_torch as tct
from cylon_tpu_torch import arrow_builder as tab
from cylon_tpu_torch import benchutils as tbu
from cylon_tpu_torch import table_api as tapi
from cylon_tpu_torch import util as tutil
from cylon_tpu_torch.dtypes import Type as TType
from cylon_tpu_torch.io import csv as tcsv
from cylon_tpu_torch.io.dataloader import DataLoader as TLoader


@pytest.fixture(scope="module")
def tctx():
    return tct.CylonContext.Init(device="cpu")


def _addr(arr: np.ndarray):
    return arr.ctypes.data, arr.nbytes


def _pydict(t):
    return {k: [None if (isinstance(x, float) and x != x) else x
                for x in np.asarray(v).tolist()]
            for k, v in t.to_pydict().items()}


def _build(ab, Type, tid, ctx):
    """tests/test_arrow_builder.py's table: int64, float64 with a null,
    a string column; the buffers stay alive until finish."""
    ab.begin_table(tid)
    ints = np.array([10, 20, 30, 40, 50], np.int64)
    ab.add_column(tid, "x", int(Type.INT64), 5, 0, 0, 0, *_addr(ints))
    floats = np.array([1.5, 2.5, 3.5, 4.5, 5.5], np.float64)
    bitmap = np.array([0b00011101], np.uint8)
    ab.add_column(tid, "y", int(Type.DOUBLE), 5, 1, *_addr(bitmap),
                  *_addr(floats))
    payload = np.frombuffer(b"heyjudedont", np.uint8)
    offsets = np.array([0, 3, 7, 7, 11, 11], np.int32)
    ab.add_column(tid, "s", int(Type.STRING), 5, 0, 0, 0, *_addr(payload),
                  *_addr(offsets))
    ab.finish_table(tid, ctx)


def test_build_table_from_raw_buffers(local_ctx, tctx):
    _build(jab, JType, "bld-1", local_ctx)
    _build(tab, TType, "bld-1", tctx)
    jt, tt = japi.get_table("bld-1"), tapi.get_table("bld-1")
    assert _pydict(tt) == _pydict(jt)
    d = _pydict(tt)
    assert d["x"] == [10, 20, 30, 40, 50]
    assert d["y"] == [1.5, None, 3.5, 4.5, 5.5]
    assert d["s"] == ["hey", "jude", "", "dont", ""]
    assert tt._columns[2].is_varbytes
    other = tct.Table.from_pydict(tctx, {"x": np.array([20, 40, 99])})
    tapi.put_table("bld-2", other)
    tapi.join_tables("bld-1", "bld-2",
                     tct.JoinConfig(tct.JoinType.INNER, [0], [0]), "bld-out")
    assert tapi.get_table("bld-out").row_count == 2
    for i in ("bld-1", "bld-2", "bld-out"):
        tapi.remove_table(i)
    japi.remove_table("bld-1")


FIXED = [("UINT8", np.uint8), ("INT8", np.int8), ("UINT16", np.uint16),
         ("INT16", np.int16), ("UINT32", np.uint32), ("INT32", np.int32),
         ("UINT64", np.uint64), ("INT64", np.int64),
         ("HALF_FLOAT", np.float16), ("FLOAT", np.float32),
         ("DOUBLE", np.float64), ("DATE32", np.int32), ("DATE64", np.int64),
         ("TIMESTAMP", np.int64), ("TIME32", np.int32), ("TIME64", np.int64)]


@pytest.mark.parametrize("tname,np_t", FIXED, ids=[f[0] for f in FIXED])
def test_fixed_width_and_bool_columns(local_ctx, tctx, tname, np_t):
    """Every fixed-width type of the reference's map and a bitmap BOOL
    column, each with a validity bitmap, give the reference's rows."""
    rng = np.random.default_rng(len(tname))
    n = 37
    vals = (rng.integers(0, 100, n)).astype(np_t)
    valid = rng.random(n) > 0.3
    vbits = np.packbits(valid, bitorder="little")
    bools = np.packbits(rng.random(n) > 0.5, bitorder="little")
    out = []
    for ab, Type, ctx, api in ((jab, JType, local_ctx, japi),
                               (tab, TType, tctx, tapi)):
        ab.begin_table("fx")
        ab.add_column("fx", "v", int(getattr(Type, tname)), n,
                      int((~valid).sum()), *_addr(vbits), *_addr(vals))
        ab.add_column("fx", "b", int(Type.BOOL), n, 0, 0, 0, *_addr(bools))
        ab.finish_table("fx", ctx)
        out.append(_pydict(api.get_table("fx")))
        api.remove_table("fx")
    assert out[0] == out[1]


def test_builder_errors(tctx):
    for ab, Type, api in ((jab, JType, japi), (tab, TType, tapi)):
        with pytest.raises(Exception) as ei:
            ab.add_column("nope", "c", int(Type.INT32), 0, 0, 0, 0, 0, 0)
        assert ei.value.code.name == "KeyError"
        with pytest.raises(Exception) as ei:
            ab.finish_table("nope")
        assert ei.value.code.name == "KeyError"
        ab.begin_table("dup")
        with pytest.raises(Exception) as ei:
            ab.begin_table("dup")
        assert ei.value.code.name == "AlreadyExists"
        with pytest.raises(Exception) as ei:
            ab.add_column("dup", "s", int(Type.STRING), 1, 0, 0, 0, 0, 0)
        assert ei.value.code.name == "Invalid"
        with pytest.raises(Exception) as ei:
            ab.add_column("dup", "d", int(Type.DECIMAL), 1, 0, 0, 0, 0, 0)
        assert ei.value.code.name == "NotImplemented"
        ab.finish_table("dup", tctx if ab is tab else None)
        api.remove_table("dup")


def test_finish_without_context_is_cuda():
    """Without a context the table lands on CUDA
    (``CylonContext.Init()``): on a machine without it, a typed error."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the gpu tests cover it")
    tab.begin_table("cuda-default")
    ints = np.arange(3, dtype=np.int32)
    tab.add_column("cuda-default", "i", int(TType.INT32), 3, 0, 0, 0,
                   *_addr(ints))
    with pytest.raises(tct.CylonError, match="CUDA is not available"):
        tab.finish_table("cuda-default")


# ---------------------------------------------------------------------------
# the data loader and the CSV generators
# ---------------------------------------------------------------------------


def test_csv_generators_byte_equal(tmp_path):
    for gen, args in (("generate_keyed_csv", (100, 10)),
                      ("generate_numeric_csv", (50, 3))):
        paths = [str(tmp_path / f"{gen}_{p}.csv") for p in ("j", "t")]
        getattr(jbu, gen)(*args, paths[0], seed=3)
        getattr(tbu, gen)(*args, paths[1], seed=3)
        a, b = (open(p, "rb").read() for p in paths)
        assert a == b and len(a) > 100


def test_dataloader_partitions(tmp_path, local_ctx, tctx):
    for r in range(2):
        tbu.generate_keyed_csv(100, 10, str(tmp_path / f"part_{r}.csv"),
                               seed=r)
    files = ["part_0.csv", "part_1.csv"]
    jdl = JLoader(local_ctx, str(tmp_path), files).load()
    tdl = TLoader(tctx, str(tmp_path), files).load()
    assert tdl.table(0).row_count == 100
    for a, b in zip(jdl.to_numpy_blocks(), tdl.to_numpy_blocks()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jp, tp = jdl.partitions(4), tdl.partitions(4)
    assert sum(len(p) for p in tp) == 100
    assert tp[0][0].shape == (2,)
    for a, b in zip(jp, tp):
        assert a.index == b.index and np.array_equal(a.data, b.data)
    assert [p.index for p in tdl.partitions(3, seed=None)] == \
        [p.index for p in jdl.partitions(3, seed=None)]
    with pytest.raises(tct.CylonError):
        TLoader(tctx, str(tmp_path), ["nope.csv"])
    with pytest.raises(tct.CylonError):
        TLoader(tctx, str(tmp_path / "nodir"), files)


def test_csv_numpy_path_without_pyarrow(tmp_path, tctx, monkeypatch):
    """Where pyarrow is missing, a numeric CSV under a header row reads
    with numpy into the same table pyarrow gives: int64 and float64
    columns, empty fields null; other options and text raise typed."""
    path = str(tmp_path / "n.csv")
    with open(path, "w") as f:
        f.write("key,value,c\n3,0.5,1\n-7,,2\n11,2.25,\n0,1e-3,4\n")
    want = tcsv.read_csv(tctx, path)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError):
        import pyarrow  # noqa: F401
    got = tcsv.read_csv(tctx, path)
    assert got.column_names == want.column_names == ["key", "value", "c"]
    for a, b in zip(got._columns, want._columns):
        assert a.data.dtype == b.data.dtype
        assert torch.equal(a.valid_mask(), b.valid_mask())
        assert torch.equal(a.data[a.valid_mask()], b.data[b.valid_mask()])
    parts = [str(tmp_path / f"p{r}.csv") for r in range(2)]
    for r, p in enumerate(parts):
        tbu.generate_keyed_csv(40, 5, p, seed=r)
    dl = TLoader(tctx, str(tmp_path), ["p0.csv", "p1.csv"]).load()
    assert [t.row_count for t in dl.tables] == [40, 40]
    assert np.array_equal(dl.to_numpy_blocks()[1],
                          np.loadtxt(parts[1], delimiter=",", skiprows=1))
    bad_opts = tct.CSVReadOptions()
    bad_opts._skip_rows = 1
    with pytest.raises(tct.CylonError, match="need pyarrow") as ei:
        tcsv.read_csv(tctx, path, bad_opts)
    assert ei.value.code == tct.Code.NotImplemented
    text = str(tmp_path / "t.csv")
    with open(text, "w") as f:
        f.write("a,b\n1,x\n")
    with pytest.raises(tct.CylonError, match="not numeric") as ei:
        tcsv.read_csv(tctx, text)
    assert ei.value.code == tct.Code.NotImplemented
    semi = str(tmp_path / "s.csv")
    with open(semi, "w") as f:
        f.write("a;b\n1;2.5\n")
    got = tcsv.read_csv(tctx, semi, tct.CSVReadOptions().WithDelimiter(";"))
    assert got.to_pydict()["b"].tolist() == [2.5]


# ---------------------------------------------------------------------------
# benchutils
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x", [0.0000234567891, 0.023456789, 1234567.891,
                               0.0, float("inf"), 7, -0.000987654321,
                               0.00012345678, 0.9876543, 123456.789])
def test_round_sig_matches_reference(x):
    assert tbu.round_sig(x) == jbu.round_sig(x)
    assert tbu.round_sig(x, 3) == jbu.round_sig(x, 3)


def test_round_sig_keeps_submillisecond_walls():
    assert tbu.round_sig(0.0000234567891) == 0.0000234568
    assert tbu.round_sig(0.023456789) == 0.0234568
    assert tbu.round_sig(1234567.891) == 1234570.0
    assert tbu.round_sig(0.0) == 0.0
    assert tbu.round_sig(float("inf")) == float("inf")
    assert tbu.round_sig(7) == 7


def test_bucket_cap_is_util_and_matches_reference():
    assert tbu.bucket_cap is tutil.bucket_cap
    assert tbu.BUCKET_FLOOR == jbu.BUCKET_FLOOR
    for n in (0, 1, 511, 512, 513, 4097, 1 << 20):
        assert tbu.bucket_cap(n) == jbu.bucket_cap(n)
        assert tbu.bucket_cap(n, 8) == jbu.bucket_cap(n, 8)


def test_benchmark_with_repetitions(tctx, monkeypatch):
    """The decorator runs f ``repetitions`` times and returns (mean time,
    last result); CPU results are forced without any CUDA call, and the
    reference's misspelt alias is kept."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    calls = []
    t = tct.Table.from_pydict(tctx, {"a": np.arange(10)})

    def f(x):
        calls.append(x)
        return {"t": t, "nested": [torch.ones(3), (t, 5)]}

    ms, out = tbu.benchmark_with_repetitions(4, "ms")(f)(1)
    assert len(calls) == 4 and out["t"] is t and ms >= 0
    assert synced == []
    us, _ = tbu.benchmark_with_repitions(2, "us")(lambda: 1)()
    assert us >= 0
    found = list(tbu._tensors({"t": t, "n": [torch.ones(2), (t,)]}))
    assert len(found) == 3 and all(isinstance(x, torch.Tensor)
                                   for x in found)
    jms, jout = jbu.benchmark_with_repetitions(2, "ms")(lambda: 3)()
    assert jout == 3 and jms >= 0
