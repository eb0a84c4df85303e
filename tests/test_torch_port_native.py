"""The port's native host runtime (cylon_tpu_torch/csrc/host/cylon_host.cpp
through ``cylon_tpu_torch.native``) against cylon_tpu's library
(``cylon_tpu.native``, also built here by g++) and against the port's
numpy versions, on the CPU.

* ``row_hash`` and ``hash_partition``: the three agree bit for bit for
  int32, int64, uint32, uint64, float32 and float64 keys (with -0.0 and
  NaN), nulls, dictionary codes, prehashed varbytes keys and two-column
  keys, at world 1, 3, 4 and 8; and each call the library serves counts
  in ``native.CALLS``.
* ``pack_bitmap`` / ``unpack_bitmap`` at every n in 0..130.
* The CSV writer: F10 and F11 (ROADMAP queue 3). The port's numeric CSV
  bytes equal cylon_tpu's cell for cell, but where cylon_tpu writes an
  integral float ("2", "-0"): there the port appends ".0", so its float
  columns read back as floats where cylon_tpu's read back as int64.
* ``write_csv_numeric``'s refusals, ``StagingPool`` reuse,
  ``available()``, and two processes building the library at once.
Tolerance 0 everywhere.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
from cylon_tpu import native as jnative

import cylon_tpu_torch as tct
from cylon_tpu_torch import native

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    not any(shutil.which(c) for c in ("g++", "c++", "clang++")),
    reason="no C++ compiler")

DTYPES = ("int32", "int64", "uint32", "uint64", "float32", "float64")
WORLDS = (1, 3, 4, 8)


def _keys(dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = rng.normal(0, 100, n).astype(dt)
        x[::5] = -0.0
        x[1::5] = 0.0
        x[2::13] = np.nan
        return x
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _three(fn_port, fn_np, fn_ref, *args, **kw):
    before = dict(native.CALLS)
    got = fn_port(*args, **kw)
    served = {k: native.CALLS[k] - before[k] for k in native.CALLS}
    return got, fn_np(*args, **kw), fn_ref(*args, **kw), served


def _assert_same(a, b, c):
    if isinstance(a, tuple):
        for x, y, z in zip(a, b, c):
            _assert_same(x, y, z)
        return
    assert a.dtype == b.dtype == c.dtype
    assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_hash_partition_three_ways(dtype, world):
    n = 20011  # past the library's threading threshold
    k = _keys(dtype, n, 3 + world)
    valid = np.random.default_rng(world).random(n) < 0.8
    for valids in ([None], [valid]):
        h = _three(native.row_hash, native.np_row_hash, jnative.row_hash,
                   [k], valids)
        _assert_same(*h[:3])
        assert h[3]["row_hash"] == 1
        p = _three(native.hash_partition, native.np_hash_partition,
                   jnative.hash_partition, [k], valids, world)
        _assert_same(*p[:3])
        assert p[3]["hash_partition"] == 1
        targets, counts, order = p[0]
        assert counts.sum() == n
        assert np.array_equal(np.sort(order), np.arange(n))
        assert np.array_equal(targets[order], np.sort(targets, kind="stable"))


@pytest.mark.parametrize("world", WORLDS)
def test_hash_partition_strings_and_multi_column(world):
    """Dictionary codes, prehashed varbytes keys (the host mirror of the
    device content hash, np_varbytes_hash: the library is not asked for
    the row hash but still partitions), and a two-column key."""
    rng = np.random.default_rng(40 + world)
    n = 17003
    codes = rng.integers(0, 300, n).astype(np.int32)
    words = [f"key-{i % 977}-" + "z" * (i % 23) for i in range(n)]
    vb_t, vb_j = native.np_varbytes_hash(words), \
        jnative.np_varbytes_hash(words)
    assert np.array_equal(vb_t, vb_j)
    valid = rng.random(n) < 0.9
    f = _keys("float64", n, world)
    cases = [
        ([codes], [valid], {"is_string": [True]}),
        ([vb_t], [valid], {"prehashed": [True]}),
        ([codes, f], [None, valid], {"is_string": [True, False]}),
        ([_keys("int64", n, 1), _keys("uint32", n, 2)], [valid, None], {}),
    ]
    for cols, valids, kw in cases:
        h = _three(native.row_hash, native.np_row_hash, jnative.row_hash,
                   cols, valids, **kw)
        _assert_same(*h[:3])
        assert h[3]["row_hash"] == (0 if kw.get("prehashed") else 1)
        p = _three(native.hash_partition, native.np_hash_partition,
                   jnative.hash_partition, cols, valids, world, **kw)
        _assert_same(*p[:3])
        assert p[3]["hash_partition"] == 1


def test_empty_keys_take_numpy():
    k = np.zeros(0, np.int32)
    before = dict(native.CALLS)
    t, c, o = native.hash_partition([k], [None], 4)
    assert native.CALLS == before
    assert t.shape == o.shape == (0,) and c.tolist() == [0] * 4


def test_bitmaps_three_ways():
    rng = np.random.default_rng(9)
    for n in range(131):
        mask = rng.random(n) < 0.5
        bits = _three(native.pack_bitmap, native.np_pack_bitmap,
                      jnative.pack_bitmap, mask)
        _assert_same(*bits[:3])
        assert bits[3]["pack_bitmap"] == 1
        back = _three(native.unpack_bitmap, native.np_unpack_bitmap,
                      jnative.unpack_bitmap, bits[0], n)
        _assert_same(*back[:3])
        assert np.array_equal(back[0], mask)


# F10's table (ROADMAP queue 3): cylon_tpu writes %.9g / %.17g
F10 = {"f32": np.array([0.1, 1 / 3, -0.0, 2.0, 1e20, -7.5], np.float32),
       "f64": np.array([0.1, 2.0, -0.0, 1 / 3, 1e300, -5.0]),
       "i32": np.array([0, -1, 2 ** 31 - 1, -2 ** 31, 5, 6], np.int32),
       "i64": np.array([0, -1, 2 ** 62, -2 ** 63, 5, 6], np.int64),
       "u32": np.array([0, 1, 2 ** 32 - 1, 7, 5, 6], np.uint32),
       "u64": np.array([0, 1, 2 ** 64 - 1, 7, 5, 6], np.uint64)}
# F11's smallest input: an integral float64 column
F11 = {"x": np.array([1.0, 2.0, 3.0])}


def _write_both(tmp_path, data, name):
    jpath, tpath = tmp_path / f"{name}_j.csv", tmp_path / f"{name}_t.csv"
    jct.Table.from_pydict(jct.CylonContext.Init(), data).to_csv(str(jpath))
    before = native.CALLS["write_csv"]
    tct.Table.from_pydict(tct.CylonContext.Init(device="cpu"), data).to_csv(
        str(tpath))
    assert native.CALLS["write_csv"] == before + 1  # the library wrote it
    return jpath.read_text(), tpath.read_text(), jpath, tpath


def _integral(cell: str) -> bool:
    return cell.lstrip("-").isdigit()


def test_csv_bytes_f10_and_f11(tmp_path):
    """F10: the port's numeric CSV equals cylon_tpu's cell for cell (the
    port once wrote pandas' "0.1" where cylon_tpu writes "0.100000001").
    F11: where cylon_tpu's cell is an integral float, the port's is the
    same text with ".0", so it reads back as a float."""
    jtext, ttext, jpath, tpath = _write_both(tmp_path, F10, "f10")
    assert ttext.splitlines()[1] == \
        "0.100000001,0.10000000000000001,0,0,0,0"
    assert jtext.splitlines()[1] == ttext.splitlines()[1]
    floats = {0, 1}
    f11_cells = 0
    for jl, tl in zip(jtext.splitlines(), ttext.splitlines(), strict=True):
        for i, (jc, tc) in enumerate(zip(jl.split(","), tl.split(","),
                                         strict=True)):
            if jc == tc:
                continue
            assert i in floats and _integral(jc) and tc == jc + ".0", \
                (jc, tc)
            f11_cells += 1
    # 2 and -0 in f32; 2, -0 and -5 in f64
    assert f11_cells == 5
    assert pd.read_csv(tpath).dtypes.tolist() == \
        [np.float64, np.float64, np.int64, np.int64, np.int64, np.uint64]
    jtext, ttext, jpath, tpath = _write_both(tmp_path, F11, "f11")
    assert jtext == "x\n1\n2\n3\n" and ttext == "x\n1.0\n2.0\n3.0\n"
    assert pd.read_csv(jpath)["x"].dtype == np.int64  # F11, cylon_tpu
    assert pd.read_csv(tpath)["x"].dtype == np.float64


def test_csv_nulls_nan_and_round_trip(tmp_path):
    """Null and NaN cells are empty in both files; float64 values read back
    bit for bit through the port's reader."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=500)
    x[::9] = np.nan
    data = {"k": rng.integers(-5, 5, 500), "x": x,
            "y": rng.normal(size=500).astype(np.float32)}
    jtext, ttext, _jp, tpath = _write_both(tmp_path, data, "nulls")
    assert [ln.split(",")[1] == "" for ln in jtext.splitlines()] == \
        [ln.split(",")[1] == "" for ln in ttext.splitlines()]
    back = tct.read_csv(tct.CylonContext.Init(device="cpu"), str(tpath))
    got = back.to_pydict()
    assert np.array_equal(got["x"], x, equal_nan=True)
    assert np.array_equal(got["k"], data["k"])


def test_write_csv_routes(tmp_path):
    """Strings, bools and temporal columns, and names the writer cannot
    emit verbatim, go through pandas (no library call); a masked table is
    compacted first."""
    ctx = tct.CylonContext.Init(device="cpu")
    before = native.CALLS["write_csv"]
    tct.Table.from_pydict(ctx, {"s": np.array(["a", "b"]),
                                "v": np.arange(2)}).to_csv(
        str(tmp_path / "s.csv"))
    tct.Table.from_pydict(ctx, {"b": np.array([True, False])}).to_csv(
        str(tmp_path / "b.csv"))
    tct.Table.from_pydict(ctx, {"a,b": np.arange(2)}).to_csv(
        str(tmp_path / "q.csv"))
    assert native.CALLS["write_csv"] == before
    assert pd.read_csv(tmp_path / "q.csv").columns.tolist() == ["a,b"]
    t = tct.Table.from_pydict(ctx, {"v": np.arange(10, dtype=np.int32)})
    masked = t[t["v"] > 6]
    masked.to_csv(str(tmp_path / "m.csv"))
    assert native.CALLS["write_csv"] == before + 1
    assert (tmp_path / "m.csv").read_text() == "v\n7\n8\n9\n"


def test_write_csv_numeric_rejects_bad_args(tmp_path):
    cols = [np.arange(5, dtype=np.int32), np.arange(5, dtype=np.float64)]
    for names, sep in ((["one"], ","), (["a", "b"], "¦"), (["a", "b"], ";;"),
                       (['a"', "b"], ",")):
        assert native.write_csv_numeric(cols, [None, None], names,
                                        str(tmp_path / "x.csv"), sep) is False
    assert native.write_csv_numeric([np.zeros(3, np.int16)], [None], ["a"],
                                    str(tmp_path / "x.csv")) is False
    assert not (tmp_path / "x.csv").exists()
    assert native.write_csv_numeric(cols, [None, None], ["a", "b"],
                                    str(tmp_path / "no" / "x.csv")) is False


def test_staging_pool_reuse():
    pool = native.StagingPool()
    a = pool.take(1 << 16)
    assert a is not None and a.nbytes >= 1 << 16
    a[:8] = np.arange(8, dtype=np.uint8)
    addr = a._ct_pool_addr
    assert addr % 64 == 0
    pool.give(a)
    b = pool.take(1 << 16)
    assert b._ct_pool_addr == addr  # reused, not allocated again
    live, _free = pool.stats()
    assert live >= 1 << 16
    pool.give(b)
    assert pool.stats()[0] == live - (1 << 16)


def test_available_reports():
    assert native.available() is True
    assert native.BUILD_ERROR is None and native.BUILD_SECONDS is not None
    assert Path(native.lib_path()).exists()


_BUILD_CHILD = """
import sys
from cylon_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
assert native.available(), native.BUILD_ERROR
import numpy as np
k = np.arange(50000, dtype=np.int64)
assert np.array_equal(native.row_hash([k], [None]),
                      native.np_row_hash([k], [None]))
print(native.lib_path(), native.BUILD_SECONDS)
"""


def test_two_processes_build_at_once(tmp_path):
    """Both compile to names of their own and rename into place: both load
    a whole library, and no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD,
                               str(tmp_path)], cwd=str(ROOT),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    paths = {out.split()[0] for out in outs}
    assert len(paths) == 1
    assert [f.name for f in tmp_path.iterdir()] == \
        [Path(paths.pop()).name]
