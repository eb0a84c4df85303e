"""The port's C binding (cylon_tpu_torch/csrc/host/cylon_cbind.c, built
and run by ``cylon_tpu_torch.cbind``) against the JAX package's
(native/cylon_cbind.c through scripts/build_cbind.sh), on the CPU.

Both C programs embed the interpreter and drive their package's
``table_api`` by string ids: read two CSVs, inner-join them on column 0,
count the rows, write the result. The same seeded CSVs go to both; the
printed row counts must be equal, and the written files equal as
multisets of rows with every value rounded to float32: the JAX program
runs without x64 and writes float32 payloads (``%.9g``), the port keeps
float64 (``%.17g``); both round the same parsed double, so the float32
values compare exactly. Skips where gcc or a linkable libpython is
missing.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import cylon_tpu_torch as tct
from cylon_tpu_torch import cbind

ROOT = Path(__file__).resolve().parent.parent


def _need_toolchain():
    if shutil.which("gcc") is None:
        pytest.skip("no gcc")
    try:
        cbind.flags()
    except tct.CylonError as e:
        pytest.skip(f"no linkable libpython: {e}")


def _write(path: Path, n: int, seed: int, keys: int):
    rng = np.random.default_rng(seed)
    pd.DataFrame({"k": rng.integers(0, keys, n),
                  "v": rng.normal(0, 1000, n),
                  "w": rng.integers(0, 1000, n)}).to_csv(path, index=False)


def _rows(path: Path) -> list:
    df = pd.read_csv(path)
    return sorted(map(tuple, df.to_numpy(dtype=np.float64).astype(
        np.float32).tolist()))


@pytest.mark.parametrize("n,keys", [(3000, 700), (1, 1), (500, 100000)])
def test_port_binding_equals_reference(tmp_path, n, keys):
    _need_toolchain()
    if shutil.which("python3-config") is None:
        pytest.skip("the JAX package's build script needs python3-config")
    left, right = tmp_path / "l.csv", tmp_path / "r.csv"
    _write(left, n, 1 + n, keys)
    _write(right, n + 17, 2 + n, keys)
    out_t, out_j = tmp_path / "t.csv", tmp_path / "j.csv"
    rows = cbind.run(str(left), str(right), str(out_t), device="cpu")
    r = subprocess.run(["sh", "scripts/build_cbind.sh", str(left),
                        str(right), str(out_j)], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"CBIND OK rows={rows} " in r.stdout
    got, exp = _rows(out_t), _rows(out_j)
    assert len(got) == rows
    assert got == exp
    # and an independent count
    lk = pd.read_csv(left)["k"].value_counts()
    rk = pd.read_csv(right)["k"].value_counts()
    assert rows == int((lk * rk).dropna().sum())


def test_binding_output_and_errors(tmp_path):
    """The program prints its launch counts after its OK line (none on the
    CPU: the plain versions do not count), and a missing input fails
    with the program's message, not a hang or a zero count."""
    _need_toolchain()
    left = tmp_path / "l.csv"
    _write(left, 200, 5, 50)
    out = cbind.execute(str(left), str(left), str(tmp_path / "o.csv"),
                        "cpu")
    lines = out.splitlines()
    assert lines[0].startswith("CBIND OK rows=")
    assert lines[1].startswith("LAUNCHES {") and '"join_plan_stream": 0' \
        in lines[1]
    with pytest.raises(tct.CylonError, match="read_csv") as e:
        cbind.run(str(tmp_path / "missing.csv"), str(left),
                  str(tmp_path / "x.csv"), "cpu")
    assert e.value.code == tct.Code.ExecutionError
    assert cbind.build() == cbind.binary_path()
