"""The port's examples (examples/torch_port/) on the CPU against the JAX
package's (examples/): each port example's ``main(device="cpu")``
returns what it printed, and its counts must equal what the reference
example prints, run in-process on the CPU mesh (8 devices: the join,
set-op and groupby examples run distributed there, at world 8, where the
port's run at their default worlds; row counts do not depend on the
world). The DDP demo has a file of its own
(tests/test_torch_port_ddp_example.py).

Where a value is a float, the tolerance is stated. The groupby example
also pins F12 (ROADMAP queue 3): the reference's ``distributed_groupby``
takes op names ("sum", "count", "mean") that its IntEnum never equals,
and computes MAX for every one of them; the port converts the names, and
its groups equal pandas'.
"""
import contextlib
import importlib.util
import io
import runpy
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "examples" / "torch_port"
REF = ROOT / "examples"
_REF_OUT = {}


def _load(folder: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        f"{folder.name}_{name}", folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _captured(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return result, buf.getvalue()


def reference(name: str, dist_ctx) -> str:
    """What the JAX package's example printed (run once a module)."""
    if name not in _REF_OUT:
        path = REF / f"{name}.py"
        if name == "plan_pipeline_example":  # module-level script
            _r, out = _captured(lambda: runpy.run_path(str(path)))
        else:
            _r, out = _captured(_load(REF, name).main)
        _REF_OUT[name] = out
    return _REF_OUT[name]


def port(name: str, **kw):
    return _captured(lambda: _load(PORT, name).main(device="cpu", **kw))


@pytest.fixture(scope="module", autouse=True)
def _drop_cache():
    yield
    _REF_OUT.clear()


def test_join_example(dist_ctx):
    ref = reference("join_example", dist_ctx)
    got, out = port("join_example")
    for jt, rows in got.items():
        assert f"{jt:>6} join: {rows} rows, world=4" in out
        assert f"{jt:>6} join: {rows} rows, world=8" in ref
    assert set(got) == {"inner", "left", "right", "outer"}


def test_set_ops_example(dist_ctx):
    ref = reference("set_ops_example", dist_ctx)
    for world in (1, 4):
        got, out = port("set_ops_example", world=world)
        line = (f"union: {got['union']} intersect: {got['intersect']} "
                f"subtract: {got['subtract']}")
        assert line in out and line in ref


def test_groupby_example_and_f12(dist_ctx):
    ref = reference("groupby_example", dist_ctx)
    got, out = port("groupby_example")
    assert f"{got['groups']} groups from 500000 rows" in out
    assert f"{got['groups']} groups from 500000 rows" in ref
    ref_total = float(ref.split("total sales:")[1])
    assert abs(got["total_sales"] - ref_total) <= 1e-12 * ref_total
    # the printed first group against pandas (F12: the reference prints
    # MAX in every column)
    rng = np.random.default_rng(11)
    n = 500_000
    df = pd.DataFrame({"store": rng.integers(0, 1000, n).astype(np.int32),
                       "sales": rng.exponential(50.0, n),
                       "units": rng.integers(1, 20, n).astype(np.int32)})
    g0 = df[df.store == 0]
    row = out.splitlines()[2].split("\t")
    assert row[0] == "0" and int(row[2]) == len(g0)
    assert abs(float(row[1]) - g0.sales.sum()) <= 1e-9 * g0.sales.sum()
    assert abs(float(row[3]) - g0.sales.mean()) <= 1e-9 * g0.sales.mean()
    ref_row = ref.splitlines()[2].split()
    assert int(ref_row[2]) == g0.units.max() != len(g0)  # F12
    assert abs(float(ref_row[1]) - g0.sales.max()) <= 1e-5 * g0.sales.max()


def test_select_project_example(dist_ctx):
    ref = reference("select_project_example", dist_ctx)
    got, out = port("select_project_example")
    assert f"select a<10: {got['select']}" in ref
    assert f"mask a>90: {got['mask']}" in ref
    assert f"projected columns: {got['projected']}" in ref
    # the three largest b, in order
    ref_b = [float(ln.split()[1]) for ln in ref.splitlines()[-3:]]
    got_b = [float(ln.split("\t")[1]) for ln in out.splitlines()[-3:]]
    assert np.allclose(got_b, ref_b, rtol=1e-6, atol=0)


def test_csv_pipeline_example(dist_ctx, tmp_path):
    ref = reference("csv_pipeline_example", dist_ctx)
    got, out = port("csv_pipeline_example", folder=str(tmp_path))
    assert f"rows: {got['rows']}" in ref
    assert got["path"] == str(tmp_path / "spend.csv")
    ref_path = ref.split("wrote ")[1].split()[0]
    a, b = pd.read_csv(got["path"]), pd.read_csv(ref_path)
    assert np.array_equal(a.iloc[:, 0], b.iloc[:, 0])
    assert np.allclose(a.iloc[:, 1], b.iloc[:, 1], rtol=1e-12, atol=0)
    # the host library wrote the port's inputs with a float column
    assert pd.read_csv(tmp_path / "items.csv")["amount"].dtype == np.float64


def test_plan_pipeline_example(dist_ctx):
    ref = reference("plan_pipeline_example", dist_ctx)
    got, out = port("plan_pipeline_example")
    line = (f"rows: {got['rows']}, exchange stages: "
            f"{got['exchange_stages']}")
    assert line in out and line in ref
    assert got["exchange_stages"] == 1


def test_string_regimes_demo(dist_ctx):
    ref = reference("string_regimes_demo", dist_ctx)
    got, out = port("string_regimes_demo")
    for line in ("dictionary regime: True",
                 "varbytes: True | exact lanes: True",
                 f"self-join rows: {got['self_join']} ",
                 "long keys words: 11 ",
                 f"exact-verified join rows: {got['exact_join']}"):
        assert line in out and line in ref


def test_torch_dataloader_demo(dist_ctx):
    """The ETL's rows and labels equal the reference's make_features;
    both epochs' losses are finite."""
    import cylon_tpu as jct

    ref_mod = _load(REF, "torch_dataloader_demo")
    x = ref_mod.make_features(jct.CylonContext.Init()).project(
        [1, 3]).to_numpy(order="C").astype(np.float32)
    x = np.nan_to_num(x)
    got, out = port("torch_dataloader_demo")
    assert got["rows"] == len(x)
    assert got["positives"] == int((x[:, 1] > 100.0).sum())
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
    assert f"epoch 1: loss {got['losses'][1]:.4f}" in out


def test_every_example_is_ported():
    ref = sorted(p.name for p in REF.glob("*.py"))
    assert sorted(p.name for p in PORT.glob("*.py")) == ref
    for p in PORT.glob("*.py"):
        src = p.read_text()
        assert "def main(device=None" in src and '"--device"' in src, p
