"""The port's measuring tools (scripts/torch_port/scaling_sweep.py,
compare_competitors.py, profile_shuffle.py, profile_dist_join.py,
profile_stream.py, profile_join.py) on the CPU at tiny sizes.

Each tool's ``main`` runs in-process with ``--device cpu`` and the route
switches forced on, so the kernels' plain versions run through the same
call sites as K1-K4 and K7 on the card. Its JSON keys equal the keys of
the JAX script of the same name, whose ``main`` is called in-process at
the same size (never as a script: its ``__main__`` block writes
SCALING.json, COMPARE.json or PROFILE_*.json at the repo root), apart
from the keys named here: what the port adds (its device, kernel
launches and row counts) and what only the JAX script's CPU branch
prints. The JAX package's profile_stream.py and profile_join.py cannot
run here (the first calls its Pallas kernels outside interpret mode, the
second is fixed at 2^24 rows): their printed phase labels are matched
in their source instead. Every recorded row count equals numpy's and
cylon_tpu's on the same inputs. With ``--device cuda`` and no CUDA, each
tool raises.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.parallel import dist_ops as jdist

from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch.status import CylonError

ROOT = Path(__file__).resolve().parent.parent
TOOLS_DIR = ROOT / "scripts" / "torch_port"
TOOLS = ("scaling_sweep", "compare_competitors", "profile_shuffle",
         "profile_dist_join", "profile_stream", "profile_join")
ROOT_FILES = ("SCALING.json", "COMPARE.json", "PROFILE_shuffle.json",
              "PROFILE_dist_join.json")
# keys the port adds to the JAX script's, and the JAX script's keys the
# port leaves out (its XLA-plan branch on the CPU)
PORT_ONLY = {
    "scaling_sweep": {"device", "wall_s", "launches"},
    "compare_competitors": {"device", "expected", "launches"},
    "profile_shuffle": {"device", "rows_out", "launches"},
    "profile_dist_join": {"device", "route", "join_wall_s", "rows_out",
                          "broadcast_rows_out", "launches"},
}
REF_ONLY = {"profile_dist_join": {"stream_mode"}}
# the JAX scripts' printed labels -> the port's keys
PRINTED = {
    "profile_stream": {'f"plan ': "plan_s", 'f"materialize ': "materialize_s",
                       '"  expand jit': "expand_s", "n_out=": "n_out",
                       "cap_e=": "cap_e"},
    "profile_join": {'f"plan:': "plan_s", "n_primary=": "n_primary",
                     "cap=": "cap", 'f"materialize:': "materialize_s",
                     "expand_from_match alone": "expand_s",
                     "micro 1-col gather": "gather_1col_s",
                     "micro packed (n,4)": "gather_packed4_s",
                     "4x1col": "gather_4x1col_s",
                     "micro packed (n,2)": "gather_packed2_s",
                     "micro scatter 1col": "scatter_1col_s",
                     "packed 2col": "scatter_packed2_s",
                     "micro fused 4-operand sort": "sort_fused_s",
                     "micro cumsum": "cumsum_s"},
}
SIZES = {"scaling_sweep": ["8"], "compare_competitors": ["10"],
         "profile_shuffle": ["10"],
         "profile_dist_join": ["10", "--bcast-rows-log2", "14"],
         "profile_stream": ["10"], "profile_join": ["10"]}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    sys.path.insert(0, str(TOOLS_DIR))
    try:
        yield {t: _load(TOOLS_DIR / f"{t}.py", f"port_tool_{t}")
               for t in TOOLS}
    finally:
        sys.path.remove(str(TOOLS_DIR))


@pytest.fixture(scope="module")
def root_files():
    """The JAX-era JSON files at the repo root, byte for byte."""
    before = {f: (ROOT / f).read_bytes() for f in ROOT_FILES
              if (ROOT / f).exists()}
    yield
    after = {f: (ROOT / f).read_bytes() for f in ROOT_FILES
             if (ROOT / f).exists()}
    assert after == before, "a tool wrote a JAX-era file at the repo root"


_RUNS = {}


def _run(tools, name, capsys):
    """The port tool's summary at its tiny size, the routes forced on
    (cached: one run a tool)."""
    if name not in _RUNS:
        saved = (tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL)
        tjoin.STREAM_PLAN = tshuffle.PARTITION_KERNEL = True
        try:
            doc = tools[name].main(SIZES[name] + ["--device", "cpu"])
        finally:
            tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL = saved
        last = [l for l in capsys.readouterr().out.splitlines()
                if l.strip()][-1]
        assert json.loads(last) == json.loads(json.dumps(doc, default=str))
        _RUNS[name] = doc
    return _RUNS[name]


_REF = {}


def _reference(name):
    """The JAX script's ``main`` at the same size, in-process."""
    if name not in _REF:
        mod = _load(ROOT / "scripts" / f"{name}.py", f"jax_tool_{name}")
        _REF[name] = mod.main(int(SIZES[name][0]))
    return _REF[name]


@pytest.mark.parametrize("name", ["scaling_sweep", "compare_competitors",
                                  "profile_shuffle", "profile_dist_join"])
def test_keys_equal_the_jax_scripts(tools, root_files, capsys, name):
    got = _run(tools, name, capsys)
    ref = _reference(name)
    want = (set(ref) - REF_ONLY.get(name, set())) | PORT_ONLY[name]
    assert set(got) == want, (sorted(set(got) ^ want))
    if name == "scaling_sweep":
        assert set(got["modes"]) == set(ref["modes"]) == {"strong", "weak"}
        for mode in ("strong", "weak"):
            g, r = got["modes"][mode], ref["modes"][mode]
            assert set(g) == set(r)
            assert [x["world"] for x in g["worlds"]] == \
                [x["world"] for x in r["worlds"]] == [1, 2, 4, 8]
            for gw, rw in zip(g["worlds"], r["worlds"]):
                assert set(gw) == set(rw) | {"dist_join_rows_out"}
                assert gw["global_rows"] == rw["global_rows"]
        assert isinstance(got["diagnosis"], str) and "cpu" in \
            got["diagnosis"]
    if name == "compare_competitors":
        ref_engines = {("cylon_tpu_torch" if e == "cylon_tpu" else e): v
                       for e, v in ref["engines"].items()}
        assert set(got["engines"]) == set(ref_engines)
        for e, r in ref_engines.items():
            g = got["engines"][e]
            extra = {"launches"} if e == "cylon_tpu_torch" else set()
            extra |= {"join_rows", "groups"} if "join_s" in r and \
                "groupby_s" in r else set()
            assert set(g) == set(r) | extra, (e, sorted(g), sorted(r))
        assert set(got["speedup_vs_pandas"]) == set(ref["speedup_vs_pandas"])


@pytest.mark.parametrize("name", ["profile_stream", "profile_join"])
def test_printed_phases_of_the_jax_scripts(tools, root_files, capsys, name):
    """The JAX script prints its phases: each label is in its source and
    its value is a key of the port's summary."""
    src = (ROOT / "scripts" / f"{name}.py").read_text()
    got = _run(tools, name, capsys)
    for label, key in PRINTED[name].items():
        assert label in src, label
        assert key in got, key
        assert isinstance(got[key], (int, float)), (key, got[key])


def _numpy_join_rows(lk, rk, n):
    return int((np.bincount(lk, minlength=n).astype(np.int64)
                * np.bincount(rk, minlength=n)).sum())


def test_sweep_rows_equal_numpy_and_cylon_tpu(tools, root_files, capsys,
                                              dist_ctx):
    got = _run(tools, "scaling_sweep", capsys)
    for mode in ("strong", "weak"):
        for r in got["modes"][mode]["worlds"]:
            n, w = r["global_rows"], r["world"]
            rng = np.random.default_rng(w)
            lk = rng.integers(0, n, n)
            rng.normal(size=n)
            rk = rng.integers(0, n, n)
            assert r["dist_join_rows_out"] == _numpy_join_rows(lk, rk, n)
    # the world-4 point of the strong sweep through the JAX package
    n = got["modes"]["strong"]["global_rows"]
    rng = np.random.default_rng(4)
    lt = jct.Table.from_pydict(dist_ctx, {
        "k": rng.integers(0, n, n).astype(np.int64),
        "v": rng.normal(size=n).astype(np.float32)})
    rt = jct.Table.from_pydict(dist_ctx, {
        "k": rng.integers(0, n, n).astype(np.int64),
        "w": rng.normal(size=n).astype(np.float32)})
    cfg = lt._make_join_config(rt, "inner", "sort", {"on": ["k"]})
    ref = jdist.distributed_join(lt, rt, cfg, force_exchange=True)
    assert got["modes"]["strong"]["worlds"][2]["dist_join_rows_out"] == \
        ref.row_count


def test_compare_counts_equal_numpy_and_cylon_tpu(tools, root_files, capsys,
                                                  local_ctx):
    got = _run(tools, "compare_competitors", capsys)
    d = tools["compare_competitors"].make_data(got["n_rows"])
    cy = got["engines"]["cylon_tpu_torch"]
    assert cy["join_rows"] == got["expected"]["join_rows"] == \
        _numpy_join_rows(d["lk"], d["rk"], got["n_rows"])
    assert cy["groups"] == got["expected"]["groups"] == \
        np.unique(d["g"]).size
    left = jct.Table.from_pydict(local_ctx, {"k": d["lk"], "v": d["lv"]})
    right = jct.Table.from_pydict(local_ctx, {"k": d["rk"], "w": d["rv"]})
    gt = jct.Table.from_pydict(local_ctx, {"g": d["g"], "x": d["lv"],
                                           "y": d["g"]})
    assert cy["join_rows"] == left.join(right, "inner", on="k").row_count
    assert cy["groups"] == gt.groupby(0, [1, 2, 1], ["sum", "count",
                                                     "mean"]).row_count
    for e in ("pandas", "pyarrow"):
        if "join_rows" in got["engines"][e]:
            assert got["engines"][e]["join_rows"] == cy["join_rows"]
            assert got["engines"][e]["groups"] == cy["groups"]


def test_profile_rows_equal_numpy_and_cylon_tpu(tools, root_files, capsys,
                                                local_ctx, dist_ctx):
    shuf = _run(tools, "profile_shuffle", capsys)
    assert shuf["rows_out"] == shuf["n_rows"]
    assert shuf["partition_path"] == "kernel"
    assert shuf["chunks"] >= 4
    dj = _run(tools, "profile_dist_join", capsys)
    assert dj["route"] == "stream"
    n = dj["n_rows"]
    rng = np.random.default_rng(0)
    lk = rng.integers(0, n, n).astype(np.int32)
    lv = rng.normal(size=n).astype(np.float32)
    rk = rng.integers(0, n, n).astype(np.int32)
    rv = rng.normal(size=n).astype(np.float32)
    expect = _numpy_join_rows(lk, rk, n)
    jl = jct.Table.from_pydict(dist_ctx, {"k": lk, "v": lv})
    jr = jct.Table.from_pydict(dist_ctx, {"k": rk, "w": rv})
    ref = jl.distributed_join(jr, "inner", on=["k"]).row_count
    assert dj["rows_out"] == expect == ref
    local = jct.Table.from_pydict(local_ctx, {"k": lk, "v": lv}).join(
        jct.Table.from_pydict(local_ctx, {"k": rk, "w": rv}), "inner",
        on="k").row_count
    for name, key in (("profile_stream", "n_out"),
                      ("profile_join", "n_primary")):
        got = _run(tools, name, capsys)
        assert got["n_rows"] == n and got[key] == expect == local
    assert _run(tools, "profile_stream", capsys)["rows_out"] == expect
    # the broadcast join at phase 18's shapes
    nb = 1 << 14
    brng = np.random.default_rng(21)
    build = max(nb // 1000, 64)
    keys = build // 2
    bk = brng.integers(0, keys, nb)
    brng.normal(size=nb)
    sk = brng.integers(0, keys, build)
    assert dj["broadcast_build_rows"] == build
    assert dj["broadcast_rows_out"] == _numpy_join_rows(bk, sk, keys)


@pytest.mark.parametrize("name", TOOLS)
def test_cuda_without_a_card_raises(tools, name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(CylonError):
        tools[name].main(SIZES[name] + ["--device", "cuda"])


@pytest.mark.parametrize("name", TOOLS)
def test_out_is_the_only_file_written(tools, root_files, capsys, tmp_path,
                                      name):
    """``--out PATH`` writes the summary there; without it, nothing is
    written (the module fixture checks the JAX-era files)."""
    out = tmp_path / "sub" / f"{name}.json"
    small = {"scaling_sweep": ["6"]}.get(name, ["8"])
    if name == "profile_dist_join":
        small += ["--bcast-rows-log2", "12"]
    doc = tools[name].main(small + ["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(
        doc, default=str))
    assert sorted(p.name for p in tmp_path.rglob("*") if p.is_file()) == \
        [out.name]
