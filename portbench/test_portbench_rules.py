"""What the benchmark's files must keep: no JAX anywhere under the
folder, no program in the reference, BENCHMARK.json's names, units and
limits, a file for every name it gives, and run.py's refusals."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, testing

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "cylon_tpu"}


def imported(path: Path):
    """Top-level names of every module a source imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_whole_name_scan_tells_the_packages_apart(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import cylon_tpu_torch.ops\nfrom jax import numpy\n"
                 "import importlib\nimportlib.import_module('cylon_tpu.x')\n")
    assert set(imported(p)) & JAX == {"jax", "cylon_tpu"}
    assert "cylon_tpu_torch" not in JAX


def test_no_source_imports_jax_or_the_jax_package():
    for p in HERE.rglob("*.py"):
        assert not set(imported(p)) & JAX, p


def test_reference_imports_nothing_of_the_program():
    for p in list((HERE / "reference").glob("*.py")) + [HERE / "check.py",
                                                        HERE / "gen.py"]:
        assert not set(imported(p)) & (JAX | {"cylon_tpu_torch",
                                              "portbench"}), p


def test_benchmark_json_keeps_the_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
        names.append(c["name"])
    cells = []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in names
        assert len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        cells.append(w["name"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    all_names = names + cells + [m["name"] for m in metrics]
    assert len(all_names) == len(set(all_names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        assert (HERE.parent / c["file"]).exists()
    for w in BENCH["workloads"]:
        wl = json.loads((HERE / "workloads" / f"{w['name']}.json")
                        .read_text())
        assert wl["config"] == w["config"]
        assert (HERE / "queries" / f"{wl['query']['op']}.py").exists()
        assert (HERE / "reference" / f"{wl['query']['op']}.py").exists()
    for m in BENCH["end_to_end"]:
        mod = harness.load_module(HERE / "e2e" / f"{m['name']}.py")
        assert mod.UNIT == m["unit"]
    for m in BENCH["per_layer"]:
        mod = harness.load_module(HERE / "metrics" / f"{m['name']}.py")
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == \
            (m["unit"], m["layer"], m["moves"])


def test_kernel_list_names_the_port_kernels():
    """``kernels.json`` names every hand-written kernel of the port, so
    no kernel's time counts as a torch op; a roofline file is kept only
    for a kernel whose stage some cell runs."""
    from cylon_tpu_torch.ops import kernels

    listed = harness.kernel_symbols()
    assert set(listed) == set(kernels.KERNELS)
    assert all(listed.values())
    rooflines = set(harness.roofline_modules())
    assert rooflines <= set(listed)
    read = {m["name"][:-len("_roofline")] for m in BENCH["per_layer"]
            if m["name"].endswith("_roofline")}
    assert rooflines == read


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "cylon_join_200m.inner", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=str(HERE.parent), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    root = testing.tiny_checkout(tmp_path / "c", program=False)
    p = testing.run_cpu(root, ["--workload", "cylon_join_200m.inner",
                               "--seed", "1", "--seconds", "1"])
    assert p.returncode != 0 and p.stdout.strip() == ""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "cylon_join_200m.inner", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=str(root),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_limits_name_every_number(cell):
    wl = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    want = {"rows_gap", "mismatched"} | (
        {"gap"} if wl["check"].get("gap_columns") else set())
    assert set(wl["limits"]) == want


def test_a_loop_the_harness_cannot_run_is_refused(tmp_path):
    root = testing.tiny_checkout(tmp_path / "c", program=False)
    p = root / "portbench" / "workloads" / "h2o_groupby_1e8.q5.json"
    wl = json.loads(p.read_text())
    wl["loop"] = "open"
    p.write_text(json.dumps(wl))
    with pytest.raises(ValueError):
        harness.load_cell("h2o_groupby_1e8.q5", root)


LEAKS = {
    "e2e": ("0", 1, "import jax\n"),
    "metrics": ("1", 1, "import jax\n"),
    # only the second process loads it: the first must print nothing too
    "metrics-in-another-rank": ("1", 2, "import sys\n"
                                "if '--rank' in sys.argv:\n"
                                "    import jax\n"),
}


@pytest.mark.parametrize("case", sorted(LEAKS))
def test_jax_loaded_by_a_reader_gives_no_result(tmp_path, case):
    """A reader loaded after the window that pulls in a module named
    ``jax`` (a stub here) leaves the run without a result line."""
    trace, nproc, head = LEAKS[case]
    kind = case.split("-")[0]
    root = testing.tiny_checkout(tmp_path / "c", rows=3000)
    (root / "jax").mkdir()
    (root / "jax" / "__init__.py").write_text("")
    b = json.loads((root / "BENCHMARK.json").read_text())
    cell = "h2o_groupby_1e8.q5"
    if kind == "e2e":
        b["end_to_end"].append({"name": "toy_leak", "unit": "s", "better":
                                "lower", "bound": 0.25,
                                "source": "host_clock"})
        body = 'UNIT = "s"\n'
    else:
        b["per_layer"].append({"name": "toy_leak", "unit": "s", "better":
                               "lower", "source": "program_counter",
                               "layer": "device", "moves":
                               "input_rows_per_s", "workloads": [cell]})
        body = 'UNIT, LAYER, MOVES = "s", "device", "input_rows_per_s"\n'
    (root / "portbench" / kind / "toy_leak.py").write_text(
        head + body + "\n\ndef read(r):\n    return 1.0\n")
    if nproc > 1:
        p = root / "portbench" / "workloads" / f"{cell}.json"
        wl = json.loads(p.read_text())
        wl["processes_per_chip"] = nproc
        p.write_text(json.dumps(wl))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    p = testing.run_cpu(root, ["--workload", cell, "--seed", "5",
                               "--seconds", "0.3", "--trace", trace])
    assert p.returncode != 0 and p.stdout.strip() == "", p.stdout
    assert "['jax']" in p.stderr, p.stderr[-2000:]
