"""cylon_tpu_torch stands alone: it imports neither jax nor cylon_tpu
(nor does chip_smoke.py, nor the port's examples in examples/torch_port/,
nor its drills and measuring tools in scripts/torch_port/, nor the
process-group children of the CPU tests,
tests/torch_port_mp_child.py), its C sources name no module but its own,
and its entry points refuse to run on a CUDA-less machine unless asked
for the CPU."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "cylon_tpu_torch"
CHILD = ROOT / "tests" / "torch_port_mp_child.py"
EXAMPLES = ROOT / "examples" / "torch_port"
DRILLS = ROOT / "scripts" / "torch_port"
DRILL_NAMES = ("smoke_telemetry", "smoke_service", "smoke_obs",
               "smoke_stats", "chaos", "fuzz_differential",
               "scaling_sweep", "compare_competitors", "profile_shuffle",
               "profile_dist_join", "profile_stream", "profile_join")
FORBIDDEN = ("jax", "jaxlib", "cylon_tpu")


def _forbidden(module: str) -> bool:
    # exact module names: cylon_tpu_torch itself starts with "cylon_tpu"
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_import_leaves_jax_and_cylon_tpu_out():
    code = ("import sys, cylon_tpu_torch, cylon_tpu_torch.parallel.dist_ops,"
            " cylon_tpu_torch.interop, cylon_tpu_torch.ops.kernels,"
            " cylon_tpu_torch.ops.setops, cylon_tpu_torch.ops.groupby,"
            " cylon_tpu_torch.ops.aggregates, cylon_tpu_torch.data.strings,"
            " cylon_tpu_torch.io.parquet, cylon_tpu_torch.native,"
            " cylon_tpu_torch.memory, cylon_tpu_torch.telemetry.knobs,"
            " cylon_tpu_torch.telemetry, cylon_tpu_torch.telemetry.spans,"
            " cylon_tpu_torch.telemetry.flight,"
            " cylon_tpu_torch.telemetry.stats,"
            " cylon_tpu_torch.telemetry.querylog,"
            " cylon_tpu_torch.plan, cylon_tpu_torch.plan.executor,"
            " cylon_tpu_torch.plan.optimizer, cylon_tpu_torch.plan.report,"
            " cylon_tpu_torch.plan.lazy, cylon_tpu_torch.resilience,"
            " cylon_tpu_torch.resilience.admission,"
            " cylon_tpu_torch.table_api, cylon_tpu_torch.service,"
            " cylon_tpu_torch.service.scheduler,"
            " cylon_tpu_torch.service.obs_http,"
            " cylon_tpu_torch.service.plancache, cylon_tpu_torch.plan.tasks,"
            " cylon_tpu_torch.parallel.task_plan,"
            " cylon_tpu_torch.telemetry.profiler,"
            " cylon_tpu_torch.arrow_builder, cylon_tpu_torch.io.dataloader,"
            " cylon_tpu_torch.benchutils, cylon_tpu_torch.cbind,"
            " torch_port_mp_child;"
            " bad = [m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'cylon_tpu')];"
            " print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(CHILD.parent)]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_scan_covers_the_new_subpackages():
    names = {str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")}
    for sub in ("plan/executor.py", "plan/optimizer.py", "plan/lazy.py",
                "resilience/retry.py", "resilience/admission.py",
                "telemetry/spans.py", "telemetry/ledger.py",
                "table_api.py", "service/__init__.py",
                "service/plancache.py", "service/scheduler.py",
                "service/obs_http.py", "plan/tasks.py",
                "parallel/task_plan.py", "telemetry/profiler.py",
                "arrow_builder.py", "io/dataloader.py", "benchutils.py",
                "native.py", "cbind.py"):
        assert sub in names
    assert len(list(EXAMPLES.glob("*.py"))) == 9


@pytest.mark.parametrize("path", sorted(
    [p for p in PACKAGE.rglob("*.py")] + list(EXAMPLES.glob("*.py"))
    + list(DRILLS.glob("*.py")) + [ROOT / "chip_smoke.py", CHILD]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    """The AST scan covers every module of the package (plan/,
    resilience/ and telemetry/ included), the port's examples, its
    drills, chip_smoke.py and the process-group child."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue  # relative: inside the package
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_drills_are_all_there():
    names = {p.stem for p in DRILLS.glob("*.py")}
    assert names == set(DRILL_NAMES) | {"drill_common"}
    assert (DRILLS / "check.sh").exists()


@pytest.mark.parametrize("name", DRILL_NAMES)
def test_drill_help_imports_no_jax(name):
    """Each drill and measuring tool answers ``--help`` (exit 0) with its modules and the
    package loaded, and no jax or cylon_tpu module among them."""
    path = DRILLS / f"{name}.py"
    code = ("import runpy, sys\n"
            f"sys.argv = [{str(path)!r}, '--help']\n"
            f"sys.path.insert(0, {str(DRILLS)!r})\n"
            "try:\n"
            f"    runpy.run_path({str(path)!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n"
            "import cylon_tpu_torch, cylon_tpu_torch.service, "
            "cylon_tpu_torch.plan, drill_common\n"
            "bad = [m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'cylon_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "usage:" in r.stdout


# a module name in a C source: an import call's argument, or an import
# statement in embedded Python text
_C_MODULES = re.compile(
    r'PyImport_ImportModule\(\s*"([\w.]+)"|(?:from|import)\s+([\w.]+)')


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("csrc/host/*.c*")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_c_sources_name_only_the_port(path):
    """The host library and the C binding are the port's own copies: the
    binding imports ``cylon_tpu_torch`` modules only, and neither source
    names a module of jax or of cylon_tpu."""
    src = path.read_text()
    imported = [m.group(1) for m in _C_MODULES.finditer(src) if m.group(1)]
    assert all(m.split(".")[0] == "cylon_tpu_torch" for m in imported), \
        imported
    words = re.findall(r"[A-Za-z_][\w.]*", src)
    bad = sorted({w for w in words if _forbidden(w)})
    assert not bad, f"{path} names {bad}"
    if path.suffix == ".c":
        assert "cylon_tpu_torch.table_api" in imported


def test_context_without_device_needs_cuda():
    import cylon_tpu_torch as ct

    if torch.cuda.is_available():
        assert ct.CylonContext.Init().device.type == "cuda"
        return
    with pytest.raises(ct.CylonError, match="CUDA is not available"):
        ct.CylonContext.Init()
    with pytest.raises(ct.CylonError, match="CUDA is not available"):
        ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    assert ct.CylonContext.Init(device="cpu").device.type == "cpu"


def test_strings_raise_not_ported():
    """String columns load and export, the ring join on a string key
    (which raised "not yet ported" before the ring join was ported)
    equals the shuffle join, and an unknown ``comm`` raises Code.Invalid
    with the JAX package's message."""
    import numpy as np

    import cylon_tpu_torch as ct

    ctx = ct.CylonContext.Init(device="cpu")
    t = ct.Table.from_pydict(ctx, {"s": np.array(["a", "b"])})
    assert t.to_pydict()["s"].tolist() == ["a", "b"]
    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                           device="cpu")
    d = ct.Table.from_pydict(dctx, {"s": np.array(["a", "b", "c", "a"]),
                                    "v": np.arange(4)})
    ring = d.distributed_join(d, "inner", on=["s"], comm="ring")
    shuffle = d.distributed_join(d, "inner", on=["s"])

    def rows(x):
        return sorted(zip(*[v.tolist() for v in x.to_pydict().values()]))

    assert rows(ring) == rows(shuffle) and len(rows(ring)) == 6
    with pytest.raises(ct.CylonError, match="unknown comm mode") as e:
        d.distributed_join(d, "inner", on=["s"], comm="bogus")
    assert e.value.code == ct.Code.Invalid
