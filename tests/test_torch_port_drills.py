"""The port's four smoke drills (scripts/torch_port/smoke_*.py) run on
the CPU, each in a fresh process: exit 0, the JSON summary as the last
line, every check named, and no kernel launch (the CPU runs the kernels'
plain versions, which do not count). Without CUDA the default device
raises: a drill never carries on quietly on the CPU."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DRILLS = ROOT / "scripts" / "torch_port"

CHECKS = {
    "smoke_telemetry": ["trace", "explain_analyze", "hbm_attrs",
                        "prometheus", "compile_profile", "crash_dump"],
    "smoke_service": ["first_query_builds", "results", "plan_cache",
                      "tenant_label", "prometheus", "no_leaks"],
    "smoke_obs": ["phase_a", "live_scrape", "sampling", "querylog",
                  "clean_shutdown"],
    "smoke_stats": ["first_sight_shed", "learned_admit",
                    "fresh_shape_sheds", "observatory", "clean_shutdown"],
}


def run(name, *args, timeout=120):
    return subprocess.run([sys.executable, str(DRILLS / f"{name}.py"),
                           *args], capture_output=True, text=True,
                          cwd=str(ROOT), timeout=timeout)


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_smoke_on_cpu(name):
    r = run(name, "--device", "cpu")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["drill"] == name and doc["device"] == "cpu"
    assert doc["checks"] == CHECKS[name]
    assert doc["wall_s"] > 0
    assert set(doc["launches"]) == {
        "partition_hist", "partition_scatter", "join_plan_stream",
        "join_expand_stream", "setop_stream", "stream_compact",
        "segment_sum"}
    assert not any(doc["launches"].values()), doc["launches"]
    if name == "smoke_telemetry":
        # the ledger-backed pool: nonzero memory on the CPU, and no
        # kernel library loaded there
        assert doc["hbm_peak"] > 0 and doc["dump_bytes_in_use"] > 0
        assert doc["compiles"] == doc["library_loads"] == 0
    if name == "smoke_service":
        assert doc["first_query_builds"] == 0
        assert doc["builds_after_first_service_query"] == 0
        assert doc["plan_cache_hits"] >= 7
    if name == "smoke_stats":
        assert doc["decisions"] == ["shed", "ok", "shed"]
        assert doc["comm_budget"] is None


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    r = run("smoke_telemetry")
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not r.stdout.strip()
