"""Helpers for the benchmark's own tests: a checkout of the benchmark at
a tiny size in a temporary folder, and a run of one of its cells on the
CPU in a fresh process (the same run as on the card, minus the look for
a card)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

REPO = Path(__file__).resolve().parent.parent

DRIVER = """
import sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
from portbench import harness
exec(sys.argv[2])
why = harness.program_inside(root)
if why:
    sys.exit(harness.fail(why))
sys.exit(harness.main(sys.argv[3:], time.perf_counter(), device="cpu",
                      root=root))
"""


def shrink(cfg: dict, rows: int) -> dict:
    """``cfg`` with every table at ``rows`` rows and each integer range
    cut in the same proportion (at least 2 values); a string column keeps
    its range, so its form (a dictionary or varbytes) stays the same."""
    cfg = json.loads(json.dumps(cfg))
    for t in cfg["tables"].values():
        f = rows / t["rows"]
        t["rows"] = rows
        for c in t["columns"].values():
            if c["dist"] == "uniform_int" and c["dtype"] != "string":
                span = int(c["high"]) - int(c["low"])
                c["high"] = int(c["low"]) + max(int(span * f), 2)
    return cfg


def tiny_checkout(dest: Path, rows: int = 4096,
                  program: bool = True) -> Path:
    """BENCHMARK.json and this folder copied to ``dest``, every
    configuration shrunk to ``rows`` rows; the port linked in beside
    them unless ``program`` is False."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    for p in (dest / "portbench" / "configs").glob("*.json"):
        p.write_text(json.dumps(shrink(json.loads(p.read_text()), rows),
                                indent=1))
    if program:
        os.symlink(REPO / "cylon_tpu_torch", dest / "cylon_tpu_torch")
    return dest


def run_cpu(root: Path, argv: List[str], env: Optional[dict] = None,
            timeout: float = 240, prelude: str = ""
            ) -> subprocess.CompletedProcess:
    """One run of a cell of the checkout at ``root`` on the CPU;
    ``prelude`` is run first in that process (to break the timed path
    underneath, say)."""
    e = dict(os.environ, **(env or {}))
    e.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", DRIVER, str(root), prelude,
                           *argv],
                          cwd=str(root), env=e, capture_output=True,
                          text=True, timeout=timeout)


def result(proc: subprocess.CompletedProcess) -> dict:
    """The run's result line (its last line of output)."""
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"run failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])
