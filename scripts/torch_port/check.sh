#!/bin/sh
# The port's verification gate (counterpart of scripts/check.sh): the
# static-analysis suite, the four smoke drills, the chaos drill, the
# differential fuzzer and the port's CPU tests, plus the card tests
# where a card is present.
#
#   sh scripts/torch_port/check.sh [--device cuda|cpu]
#
# --device (default cuda) is passed to every drill. There is no
# counterpart of benchtrend.py --check: it reads the JAX package's
# BENCH_r*.json.
set -e
cd "$(dirname "$0")/../.."
DEVICE=cuda
while [ $# -gt 0 ]; do
    case "$1" in
        --device) DEVICE="$2"; shift 2 ;;
        --device=*) DEVICE="${1#--device=}"; shift ;;
        *) echo "usage: sh scripts/torch_port/check.sh [--device cuda|cpu]" >&2
           exit 2 ;;
    esac
done
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

echo "== static analysis: ten families + wall-clock budget =="
python - <<'PYEOF'
import json, subprocess, sys, time
t0 = time.monotonic()
proc = subprocess.run(
    [sys.executable, "-m", "cylon_tpu_torch.analysis", "--json"],
    capture_output=True, text=True)
wall = time.monotonic() - t0
if proc.returncode != 0:
    sys.exit("analysis gate: real tree not clean (exit %d)\n%s"
             % (proc.returncode, proc.stdout + proc.stderr))
doc = json.loads(proc.stdout)
assert len(doc["checkers"]) == 10, doc["checkers"]
assert doc["ok"] and not doc["findings"], doc["findings"]
if wall >= 90.0:
    sys.exit("analysis gate: %.1fs wall, budget is 90s" % wall)
print("analysis gate ok: ten families clean in %.1fs (budget 90s)" % wall)
PYEOF

echo "== telemetry smoke =="
python scripts/torch_port/smoke_telemetry.py --device "$DEVICE"

echo "== service smoke =="
python scripts/torch_port/smoke_service.py --device "$DEVICE"

echo "== observability smoke =="
python scripts/torch_port/smoke_obs.py --device "$DEVICE"

echo "== stats smoke =="
python scripts/torch_port/smoke_stats.py --device "$DEVICE"

echo "== chaos drill: --seeds 3 =="
python scripts/torch_port/chaos.py --seeds 3 --device "$DEVICE"

echo "== differential fuzzer =="
python scripts/torch_port/fuzz_differential.py --device "$DEVICE"

echo "== the port's CPU tests =="
# they hold the port against the JAX package, so they need jax: a
# machine without it (the card's) runs the card tests below instead
if python -c 'import jax' 2>/dev/null; then
    XDIST=""
    if python -c 'import xdist' 2>/dev/null; then
        XDIST="-p xdist -n 4 --dist loadfile"
    fi
    # shellcheck disable=SC2086
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_*.py -q \
        -m 'not slow' -p no:cacheprovider -p no:randomly $XDIST
else
    echo "skipped: jax is not importable here"
fi

if python -c 'import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)'; then
    echo "== the card tests =="
    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q \
        -p no:cacheprovider
fi
echo "check: OK"
