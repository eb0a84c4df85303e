"""What the port's drills share: the ``--device`` option, the kernel
launch counts and the JSON summary each drill prints as its last line.

Every drill builds its contexts on ``--device`` (``cuda`` by default).
Asked for CUDA on a machine without it, the context raises: a drill
never carries on quietly on the CPU.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def add_device_arg(parser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="device the drill's contexts run on "
                             "(default cuda; without CUDA it raises)")


def parse_device(argv=None, description: str = "") -> str:
    """``--device`` of a drill that takes no other option."""
    import argparse

    p = argparse.ArgumentParser(description=description)
    add_device_arg(p)
    return p.parse_args(argv).device


def launches() -> dict:
    """A copy of the kernel wrappers' launch counts (ops/kernels.py)."""
    from cylon_tpu_torch.ops import kernels

    return dict(kernels.LAUNCHES)


def launch_delta(before: dict) -> dict:
    """Launches since ``before``, by kernel (every kernel named)."""
    return {k: v - before.get(k, 0) for k, v in launches().items()}


class Summary:
    """Collects the names of the checks a drill passed and prints its
    JSON line: ``{"drill", "device", "checks", "wall_s", "launches"}``
    plus any extra fields."""

    def __init__(self, drill: str, device: str):
        self.drill = drill
        self.device = device
        self.checks = []
        self.t0 = time.perf_counter()
        self.launches0 = launches()

    def ok(self, name: str) -> None:
        self.checks.append(name)

    def emit(self, **extra) -> dict:
        doc = {"drill": self.drill, "device": self.device,
               "checks": self.checks,
               "wall_s": round(time.perf_counter() - self.t0, 3),
               "launches": launch_delta(self.launches0)}
        doc.update(extra)
        print(json.dumps(doc, default=str), flush=True)
        return doc


def last_json(stdout: str) -> dict:
    """The JSON object on a drill's last non-empty stdout line."""
    lines = [l for l in stdout.splitlines() if l.strip()]
    if not lines:
        raise ValueError("no output")
    return json.loads(lines[-1])
