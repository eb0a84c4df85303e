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


# ---------------------------------------------------------------------------
# the measuring tools (scaling_sweep, compare_competitors, profile_*)
# ---------------------------------------------------------------------------


def tool_parser(description: str, rows_log2: int, what: str):
    """The options every measuring tool takes: the size as the JAX
    script's positional ``rows_log2`` (``rows_log2`` by default, the
    card's benchmark size), ``--device`` and ``--out``."""
    import argparse

    p = argparse.ArgumentParser(description=description)
    p.add_argument("rows_log2", type=int, nargs="?", default=rows_log2,
                   help=f"log2 of {what} (default {rows_log2})")
    add_device_arg(p)
    p.add_argument("--out", default=None,
                   help="also write the JSON summary to this path (no file "
                        "is written without it)")
    return p


def device_of(name: str):
    """The torch device of ``--device``: CUDA without a card raises."""
    from cylon_tpu_torch.context import resolve_device

    return resolve_device(name)


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU): every timed region ends
    here."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_of(fn, device, iters: int = 3) -> float:
    """One warm-up run of ``fn``, then the best wall (s) of ``iters`` runs,
    each ending in a synchronize of ``device`` (the JAX scripts'
    ``best_of``)."""
    fn()
    sync(device)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def card_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def finish(doc: dict, out, launches0: dict) -> dict:
    """Add the kernel launches since ``launches0``, write ``doc`` to
    ``out`` when it is given, and print it as the last stdout line."""
    doc["launches"] = launch_delta(launches0)
    if out:
        folder = os.path.dirname(os.path.abspath(out))
        os.makedirs(folder, exist_ok=True)
        with open(out, "w") as f:
            json.dump(doc, f, indent=1, default=str)
    print(json.dumps(doc, default=str), flush=True)
    return doc
