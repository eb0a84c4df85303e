"""The readings a cell's limits are set from: on each seed, the numbers
the comparison gives for the program's result (sound runs: the lower
reading) and for the control (the plain reference computed with every
float in the next lower precision, put in the program's place: the
upper reading).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--low float32] [--no-program]

It prints one JSON line a seed. The benchmark's runs never run it. It
runs on the card only, at the cell's own size, one process; a cell of
several processes is read with the run's own check instead.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).absolute().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check, gen, harness, queries, reference  # noqa: E402


def compare(cols, ref, scales, rows, spec) -> dict:
    loc = check.local_numbers(cols, ref, scales, spec)
    return check.numbers(loc, rows, spec)


def readings(cell_name: str, seeds, low: str = "float32",
             program: bool = True, device: str = "cuda",
             root: Path = ROOT):
    """Yield {seed, program, control} for each seed."""
    import torch

    cell = harness.load_cell(cell_name, root)
    wl, cfg = cell.workload, cell.config
    q = wl["query"]
    names = harness.query_tables(cell)
    dev = torch.device(device)
    ref_mod = reference.module(q["op"])
    ctx = None
    if program:
        import cylon_tpu_torch as ct

        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(1),
                                              device=dev)
    for seed in seeds:
        out = {"seed": seed}
        if program:
            drawn = {t: c for t, c in gen.make_tables(cfg, seed, dev).items()
                     if t in names}
            tables = harness.ingest(ct, ctx, drawn, 1)
            del drawn
            res = queries.module(q["op"]).run(tables, q)
            prog = harness.live_columns(res)
            del res, tables
        full = {t: c for t, c in gen.make_tables(cfg, seed, dev).items()
                if t in names}
        ref, scales, stats = ref_mod.compute(full, q)
        if program:
            out["program"] = compare(prog, ref, scales, stats["out_rows"],
                                     wl["check"])
            del prog
        ctl, _s, _st = ref_mod.compute(full, q, low=low)
        out["control"] = compare(ctl, ref, scales, stats["out_rows"],
                                 wl["check"])
        out["limits"] = wl["limits"]
        del ctl, ref, scales, full
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--low", default="float32")
    p.add_argument("--no-program", action="store_true")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        return harness.fail("no CUDA device: the control runs on the card")
    harness.cache_dirs(ROOT)
    torch.cuda.set_device(0)
    for r in readings(a.workload, [int(s) for s in a.seeds.split(",")],
                      a.low, not a.no_program, "cuda"):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
