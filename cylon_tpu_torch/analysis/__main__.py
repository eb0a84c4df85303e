"""CLI: ``python -m cylon_tpu_torch.analysis`` — run the static-analysis
suite; exit 0 iff no unsuppressed finding.

The same command runs on a machine with a CUDA card and no jax: the
suite imports neither jax nor cylon_tpu, and sets no environment
variable. Typical invocations:

    python -m cylon_tpu_torch.analysis                    # full suite
    python -m cylon_tpu_torch.analysis --json             # machine-readable
    python -m cylon_tpu_torch.analysis --format sarif     # SARIF v2.1.0 (CI)
    python -m cylon_tpu_torch.analysis --families layering,hostsync
    python -m cylon_tpu_torch.analysis --package-root tests/analysis_fixtures/pkg_bad
    python -m cylon_tpu_torch.analysis --list-rules
    python -m cylon_tpu_torch.analysis --families collectives --device cuda
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cylon_tpu_torch.analysis",
        description="cylon_tpu_torch static-analysis suite (rule catalog: "
                    "the family modules' docstrings, --list-rules)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (stable schema v1); "
                        "alias for --format json")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default=None,
                   help="output format: text (default), json (stable "
                        "schema v1), or sarif (SARIF v2.1.0 for CI "
                        "inline annotation)")
    p.add_argument("--families",
                   help="comma-separated checker families to run "
                        "(default: all registered)")
    p.add_argument("--package-root",
                   help="package tree to scan (default: the installed "
                        "cylon_tpu_torch package); fixture trees use this")
    p.add_argument("--collectives-entry-module",
                   help="fixture module file declaring ENTRY_POINTS "
                        "for the collectives checker")
    p.add_argument("--witness-plan-module",
                   help="fixture module file declaring build_plans() "
                        "for the witness checker")
    p.add_argument("--world", type=int, default=4,
                   help="virtual world width for semantic checkers")
    p.add_argument("--device", default="cpu",
                   help="device the collectives catalog runs on (cpu: the "
                        "kernels' plain versions; cuda: the kernels)")
    p.add_argument("--list-rules", action="store_true",
                   help="print registered checker families and exit")
    args = p.parse_args(argv)

    from . import AnalysisContext, CHECKERS, run_checkers, \
        to_json_text, to_sarif_text

    fmt = args.format or ("json" if args.json else "text")

    if args.list_rules:
        for name in sorted(CHECKERS):
            doc = (sys.modules[CHECKERS[name].__module__].__doc__ or
                   "").strip().splitlines()[0]
            print(f"{name:12s} {doc}")
        return 0

    if args.package_root:
        root = args.package_root
    else:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    options = {"world": args.world, "device": args.device}
    if args.collectives_entry_module:
        options["collectives_entry_module"] = args.collectives_entry_module
    if args.witness_plan_module:
        options["witness_plan_module"] = args.witness_plan_module

    families = args.families.split(",") if args.families else None
    if args.package_root and families is None and \
            not (args.collectives_entry_module or
                 args.witness_plan_module):
        # scanning a fixture/foreign tree: the semantic checkers
        # (collectives/witness) are about the REAL package's operators
        # and optimizer — run only the file-scanning families
        families = ["layering", "hostsync", "span-coverage",
                    "ledger-coverage", "errors", "concurrency",
                    "envknobs", "specialization"]

    ctx = AnalysisContext(root, options)
    try:
        res = run_checkers(ctx, families)
    except ValueError as e:  # unknown --families entry
        print(f"error: {e}", file=sys.stderr)
        return 2
    print({"json": to_json_text, "sarif": to_sarif_text}[fmt](res)
          if fmt != "text" else res.format_text())
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
