"""Ledger-coverage lint: materializing code paths must register output
(counterpart of cylon_tpu.analysis.ledgercov, the same scopes).

The memory half of the observatory (telemetry/ledger.py) is only as
good as its coverage — a distributed operator that materializes a
result without registering it leaves HBM that no gauge, leak report or
crash dump can attribute, and the gap is silent because nothing fails.
This checker is the memory analog of ``span-coverage``:

* every public ``distributed_*`` function in ``parallel/dist_ops.py``
  must call ``ledger.track(...)`` (any alias — ``_ledger.track``,
  bare ``track``) somewhere in its body;
* every executor lowering (``_do_*`` method in ``plan/executor.py``)
  must do the same — the lowering's ``track`` is what gives
  ``cylon_live_table_bytes{owner="plan.*"}`` and the end-of-query leak
  report their per-node attribution.

A track "anywhere in the body" is deliberately the whole bar, for the
same reason span-coverage accepts it: several operators return early
on no-op paths (world-1 short circuits, witness-skipped shuffles) that
allocate nothing, and per-branch coverage would force tracking of
tables the op did not materialize. What the lint catches is the real
failure mode — a NEW operator or lowering whose output the ledger
never sees.

Fixture trees exercise it through ``options["ledger_scopes"]``.
"""
from __future__ import annotations

import ast
from typing import List, Tuple

from .core import AnalysisContext, Finding, register
from .spancov import _targets

# (package-relative file, kind, name-prefix); kind as in spancov
DEFAULT_SCOPES: Tuple[Tuple[str, str, str], ...] = (
    ("parallel/dist_ops.py", "function", "distributed_"),
    ("plan/executor.py", "method", "_do_"),
)

# call names that register with the ledger: telemetry.ledger.track
# under the repo's import aliases, as bare names or attributes
_TRACK_CALL_NAMES = frozenset({"track", "_track", "ledger_track"})


def _is_track_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else \
        fn.attr if isinstance(fn, ast.Attribute) else None
    return name in _TRACK_CALL_NAMES


def _has_track(fn_node: ast.FunctionDef) -> bool:
    return any(_is_track_call(n) for n in ast.walk(fn_node))


@register("ledger-coverage")
def check_ledger_coverage(ctx: AnalysisContext) -> List[Finding]:
    scopes = ctx.options.get("ledger_scopes", DEFAULT_SCOPES)
    by_rel = {f.rel: f for f in ctx.files()}
    findings: List[Finding] = []
    for rel, kind, prefix in scopes:
        f = by_rel.get(rel)
        if f is None:
            continue
        for fn in _targets(f.tree, kind, prefix):
            if not _has_track(fn):
                what = "executor lowering" if kind == "method" \
                    else "distributed op"
                findings.append(Finding(
                    rule="ledger-coverage/missing-ledger", path=rel,
                    line=fn.lineno,
                    message=f"{what} {fn.name}() materializes output "
                            f"the memory ledger never sees: no HBM "
                            f"gauge, leak report or crash dump can "
                            f"attribute it — register the result via "
                            f"telemetry.ledger.track(table, owner)"))
    return findings
