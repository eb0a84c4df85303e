"""Error-handling lints: no silent swallowing of broad exceptions
(counterpart of cylon_tpu.analysis.errors).

The resilience layer only works when failures actually REACH it: a
``try/except Exception: pass`` between a fault and the retry loop
converts a recoverable transient into silent data loss, and a bare
``except:`` even eats ``KeyboardInterrupt``. This family makes the
swallow-points static:

* ``errors/bare-except``   — a bare ``except:`` handler, anywhere.
* ``errors/broad-swallow`` — an ``except Exception`` /
  ``except BaseException`` handler that SWALLOWS: its body neither
  re-raises, nor reports through the telemetry error channel
  (``logger.exception/error/warning`` or an ``error=True`` span
  attribute).

"Swallow" is deliberately the bar, not "catch": catching broadly at a
defensive boundary is fine as long as the failure stays observable.
Handlers that ``raise`` (bare or a typed error), log through the
telemetry logger, or mark the enclosing span errored all pass. A
deliberate silent fallback (e.g. a memory-stats probe where failure
IS the answer) opts out per line with
``# cylint: disable=errors/broad-swallow`` — an explicit, reviewable
decision, never a hidden default.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .core import AnalysisContext, Finding, register

# exception names considered over-broad when caught
_BROAD = frozenset({"Exception", "BaseException"})

# attribute/function call names that count as REPORTING the failure
_REPORT_CALLS = frozenset({"exception", "error", "warning"})


def _exc_name(node: Optional[ast.expr]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return False  # the bare-except rule owns that case
    if isinstance(t, ast.Tuple):
        return any(_exc_name(e) in _BROAD for e in t.elts)
    return _exc_name(t) in _BROAD


def _reports_or_reraises(handler: ast.ExceptHandler) -> bool:
    """True when the handler body re-raises or reports through the
    telemetry error channel (log call or error=True span attr)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name in _REPORT_CALLS:
                return True
            # span error marking: any call carrying error=True
            # (sp.set(error=True), annotate(error=True))
            for kw in node.keywords:
                if kw.arg == "error" and \
                        isinstance(kw.value, ast.Constant) and \
                        kw.value.value is True:
                    return True
    return False


@register("errors")
def check_errors(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files():
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(Finding(
                    rule="errors/bare-except", path=f.rel,
                    line=node.lineno,
                    message="bare `except:` catches everything "
                            "(KeyboardInterrupt/SystemExit included) "
                            "— name the exception class, at least "
                            "`Exception`"))
                continue
            if _is_broad(node) and not _reports_or_reraises(node):
                findings.append(Finding(
                    rule="errors/broad-swallow", path=f.rel,
                    line=node.lineno,
                    message="broad handler swallows the failure: "
                            "neither re-raises nor reports it "
                            "(logger.exception/error/warning or an "
                            "error=True span attr) — a fault dying "
                            "here never reaches the retry/flight-"
                            "recorder machinery; if the silent "
                            "fallback is deliberate, opt out with "
                            "`# cylint: disable=errors/broad-swallow`"))
    return findings
