"""Environment-knob discipline: every ``CYLON_*`` read is declared
(counterpart of cylon_tpu.analysis.envknobs; the port declares the JAX
package's knobs under the same names, documented in the same
docs/telemetry.md table).

The engine grew ~15 ``CYLON_*`` tunables across seven modules (retry
budget, deadlines, shed factor, DRR quantum, queue bound, flight ring,
skew threshold, HBM fallback, ...). Each used to be an ad-hoc
``os.environ.get`` with its own inline default — undiscoverable,
undocumented, and trivially typo-able. They all route through the
declared registry (``telemetry/knobs.py``); this family keeps it that
way:

* ``envknobs/unregistered-read`` — an ``os.environ[...]`` /
  ``os.environ.get`` / ``os.getenv`` read of a ``CYLON_*`` name (or a
  raw ``env_number("CYLON_*", ...)`` parse) ANYWHERE outside
  ``telemetry/knobs.py``. Ad-hoc reads fork the default/parse policy
  and dodge the generated docs table.
* ``envknobs/undeclared-knob`` — ``knobs.get("CYLON_X")`` /
  ``knobs.default("CYLON_X")`` naming a knob the scanned tree's
  registry never ``declare``s: it would raise ``KeyError`` at runtime
  and documents nothing.
* ``envknobs/undocumented-knob`` — a declared knob whose name does not
  appear in ``docs/telemetry.md`` (the knob table the JAX package's
  ``render_table`` generates; the port shares its names).
  Anchored at the ``declare(...)`` line. Skipped — with a note — when
  the scanned tree has no sibling ``docs/`` (fixture trees).

The checker is purely syntactic over string LITERALS: a knob name
built at runtime is invisible (and would be a finding-worthy design
smell on its own — names are the registry's keys).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from .core import (AnalysisContext, Finding, ModuleIndex, attr_chain,
                   build_module_index, register)

REGISTRY_REL = "telemetry/knobs.py"

_ENV_GET_CHAINS = {("os", "environ", "get"), ("environ", "get"),
                   ("os", "getenv"), ("getenv",)}


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _declared_knobs(tree: ast.AST) -> Dict[str, int]:
    """CYLON_* names passed to ``declare(...)`` in the registry module
    -> declaration line."""
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if chain is None or chain[-1] != "declare":
            continue
        name = None
        if node.args:
            name = _const_str(node.args[0])
        for kw in node.keywords:
            if kw.arg == "name":
                name = _const_str(kw.value)
        if name is not None:
            out.setdefault(name, node.lineno)
    return out


def _knob_api_call(chain: Tuple[str, ...], mod: ModuleIndex
                   ) -> Optional[str]:
    """'get'/'default' when this call chain resolves to the knob
    registry's accessor (via import tables), else None."""
    if len(chain) == 1:
        target = mod.fn_imports.get(chain[0])
        if target is not None and target[0].endswith("telemetry.knobs") \
                and target[1] in ("get", "default"):
            return target[1]
    elif len(chain) == 2 and chain[1] in ("get", "default"):
        alias = mod.mod_aliases.get(chain[0], "")
        if alias == "telemetry.knobs" or alias.endswith(".knobs") or \
                alias == "knobs":
            return chain[1]
    return None


@register("envknobs")
def check_envknobs(ctx: AnalysisContext) -> List[Finding]:
    modules = build_module_index(ctx)
    findings: List[Finding] = []
    notes = ctx.options.setdefault("notes", [])

    registry_file = next((sf for sf in ctx.files()
                          if sf.rel == REGISTRY_REL), None)
    declared: Dict[str, int] = {}
    if registry_file is not None:
        declared = _declared_knobs(registry_file.tree)

    reads = 0
    for sf in ctx.files():
        if sf.rel == REGISTRY_REL:
            continue
        mod = modules[ctx.module_name(sf)]
        for node in ast.walk(sf.tree):
            # os.environ["CYLON_X"] subscript form — Load context only:
            # an env-var WRITE (os.environ["CYLON_X"] = v, the way
            # tests/operators flip a live knob) is not a read and has
            # no registry equivalent to route through
            if isinstance(node, ast.Subscript):
                if not isinstance(node.ctx, ast.Load):
                    continue
                chain = attr_chain(node.value)
                if chain in (("os", "environ"), ("environ",)):
                    key = _const_str(node.slice)
                    if key is not None and key.startswith("CYLON_"):
                        reads += 1
                        findings.append(Finding(
                            rule="envknobs/unregistered-read",
                            path=sf.rel, line=node.lineno,
                            message=f"os.environ[{key!r}] bypasses the "
                                    f"declared knob registry "
                                    f"(telemetry/knobs.py) — route "
                                    f"through knobs.get"))
                continue
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if chain is None:
                continue
            arg0 = _const_str(node.args[0]) if node.args else None
            if chain in _ENV_GET_CHAINS:
                if arg0 is not None and arg0.startswith("CYLON_"):
                    reads += 1
                    findings.append(Finding(
                        rule="envknobs/unregistered-read",
                        path=sf.rel, line=node.lineno,
                        message=f"{'.'.join(chain)}({arg0!r}) bypasses "
                                f"the declared knob registry "
                                f"(telemetry/knobs.py) — route "
                                f"through knobs.get"))
            elif chain[-1] == "env_number":
                if arg0 is not None and arg0.startswith("CYLON_"):
                    reads += 1
                    findings.append(Finding(
                        rule="envknobs/unregistered-read",
                        path=sf.rel, line=node.lineno,
                        message=f"env_number({arg0!r}) parses a CYLON_ "
                                f"knob outside the registry — its "
                                f"default/doc live nowhere; declare "
                                f"it and use knobs.get"))
            else:
                api = _knob_api_call(chain, mod)
                if api is not None and arg0 is not None and \
                        registry_file is not None and \
                        arg0 not in declared:
                    findings.append(Finding(
                        rule="envknobs/undeclared-knob",
                        path=sf.rel, line=node.lineno,
                        message=f"knobs.{api}({arg0!r}) names a knob "
                                f"telemetry/knobs.py never declares "
                                f"(KeyError at runtime)"))

    # docs check: every declared knob appears in docs/telemetry.md
    if registry_file is None:
        notes.append("envknobs: no telemetry/knobs.py in this tree — "
                     "registry/docs checks skipped")
    else:
        docs_path = os.path.join(os.path.dirname(ctx.package_root),
                                 "docs", "telemetry.md")
        if not os.path.isfile(docs_path):
            notes.append("envknobs: no sibling docs/telemetry.md — "
                         "documentation check skipped")
        else:
            text = open(docs_path, encoding="utf-8").read()
            for name, line in sorted(declared.items()):
                # backtick-delimited match: a bare substring test would
                # let a knob that is a PREFIX of a documented one
                # (CYLON_FLIGHT_MAX vs CYLON_FLIGHT_MAX_DUMPS) pass
                # undocumented
                if f"`{name}`" not in text and \
                        not re.search(rf"\b{re.escape(name)}\b", text):
                    findings.append(Finding(
                        rule="envknobs/undocumented-knob",
                        path=REGISTRY_REL, line=line,
                        message=f"declared knob {name} is missing from "
                                f"docs/telemetry.md — add its row to "
                                f"the knob table"))
        # "site(s)": the count is taken before core applies per-line
        # cylint suppressions, so a sanctioned suppressed read shows
        # here even when zero findings surface
        notes.append(f"envknobs: {len(declared)} declared knobs, "
                     f"{reads} unregistered read site(s)")
    return findings
