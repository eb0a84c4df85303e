"""Analysis framework core: findings, suppressions, checker registry
(counterpart of cylon_tpu.analysis.core, the same schema and outputs).

A *checker* is a function ``(AnalysisContext) -> list[Finding]``
registered under a family name ("layering", "hostsync", ...). The CLI
(`python -m cylon_tpu_torch.analysis`) runs every registered checker and
exits non-zero when any unsuppressed finding survives; tests drive the
same API directly against fixture trees with seeded violations.

Suppression syntax (mirrors the familiar linter discipline):

* ``# cylint: disable=<rule>[,<rule>...]`` on the offending line
  suppresses those rules for that line only;
* ``# cylint: disable-file=<rule>[,<rule>...]`` anywhere in a file
  (conventionally the top) suppresses for the whole file.

A ``<rule>`` is either a full rule id (``layering/plan-no-ops``), a
family name (``layering`` — every rule in the family), or ``all``.
Suppressions are deliberately per-rule: a bare ``# cylint: disable``
with no rule is ignored (and reported), so silencing is always an
explicit, reviewable decision.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

# JSON output schema version — tests pin this; bump only with a
# deliberate, documented schema change (docs/analysis.md).
SCHEMA_VERSION = 1

_SUPPRESS_RE = re.compile(
    r"#\s*cylint:\s*(disable|disable-file)=([A-Za-z0-9_\-/,*]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``rule`` is ``<family>/<name>``; ``path`` is repo/package-relative
    for display (checkers that analyze traced programs rather than
    files point at the factory's def line)."""

    rule: str
    path: str
    line: int
    message: str
    col: int = 0

    @property
    def family(self) -> str:
        return self.rule.split("/", 1)[0]

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


def _rule_matches(entry: str, rule: str) -> bool:
    if entry == "all" or entry == "*":
        return True
    if entry == rule:
        return True
    # family name, or explicit family wildcard ("layering/*")
    fam = entry[:-2] if entry.endswith("/*") else entry
    return "/" not in fam and rule.split("/", 1)[0] == fam


class Suppressions:
    """Per-file suppression index parsed straight from source text."""

    def __init__(self, source: str):
        self.line_rules: Dict[int, List[str]] = {}
        self.file_rules: List[str] = []
        for i, text in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            kind, rules = m.group(1), m.group(2).split(",")
            rules = [r.strip() for r in rules if r.strip()]
            if kind == "disable-file":
                self.file_rules.extend(rules)
            else:
                self.line_rules.setdefault(i, []).extend(rules)

    def is_suppressed(self, finding: Finding) -> bool:
        for entry in self.file_rules:
            if _rule_matches(entry, finding.rule):
                return True
        for entry in self.line_rules.get(finding.line, ()):
            if _rule_matches(entry, finding.rule):
                return True
        return False


@dataclass
class SourceFile:
    path: str         # absolute
    rel: str          # package-root-relative, '/'-separated
    source: str
    tree: ast.AST
    suppressions: Suppressions


class AnalysisContext:
    """Shared state for one analysis run.

    ``package_root`` is the directory whose layout defines subsystems
    (``ops/``, ``plan/``, ...) — the installed ``cylon_tpu_torch`` package by
    default, a fixture tree with the same shape under test. ``options``
    carries checker-specific knobs (fixture entry-point modules, world
    size, ...).
    """

    def __init__(self, package_root: str, options: Optional[dict] = None):
        self.package_root = os.path.abspath(package_root)
        self.package_name = os.path.basename(self.package_root)
        self.options = dict(options or {})
        self._files: Optional[List[SourceFile]] = None
        self._module_index: Optional[Dict[str, "ModuleIndex"]] = None
        # how many times the index was BUILT (not fetched) — tests pin
        # this at 1 across a multi-family run: hostsync, concurrency,
        # envknobs and specialization all share one call-graph index
        self.index_builds = 0

    def module_index(self) -> Dict[str, "ModuleIndex"]:
        """The per-module symbol/call-graph index, built once per
        context and shared by every family that closes over the call
        graph (hostsync, concurrency, envknobs, specialization). The
        walk+index is the dominant cost the check.sh wall-clock budget
        guards, so a CLI invocation must never rebuild it per family."""
        if self._module_index is None:
            self.index_builds += 1
            self._module_index = {
                self.module_name(sf): ModuleIndex(sf,
                                                  self.module_name(sf),
                                                  self.package_name)
                for sf in self.files()}
        return self._module_index

    def files(self) -> List[SourceFile]:
        if self._files is None:
            out = []
            for root, dirs, names in os.walk(self.package_root):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", "_native",
                                              "_build"))
                for name in sorted(names):
                    if not name.endswith(".py"):
                        continue
                    path = os.path.join(root, name)
                    rel = os.path.relpath(path, self.package_root)
                    rel = rel.replace(os.sep, "/")
                    src = open(path, encoding="utf-8").read()
                    try:
                        tree = ast.parse(src, filename=path)
                    except SyntaxError as e:  # pragma: no cover
                        raise RuntimeError(f"cannot parse {path}: {e}")
                    out.append(SourceFile(path, rel, src, tree,
                                          Suppressions(src)))
            self._files = out
        return self._files

    def module_name(self, f: SourceFile) -> str:
        """Package-relative dotted module path ('' for __init__)."""
        mod = f.rel[:-3].replace("/", ".")
        if mod.endswith("__init__"):
            mod = mod[: -len("__init__")].rstrip(".")
        return mod


# ---------------------------------------------------------------------------
# shared import resolution (used by the layering and hostsync passes —
# ONE copy, so the two checkers can never disagree about what module an
# import statement targets)
# ---------------------------------------------------------------------------


def importer_package(rel: str, modname: str) -> str:
    """Package-relative dotted path of a file's PACKAGE — the anchor a
    level-1 relative import resolves against. For ``pkg/sub/x.py`` that
    is ``sub``; for ``pkg/sub/__init__.py`` it is also ``sub`` (a
    package's relative imports anchor at itself)."""
    if rel.endswith("__init__.py"):
        return modname
    return ".".join(modname.split(".")[:-1]) if modname else ""


def resolve_import(module: Optional[str], level: int, importer_pkg: str,
                   package: str) -> Optional[str]:
    """Resolve an import statement to a *package-relative* dotted path
    ('' = the package root), or None when it leaves the package.
    ``importer_pkg`` is the importing file's package (see
    importer_package); ``level`` is the ImportFrom relative level (0
    for absolute)."""
    if level == 0:
        name = module or ""
        if name == package:
            return ""
        if name.startswith(package + "."):
            return name[len(package) + 1:]
        return None
    # relative: level 1 anchors at the importer's own package, each
    # further level climbs one package
    parts = importer_pkg.split(".") if importer_pkg else []
    anchor = parts[: max(len(parts) - (level - 1), 0)]
    return ".".join(anchor + ([module] if module else []))


# ---------------------------------------------------------------------------
# shared call-graph machinery (hoisted out of the hostsync pass so
# the concurrency checker reuses the SAME transitive-closure semantics —
# two checkers must never disagree about what a call statement targets)
# ---------------------------------------------------------------------------


def attr_chain(node: ast.AST):
    """('torch','cuda','synchronize') for ``torch.cuda.synchronize``;
    ('f',) for bare
    names; None when the chain does not bottom out in a Name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


class ModuleIndex:
    """Per-file symbol tables for closure passes.

    ``functions`` maps module-level def names to their AST;
    ``methods`` maps ``Class.method`` qualnames (one level — the
    repo's universal shape); ``objects`` maps module-level
    ``NAME = Cls(...)`` singletons to their class so
    ``alias.OBJ.method()`` call chains resolve (the metrics REGISTRY
    pattern); ``mod_aliases``/``fn_imports`` resolve intra-package
    ``alias.fn(...)`` and ``from ..m import f`` calls."""

    def __init__(self, sf: SourceFile, modname: str, package: str):
        self.sf = sf
        self.modname = modname
        self.functions: Dict[str, ast.AST] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.methods: Dict[str, ast.AST] = {}     # "Cls.m" -> def node
        self.objects: Dict[str, tuple] = {}       # name -> (mod, Cls)
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self.methods[f"{node.name}.{sub.name}"] = sub
        # local alias -> package-relative module path, for call
        # resolution of `_join.join_plan_keys(...)`
        self.mod_aliases: Dict[str, str] = {}
        # local name -> (module path, name) from
        # `from ..ops.join import gather_columns as _gather`
        self.fn_imports: Dict[str, tuple] = {}
        pkg = importer_package(sf.rel, modname)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    target = resolve_import(a.name, 0, pkg, package)
                    if target:  # intra-package, below the root
                        self.mod_aliases[a.asname
                                         or a.name.split(".")[-1]] = target
            elif isinstance(node, ast.ImportFrom):
                base = resolve_import(node.module or "", node.level, pkg,
                                      package)
                if base is None:
                    continue
                for a in node.names:
                    sub = (base + "." + a.name) if base else a.name
                    local = a.asname or a.name
                    # imported name could be a submodule or a function;
                    # record both interpretations, resolved lazily
                    self.mod_aliases.setdefault(local, sub)
                    self.fn_imports[local] = (base, a.name)
        # module-level singletons: NAME = Cls(...) where Cls is a local
        # class or an imported one
        for node in sf.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            chain = attr_chain(node.value.func)
            if chain is None:
                continue
            name = node.targets[0].id
            if len(chain) == 1 and chain[0] in self.classes:
                self.objects[name] = (modname, chain[0])
            elif len(chain) == 1 and chain[0] in self.fn_imports:
                self.objects[name] = self.fn_imports[chain[0]]

    def lookup(self, qualname: str):
        """The def node for a module-level function OR a Class.method
        qualname, or None."""
        return self.functions.get(qualname) or self.methods.get(qualname)


def build_module_index(ctx: AnalysisContext) -> Dict[str, ModuleIndex]:
    return ctx.module_index()


def called_functions(body: ast.AST, mod: ModuleIndex,
                     modules: Optional[Dict[str, ModuleIndex]] = None,
                     self_cls: Optional[str] = None):
    """(module path, qualname) pairs ``body`` calls, resolved as far as
    syntax allows: same-module ``fn(...)``, imported ``fn(...)``,
    intra-package ``alias.fn(...)``, ``self.m(...)`` (when ``self_cls``
    names the enclosing class), ``Cls(...)`` construction (-> its
    ``__init__``), module-level singleton ``obj.m(...)``, and — given
    ``modules`` — the three-deep ``alias.OBJ.m(...)`` form."""
    out = set()
    for node in ast.walk(body):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if chain is None:
            continue
        if len(chain) == 1:
            name = chain[0]
            if name in mod.functions:
                out.add((mod.modname, name))
            elif name in mod.classes:
                if f"{name}.__init__" in mod.methods:
                    out.add((mod.modname, f"{name}.__init__"))
            elif name in mod.fn_imports:
                base, fn = mod.fn_imports[name]
                target = modules.get(base) if modules else None
                if target is not None and fn in target.classes:
                    if f"{fn}.__init__" in target.methods:
                        out.add((base, f"{fn}.__init__"))
                else:
                    out.add(mod.fn_imports[name])
        elif len(chain) == 2:
            head, meth = chain
            if head == "self" and self_cls is not None:
                if f"{self_cls}.{meth}" in mod.methods:
                    out.add((mod.modname, f"{self_cls}.{meth}"))
            elif head in mod.objects:
                omod, ocls = mod.objects[head]
                out.add((omod, f"{ocls}.{meth}"))
            elif head in mod.mod_aliases:
                out.add((mod.mod_aliases[head], meth))
        elif len(chain) == 3 and modules is not None:
            alias, obj, meth = chain
            target = modules.get(mod.mod_aliases.get(alias, ""))
            if target is not None and obj in target.objects:
                omod, ocls = target.objects[obj]
                out.add((omod, f"{ocls}.{meth}"))
    return out


def call_closure(modules: Dict[str, ModuleIndex], seeds: Dict,
                 package: str) -> Dict:
    """Transitive closure over the call graph from ``seeds`` — a
    ``{(mod, qualname): chain description}`` map. Returns the closed
    map; each discovered callee's description extends its caller's
    (``root -> mod.callee``), so findings can print the whole chain."""
    closed = dict(seeds)
    work = list(seeds)
    while work:
        modname, fname = work.pop()
        mod = modules.get(modname)
        fn = mod.lookup(fname) if mod is not None else None
        if fn is None:
            continue
        desc = closed[(modname, fname)]
        self_cls = fname.split(".", 1)[0] if "." in fname else None
        for callee in called_functions(fn, mod, modules, self_cls):
            cmod, cfn = callee
            target = modules.get(cmod)
            if target is None or target.lookup(cfn) is None:
                continue
            if callee not in closed:
                closed[callee] = f"{desc} -> {cmod or package}.{cfn}"
                work.append(callee)
    return closed


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

CheckerFn = Callable[[AnalysisContext], List[Finding]]
CHECKERS: Dict[str, CheckerFn] = {}


def register(family: str):
    def deco(fn: CheckerFn) -> CheckerFn:
        CHECKERS[family] = fn
        return fn
    return deco


@dataclass
class RunResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    checkers: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        counts: Dict[str, int] = {}
        for f in self.findings:
            counts[f.family] = counts.get(f.family, 0) + 1
        return {
            "version": SCHEMA_VERSION,
            "ok": self.ok,
            "checkers": list(self.checkers),
            "counts": counts,
            "suppressed": self.suppressed,
            "notes": list(self.notes),
            "findings": [f.to_json() for f in self.findings],
        }

    def format_text(self) -> str:
        lines = []
        for f in self.findings:
            lines.append(f.format())
        lines.append(f"cylint: {len(self.findings)} finding(s), "
                     f"{self.suppressed} suppressed "
                     f"[{', '.join(self.checkers)}]")
        for n in self.notes:
            lines.append(f"note: {n}")
        return "\n".join(lines)


def run_checkers(ctx: AnalysisContext,
                 families: Optional[Sequence[str]] = None) -> RunResult:
    """Run the selected checker families (default: all registered) and
    apply suppressions. Findings sort by (path, line, rule) so output
    (and the JSON schema) is deterministic. Unknown family names raise:
    a typo in a CI config must not become an exit-0 gate that ran
    nothing."""
    if families is not None:
        unknown = sorted(set(families) - set(CHECKERS))
        if unknown:
            raise ValueError(
                f"unknown checker families {unknown}; registered: "
                f"{sorted(CHECKERS)}")
    res = RunResult()
    by_path = {f.rel: f for f in ctx.files()}
    for name in sorted(CHECKERS):
        if families is not None and name not in families:
            continue
        res.checkers.append(name)
        for finding in CHECKERS[name](ctx):
            sf = by_path.get(finding.path)
            if sf is not None and sf.suppressions.is_suppressed(finding):
                res.suppressed += 1
                continue
            res.findings.append(finding)
    res.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    # checkers accumulate informational notes (coverage gaps, corpus
    # sizes, host-transfer census) in ctx.options["notes"]
    res.notes.extend(ctx.options.pop("notes", []))
    return res


def to_json_text(res: RunResult) -> str:
    return json.dumps(res.to_json(), indent=2, sort_keys=True)


# SARIF v2.1.0 (OASIS) — the interchange format CI annotators consume;
# docs/analysis.md pins the envelope shape alongside JSON schema v1.
SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(res: RunResult) -> dict:
    """Render a run as a SARIF v2.1.0 log: one run, one driver
    ("cylint"), one rule entry per distinct rule id seen, one result
    per finding. Paths stay package-root-relative (the same strings
    the text/JSON outputs use), so CI resolves them against the
    package root it invoked the suite on."""
    rule_ids = sorted({f.rule for f in res.findings})
    results = [{
        "ruleId": f.rule,
        "ruleIndex": rule_ids.index(f.rule),
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": f.line,
                           "startColumn": max(f.col, 1)},
            },
        }],
    } for f in res.findings]
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "cylint",
                "informationUri":
                    "https://github.com/cylon-tpu/cylon-tpu"
                    "/blob/main/docs/analysis.md",
                "rules": [{"id": rid,
                           "shortDescription": {"text": rid}}
                          for rid in rule_ids],
            }},
            "invocations": [{"executionSuccessful": res.ok}],
            "properties": {
                "checkers": list(res.checkers),
                "suppressed": res.suppressed,
                "notes": list(res.notes),
            },
            "results": results,
        }],
    }


def to_sarif_text(res: RunResult) -> str:
    return json.dumps(to_sarif(res), indent=2, sort_keys=True)
