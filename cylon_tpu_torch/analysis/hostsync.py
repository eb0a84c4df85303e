"""Host-sync detector: the host-sync discipline of eager torch
(counterpart of cylon_tpu.analysis.hostsync — the same discipline, not a
copy of its pass).

The JAX package flags host transfers inside code traced by ``jit`` /
``shard_map`` / ``pallas_call``; its discipline is that host syncs
happen at exactly the declared points, the count→capacity fetches
between kernel phases. Eager torch traces nothing: every ``.item()`` of
a CUDA tensor stalls the host until the card drains its queue. The port
keeps the discipline with two rules:

* ``hostsync/in-launch`` — a host transfer in the call closure of a
  kernel wrapper of ``ops/kernels.py`` (the names of its ``KERNELS``
  tuple, and what they call through the package, `core.call_closure`).
  A wrapper only launches: a sync there serialises the host with every
  launch on the main path.
* ``hostsync/undeclared`` — a host transfer in a function of
  ``parallel/`` that does not call ``record_host_sync``: the fetches
  between the distributed operators' phases are the declared points,
  each counted in ``cylon_host_syncs_total{site=...}`` (the JAX
  package's sites and names, docs/telemetry.md).

Host transfers are ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``.to("cpu")`` (or ``device="cpu"``, ``torch.device("cpu")``) and
``torch.cuda.synchronize()``, plus ``int()`` / ``float()`` / ``bool()``
and the truth test of ``if`` / ``while`` applied to an expression the
AST can tell is a tensor: a ``torch.*`` call, a method call, subscript
or arithmetic on a tensor, a name assigned one in the same function, or
a parameter annotated ``torch.Tensor``. A name the AST cannot type is
not a finding (``int(v)`` inside ``comm.agree_max`` is invisible here;
its callers declare their own sites).

The pass is purely syntactic (nothing is imported). Host transfers
elsewhere (``data/``, the local ``ops/``, ``io/``) are host-side by
design and counted by module in the family's note, as the JAX package's
note counts its host-side (legal) sites. A justified exception takes a
per-line ``# cylint: disable=hostsync/...`` with a reason.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .core import (AnalysisContext, Finding, attr_chain, build_module_index,
                   call_closure, register)

KERNELS_MOD = "ops.kernels"
PARALLEL_PREFIX = "parallel/"

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CAST_BUILTINS = {"int", "float", "bool"}
_RECORD_NAMES = {"record_host_sync", "_host_sync"}

# torch.* callables that return no tensor
_TORCH_NON_TENSOR = {"device", "dtype", "Size", "is_tensor", "numel",
                     "is_floating_point", "get_default_dtype", "finfo",
                     "iinfo", "is_grad_enabled", "get_device_name"}
# tensor methods that return a host value (no transfer: a shape or an
# address) or that are themselves the transfers counted above
_NON_TENSOR_METHODS = {"numel", "dim", "size", "element_size", "data_ptr",
                       "is_contiguous", "stride", "nelement",
                       "get_device", "item", "tolist", "numpy"}


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """fn's own scope: every node, not descending into nested defs or
    lambdas (a nested function is a function of its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _is_cpu_device(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return isinstance(node, ast.Call) and \
        attr_chain(node.func) == ("torch", "device") and \
        bool(node.args) and _is_cpu_device(node.args[0])


class _Typer:
    """Which expressions of one function are tensors, as far as the
    syntax tells."""

    def __init__(self, fn: Optional[ast.AST]):
        self.names: Set[str] = set()
        if fn is None or isinstance(fn, ast.Module):
            return
        for a in list(fn.args.posonlyargs) + list(fn.args.args) + \
                list(fn.args.kwonlyargs):
            if attr_chain(a.annotation) in (("torch", "Tensor"),
                                            ("Tensor",)):
                self.names.add(a.arg)
        # names bound to a tensor anywhere in the function's own scope
        # (flow-insensitive; iterate so chains of assignments resolve)
        assigns = [n for n in _own_nodes(fn) if isinstance(n, ast.Assign)
                   and len(n.targets) == 1
                   and isinstance(n.targets[0], ast.Name)]
        for _ in range(4):
            before = len(self.names)
            for n in assigns:
                if self.tensor(n.value):
                    self.names.add(n.targets[0].id)
            if len(self.names) == before:
                break

    def tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain is not None and chain[0] == "torch":
                return len(chain) >= 2 and chain[1] != "cuda" and \
                    chain[-1] not in _TORCH_NON_TENSOR
            if isinstance(node.func, ast.Attribute):
                return node.func.attr not in _NON_TENSOR_METHODS and \
                    self.tensor(node.func.value)
            return False
        if isinstance(node, ast.Subscript):
            return self.tensor(node.value)
        if isinstance(node, ast.Attribute):
            return node.attr in ("T", "mT", "real", "imag") and \
                self.tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.tensor(node.left) or self.tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tensor(node.operand)
        if isinstance(node, ast.Compare):
            return self.tensor(node.left) or \
                any(self.tensor(c) for c in node.comparators)
        return False


def _transfers(fn: ast.AST, typer: _Typer) -> List[Tuple[int, str]]:
    """(line, description) of every host transfer in fn's own scope."""
    out: List[Tuple[int, str]] = []
    for node in _own_nodes(fn):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain == ("torch", "cuda", "synchronize"):
                out.append((node.lineno, "torch.cuda.synchronize()"))
                continue
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _SYNC_METHODS and not node.args:
                    out.append((node.lineno, f".{attr}()"))
                    continue
                if attr == "to" and (
                        (node.args and _is_cpu_device(node.args[0])) or
                        any(k.arg == "device" and _is_cpu_device(k.value)
                            for k in node.keywords)):
                    out.append((node.lineno, '.to("cpu")'))
                    continue
            if chain is not None and len(chain) == 1 and \
                    chain[0] in _CAST_BUILTINS and len(node.args) == 1 \
                    and typer.tensor(node.args[0]):
                out.append((node.lineno, f"{chain[0]}() of a tensor"))
        elif isinstance(node, (ast.If, ast.While)) and \
                typer.tensor(node.test):
            out.append((node.lineno, "the truth test of a tensor"))
    return out


def _defs(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _declares(fn: ast.AST) -> bool:
    """fn (nested helpers included) calls record_host_sync."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain is not None and chain[-1] in _RECORD_NAMES:
                return True
    return False


def _kernel_names(tree: ast.AST) -> List[str]:
    """The string constants of ops/kernels.py's ``KERNELS`` tuple."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "KERNELS" and \
                isinstance(node.value, (ast.Tuple, ast.List)):
            return [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
    return []


@register("hostsync")
def check_hostsync(ctx: AnalysisContext) -> List[Finding]:
    package = ctx.package_name
    modules = build_module_index(ctx)
    findings: List[Finding] = []

    # 1. kernel wrappers: the KERNELS entries and their call closure
    seeds: Dict[Tuple[str, str], str] = {}
    kmod = modules.get(KERNELS_MOD)
    if kmod is not None:
        for name in _kernel_names(kmod.sf.tree):
            if name in kmod.functions:
                seeds[(KERNELS_MOD, name)] = f"kernels.{name}"
    launch = call_closure(modules, seeds, package)
    flagged: Set[Tuple[str, int]] = set()
    for (modname, qual), desc in sorted(launch.items()):
        mod = modules[modname]
        fn = mod.lookup(qual)
        if fn is None:
            continue
        for sub in [fn] + [d for d in _defs(fn) if d is not fn]:
            for line, what in _transfers(sub, _Typer(sub)):
                if (mod.sf.rel, line) in flagged:
                    continue
                flagged.add((mod.sf.rel, line))
                findings.append(Finding(
                    rule="hostsync/in-launch", path=mod.sf.rel, line=line,
                    message=f"{what} in a kernel wrapper's call closure "
                            f"[reached from {desc}]: a wrapper only "
                            f"launches — a host transfer here stalls the "
                            f"host on every launch of the main path"))

    # 2. parallel/: every host transfer in a function that declares it
    census: Dict[str, int] = {}
    declared = undeclared = 0
    for sf in ctx.files():
        units = [(d, _Typer(d)) for d in _defs(sf.tree)]
        units.append((sf.tree, _Typer(None)))
        for fn, typer in units:
            for line, what in _transfers(fn, typer):
                census[sf.rel] = census.get(sf.rel, 0) + 1
                if not sf.rel.startswith(PARALLEL_PREFIX) or \
                        (sf.rel, line) in flagged:
                    continue
                if fn is not sf.tree and _declares(fn):
                    declared += 1
                    continue
                undeclared += 1
                where = f"{fn.name}()" if fn is not sf.tree \
                    else "module level"
                findings.append(Finding(
                    rule="hostsync/undeclared", path=sf.rel, line=line,
                    message=f"{what} in {where}, which never calls "
                            f"record_host_sync: a device->host round "
                            f"trip of a distributed operator that "
                            f"cylon_host_syncs_total cannot see — "
                            f"declare the site (the JAX package's site "
                            f"name where it has one)"))

    total = sum(census.values())
    elsewhere = ", ".join(f"{rel}={n}" for rel, n in sorted(census.items())
                          if not rel.startswith(PARALLEL_PREFIX))
    ctx.options.setdefault("notes", []).append(
        f"hostsync: {total} host-transfer sites; {len(flagged)} in kernel-"
        f"wrapper closures (flagged); parallel/: {declared} declared, "
        f"{undeclared} undeclared; host-side (legal) by module: "
        f"{elsewhere or 'none'}; {len(launch)} functions in the wrapper "
        f"closure")
    return findings
