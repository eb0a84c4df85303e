"""Plan-witness checker: drives `plan/verify.py` over a plan corpus
(counterpart of cylon_tpu.analysis.witness, over the port's optimizer
and verifier, with the same corpora and seed).

The verifier itself (optimizer-independent witness re-derivation) lives
in `cylon_tpu_torch/plan/verify.py` so the optimizer's debug assert can
use it without an upward import. This checker family gives it a standing
corpus to run against on every `python -m cylon_tpu_torch.analysis`:

1. *Canonical pipelines* — symbolic plans (raw IR `Scan`s with schema /
   dtype / witness snapshots, no tables, no devices) covering the
   optimizer's rewrite space: elision via witnessed scans, string keys,
   promoting joins, filter pushdown, projection pruning, set ops. Each
   is optimized and must verify CLEAN — a violation here means the
   optimizer itself produced an unjustified elision.
2. *Randomized plans* — a seeded generator builds arbitrary deep
   pipelines (random dtypes, random witnesses, random operator mix);
   every optimizer output must verify clean. This is the property-test
   form of the soundness argument.
3. *Self-checks* — hand-mutated plans (a join-side `Shuffle` deleted
   with no witness to justify it; a witness snapshot stripped after
   elision) that the verifier MUST reject. If it accepts one, the
   verifier has gone blind and the checker fails the run — the suite
   checks itself.

Fixture modules (tests) may override the corpus via the
``witness_plan_module`` option: the module's ``build_plans()`` returns
``(name, root, world, expect_clean)`` tuples.
"""
from __future__ import annotations

import random
from typing import Callable, List, Optional, Tuple

from .core import AnalysisContext, Finding, register

_PATH = "plan/optimizer.py"     # findings anchor at the elision pass

_DTYPES = ["int32", "int64", "float32"]


def _scan(types, witness_cols=None, world: int = 4,
          name: str = "t"):
    from ..plan import ir

    schema = [f"c{i}" for i in range(len(types))]
    sig = None
    if witness_cols is not None:
        sig = (tuple(witness_cols),
               tuple(types[c] for c in witness_cols), world)
    return ir.Scan(name, schema, list(types), witness_sig=sig)


def canonical_plans(world: int = 4) -> List[Tuple[str, Callable]]:
    """(name, build()) pairs; build returns a LOGICAL plan root."""
    from ..plan import ir
    from ..plan.ir import col

    def join_groupby_same_keys():
        l = _scan(["int32", "float32", "int32"])
        r = _scan(["int32", "int32"], name="r")
        j = ir.Join(l, r, [0], [0])
        return ir.GroupBy(j, [0], [4], ["sum"])

    def witnessed_both_sides():
        l = _scan(["int32", "float32"], witness_cols=[0], world=world)
        r = _scan(["int32", "int32"], witness_cols=[0], world=world,
                  name="r")
        j = ir.Join(l, r, [0], [0])
        return ir.GroupBy(j, [0], [3], ["sum"])

    def string_keys_never_elide():
        l = _scan([ir.STR_TYPE, "int32"])
        r = _scan([ir.STR_TYPE, "int64"], name="r")
        return ir.Join(l, r, [0], [0])

    def promoting_join_witnessed_left():
        # left witnessed on int32 k; right key is int64: alignment
        # promotes, so the witness must NOT justify an elision
        l = _scan(["int32", "float32"], witness_cols=[0], world=world)
        r = _scan(["int64", "int32"], name="r")
        return ir.Join(l, r, [0], [0])

    def filter_pushdown_prune():
        l = _scan(["int32", "float32", "int32"])
        r = _scan(["int32", "int32"], name="r")
        f = ir.Filter(ir.Shuffle(l, [0]), (col(2) > 5).bind(lambda p: p))
        j = ir.Join(f, r, [0], [0])
        return ir.GroupBy(j, [0], [4], ["mean"])

    def user_shuffle_then_join():
        l = _scan(["int32", "int64"])
        r = _scan(["int32", "float32"], name="r")
        return ir.Join(ir.Shuffle(l, [0]), r, [0], [0])

    def setop_sort():
        a = _scan(["int32", "int32"])
        b = _scan(["int32", "int32"], name="b")
        return ir.Sort(ir.SetOp(a, b, "union"), [0], True)

    def groupby_after_witnessed_scan():
        t = _scan(["int32", "float32"], witness_cols=[0], world=world)
        return ir.GroupBy(t, [0], [1], ["sum"])

    return [(f.__name__, f) for f in (
        join_groupby_same_keys, witnessed_both_sides,
        string_keys_never_elide, promoting_join_witnessed_left,
        filter_pushdown_prune, user_shuffle_then_join, setop_sort,
        groupby_after_witnessed_scan)]


def random_plan(rng: random.Random, world: int):
    """One random logical plan: scans with random dtypes/witnesses under
    a random operator stack."""
    from ..plan import ir

    def scan():
        width = rng.randint(2, 4)
        types = [rng.choice(_DTYPES + [ir.STR_TYPE]) for _ in range(width)]
        witness = None
        hashable = [i for i, t in enumerate(types) if t != ir.STR_TYPE]
        if hashable and rng.random() < 0.5:
            k = rng.randint(1, min(2, len(hashable)))
            witness = rng.sample(hashable, k)
        return _scan(types, witness_cols=witness, world=world,
                     name=f"t{rng.randrange(1 << 16)}")

    def grow(node, depth):
        if depth <= 0:
            return node
        roll = rng.random()
        if roll < 0.35 and node.width >= 1:
            other = scan()
            li = rng.randrange(node.width)
            rj = rng.randrange(other.width)
            how = rng.choice(["inner", "left", "right"])
            node = ir.Join(node, other, [li], [rj], how)
        elif roll < 0.55:
            keys = [rng.randrange(node.width)]
            aggable = [i for i in range(node.width) if i not in keys]
            if aggable:
                node = ir.GroupBy(node, keys, [rng.choice(aggable)],
                                  [rng.choice(["sum", "count", "max"])])
        elif roll < 0.7:
            node = ir.Shuffle(node, [rng.randrange(node.width)])
        elif roll < 0.85:
            keep = sorted(rng.sample(range(node.width),
                                     rng.randint(1, node.width)))
            node = ir.Project(node, keep)
        else:
            node = ir.Sort(node, [rng.randrange(node.width)], True)
        return grow(node, depth - 1)

    return grow(scan(), rng.randint(1, 4))


def mutate_delete_shuffle(root, rng: Optional[random.Random] = None,
                          world: int = 4) -> bool:
    """Delete one join-side Shuffle whose input carries no witness —
    the canonical unjustified elision. Returns True when a mutation
    site existed."""
    from ..plan import ir
    from ..plan.verify import derive_witness

    sites = []
    for node in ir.walk(root):
        if isinstance(node, ir.Join):
            for side in (0, 1):
                c = node.children[side]
                if isinstance(c, ir.Shuffle) and \
                        derive_witness(c.children[0], world) is None:
                    sites.append((node, side))
    if not sites:
        return False
    node, side = sites[0] if rng is None else rng.choice(sites)
    node.children[side] = node.children[side].children[0]
    return True


@register("witness")
def check_witness(ctx: AnalysisContext) -> List[Finding]:
    from ..plan.ir import format_plan
    from ..plan.optimizer import optimize
    from ..plan.verify import verify_plan
    from ..status import CylonError

    world = int(ctx.options.get("world", 4))
    findings: List[Finding] = []
    notes: List[str] = ctx.options.setdefault("notes", [])

    plan_module = ctx.options.get("witness_plan_module")
    if plan_module is not None:
        # fixture mode: every verification problem IS a finding (the
        # seeded violation surfacing — non-zero exit), and a seeded-bad
        # plan the verifier ACCEPTS is a finding about the verifier
        for name, root, w, expect_clean in \
                _load_plan_module(plan_module):
            problems = verify_plan(root, w)
            for p in problems:
                findings.append(Finding(
                    rule="witness/unjustified-elision", path=_PATH,
                    line=1, message=f"{name}: {p}"))
            if not expect_clean and not problems:
                findings.append(Finding(
                    rule="witness/verifier-blind", path=_PATH, line=1,
                    message=f"{name}: verifier accepted a plan seeded "
                            f"with an unjustified elision"))
        return findings

    # 1. canonical pipelines: optimizer output must verify clean
    for name, build in canonical_plans(world):
        try:
            root, _stats = optimize(build(), world)
        except CylonError as e:
            findings.append(Finding(
                rule="witness/unjustified-elision", path=_PATH, line=1,
                message=f"canonical[{name}]: optimizer output failed "
                        f"verification: {e}"))
            continue
        problems = verify_plan(root, world)
        for p in problems:
            findings.append(Finding(
                rule="witness/unjustified-elision", path=_PATH, line=1,
                message=f"canonical[{name}]: {p}"))

    # 2. randomized property sweep (seeded — deterministic output)
    rng = random.Random(int(ctx.options.get("seed", 0xC11)))
    n_random = int(ctx.options.get("random_plans", 64))
    rejected = 0
    for i in range(n_random):
        logical = random_plan(rng, world)
        try:
            root, _stats = optimize(logical, world)
        except CylonError as e:
            findings.append(Finding(
                rule="witness/unjustified-elision", path=_PATH, line=1,
                message=f"random[{i}]: optimizer output failed "
                        f"verification: {e}"))
            continue
        problems = verify_plan(root, world)
        for p in problems:
            findings.append(Finding(
                rule="witness/unjustified-elision", path=_PATH, line=1,
                message=f"random[{i}]:\n{format_plan(root)}\n  {p}"))
        # 3. self-check: the same plan with one exchange deleted must
        # be REJECTED — otherwise the verifier has gone blind
        if not problems and mutate_delete_shuffle(root, rng, world):
            if not verify_plan(root, world):
                findings.append(Finding(
                    rule="witness/verifier-blind", path=_PATH, line=1,
                    message=f"random[{i}]: verifier accepted a plan "
                            f"whose join-side shuffle was deleted "
                            f"without a witness:\n{format_plan(root)}"))
            else:
                rejected += 1
    notes.append(f"witness: {len(canonical_plans(world))} canonical + "
                 f"{n_random} random plans verified; {rejected} "
                 f"mutations correctly rejected")
    return findings


def _load_plan_module(path: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location("_cylint_plans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_plans()
