"""cylon_tpu_torch.analysis against cylon_tpu.analysis (the JAX package's
tests/test_analysis.py pins the reference suite itself):

* over tests/analysis_fixtures/pkg_bad both suites report the same
  findings, as (rule, path, line) multisets, for the shared families
  (layering, span-coverage, ledger-coverage, errors, envknobs,
  specialization and the non-JAX rules of concurrency), with equal JSON
  and SARIF texts where the findings are equal;
* the witness corpora verify clean in both, and the self-check
  mutations are rejected in both;
* the port's own rules (hostsync/in-launch, hostsync/undeclared, the
  collectives rules) fire exactly at seeded fixture lines written to
  tmp_path, and nowhere in cylon_tpu_torch;
* the port's full suite over cylon_tpu_torch, and the reference's
  file-scanning families over it, are clean.
"""
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import pytest

import cylon_tpu
from cylon_tpu import analysis as jana
import cylon_tpu_torch
from cylon_tpu_torch import analysis as tana
from cylon_tpu_torch.analysis import collectives as tcoll
from cylon_tpu_torch.analysis import layering as tlayering

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "analysis_fixtures"
PKG_BAD = str(FIXTURES / "pkg_bad")
PORT = os.path.dirname(os.path.abspath(cylon_tpu_torch.__file__))
SHARED = ("layering", "span-coverage", "ledger-coverage", "errors",
          "envknobs", "specialization", "concurrency")
FILE_FAMILIES = ["layering", "hostsync", "span-coverage", "ledger-coverage",
                 "errors", "concurrency", "envknobs", "specialization"]
# the JAX-only rule seeded in pkg_bad: a finalizer dispatching through jax
JAX_ONLY = {("concurrency/finalizer-hazard", "telemetry/gc_bad.py", 22)}
ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _keys(res):
    return Counter((f.rule, f.path, f.line) for f in res.findings)


@pytest.fixture(scope="module")
def bad_runs():
    """{family: (reference result, port result)} over pkg_bad."""
    return {fam: (jana.run_checkers(jana.AnalysisContext(PKG_BAD), [fam]),
                  tana.run_checkers(tana.AnalysisContext(PKG_BAD), [fam]))
            for fam in SHARED}


@pytest.fixture(scope="module")
def port_ctx():
    """One context over cylon_tpu_torch: its parsed files and module
    index are built once and shared by the single-family runs."""
    return tana.AnalysisContext(PORT)


@pytest.fixture(scope="module")
def port_full():
    """The port's CLI over cylon_tpu_torch (every family, JSON), in a
    subprocess that then reports which modules it imported."""
    code = ("import json, sys\n"
            "from cylon_tpu_torch.analysis.__main__ import main\n"
            "rc = main(['--format', 'json'])\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} &"
            " {'jax', 'jaxlib', 'cylon_tpu'})\n"
            "print(json.dumps({'rc': rc, 'bad': bad}))\n")
    env = {k: v for k, v in ENV.items() if not k.startswith("JAX_")}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    out, tail = r.stdout.rsplit("\n", 2)[0], r.stdout.strip().splitlines()
    return json.loads(out), json.loads(tail[-1]), r


# ---------------------------------------------------------------------------
# the differential over pkg_bad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", SHARED)
def test_shared_family_same_findings(bad_runs, family):
    ref, port = bad_runs[family]
    want = _keys(ref) - Counter(JAX_ONLY)
    assert _keys(port) == want, port.format_text()
    assert want, f"pkg_bad seeds {family}"
    assert port.suppressed == ref.suppressed


@pytest.mark.parametrize("family", [f for f in SHARED
                                    if f != "concurrency"])
@pytest.mark.parametrize("fmt", ["json", "sarif"])
def test_shared_family_same_output_text(bad_runs, family, fmt):
    ref, port = bad_runs[family]
    render = {"json": (jana.to_json_text, tana.to_json_text),
              "sarif": (jana.to_sarif_text, tana.to_sarif_text)}[fmt]
    assert render[1](port) == render[0](ref)


def test_concurrency_non_jax_messages_equal(bad_runs):
    ref, port = bad_runs["concurrency"]
    want = {(f.rule, f.path, f.line): f.message for f in ref.findings
            if (f.rule, f.path, f.line) not in JAX_ONLY}
    assert {(f.rule, f.path, f.line): f.message
            for f in port.findings} == want
    assert port.notes == ref.notes


def test_schema_and_sarif_constants_match():
    assert tana.SCHEMA_VERSION == jana.SCHEMA_VERSION == 1
    assert tana.SARIF_VERSION == jana.SARIF_VERSION == "2.1.0"
    res = tana.run_checkers(tana.AnalysisContext(PKG_BAD), ["layering"])
    doc = json.loads(tana.to_json_text(res))
    assert set(doc) == {"version", "ok", "checkers", "counts",
                        "suppressed", "notes", "findings"}
    keys = [(f["path"], f["line"], f["rule"]) for f in doc["findings"]]
    assert keys == sorted(keys)


# ---------------------------------------------------------------------------
# witness
# ---------------------------------------------------------------------------


def test_witness_corpus_clean_in_both():
    ref = jana.run_checkers(jana.AnalysisContext(
        os.path.dirname(cylon_tpu.__file__)), ["witness"])
    port = tana.run_checkers(tana.AnalysisContext(PORT), ["witness"])
    assert ref.findings == [] and port.findings == [], port.format_text()
    # same corpus, same seed, same optimizer semantics: the same number
    # of self-check mutations rejected
    assert port.notes == ref.notes
    assert "mutations correctly rejected" in port.notes[0]


WITNESS_FIXTURE = """
from cylon_tpu_torch.analysis.witness import _scan, mutate_delete_shuffle
from cylon_tpu_torch.plan import ir
from cylon_tpu_torch.plan.optimizer import optimize

WORLD = 4


def _logical():
    left = _scan(["int32", "float32"], world=WORLD)
    right = _scan(["int32", "int32"], world=WORLD, name="r")
    return ir.GroupBy(ir.Join(left, right, [0], [0]), [0], [3], ["sum"])


def build_plans():
    intact, _stats = optimize(_logical(), WORLD)
    mutated, _stats = optimize(_logical(), WORLD)
    assert mutate_delete_shuffle(mutated, world=WORLD)
    return [("intact-join-groupby", intact, WORLD, True),
            ("hand-deleted-shuffle", mutated, WORLD, False)]
"""


def test_witness_mutation_rejected_in_both(tmp_path):
    fixture = tmp_path / "witness_port.py"
    fixture.write_text(WITNESS_FIXTURE)
    ref = jana.run_checkers(jana.AnalysisContext(
        os.path.dirname(cylon_tpu.__file__), {
            "witness_plan_module": str(FIXTURES / "witness_bad.py")}),
        ["witness"])
    port = tana.run_checkers(tana.AnalysisContext(PORT, {
        "witness_plan_module": str(fixture)}), ["witness"])
    for res in (ref, port):
        assert [f.rule for f in res.findings] == \
            ["witness/unjustified-elision"], res.format_text()
        assert "hand-deleted-shuffle" in res.findings[0].message
    assert port.findings[0].message == ref.findings[0].message


# ---------------------------------------------------------------------------
# hostsync: the port's two rules at seeded lines
# ---------------------------------------------------------------------------


def _tree(root: Path, files: dict) -> str:
    pkg = root / "pkg_port"
    for rel, text in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        for d in [p.parent] + list(p.parent.parents):
            if d == pkg.parent:
                break
            (d / "__init__.py").touch()
        p.write_text(textwrap.dedent(text).lstrip("\n"))
    return str(pkg)


HOSTSYNC_FILES = {
    "ops/kernels.py": """
        import torch

        KERNELS = ("k_one", "k_two")


        def _check(x):
            if x.sum() > 0:                # not typed: x is a parameter
                pass


        def _helper(x: torch.Tensor):
            return x.item()                # SEEDED: in-launch (via k_one)


        def k_one(x):
            _check(x)
            return _helper(x)


        def k_two(x):
            torch.cuda.synchronize()       # SEEDED: in-launch
            return x


        def not_a_wrapper(x):
            return x.tolist()              # outside the closure: census
        """,
    "parallel/dist.py": """
        import torch

        from ..telemetry.metrics import record_host_sync


        def undeclared(x):
            n = int(torch.sum(x))          # SEEDED: undeclared
            if (x > n).any():              # not typed: x is a parameter
                pass
            t = torch.zeros(3)
            if t.any():                    # SEEDED: undeclared
                pass
            return x.to("cpu")             # SEEDED: undeclared


        def declared(x):
            host = x.cpu().numpy()
            record_host_sync("dist.count")
            return host


        def nested(x):
            def fetch():
                v = x.cpu()
                record_host_sync("dist.nested")
                return v
            return fetch()
        """,
    "data/host.py": """
        def export(x):
            return x.cpu().tolist()        # host side: census only
        """,
}


@pytest.fixture(scope="module")
def hostsync_run(tmp_path_factory):
    root = _tree(tmp_path_factory.mktemp("hostsync"), HOSTSYNC_FILES)
    return tana.run_checkers(tana.AnalysisContext(root), ["hostsync"])


def test_hostsync_fires_exactly_where_seeded(hostsync_run):
    assert _keys(hostsync_run) == Counter({
        ("hostsync/in-launch", "ops/kernels.py", 12): 1,
        ("hostsync/in-launch", "ops/kernels.py", 21): 1,
        ("hostsync/undeclared", "parallel/dist.py", 7): 1,
        ("hostsync/undeclared", "parallel/dist.py", 11): 1,
        ("hostsync/undeclared", "parallel/dist.py", 13): 1,
    }), hostsync_run.format_text()


def test_hostsync_in_launch_names_the_wrapper(hostsync_run):
    msg = {f.line: f.message for f in hostsync_run.findings
           if f.rule == "hostsync/in-launch"}
    assert "kernels.k_one" in msg[12] and "kernels.k_two" in msg[21]


def test_hostsync_census_counts_host_side_modules(hostsync_run):
    note = next(n for n in hostsync_run.notes if n.startswith("hostsync"))
    assert "data/host.py=2" in note and "ops/kernels.py=3" in note
    assert "parallel/: 3 declared, 3 undeclared" in note


def test_hostsync_suppression_counts(tmp_path):
    files = dict(HOSTSYNC_FILES)
    files["parallel/dist.py"] = files["parallel/dist.py"].replace(
        '# SEEDED: undeclared\n            if (x',
        '# cylint: disable=hostsync/undeclared\n            if (x')
    res = tana.run_checkers(tana.AnalysisContext(_tree(tmp_path, files)),
                            ["hostsync"])
    assert ("hostsync/undeclared", "parallel/dist.py", 7) not in _keys(res)
    assert res.suppressed == 1


def test_hostsync_real_tree_clean(port_ctx):
    res = tana.run_checkers(port_ctx, ["hostsync"])
    assert res.findings == [], res.format_text()
    note = next(n for n in res.notes if n.startswith("hostsync"))
    # every transfer of parallel/ is declared, none undeclared
    assert ", 0 undeclared;" in note and "0 in kernel-wrapper" in note


# ---------------------------------------------------------------------------
# collectives: static rules at seeded lines
# ---------------------------------------------------------------------------


COLLECTIVE_FILES = {
    "ops/bad.py": """
        import torch
        import torch.distributed as dist  # SEEDED: comm-seam


        def reduce(t):
            torch.distributed.all_reduce(t)  # SEEDED: comm-seam
            return t
        """,
    "parallel/comm.py": """
        import torch.distributed as dist  # the seam: legal


        def all_reduce(t):
            dist.all_reduce(t)
        """,
    "context.py": """
        from torch import distributed  # the seam: legal
        """,
    "parallel/dist_ops.py": """
        def distributed_join(a, b):
            return a


        def rogue_op(a):  # SEEDED: uncataloged-factory
            return a


        def host_helper(a):  # cylint: disable=collectives/uncataloged-factory
            return a


        def _private(a):
            return a
        """,
    "parallel/shuffle.py": """
        from torch import distributed  # SEEDED: comm-seam


        def exchange(p):
            return p
        """,
}


def test_collectives_static_rules_fire_exactly_where_seeded(tmp_path):
    root = _tree(tmp_path, COLLECTIVE_FILES)
    res = tana.run_checkers(tana.AnalysisContext(
        root, {"collectives_coverage_only": True}), ["collectives"])
    assert _keys(res) == Counter({
        ("collectives/comm-seam", "ops/bad.py", 2): 1,
        ("collectives/comm-seam", "ops/bad.py", 6): 1,
        ("collectives/comm-seam", "parallel/shuffle.py", 1): 1,
        ("collectives/uncataloged-factory", "parallel/dist_ops.py", 5): 1,
    }), res.format_text()
    assert res.suppressed == 1


# ---------------------------------------------------------------------------
# collectives: runtime rules through a fixture catalog
# ---------------------------------------------------------------------------


ENTRY_FILES = {
    "parallel/fx.py": """
        def bad_all_to_all(ctx):
            pass


        def bad_ring_shift(ctx):
            pass


        def f64_cast(ctx):
            pass


        def raises(ctx):
            pass


        def clean(ctx):
            pass
        """,
}

ENTRY_MODULE = """
import torch

from cylon_tpu_torch.analysis.collectives import EntryPoint


def bad_all_to_all(ctx):
    ctx.comm.all_to_all(torch.zeros(4, 16, dtype=torch.int32))


def bad_ring_shift(ctx):
    ctx.comm.ring_shift(torch.zeros(7))


def f64_cast(ctx):
    torch.ones(8, dtype=torch.float32).to(torch.float64)


def raises(ctx):
    raise ValueError("seeded")


def clean(ctx):
    x = ctx.comm.all_to_all(torch.zeros(4, 4, 3))
    ctx.comm.ring_shift(x)
    ctx.comm.gather_full(x)
    torch.ones(4, dtype=torch.float32) * 2.0   # a Python float: float32


ENTRY_POINTS = [EntryPoint(f.__name__, "parallel/fx.py", f.__name__, f)
                for f in (bad_all_to_all, bad_ring_shift, f64_cast, raises,
                          clean)]
"""


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entries")
    root = _tree(tmp, ENTRY_FILES)
    mod = tmp / "entries_port.py"
    mod.write_text(ENTRY_MODULE)
    return tana.run_checkers(tana.AnalysisContext(root, {
        "collectives_entry_module": str(mod)}), ["collectives"])


def test_collectives_runtime_rules_fire_exactly_where_seeded(entry_run):
    assert _keys(entry_run) == Counter({
        ("collectives/all-to-all-axes", "parallel/fx.py", 1): 1,
        ("collectives/all-to-all-axes", "parallel/fx.py", 5): 1,
        ("collectives/f64-promotion", "parallel/fx.py", 9): 1,
        ("collectives/trace-error", "parallel/fx.py", 13): 1,
    }), entry_run.format_text()


def test_collectives_runtime_messages(entry_run):
    msg = {f.line: f.message for f in entry_run.findings}
    assert "[4, 4, ...]" in msg[1] and "(4, 16)" in msg[1]
    assert "ring_shift" in msg[5]
    assert "_to_copy" in msg[9]
    assert "ValueError: seeded" in msg[13]


def test_collectives_restores_route_switches(entry_run):
    from cylon_tpu_torch.ops import join, setops
    from cylon_tpu_torch.parallel import shuffle

    assert join.STREAM_PLAN is None and setops.STREAM_SETOP is None \
        and shuffle.PARTITION_KERNEL is None


def test_collectives_catalog_covers_every_public_function(port_ctx):
    port_ctx.options["collectives_coverage_only"] = True
    try:
        res = tana.run_checkers(port_ctx, ["collectives"])
    finally:
        del port_ctx.options["collectives_coverage_only"]
    assert res.findings == [], res.format_text()
    assert res.suppressed == 1  # shuffle.use_partition_kernel
    covered = {(e.path, e.func) for e in tcoll.default_entry_points()}
    assert ("parallel/dist_ops.py", "distributed_join") in covered


# ---------------------------------------------------------------------------
# the real tree: both suites clean
# ---------------------------------------------------------------------------


def test_port_suite_clean_with_ten_families(port_full):
    doc, tail, r = port_full
    assert tail == {"rc": 0, "bad": []}, r.stdout[-3000:] + r.stderr
    assert doc["ok"] is True and doc["findings"] == []
    assert len(doc["checkers"]) == 10
    assert any(n.startswith("collectives: 23 catalog entries")
               for n in doc["notes"])


def test_reference_file_families_clean_over_port():
    res = jana.run_checkers(jana.AnalysisContext(PORT), FILE_FAMILIES)
    assert res.findings == [], res.format_text()


@pytest.mark.parametrize("family", ["layering", "span-coverage",
                                    "ledger-coverage", "errors",
                                    "concurrency", "envknobs",
                                    "specialization"])
def test_port_family_clean_on_port(port_ctx, family):
    res = tana.run_checkers(port_ctx, [family])
    assert res.findings == [], res.format_text()


def test_contract_modules_exist_in_port():
    """Every module a contract names is in the port under that name."""
    names = {str(p.relative_to(PORT)) for p in Path(PORT).rglob("*.py")}
    dirs = {n.split("/")[0] for n in names if "/" in n}
    for c in tlayering.DEFAULT_CONTRACTS:
        for scope in c.scope:
            assert scope in names or scope in dirs, (c.name, scope)
        for ex in c.exempt:
            assert any(n.endswith("/" + ex) for n in names), (c.name, ex)
    from cylon_tpu_torch.analysis import envknobs, ledgercov, spancov
    for rel, _kind, _prefix in spancov.DEFAULT_SCOPES + \
            ledgercov.DEFAULT_SCOPES:
        assert rel in names
    assert envknobs.REGISTRY_REL in names


def test_envknobs_counts_every_declared_knob(port_ctx):
    res = tana.run_checkers(port_ctx, ["envknobs"])
    note = next(n for n in res.notes if "declared knobs" in n)
    assert note == "envknobs: 30 declared knobs, 0 unregistered read " \
                   "site(s)"


def test_specialization_audits_load_library(port_ctx):
    res = tana.run_checkers(port_ctx, ["specialization"])
    census = next(n for n in res.notes if "counted_cache factories" in n)
    assert census.startswith("specialization: 1 counted_cache factories")
    assert "0 data-dependent" in census and "0 unbounded" in census
    assert res.suppressed == 0


def test_module_index_built_once_across_families():
    ctx = tana.AnalysisContext(PKG_BAD)
    tana.run_checkers(ctx, ["hostsync", "concurrency", "envknobs",
                            "specialization"])
    assert ctx.index_builds == 1


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "cylon_tpu_torch.analysis",
                           *args], capture_output=True, text=True,
                          cwd=str(ROOT), env=ENV, timeout=300)


def test_cli_list_rules_lists_ten():
    r = _cli("--list-rules")
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.strip().splitlines()) == 10


def test_cli_fixture_root_fails_with_seeded_rules():
    r = _cli("--package-root", PKG_BAD)
    assert r.returncode == 1, r.stdout + r.stderr
    for rule in ("[layering/plan-no-ops]", "[errors/bare-except]",
                 "[concurrency/blocking-under-lock]",
                 "[envknobs/unregistered-read]",
                 "[specialization/unbucketed-capacity]"):
        assert rule in r.stdout


def test_cli_unknown_family_exits_2():
    r = _cli("--families", "layring")
    assert r.returncode == 2 and "unknown checker families" in r.stderr


def test_import_of_package_leaves_analysis_out():
    code = ("import sys, cylon_tpu_torch;"
            " sys.exit('cylon_tpu_torch.analysis' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       env=ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_suppression_file_level(tmp_path):
    root = _tree(tmp_path, {"plan/x.py": """
        # cylint: disable-file=layering/plan-no-ops
        from ..ops import join
        """})
    res = tana.run_checkers(tana.AnalysisContext(root), ["layering"])
    assert res.findings == [] and res.suppressed == 1
