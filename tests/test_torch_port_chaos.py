"""The port's chaos drill and differential fuzzer on the CPU
(scripts/torch_port/chaos.py, fuzz_differential.py), each in fresh
processes, all started together:

* ``chaos.py --seeds 1 --device cpu``: every scenario of seed 0 passes,
  ``compile`` reported skipped (no kernel library is loaded on the CPU;
  the only skip), no kernel launch counted;
* the port's and the JAX package's ``--seed 0 --scenario transient`` and
  ``--scenario persistent``: the same retries, the same typed error
  class and the same fault site named in the crash dump;
* the fuzzer at 6 cases with no failing seed;
* the fuzzer's case generator draws, seed for seed, the JAX script's
  tables and choices (its draws copied below: the JAX script reconfigures
  jax when imported)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "scripts" / "torch_port"
REF = ROOT / "scripts"


def _start(script, args, tmp):
    env = dict(os.environ, TMPDIR=str(tmp), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(script), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT), env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every drill process of this file, started at once; each entry
    waits for its process when first read."""
    jobs = {
        "sweep": (PORT / "chaos.py", ["--seeds", "1", "--device", "cpu"]),
        "fuzz": (PORT / "fuzz_differential.py", ["6", "--device", "cpu"]),
    }
    for sc in ("transient", "persistent"):
        jobs[f"port_{sc}"] = (PORT / "chaos.py",
                              ["--seed", "0", "--scenario", sc,
                               "--device", "cpu"])
        jobs[f"ref_{sc}"] = (REF / "chaos.py",
                             ["--seed", "0", "--scenario", sc])
    procs = {}
    for k, (script, args) in jobs.items():
        tmp = tmp_path_factory.mktemp(k)
        procs[k] = (_start(script, args, tmp), tmp)
    done = {}

    def get(k):
        if k not in done:
            p, tmp = procs[k]
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, (k, out[-3000:], err[-3000:])
            done[k] = (json.loads(out.strip().splitlines()[-1]), tmp)
        return done[k]

    yield get
    for p, _tmp in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def test_chaos_sweep_on_cpu(runs):
    doc, _ = runs("sweep")
    assert doc["drill"] == "chaos" and doc["device"] == "cpu"
    ran = doc["seeds"]["0"]
    assert list(ran) == ["compile", "transient", "overlap", "persistent",
                         "shed", "degrade", "deadline", "stats",
                         "mislearn", "service"]
    assert ran["compile"] == {"skipped": "no kernel library is loaded on "
                                         "the CPU"}
    assert [k for k, v in ran.items() if "skipped" in v] == ["compile"]
    assert doc["checks"] == sorted(set(ran) - {"compile"})
    assert not any(doc["launches"].values()), doc["launches"]
    assert ran["overlap"]["chunks"] > 0 and ran["overlap"]["retries"] > 0
    assert ran["shed"]["decision"]["action"] == "shed"
    assert ran["degrade"]["decision"]["action"] == "degrade"
    assert ran["service"]["shed"]["tenant"] == "tenant-a"


def test_transient_matches_reference(runs):
    port, _ = runs("port_transient")
    ref, _ = runs("ref_transient")
    assert port["scenarios"]["transient"] == ref["scenarios"]["transient"]
    assert port["scenarios"]["transient"]["retries"] >= 1


def test_persistent_matches_reference(runs):
    port, _ = runs("port_persistent")
    ref, ref_tmp = runs("ref_persistent")
    p, r = port["scenarios"]["persistent"], ref["scenarios"]["persistent"]
    assert p["fired"] == r["fired"]
    # the JAX drill passes only on a CylonTransientError
    assert p["error"] == "CylonTransientError"
    dumps = list(ref_tmp.glob(f"cylon-chaos-*/{r['dump']}"))
    assert len(dumps) == 1, dumps
    faults = json.loads(dumps[0].read_text())["sections"]["faults"]
    assert p["dump_sites"] == sorted({f["site"] for f in faults["fired"]}) \
        == ["exchange"]


def test_fuzzer_on_cpu(runs):
    doc, _ = runs("fuzz")
    assert doc["cases"] == 6 and doc["failed_seeds"] == []
    assert not any(doc["launches"].values())


# -- the case generator, seed for seed ------------------------------------

def _ref_rand_keys(rng, n, kind):
    # scripts/fuzz_differential.py rand_keys
    if kind == "int32":
        return rng.integers(-50, 50, n).astype(np.int32)
    if kind == "int64":
        return rng.integers(-1000, 1000, n).astype(np.int64)
    if kind == "short_str":
        return np.array([f"k{int(x):03d}" for x in
                         rng.integers(0, 60, n)], object)
    return np.array([f"{'L' * 30}{int(x):04d}" for x in
                     rng.integers(0, 60, n)], object)


def _ref_table(rng, n, kind, extra):
    return {"k": _ref_rand_keys(rng, n, kind),
            extra: rng.normal(size=n).astype(np.float32)}


def _ref_case(seed):
    """one_case's draws, in its order."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(["int32", "int64", "short_str", "long_str"])
    n1 = int(rng.integers(8, 400))
    n2 = int(rng.integers(8, 400))
    jt = rng.choice(["inner", "left", "right", "outer"])
    force_vb = bool(rng.integers(0, 2)) and "str" in kind
    with_nulls = bool(rng.integers(0, 2)) and "str" in kind
    overlap = bool(rng.integers(0, 2))
    partition = "pallas" if bool(rng.integers(0, 2)) else "sort"
    ld = _ref_table(rng, n1, kind, "v")
    rd = _ref_table(rng, n2, kind, "w")
    if with_nulls:
        ld["k"][rng.integers(0, n1, max(n1 // 10, 1))] = None
        rd["k"][rng.integers(0, n2, max(n2 // 10, 1))] = None
    return dict(kind=kind, jt=jt, force_vb=force_vb, with_nulls=with_nulls,
                overlap=overlap, partition=partition, ld=ld, rd=rd)


def _ref_plan_case(seed):
    """lazy_plan_case's draws, in its order."""
    rng = np.random.default_rng(seed ^ 0x5A17)
    kind = rng.choice(["int32", "int64", "short_str"])
    n1 = int(rng.integers(64, 600))
    n2 = int(rng.integers(8, 200))
    jt = rng.choice(["inner", "left", "right"])
    mode = rng.choice(["auto", "shuffle", "broadcast"])
    salt = int(rng.choice([0, 4]))
    zipf = bool(rng.integers(0, 2))
    with_gb = bool(rng.integers(0, 2)) and kind != "short_str"
    with_shuffle = bool(rng.integers(0, 2))
    ld = _ref_table(rng, n1, kind, "v")
    rd = _ref_table(rng, n2, kind, "w")
    if zipf and kind == "int32":
        hot = ld["k"][0]
        ld["k"] = np.where(rng.random(n1) < 0.6, hot,
                           ld["k"]).astype(np.int32)
    return dict(kind=kind, jt=jt, mode=mode, salt=salt, with_gb=with_gb,
                with_shuffle=with_shuffle, ld=ld, rd=rd)


def _same_tables(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        assert a[k].tolist() == b[k].tolist(), k


@pytest.fixture(scope="module")
def fuzz_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_fuzz_differential", PORT / "fuzz_differential.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(PORT))   # its drill_common
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(PORT))
    return mod


@pytest.mark.parametrize("seed", range(40))
def test_case_generator_matches_reference(fuzz_module, seed):
    got, want = fuzz_module.case_draws(seed), _ref_case(seed)
    want["partition"] = {"pallas": "kernel", "sort": "sort"}[
        want["partition"]]
    for k in ("kind", "jt", "force_vb", "with_nulls", "overlap",
              "partition"):
        assert got[k] == want[k], k
    _same_tables(got["ld"], want["ld"])
    _same_tables(got["rd"], want["rd"])
    got, want = fuzz_module.plan_case_draws(seed), _ref_plan_case(seed)
    for k in ("kind", "jt", "mode", "salt", "with_gb", "with_shuffle"):
        assert got[k] == want[k], k
    _same_tables(got["ld"], want["ld"])
    _same_tables(got["rd"], want["rd"])
