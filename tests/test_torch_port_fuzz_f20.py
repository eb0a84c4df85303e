"""F20: the port's differential fuzzer (scripts/torch_port/fuzz_differential.py)
on the seeds whose float checks failed before its comparison changed.

Sixteen seeds of a 2,000-seed run failed, none with a wrong result: five
in ``one_case``'s groupby check, which held the distributed float32 SUM
to the local one with ``rtol=1e-4`` of the result (a few ulps for a
group that cancels), and eleven in ``lazy_plan_case``, whose ``canon``
rounded float cells to 3 decimals (a sum on a rounding edge fails when
the optimized plan adds in another order than the unoptimized one).

Each seed must pass the fuzzer's comparison now (keys, counts and row
counts exact, each float SUM within PERF.md section 2's bound of its
group, computed from the drawn input) and fail the old one, whose code
is kept below. The JAX package's script is not changed.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

PORT = Path(__file__).resolve().parent.parent / "scripts" / "torch_port"

EAGER_SEEDS = (100060, 100348, 100614, 100689, 101980)
PLAN_SEEDS = (100126, 100230, 100239, 101347, 101372, 101588, 101680,
              101733, 101742, 101781, 101874)


@pytest.fixture(scope="module")
def fuzz():
    spec = importlib.util.spec_from_file_location(
        "port_fuzz_differential_f20", PORT / "fuzz_differential.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(PORT))   # its drill_common
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(PORT))
    mod.DEVICE = "cpu"
    return mod


# -- the comparison before the change, verbatim ---------------------------

def old_canon(df):
    df = df.copy()
    df.columns = range(len(df.columns))
    rows = []
    for t in df.itertuples(index=False):
        # stringify EVERY cell so mixed null/str/float columns sort
        rows.append(tuple(
            "<null>" if v is None or v != v else
            (f"{float(v):.3f}" if isinstance(v, (float, np.floating))
             else str(v)) for v in t))
    return sorted(rows)


def old_check_group_sums(gd, gl, ld, seed):
    a = gd.sort_values(gd.columns[0]).reset_index(drop=True)
    b = gl.sort_values(gl.columns[0]).reset_index(drop=True)
    np.testing.assert_allclose(
        a.iloc[:, 1].astype(float), b.iloc[:, 1].astype(float),
        rtol=1e-4, err_msg=f"groupby sum seed={seed}")


def old_check_plan_rows(got, ref, c, seed, run):
    assert old_canon(got) == old_canon(ref), \
        f"lazy plan optimized!=unoptimized seed={seed} " \
        f"run={run} mode={c['mode']} salt={c['salt']}"


def _old_comparison(fuzz, monkeypatch):
    monkeypatch.setattr(fuzz, "canon", old_canon)
    monkeypatch.setattr(fuzz, "check_group_sums", old_check_group_sums)
    monkeypatch.setattr(fuzz, "check_plan_rows", old_check_plan_rows)


@pytest.mark.parametrize("seed", EAGER_SEEDS + PLAN_SEEDS)
def test_f20_seed_passes_new_check_and_failed_old(fuzz, monkeypatch, seed):
    fuzz.one_case(seed)
    fuzz.lazy_plan_case(seed)
    _old_comparison(fuzz, monkeypatch)
    case = fuzz.one_case if seed in EAGER_SEEDS else fuzz.lazy_plan_case
    with pytest.raises(AssertionError):
        case(seed)


def test_new_check_still_catches_a_wrong_sum(fuzz):
    """The bound is not a pass for everything: a sum off by more than its
    group's bound, a changed count or a missing key fails."""
    import pandas as pd

    ld = {"k": np.array([1, 1, 2], np.int32),
          "v": np.array([1.0, -1.0, 3.0], np.float32)}
    good = pd.DataFrame({"k": [1, 2], "s": [0.0, 3.0], "c": [2, 1]})
    fuzz.check_group_sums(good, good.copy(), ld, 0)
    bad_sum = good.assign(s=[0.0, 3.0 + 4e-5])
    bad_count = good.assign(c=[2, 2])
    bad_key = good.assign(k=[1, 3])
    for bad in (bad_sum, bad_count, bad_key, good.iloc[:1]):
        with pytest.raises(AssertionError):
            fuzz.check_group_sums(bad, good, ld, 0)
