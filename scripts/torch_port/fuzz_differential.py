#!/usr/bin/env python
"""Randomized differential testing of the port (counterpart of
scripts/fuzz_differential.py): random tables (mixed dtypes, strings in
both storages, nulls) and random relational ops, every result checked
three ways: distributed (a world of 8 shards) against local against
pandas. Seeded per case; a failure prints the reproducing seed. A seed
draws the same tables and choices as the JAX package's script.

Each case toggles, with the reference's draws:

* the chunked exchange (``CYLON_EXCHANGE_OVERLAP``, with
  ``CYLON_EXCHANGE_CHUNK_BYTES=4096`` every padded exchange chunks);
* the partition route, ``shuffle.PARTITION_KERNEL``: ``None`` (kernels
  K1/K2 on CUDA, where the JAX script ran its Pallas kernel) or
  ``False`` (the stable sort), so both routes get differential evidence
  on the card;
* varbytes storage for string keys (``strings.DICT_MAX_VOCAB = 0``).

Each case also runs a random LazyTable plan (scan -> optional shuffle ->
join -> optional groupby) optimized against unoptimized and pandas, with
``CYLON_JOIN_ALGORITHM`` (auto/shuffle/broadcast) and
``CYLON_SALT_FACTOR`` (0/4) toggled and the statistics warehouse
learning across three optimized runs.

The distributed joins run K1-K4 on CUDA, the local set ops K5/K6.

Results compare exactly: keys, counts, row counts and every cell that no
add made (joins and set ops gather their inputs' values). A float group
SUM, whose adds run in another order on another route or plan, is held
within PERF.md section 2's bound, ``1e-5 * sum |x|`` of its group plus
``1e-30``, the sum of ``|x|`` taken from the drawn input.

Usage: python scripts/torch_port/fuzz_differential.py [n_cases=40]
[base_seed=0] [--device cuda|cpu]

The last stdout line is one JSON object: the cases run, the failing
seeds, the wall time and the kernel launches by kernel. (The JAX script
split long runs over fresh interpreters to bound its compile cache; the
port compiles nothing per shape and runs every case in one process.)
"""
import argparse
import json
import os
import sys
import time

import numpy as np

import drill_common

import cylon_tpu_torch as ct  # noqa: E402
from cylon_tpu_torch.data import strings as _strings  # noqa: E402
from cylon_tpu_torch.parallel import shuffle as _shuffle  # noqa: E402

DEVICE = "cuda"


def rand_keys(rng, n, kind):
    if kind == "int32":
        return rng.integers(-50, 50, n).astype(np.int32)
    if kind == "int64":
        return rng.integers(-1000, 1000, n).astype(np.int64)
    if kind == "short_str":
        return np.array([f"k{int(x):03d}" for x in
                         rng.integers(0, 60, n)], object)
    if kind == "long_str":
        return np.array([f"{'L' * 30}{int(x):04d}" for x in
                         rng.integers(0, 60, n)], object)
    raise AssertionError(kind)


def rand_table(rng, n, kind, extra):
    d = {"k": rand_keys(rng, n, kind),
         extra: rng.normal(size=n).astype(np.float32)}
    return d


# PERF.md section 2's bound on a float SUM whose adds may run in another
# order: |a - b| <= SUM_RTOL * sum |x| of the group + SUM_ATOL, the sum of
# |x| taken from the drawn input, never from either result
SUM_RTOL = 1e-5
SUM_ATOL = 1e-30


def _null(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def cell(v) -> str:
    """One cell as an exact token: nulls as one token, floats by their
    full value, everything else by str."""
    if _null(v):
        return "<null>"
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def canon(df):
    """A frame's rows as a sorted list of tuples of exact cell tokens: the
    results compared with it add no floats (joins and set ops gather
    their inputs' values), so every cell compares exactly."""
    df = df.copy()
    df.columns = range(len(df.columns))
    return sorted(tuple(cell(v) for v in t)
                  for t in df.itertuples(index=False))


def group_key(v):
    """A group key as a dict key: None for a null, a Python int for an
    integer, the value itself otherwise."""
    if _null(v):
        return None
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def check_groups(got, exp, bound, what: str) -> None:
    """Two group results of (key, float SUM, COUNT) rows: the same keys
    and counts exactly, and each SUM within its group's ``bound`` (key ->
    allowed difference)."""
    assert len(got) == len(exp), f"{what}: {len(got)} != {len(exp)} groups"

    def rows(df):
        out = {}
        for k, s, c in df.itertuples(index=False):
            out[group_key(k)] = (float(s), int(c))
        assert len(out) == len(df), f"{what}: a key repeats"
        return out

    a, b = rows(got), rows(exp)
    assert sorted(map(repr, a)) == sorted(map(repr, b)), f"{what}: keys"
    for k, (sa, ca) in a.items():
        sb, cb = b[k]
        assert ca == cb, f"{what}: count of key {k!r}: {ca} != {cb}"
        if _null(sa) or _null(sb):   # a group of null values only
            assert _null(sa) and _null(sb), f"{what}: sum of key {k!r}"
            continue
        assert abs(sa - sb) <= bound[k], \
            f"{what}: sum of key {k!r}: {sa!r} vs {sb!r} (bound {bound[k]})"


def sum_bounds(keys, x) -> dict:
    """{group key: SUM_RTOL * sum |x| + SUM_ATOL} of the groups of
    ``keys`` (nulls one group) over the values ``x``."""
    import pandas as pd

    a = pd.DataFrame({"k": keys, "a": np.abs(np.asarray(x, np.float64))})
    s = a.groupby("k", dropna=False, sort=False)["a"].sum()
    return {group_key(k): SUM_RTOL * float(v) + SUM_ATOL
            for k, v in s.items()}


def check_group_sums(gd, gl, ld, seed) -> None:
    """The distributed against the local groupby SUM/COUNT of the left
    table's ``v`` by ``k``."""
    check_groups(gd, gl, sum_bounds(ld["k"], ld["v"]),
                 f"groupby seed={seed}")


def plan_sum_bounds(ld, rd, jt) -> dict:
    """The bounds of the plan's groupby of the join's ``rt-3`` (the right
    table's ``w``) by ``lt-0`` (the left key; null for a right row no
    left row matched), from the drawn tables."""
    import pandas as pd

    left = pd.DataFrame({"g": ld["k"], "k": ld["k"]})
    right = pd.DataFrame({"k": rd["k"], "w": rd["w"]})
    j = left.merge(right, on="k", how=jt)
    w = j["w"].to_numpy(np.float64)
    w = np.where(np.isnan(w), 0.0, w)   # a null w adds nothing
    g = [None if _null(v) else int(v) for v in j["g"]]
    return sum_bounds(np.array(g, object), w)


def check_plan_rows(got, ref, c, seed, run) -> None:
    """The optimized plan's rows against the unoptimized plan's: exact
    cells, except the groupby's float SUMs, held per key within their
    bound."""
    what = (f"lazy plan optimized!=unoptimized seed={seed} run={run} "
            f"mode={c['mode']} salt={c['salt']}")
    if not c["with_gb"]:
        assert canon(got) == canon(ref), what
        return
    check_groups(got, ref, plan_sum_bounds(c["ld"], c["rd"], c["jt"]),
                 what)


def case_draws(seed):
    """Every random draw of one eager case, in the JAX script's order:
    the choices and the two tables' columns (nulls placed)."""
    rng = np.random.default_rng(seed)
    kind = str(rng.choice(["int32", "int64", "short_str", "long_str"]))
    n1 = int(rng.integers(8, 400))
    n2 = int(rng.integers(8, 400))
    jt = str(rng.choice(["inner", "left", "right", "outer"]))
    force_vb = bool(rng.integers(0, 2)) and "str" in kind
    with_nulls = bool(rng.integers(0, 2)) and "str" in kind
    overlap = bool(rng.integers(0, 2))
    # the JAX script's "pallas" draw is the port's kernel route
    partition = "kernel" if bool(rng.integers(0, 2)) else "sort"
    ld = rand_table(rng, n1, kind, "v")
    rd = rand_table(rng, n2, kind, "w")
    if with_nulls:
        ld["k"][rng.integers(0, n1, max(n1 // 10, 1))] = None
        rd["k"][rng.integers(0, n2, max(n2 // 10, 1))] = None
    return dict(kind=kind, jt=jt, force_vb=force_vb,
                with_nulls=with_nulls, overlap=overlap,
                partition=partition, ld=ld, rd=rd)


def one_case(seed):
    c = case_draws(seed)
    kind, jt, force_vb = c["kind"], c["jt"], c["force_vb"]
    with_nulls, overlap, partition = c["with_nulls"], c["overlap"], \
        c["partition"]
    ld, rd = c["ld"], c["rd"]

    # the chunked exchange: with a tiny chunk target every padded
    # exchange chunks, and must stay equal to the single-shot program on
    # every distributed-vs-local comparison below
    os.environ["CYLON_EXCHANGE_OVERLAP"] = "1" if overlap else "0"
    if overlap:
        os.environ["CYLON_EXCHANGE_CHUNK_BYTES"] = "4096"
    # ...and, orthogonally, the partition route (K1/K2 on CUDA, or the
    # stable sort): every combination must agree with local AND pandas
    old_part = _shuffle.PARTITION_KERNEL
    _shuffle.PARTITION_KERNEL = None if partition == "kernel" else False

    old = _strings.DICT_MAX_VOCAB
    if force_vb:
        _strings.DICT_MAX_VOCAB = 0
    try:
        dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(8),
                                               device=DEVICE)
        lctx = ct.CylonContext.Init(DEVICE)

        lt_d = ct.Table.from_pydict(dctx, ld)
        rt_d = ct.Table.from_pydict(dctx, rd)
        lt_l = ct.Table.from_pydict(lctx, ld)
        rt_l = ct.Table.from_pydict(lctx, rd)

        jd = lt_d.distributed_join(rt_d, jt, on="k").to_pandas()
        jl = lt_l.join(rt_l, jt, on="k").to_pandas()
        assert canon(jd) == canon(jl), f"dist!=local join seed={seed}"
        if not with_nulls:
            # null-key match semantics differ from pandas (pandas merges
            # NaN keys as equal) — pandas row counts only on clean keys
            import pandas as pd

            jp = pd.DataFrame(ld).merge(pd.DataFrame(rd), on="k", how=jt)
            assert len(jd) == len(jp), \
                f"rowcount vs pandas seed={seed}: {len(jd)} != {len(jp)}"

        # set ops: distributed vs local (schemas must match: k only)
        sld = ct.Table.from_pydict(dctx, {"k": ld["k"]})
        srd = ct.Table.from_pydict(dctx, {"k": rd["k"]})
        sll = ct.Table.from_pydict(lctx, {"k": ld["k"]})
        srl = ct.Table.from_pydict(lctx, {"k": rd["k"]})
        for op in ("union", "intersect", "subtract"):
            ud = getattr(sld, f"distributed_{op}")(srd).to_pandas()
            ul = getattr(sll, op)(srl).to_pandas()
            assert canon(ud) == canon(ul), \
                f"dist!=local {op} seed={seed}"

        # groupby sum/count on the left table
        import pandas as pd

        gd = lt_d.groupby(0, [1, 1], ["sum", "count"]).to_pandas()
        gl = lt_l.groupby(0, [1, 1], ["sum", "count"]).to_pandas()
        # dropna=False: null keys form ONE group here (Arrow/SQL GROUP
        # BY semantics), which pandas only matches with dropna=False
        gp = pd.DataFrame(ld).groupby("k", dropna=False)["v"].agg(
            ["sum", "count"])
        assert len(gd) == len(gl) == len(gp), f"groupby len seed={seed}"
        check_group_sums(gd, gl, ld, seed)

        # distributed sort
        sd = ct.distributed_sort(lt_d, "k")
        sl = lt_l.sort("k")
        kd = [x for x in sd.to_pydict()["k"].tolist()]
        kl = [x for x in sl.to_pydict()["k"].tolist()]
        assert kd == kl, f"sort seed={seed}"
    finally:
        _strings.DICT_MAX_VOCAB = old
        _shuffle.PARTITION_KERNEL = old_part
        os.environ.pop("CYLON_EXCHANGE_OVERLAP", None)
        os.environ.pop("CYLON_EXCHANGE_CHUNK_BYTES", None)
    return kind, jt, force_vb, overlap, partition


def plan_case_draws(seed):
    """Every random draw of one LazyTable plan case, in the JAX script's
    order."""
    rng = np.random.default_rng(seed ^ 0x5A17)
    kind = str(rng.choice(["int32", "int64", "short_str"]))
    n1 = int(rng.integers(64, 600))
    n2 = int(rng.integers(8, 200))
    jt = str(rng.choice(["inner", "left", "right"]))
    mode = str(rng.choice(["auto", "shuffle", "broadcast"]))
    salt = int(rng.choice([0, 4]))
    zipf = bool(rng.integers(0, 2))
    with_gb = bool(rng.integers(0, 2)) and kind != "short_str"
    with_shuffle = bool(rng.integers(0, 2))
    ld = rand_table(rng, n1, kind, "v")
    rd = rand_table(rng, n2, kind, "w")
    if zipf and kind == "int32":
        hot = ld["k"][0]
        ld["k"] = np.where(rng.random(n1) < 0.6, hot,
                           ld["k"]).astype(np.int32)
    return dict(kind=kind, jt=jt, mode=mode, salt=salt, with_gb=with_gb,
                with_shuffle=with_shuffle, ld=ld, rd=rd)


def lazy_plan_case(seed):
    """One random LazyTable plan, differentially tested optimized vs
    unoptimized vs pandas under randomized adaptive-join knobs."""
    import pandas as pd

    from cylon_tpu_torch import plan as ct_plan
    from cylon_tpu_torch.telemetry import stats as stats_mod

    c = plan_case_draws(seed)
    jt, mode, salt = c["jt"], c["mode"], c["salt"]
    with_gb, with_shuffle, ld, rd = c["with_gb"], c["with_shuffle"], \
        c["ld"], c["rd"]
    os.environ["CYLON_JOIN_ALGORITHM"] = mode
    os.environ["CYLON_SALT_FACTOR"] = str(salt)
    os.environ["CYLON_STATS_MIN_OBS"] = "2"
    stats_mod.reset()
    try:
        dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(8),
                                               device=DEVICE)
        lt_d = ct.Table.from_pydict(dctx, ld)
        rt_d = ct.Table.from_pydict(dctx, rd)

        def pipe():
            lt = ct_plan.scan(lt_d)
            if with_shuffle:
                lt = lt.shuffle(["k"])
            p = lt.join(ct_plan.scan(rt_d), jt, on="k")
            if with_gb:
                # aggregate_cols pairs 1:1 with ops
                p = p.groupby("lt-0", ["rt-3", "rt-3"],
                              ["sum", "count"])
            return p

        ref = pipe().execute(optimize=False).to_pandas()
        # repeated optimized executions: the auto cases LEARN across
        # runs (run 1-2 exploratory shuffle, run 3 may rewrite) —
        # every run must match the unoptimized plan
        for run in range(3):
            got = pipe().execute().to_pandas()
            check_plan_rows(got, ref, c, seed, run)
        if not with_gb:
            jp = pd.DataFrame(ld).merge(pd.DataFrame(rd), on="k", how=jt)
            assert len(ref) == len(jp), \
                f"lazy plan rowcount vs pandas seed={seed}: " \
                f"{len(ref)} != {len(jp)}"
    finally:
        os.environ.pop("CYLON_JOIN_ALGORITHM", None)
        os.environ.pop("CYLON_SALT_FACTOR", None)
        os.environ.pop("CYLON_STATS_MIN_OBS", None)
        stats_mod.reset()
    return jt, mode, salt, with_gb, with_shuffle


def main(n_cases, base, device="cuda"):
    global DEVICE
    DEVICE = device
    t0 = time.perf_counter()
    before = drill_common.launches()
    bad = []
    for i in range(n_cases):
        seed = base + i
        try:
            kind, jt, fv, ov, pk = one_case(seed)
            print(f"case {seed}: ok ({kind}, {jt}, vb={fv}, part={pk}, "
                  f"overlap={ov})", flush=True)
        except AssertionError as e:
            bad.append(seed)
            print(f"case {seed}: FAIL {e}", flush=True)
        except Exception as e:
            bad.append(seed)
            print(f"case {seed}: ERROR {type(e).__name__}: {e}",
                  flush=True)
        try:
            jt, mode, salt, gb, sh = lazy_plan_case(seed)
            print(f"plan case {seed}: ok ({jt}, algo={mode}, "
                  f"salt={salt}, groupby={gb}, shuffle={sh})",
                  flush=True)
        except AssertionError as e:
            bad.append(seed)
            print(f"plan case {seed}: FAIL {e}", flush=True)
        except Exception as e:
            bad.append(seed)
            print(f"plan case {seed}: ERROR {type(e).__name__}: {e}",
                  flush=True)
    print(f"{n_cases - len(set(bad))}/{n_cases} passed")
    print(json.dumps({"drill": "fuzz_differential", "device": device,
                      "checks": ["eager", "plan"], "cases": n_cases,
                      "base_seed": base, "failed_seeds": sorted(set(bad)),
                      "wall_s": round(time.perf_counter() - t0, 3),
                      "launches": drill_common.launch_delta(before)}),
          flush=True)
    return len(bad)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_cases", nargs="?", type=int, default=40)
    p.add_argument("base_seed", nargs="?", type=int, default=0)
    drill_common.add_device_arg(p)
    a = p.parse_args()
    sys.exit(1 if main(a.n_cases, a.base_seed, a.device) else 0)
