"""The plain reference against a brute-force count in numpy and against
a tiny CPU run of the port, for both cells' queries."""
import collections
import json
from pathlib import Path

import numpy as np
import torch

from portbench import check, gen, harness, queries, reference, testing

HERE = Path(__file__).resolve().parent


def tiny(name, rows):
    return testing.shrink(json.loads(
        (HERE / "configs" / f"{name}.json").read_text()), rows)


def wl(cell):
    return json.loads((HERE / "workloads" / f"{cell}.json").read_text())


def test_join_reference_against_brute_force():
    t = gen.make_tables(tiny("cylon_join_200m", 3000), 17, "cpu")
    q = wl("cylon_join_200m.inner")["query"]
    cols, scales, stats = reference.module("join").compute(t, q)
    lk, lv = (x.numpy() for _c, x in t["left"])
    rk, rv = (x.numpy() for _c, x in t["right"])
    by = collections.defaultdict(list)
    for k, v in zip(rk, rv):
        by[k].append(v)
    want = sorted((k, v, k, w) for k, v in zip(lk, lv) for w in by[k])
    got = sorted(zip(*(c.numpy().tolist() for c in cols)))
    assert got == [tuple(float(x) if i % 2 else int(x)
                         for i, x in enumerate(r)) for r in want]
    assert stats["out_rows"] == len(want)
    assert stats["left_matched"] == int(np.isin(lk, rk).sum())
    assert stats["right_matched"] == int(np.isin(rk, lk).sum())
    assert scales == [None] * 4


def test_groupby_reference_against_brute_force():
    t = gen.make_tables(tiny("h2o_groupby_1e8", 5000), 19, "cpu")
    q = wl("h2o_groupby_1e8.q5")["query"]
    cols, scales, _ = reference.module("groupby").compute(t, q)
    x = {c: v.numpy() for c, v in t["x"] if isinstance(v, torch.Tensor)}
    keys = np.unique(x["id6"])
    assert np.array_equal(cols[0].numpy(), keys)
    for i, c in enumerate(q["columns"], 1):
        want = np.array([x[c][x["id6"] == k].astype(np.float64).sum()
                         for k in keys])
        np.testing.assert_allclose(cols[i].numpy(), want, rtol=1e-12)
    assert scales[1] is None and scales[3] is not None


def test_reference_agrees_with_a_cpu_run_of_the_port():
    import cylon_tpu_torch as ct

    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(1),
                                          device="cpu")
    for cell, cfg in (("cylon_join_200m.inner", "cylon_join_200m"),
                      ("h2o_groupby_1e8.q5", "h2o_groupby_1e8")):
        w = wl(cell)
        t = gen.make_tables(tiny(cfg, 6000), 23, "cpu")
        tables = harness.ingest(ct, ctx, t, 1)
        prog = harness.live_columns(
            queries.module(w["query"]["op"]).run(tables, w["query"]))
        ref, scales, stats = reference.module(w["query"]["op"]).compute(
            t, w["query"])
        nums = check.numbers(check.local_numbers(prog, ref, scales,
                                                 w["check"]),
                             stats["out_rows"], w["check"])
        assert check.verdict(nums, w["limits"]), (cell, nums)
        assert nums["mismatched"] == 0 and nums["rows_gap"] == 0


def test_canonical_order_is_lexicographic():
    a = torch.tensor([2, 1, 2, 1])
    b = torch.tensor([0.5, 0.7, 0.1, 0.2], dtype=torch.float64)
    p = check.canonical_order([a, b], [0, 1])
    assert p.tolist() == [3, 1, 2, 0]
