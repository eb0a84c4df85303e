"""cylon_tpu_torch's process-group backend on the CPU: W = 4 shards as P
processes of V shards each (P x V in {2 x 2, 4 x 1}), each process a
plain ``python`` child (tests/torch_port_mp_child.py, which imports
torch and the port only) joined by gloo through a ``file://``
rendezvous.

Every case of ``torch_port_mp_child.CASES`` (the shuffle, the inner and
full-outer joins on the shuffle, ring and broadcast routes, the three set
ops, groupby, sort, the salted shuffle, a chunked exchange, a join on
varbytes keys with long varbytes payloads, and joins of 0, 1 and 3 rows
a side) runs once per layout, in one run of the children per layout;
the 2 x 2 layout forces the kernel wrappers (their plain versions here),
the 4 x 1 layout keeps the CPU's routes. Each process's shards are held
against

* the port's virtual world at W = 4 on the same route: every shard bit
  for bit, rows in the same order, and the same global row count in
  every process;
* cylon_tpu on ``dist_ctx``: after a shuffle (plain, salted, chunked)
  every shard holds the same rows in the same order; every other result
  is equal shard for shard as a bit-exact multiset of rows. Floats carry
  -0.0 and NaN; -0.0 is mapped to +0.0 on both sides (the reference's
  export loses its sign on a mesh, ROADMAP queue 3, F2).

The agg case's scalar aggregates (every process must get the same) are
held against both within PERF.md section 2's bound for float SUM and
MEAN and exactly otherwise; against cylon_tpu without the MIN/MAX of a
column holding a valid NaN (F3). The exact join under forced hash
collisions (``exact_redo``) redoes itself on one vocabulary gathered
from every process: against the virtual world shard for shard, against
cylon_tpu's exact join of the same input (which collides nowhere) as
the whole result's rows. The long-key sort (``long_sort``, the host
sort) is held in order against both.

The sort's splitters are held against both. Each child has a timeout of
its own. The children run while this process computes cylon_tpu's
results, which take most of the file's time (~50 s of ~60).
"""
import os

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
from cylon_tpu.ops.groupby import AggregationOp as JA
from cylon_tpu.parallel import dist_ops as jdist
from cylon_tpu.parallel import shard as jshard

import cylon_tpu_torch as tct
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.parallel import shuffle as tshuffle

import torch_port_mp_child as child

# layout -> (processes, shards a process, route)
LAYOUTS = {"2x2": (2, 2, "kernel"), "4x1": (4, 1, "default")}
CHILD_TIMEOUT = 300
ORDERED = ("shuffle", "salted", "chunked", "long_sort")
# the agg case's aggregates not held against cylon_tpu: its sharded
# scalar MIN/MAX drop a shard whose partial is NaN (ROADMAP queue 3, F3);
# the port's NaN wins, as its single-process form's does
F3_AGGS = ("min(x)", "max(x)")


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Both layouts' children, started at once."""
    base = tmp_path_factory.mktemp("mp")
    started = {name: child.start(base / name, nproc, shards, "ops", route)
               for name, (nproc, shards, route) in LAYOUTS.items()}
    yield base, started
    for procs in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs(children, reference, virtual):
    """{layout: {case: [each process's export]}}; the children run while
    this process computes the reference and the virtual world."""
    base, started = children
    out = {}
    for name, procs in started.items():
        parts = child.finish(base / name, procs, CHILD_TIMEOUT)
        out[name] = {case: [p[case] for p in parts] for case in child.CASES}
    return out


@pytest.fixture(scope="module")
def virtual():
    """{route: {case: export}} of the port's virtual world at W = 4."""
    ctx = tct.CylonContext.InitDistributed(
        tct.VirtualWorldConfig(child.WORLD), device="cpu")
    old = tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL
    out = {}
    try:
        for route in sorted({r for _n, _v, r in LAYOUTS.values()}):
            child.set_route(route)
            out[route] = {}
            for case in child.CASES:
                out[route][case] = child.run_export(tct, ctx, case)
    finally:
        tjoin.STREAM_PLAN, tshuffle.PARTITION_KERNEL = old
    return out


def _jbuild(jc, side, how="assemble"):
    cols, valid = side

    def table(lo, hi):
        return jct.Table([jct.Column.from_numpy(
            a[lo:hi], k, None if valid.get(k) is None else valid[k][lo:hi])
            for k, a in cols.items()], jc)

    n = len(next(iter(cols.values())))
    if how == "distribute":
        return jshard.distribute(table(0, n), jc)
    return jshard.assemble_process_local(
        [table(lo, hi) for lo, hi in child.shard_slices(n, child.WORLD)], jc)


def _jrun(jc, case):
    """cylon_tpu's result of a case (and the sort's splitters)."""
    data = child.case_data(case)
    if case == "shuffle":
        return jdist.shuffle(_jbuild(jc, data["t"], "distribute"), ["k"]), {}
    if case == "chunked":
        old = os.environ.get("CYLON_EXCHANGE_CHUNK_BYTES")
        os.environ["CYLON_EXCHANGE_CHUNK_BYTES"] = child.CHUNK_BYTES
        try:
            return jdist.shuffle(_jbuild(jc, data["t"]), ["k"]), {}
        finally:
            if old is None:
                del os.environ["CYLON_EXCHANGE_CHUNK_BYTES"]
            else:
                os.environ["CYLON_EXCHANGE_CHUNK_BYTES"] = old
    if case == "salted":
        return jdist.shuffle(_jbuild(jc, data["t"]), ["k"], salted=True), {}
    if case in child.SETOP_CASES:
        left, right = _jbuild(jc, data["l"]), _jbuild(jc, data["r"])
        return getattr(left, f"distributed_{case}")(right), {}
    if case == "groupby":
        return jdist.distributed_groupby(
            _jbuild(jc, data["t"]), 0, [1, 1, 2, 2, 2],
            [JA.SUM, JA.COUNT, JA.SUM, JA.MIN, JA.MAX]), {}
    if case == "agg":
        t = _jbuild(jc, data["t"])
        return None, {"agg": {f"{op}({c})": child._scalar(getattr(t, op)(c),
                                                          c)
                              for c, ops in child.AGG_OPS.items()
                              for op in ops}}
    if case == "exact_redo":
        # no forced collision here: the reference's exact join is the
        # true join, which the port's redo must give
        left, right = _jbuild(jc, data["l"]), _jbuild(jc, data["r"])
        return left.distributed_join(right, "left", on=["k"], exact=True,
                                     force_exchange=True), {}
    if case == "long_sort":
        return jdist.distributed_sort(_jbuild(jc, data["t"]), ["k", "v"],
                                      [False, True]), {}
    if case == "sort":
        t = _jbuild(jc, data["t"])
        lanes = jdist._dist_order_lanes(jc, t._columns[0], True)
        splitters = jdist._range_splitters(
            jc, [jshard.pin(l, jc) for l in lanes],
            jshard.pin(t.emit_mask(), jc))
        return jdist.distributed_sort(t, "k"), {
            "splitters": [tuple(int(x) for x in s) for s in splitters]}
    how, comm = child.JOIN_CASES.get(case, ("inner", "shuffle"))
    left, right = _jbuild(jc, data["l"]), _jbuild(jc, data["r"])
    return left.distributed_join(right, how, on=["k"], comm=comm), {}


@pytest.fixture(scope="module")
def reference(dist_ctx):
    """{case: (each shard's frame, extras)} from cylon_tpu on the 4-device
    CPU mesh."""
    out = {}
    for case in child.CASES:
        t, extra = _jrun(dist_ctx, case)
        if t is None:
            out[case] = (None, extra)
            continue
        if case == "exact_redo":
            out[case] = ([t.to_pandas()], extra)
            continue
        emit = np.asarray(t.emit_mask())
        sid = np.flatnonzero(emit) // (emit.shape[0] // child.WORLD)
        df = t.to_pandas()
        out[case] = ([df[sid == s].reset_index(drop=True)
                      for s in range(child.WORLD)], extra)
    return out


@pytest.mark.parametrize("case", child.CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_shards_equal_virtual_world(runs, virtual, layout, case):
    """Every process's shards equal the virtual world's shards of the same
    case on the same route, bit for bit and in order; every process
    counts the global rows."""
    exp = virtual[LAYOUTS[layout][2]][case]
    if case == "chunked":
        assert max(exp["chunks"]) > 1, "the exchange did not chunk"
    if case == "exact_redo":
        assert exp["redo"] == 1, "the exact join did not redo itself"
    child.assert_same_export(runs[layout][case], exp)


def _f2(df: pd.DataFrame) -> pd.DataFrame:
    """-0.0 -> +0.0 in float columns (x + 0.0 keeps NaN and its bits)."""
    df = df.copy()
    df.columns = range(df.shape[1])
    for c in df.columns:
        if df[c].dtype.kind == "f":
            df[c] = df[c].to_numpy() + df[c].dtype.type(0)
    return df


def _rows(df: pd.DataFrame) -> list:
    """A frame's rows, in order, as tuples of cell tokens: floats by their
    bits, nulls as one token, everything else by repr (the bit-exact form
    of test_torch_port_join.assert_rows_bit_equal, strings included)."""
    cols = []
    for c in df.columns:
        a = df[c].to_numpy()
        null = pd.isna(df[c]).to_numpy()
        if a.dtype.kind == "f":
            a = child.float_bits(a)
        cols.append(["<null>" if z else repr(int(x) if isinstance(
            x, (int, np.integer)) else x) for x, z in zip(a, null)])
    return list(zip(*cols))


@pytest.mark.parametrize("case", child.CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_shards_match_reference(runs, reference, layout, case):
    """Every shard against cylon_tpu's shard: the same rows in the same
    order after a shuffle, the same bit-exact row multiset otherwise."""
    ref_frames, ref_extra = reference[case]
    if case == "agg":
        got = runs[layout][case][0]["agg"]
        bounds = child.agg_bounds()
        child.assert_aggs_close(
            {k: v for k, v in got.items() if k not in F3_AGGS},
            {k: v for k, v in ref_extra["agg"].items()
             if k not in F3_AGGS}, bounds, "processes against cylon_tpu")
        return
    got = child.merged(runs[layout][case])
    names = list(got["cols"])
    if case == "exact_redo":
        # the whole result: the redo places rows by dictionary codes
        df = pd.DataFrame({i: pd.Series(got["cols"][n])
                           for i, n in enumerate(names)})
        assert sorted(_rows(_f2(df))) == sorted(_rows(_f2(ref_frames[0])))
        return
    for s, ref in enumerate(ref_frames):
        keep = got["sid"] == s
        df = pd.DataFrame({i: pd.Series(got["cols"][n][keep])
                           for i, n in enumerate(names)})
        assert df.shape == ref.shape, (s, df.shape, ref.shape)
        g, e = _f2(df), _f2(ref)
        if case in ORDERED:
            assert _rows(g) == _rows(e), s
        else:
            assert sorted(_rows(g)) == sorted(_rows(e)), s


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sort_splitters(runs, virtual, reference, layout):
    """The splitters every process drew over the global layout equal the
    virtual world's and cylon_tpu's."""
    exp = virtual[LAYOUTS[layout][2]]["sort"]["splitters"]
    assert exp == reference["sort"][1]["splitters"]
    for p in runs[layout]["sort"]:
        assert p["splitters"] == exp
