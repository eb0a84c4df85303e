"""cylon_tpu_torch against cylon_tpu for the reference API's leftovers
and the ledger-backed memory pool:

* the pool counts the ledger's tracked-table bytes where the device has
  no allocator stats (the CPU), as the JAX package's does: a traced
  world-4 join's root span carries a nonzero ``hbm_peak`` and a crash
  dump a nonzero pool watermark, in both packages;
* ``Table.retain_memory(False)`` frees the input at the distributed
  operators that consume it (shuffle, the shuffle, ring and broadcast
  joins, the exact join's dictionary redo), with the ledger moving as
  the reference's does; the default keeps the inputs;
* ``JoinConfig``'s named constructors and getters, ``Column.Make``,
  ``CylonContext.add_config``/``get_config``, ``Table.rows``,
  ``knobs.env_number``/``render_table``/``Knob.default_str`` and
  ``join.join_plan_gids`` give the reference's answers."""
import gc
import json
import os

import numpy as np
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu import plan as jplan
from cylon_tpu import telemetry as jtel
from cylon_tpu.data import strings as jstrings
from cylon_tpu.ops import join as jjoin
from cylon_tpu.parallel import dist_ops as jdist
from cylon_tpu.resilience import inject as jinject
from cylon_tpu.telemetry import knobs as jknobs

import cylon_tpu_torch as tct
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import telemetry as ttel
from cylon_tpu_torch.data import strings as tstrings
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.parallel import dist_ops as tdist
from cylon_tpu_torch.resilience import inject as tinject
from cylon_tpu_torch.telemetry import knobs as tknobs

from test_torch_port_ring_join import canon, jctx, tctx

N = 96


def _data(seed, n=N, keys=None):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n // 3, n).astype(np.int32) if keys is None \
        else keys(rng, n)
    return {"k": k, "v": rng.normal(size=n).astype(np.float32)}


def _long_keys(rng, n):
    return np.array([f"{'L' * 30}{int(x):04d}" for x in
                     rng.integers(0, n // 3, n)], object)


# -- R1: the ledger-backed pool ------------------------------------------


def _traced_join_peak(pkg, tel, ctx):
    """hbm_peak of a root span around a world-4 distributed join."""
    l = pkg.Table.from_pydict(ctx, _data(1))
    r = pkg.Table.from_pydict(ctx, _data(2))
    with tel.span("test.root") as root:
        out = l.distributed_join(r, "inner", on=["k"])
        rows = out.row_count
    assert rows > 0
    return root.attrs.get("hbm_peak", 0)


def _crash_watermark(pkg, plan, inject, ctx, tmp_path, tag):
    """The pool watermark of the crash dump a persistent injected
    exchange fault leaves."""
    l = pkg.Table.from_pydict(ctx, _data(3))
    r = pkg.Table.from_pydict(ctx, _data(4))
    d = tmp_path / tag
    d.mkdir()
    os.environ["CYLON_FLIGHT_DIR"] = str(d)
    os.environ["CYLON_RETRY_BACKOFF_S"] = "0.001"
    inject.arm("exchange:1+:transient")
    try:
        with pytest.raises(pkg.CylonTransientError):
            plan.scan(l).join(plan.scan(r), on="k").execute(analyze=True)
    finally:
        inject.disarm()
        os.environ.pop("CYLON_FLIGHT_DIR", None)
        os.environ.pop("CYLON_RETRY_BACKOFF_S", None)
    dumps = sorted(d.glob("*.json"))
    assert len(dumps) == 1, dumps
    doc = json.loads(dumps[0].read_text())
    assert any(f.get("site") == "exchange" for f in
               doc["sections"]["faults"]["fired"])
    return doc["pool"]["bytes_in_use"]


def test_traced_join_has_a_memory_peak(request):
    """Each package's pool is the one its span layer samples: the pool
    of the context made last."""
    jc = jctx(request, 4)
    jtel.set_memory_pool(jc.memory_pool)
    assert _traced_join_peak(jct, jtel, jc) > 0
    assert _traced_join_peak(tct, ttel, tctx(4)) > 0


def test_crash_dump_has_a_pool_watermark(request, tmp_path):
    jc = jctx(request, 4)
    jtel.set_memory_pool(jc.memory_pool)
    assert _crash_watermark(jct, jplan, jinject, jc, tmp_path, "j") > 0
    assert _crash_watermark(tct, tplan, tinject, tctx(4), tmp_path,
                            "t") > 0


def test_cpu_pool_reads_the_ledger():
    from cylon_tpu_torch.telemetry import ledger

    ctx = tctx(4)
    t = tdist.shuffle(tct.Table.from_pydict(ctx, _data(5)), ["k"])
    used, peak, limit = ctx.memory_pool.snapshot()
    assert used == ledger.live_bytes() > 0 and peak >= used
    assert limit == 0 and ctx.memory_pool.available_bytes() is None
    del t


# -- R2: retain_memory(False) frees the consumed inputs -------------------


OPS = ("shuffle", "join_shuffle", "join_ring", "join_broadcast",
       "join_exact_redo")


def _run_op(pkg, dist, ctx, op, retain, monkeypatch):
    """(inputs' column counts after the op, the result's canonical rows,
    the ledger's leak-count change across the op with the result held)."""
    ledger = (jtel if pkg is jct else ttel).ledger
    keys = _long_keys if op == "join_exact_redo" else None
    l = pkg.Table.from_pydict(ctx, _data(11, keys=keys))
    r = pkg.Table.from_pydict(ctx, _data(12, keys=keys))
    ins = [l] if op == "shuffle" else [l, r]
    if not retain:
        for t in ins:
            t.retain_memory(False)
    assert all(t.is_retain() == retain for t in ins)
    gc.collect()
    l0 = ledger.leak_count()
    if op == "shuffle":
        out = dist.shuffle(l, ["k"])
    elif op == "join_exact_redo":
        # force the collision redo: every exact verification collides
        monkeypatch.setattr(dist, "_exact_post_verify",
                            lambda res, nl, pairs, config: (res, True))
        out = l.distributed_join(r, "outer", on=["k"], exact=True)
    else:
        out = l.distributed_join(r, "inner", on=["k"],
                                 comm=op.split("_")[1])
    rows = canon(out.to_pandas())
    gc.collect()
    return [t.column_count for t in ins], rows, ledger.leak_count() - l0


@pytest.mark.parametrize("retain", [False, True], ids=["free", "retain"])
@pytest.mark.parametrize("op", OPS)
def test_retain_memory(request, monkeypatch, op, retain):
    for mod in (jstrings, tstrings):
        monkeypatch.setattr(mod, "DICT_MAX_VOCAB", 0)
    jres = _run_op(jct, jdist, jctx(request, 4), op, retain, monkeypatch)
    tres = _run_op(tct, tdist, tctx(4), op, retain, monkeypatch)
    if op == "join_exact_redo":
        # F16: the JAX package returns the redo's output untracked (its
        # ledger misses a live result); the port tracks it
        jres = (jres[0], jres[1], jres[2] + 1)
    assert tres == jres
    cols, _rows, _leaks = tres
    assert all((c == 0) != retain for c in cols), cols


def test_finalize_and_rows():
    ctx = tct.CylonContext.Init(device="cpu")
    t = tct.Table.from_pydict(ctx, _data(13))
    assert t.rows() == t.row_count == N
    t.finalize()
    assert t.column_count == 0 and t.rows() == 0
    t.finalize()   # idempotent


# -- the reference API's leftovers ---------------------------------------


@pytest.mark.parametrize("name", ["InnerJoin", "LeftJoin", "RightJoin",
                                  "FullOuterJoin"])
def test_join_config_constructors(local_ctx, name):
    ld, rd = _data(21), _data(22)
    jc = getattr(jjoin.JoinConfig, name)(0, 0)
    tc = getattr(tjoin.JoinConfig, name)(0, 0)
    assert tc.GetType().name == jc.GetType().name
    assert tc.GetAlgorithm().name == jc.GetAlgorithm().name
    assert tc.GetLeftColumnIdx() == jc.GetLeftColumnIdx() == [0]
    assert tc.GetRightColumnIdx() == jc.GetRightColumnIdx() == [0]
    from cylon_tpu.data import table as jtable
    from cylon_tpu_torch.data import table as ttable

    tctx1 = tct.CylonContext.Init(device="cpu")
    jout = jtable.join(jct.Table.from_pydict(local_ctx, ld),
                       jct.Table.from_pydict(local_ctx, rd), jc)
    tout = ttable.join(tct.Table.from_pydict(tctx1, ld),
                       tct.Table.from_pydict(tctx1, rd), tc)
    assert canon(tout.to_pandas()) == canon(jout.to_pandas())


@pytest.mark.parametrize("values,dtype", [
    ([3, -1, 7, 0], "Int32"), ([1.5, -2.25, 0.0], "Double"),
    (["ab", "", "zeta", "ab"], "String"), ([1, 2, 3], "Double")],
    ids=["int32", "float64", "strings", "int_to_float64"])
def test_column_make(values, dtype):
    from cylon_tpu import dtypes as jdt
    from cylon_tpu.data.column import Column as JColumn
    from cylon_tpu_torch import dtypes as tdt
    from cylon_tpu_torch.data.column import Column as TColumn

    vals = np.array(values, dtype=np.int32) \
        if dtype == "Int32" else values
    jc = JColumn.Make(None, "c", getattr(jdt, dtype)(), vals)
    tc = TColumn.Make(tct.CylonContext.Init(device="cpu"), "c",
                      getattr(tdt, dtype)(), vals)
    assert tc.dtype.type.name == jc.dtype.type.name
    assert tc.name == jc.name == "c"
    assert tc.to_numpy().tolist() == jc.to_numpy().tolist()


def test_context_config_map(local_ctx):
    tc = tct.CylonContext.Init(device="cpu")
    for c in (local_ctx, tc):
        assert c.get_config("missing") == ""
        assert c.get_config("missing", "d") == "d"
        c.add_config("compute_engine", "cuda")
        c.add_config("compute_engine", "cuda2")
        assert c.get_config("compute_engine") == "cuda2"


@pytest.mark.parametrize("raw", [None, "", "abc", "0", "7", "-5", "3.7",
                                 "1e3", " 12 "])
@pytest.mark.parametrize("kw", [dict(default=4), dict(default=4, lo=1),
                                dict(default=2.5, lo=0.5),
                                dict(default=8, as_int=True),
                                dict(default=8, lo=2, as_int=True)])
def test_env_number(monkeypatch, raw, kw):
    if raw is None:
        monkeypatch.delenv("CYLON_TEST_NUMBER", raising=False)
    else:
        monkeypatch.setenv("CYLON_TEST_NUMBER", raw)
    got = want = None
    try:
        want = jknobs.env_number("CYLON_TEST_NUMBER", **kw)
    except Exception as e:  # noqa: BLE001 - compared below
        want = type(e)
    try:
        got = tknobs.env_number("CYLON_TEST_NUMBER", **kw)
    except Exception as e:  # noqa: BLE001 - compared below
        got = type(e)
    assert got == want and type(got) is type(want)


def test_env_number_raises_like_the_reference():
    for pkg in (jknobs, tknobs):
        with pytest.raises(TypeError):
            pkg.env_number("CYLON_TEST_NUMBER")


def test_render_table_lists_every_knob():
    """Every declared knob has a row; the descriptions are the port's
    own (e.g. CYLON_PARTITION_KERNEL), so the text is not compared."""
    lines = tknobs.render_table().splitlines()
    assert lines[:2] == jknobs.render_table().splitlines()[:2]
    names = [l.split("`")[1] for l in lines[2:]]
    assert names == list(tknobs.KNOBS) and len(names) == len(jknobs.KNOBS)
    for name, k in tknobs.KNOBS.items():
        assert k.default_str() == jknobs.KNOBS[name].default_str(), name


def test_knobs_main_prints_the_table():
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-m",
                        "cylon_tpu_torch.telemetry.knobs"],
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == tknobs.render_table()


@pytest.mark.parametrize("jt", ["INNER", "LEFT", "RIGHT", "FULL_OUTER"])
def test_join_plan_gids(jt):
    rng = np.random.default_rng(31)
    gl = rng.integers(-2, 20, 40).astype(np.int32)
    gr = rng.integers(-2, 20, 33).astype(np.int32)
    le = rng.random(40) < 0.9
    re_ = rng.random(33) < 0.9
    ref = jjoin.join_plan_gids(gl, gr, le, re_, getattr(jjoin.JoinType, jt))
    got = tjoin.join_plan_gids(
        torch.from_numpy(gl)[None], torch.from_numpy(gr)[None],
        torch.from_numpy(le)[None], torch.from_numpy(re_)[None],
        getattr(tjoin.JoinType, jt))
    counts2, *rest = got
    assert counts2[0].tolist() == np.asarray(ref[0]).tolist()
    for a, b in zip(rest, ref[1:]):
        assert a[0].numpy().tolist() == np.asarray(b).tolist()
