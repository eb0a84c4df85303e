"""cylon_tpu_torch's per-process ingest and export against cylon_tpu:
``read_csv_per_rank`` and ``read_parquet_per_rank`` (shard i holds file
i's rows; mirrors tests/test_io.py::test_read_parquet_per_rank),
``Table.to_pydict_local`` (tests/test_distributed.py::
test_to_pydict_local_roundtrip), ``shard.distribute_by_key`` and the
co-partitioned fast paths (tests/test_partitioned_ingest.py and
test_distributed.py::test_distribute_by_key_varbytes), on the virtual
world (P = 1) against ``dist_ctx``; then two gloo processes of two shards
each reading ragged per-rank files (tests/test_multihost.py's child),
against the virtual world; and the process-group context itself (a
one-process group, the errors of a context asked for what the machine
lacks)."""
from collections import Counter

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.data import strings as jstrings
from cylon_tpu.parallel import dist_ops as jdist
from cylon_tpu.parallel import shard as jshard

import cylon_tpu_torch as tct
from cylon_tpu_torch.data import strings as tstrings
from cylon_tpu_torch.parallel import dist_ops as tdist
from cylon_tpu_torch.parallel import shard as tshard

import torch_port_mp_child as child
from test_torch_port_multiprocess import _f2, _rows

W = child.WORLD
# rows of the per-rank files: ragged, one file of one row
RAGGED = (37, 1, 100, 64)


@pytest.fixture(scope="module")
def tctx():
    return tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(W),
                                            device="cpu")


def port_frames(table, ctx) -> list:
    """Each global shard's live rows of a port table, as a frame."""
    e = child.export(table, ctx)
    names = list(e["cols"])
    return [pd.DataFrame({i: pd.Series(e["cols"][n][e["sid"] == s])
                          for i, n in enumerate(names)})
            for s in range(ctx.get_world_size())]


def ref_frames(table) -> list:
    """Each shard's live rows of a cylon_tpu table, as a frame."""
    emit = np.asarray(table.emit_mask())
    sid = np.flatnonzero(emit) // (emit.shape[0] // W)
    df = table.to_pandas()
    return [df[sid == s].reset_index(drop=True) for s in range(W)]


def assert_same_shards(got: list, exp: list, ordered: bool = True):
    assert len(got) == len(exp)
    for s, (g, e) in enumerate(zip(got, exp)):
        a, b = _rows(_f2(g)), _rows(_f2(e))
        assert (a == b) if ordered else (sorted(a) == sorted(b)), s


def write_rank_files(folder, sizes=RAGGED, seed=3) -> list:
    """Per-rank CSV and Parquet files of ``sizes[i]`` rows: an int key, a
    float with -0.0 and NaN (empty fields: the nulls), a string with
    nulls. (Integer columns with nulls read as floats in cylon_tpu and
    as integers in the port, whose CSV reader keeps them: ROADMAP queue
    1 items 4-5.)"""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    frames = []
    for i, n in enumerate(sizes):
        k = rng.integers(0, 50, n)
        v = rng.normal(size=n)
        v[::5] = -0.0
        v[2::7] = np.nan
        s = np.array([f"name{int(x):04d}" for x in rng.integers(0, 30, n)],
                     object)
        s[rng.random(n) < 0.1] = None
        df = pd.DataFrame({"k": k, "v": v, "s": s})
        df.to_csv(folder / f"part_{i}.csv", index=False)
        pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                       folder / f"part_{i}.parquet")
        frames.append(df)
    return frames


@pytest.mark.parametrize("kind", ["csv", "parquet"])
def test_read_per_rank_places_file_i_on_shard_i(dist_ctx, tctx, tmp_path,
                                               kind):
    """Shard i of the result holds file i's rows, in file order, equal to
    cylon_tpu's shard i; the row count is the sum of the files'."""
    frames = write_rank_files(tmp_path)
    pattern = str(tmp_path / f"part_{{rank}}.{kind}")
    reader = {"csv": (tct.read_csv_per_rank, jct.read_csv_per_rank),
              "parquet": (tct.read_parquet_per_rank,
                          jct.read_parquet_per_rank)}[kind]
    got = reader[0](tctx, pattern)
    ref = reader[1](dist_ctx, pattern)
    assert got.row_count == ref.row_count == sum(RAGGED)
    assert got.capacity == ref.capacity
    gf = port_frames(got, tctx)
    assert [len(f) for f in gf] == list(RAGGED)
    assert_same_shards(gf, ref_frames(ref))
    # file i's own rows, keys as read
    for f, df in zip(gf, frames):
        assert f[0].tolist() == df["k"].tolist()
    assert got.column_names == ["k", "v", "s"]
    assert got._columns[2].is_varbytes


def test_to_pydict_local_roundtrip(dist_ctx, tctx, monkeypatch):
    """The virtual world's process holds every shard: its local extract
    is the whole table, varbytes strings included, as cylon_tpu's."""
    monkeypatch.setattr(jstrings, "DICT_MAX_VOCAB", 0)
    monkeypatch.setattr(tstrings, "DICT_MAX_VOCAB", 0)
    rng = np.random.default_rng(5)
    n = 512
    data = {"k": rng.integers(0, 100, n).astype(np.int32),
            "s": np.array([f"name{int(x):06d}" for x in
                           rng.integers(0, 10_000, n)], object),
            "v": rng.normal(size=n).astype(np.float32)}
    t = tshard.distribute(tct.Table.from_pydict(tctx, data), tctx)
    j = jshard.distribute(jct.Table.from_pydict(dist_ctx, data), dist_ctx)
    assert t._columns[1].is_varbytes
    local, glob, ref = t.to_pydict_local(), t.to_pydict(), \
        j.to_pydict_local()
    for key in glob:
        a = list(map(str, np.asarray(local[key]).tolist()))
        assert a == list(map(str, np.asarray(glob[key]).tolist())), key
        assert sorted(a) == sorted(map(str, np.asarray(ref[key]).tolist()))


def _mk(ctx, n, hi, seed, vcol="v", pkg=tct):
    rng = np.random.default_rng(seed)
    return pkg.Table.from_pydict(ctx, {
        "k": rng.integers(0, hi, n).astype(np.int32),
        vcol: rng.integers(0, 1000, n).astype(np.int32)})


def test_distribute_by_key_placement_matches_reference(dist_ctx, tctx):
    """Every shard holds the rows cylon_tpu's distribute_by_key puts
    there, in the same order: the placement of the device shuffle."""
    t = _mk(tctx, 500, 40, 0)
    j = _mk(dist_ctx, 500, 40, 0, pkg=jct)
    got = tshard.distribute_by_key(t, tctx, ["k"])
    ref = jshard.distribute_by_key(j, dist_ctx, ["k"])
    assert got.capacity == ref.capacity
    assert_same_shards(port_frames(got, tctx), ref_frames(ref))
    # the device shuffle's placement: shuffling it moves nothing
    moved = tdist.shuffle(tshard.distribute(t, tctx), ["k"])
    assert_same_shards(port_frames(got, tctx), port_frames(moved, tctx),
                       ordered=False)


def test_shuffle_skips_for_copartitioned(tctx):
    t = _mk(tctx, 300, 30, 1)
    d = tshard.distribute_by_key(t, tctx, ["k"])
    assert tdist.shuffle(d, ["k"]) is d
    s1 = tdist.shuffle(tshard.distribute(t, tctx), ["k"])
    assert tdist.shuffle(s1, ["k"]) is s1


def _rows_of(table) -> Counter:
    d = table.to_pydict()
    return Counter(zip(*[[str(x) for x in v] for v in d.values()]))


@pytest.mark.parametrize("how,both", [("inner", True), ("left", False)])
def test_join_on_prepartitioned(dist_ctx, tctx, monkeypatch, how, both):
    """Joins of pre-partitioned sides equal the plain join and
    cylon_tpu's, and exchange only the side that is not placed."""
    left, right = _mk(tctx, 400, 50, 2, "v"), _mk(tctx, 300, 50, 3, "w")
    plain = left.distributed_join(right, how, on="k")
    jl = _mk(dist_ctx, 400, 50, 2, "v", jct)
    jr = _mk(dist_ctx, 300, 50, 3, "w", jct)
    ref = jshard.distribute_by_key(jl, dist_ctx, ["k"]).distributed_join(
        jshard.distribute_by_key(jr, dist_ctx, ["k"]) if both else jr, how,
        on="k")
    lp = tshard.distribute_by_key(left, tctx, ["k"])
    rp = tshard.distribute_by_key(right, tctx, ["k"]) if both else right
    calls = []
    real = tdist._exchange_table

    def spy(t, *a, **kw):
        calls.append(t.column_count)
        return real(t, *a, **kw)

    monkeypatch.setattr(tdist, "_exchange_table", spy)
    got = lp.distributed_join(rp, how, on="k")
    assert len(calls) == (0 if both else 1)
    assert _rows_of(got) == _rows_of(plain) == _rows_of(ref)


def test_distribute_by_key_nulls_and_floats(tctx):
    rng = np.random.default_rng(6)
    n = 200
    k = rng.normal(size=n).astype(np.float32)
    k[rng.random(n) < 0.2] = np.nan
    t = tct.Table.from_pandas(tctx, pd.DataFrame({
        "k": k, "v": np.arange(n, dtype=np.int32)}))
    d = tshard.distribute_by_key(t, tctx, ["k"])
    assert d.row_count == n
    assert d.distributed_join(d, "inner", on="k").row_count == \
        t.distributed_join(t, "inner", on="k").row_count


def test_distribute_by_key_varbytes(dist_ctx, tctx, monkeypatch):
    """Varbytes tables go through per-shard tables and
    assemble_process_local; the placement is cylon_tpu's."""
    monkeypatch.setattr(jstrings, "DICT_MAX_VOCAB", 0)
    monkeypatch.setattr(tstrings, "DICT_MAX_VOCAB", 0)
    rng = np.random.default_rng(3)
    n = 400
    keys = np.array([f"{'Q' * 40}{rng.integers(0, 50):04d}"
                     for _ in range(n)], object)
    data = {"k": keys, "v": np.arange(n)}
    got = tshard.distribute_by_key(tct.Table.from_pydict(tctx, data), tctx,
                                   ["k"])
    ref = jshard.distribute_by_key(jct.Table.from_pydict(dist_ctx, data),
                                   dist_ctx, ["k"])
    assert got.row_count == n
    d = got.to_pydict()
    assert sorted(zip(d["k"], map(int, d["v"]))) == \
        sorted(zip(keys, range(n)))
    assert_same_shards(port_frames(got, tctx), ref_frames(ref))


@pytest.fixture(scope="module")
def two_process_ingest(tmp_path_factory):
    """Two gloo processes of two shards each on the ragged files: each
    process's export of every reader and of distribute_by_key."""
    folder = tmp_path_factory.mktemp("ingest")
    write_rank_files(folder)
    procs = child.start(folder / "run", 2, 2, "ingest", folder)
    return folder, child.finish(folder / "run", procs)


@pytest.mark.parametrize("kind", ["csv", "parquet"])
def test_two_process_read_per_rank(two_process_ingest, tctx, kind):
    """Each process reads its own shards' ragged files: its shards equal
    the virtual world's, and both processes count every file's rows."""
    folder, parts = two_process_ingest
    reader = tct.read_csv_per_rank if kind == "csv" \
        else tct.read_parquet_per_rank
    exp = child.export(reader(tctx, str(folder / f"part_{{rank}}.{kind}")),
                       tctx)
    for rank, p in enumerate(parts):
        got = p[kind]
        assert got["rows"] == exp["rows"] == sum(RAGGED)
        mine = np.isin(exp["sid"], [2 * rank, 2 * rank + 1])
        assert np.array_equal(got["sid"], exp["sid"][mine])
        for name, a in exp["cols"].items():
            assert list(map(repr, got["cols"][name])) == \
                list(map(repr, a[mine])), name


def test_two_process_distribute_by_key(two_process_ingest, tctx):
    """Each process builds its own shards of distribute_by_key, equal to
    the virtual world's, and the shuffle skips them; a varbytes table
    raises Code.NotImplemented across processes, as in cylon_tpu."""
    _folder, parts = two_process_ingest
    rng = np.random.default_rng(6)
    n = 500
    whole = tct.Table.from_pydict(tctx, {
        "k": rng.integers(0, 40, n).astype(np.int32),
        "v": rng.integers(0, 1000, n).astype(np.int32)})
    exp = child.export(tshard.distribute_by_key(whole, tctx, ["k"]), tctx)
    for rank, p in enumerate(parts):
        got = p["by_key"]
        assert got["rows"] == n
        mine = np.isin(exp["sid"], [2 * rank, 2 * rank + 1])
        assert np.array_equal(got["sid"], exp["sid"][mine])
        for name, a in exp["cols"].items():
            assert np.array_equal(got["cols"][name], a[mine]), name
        assert p["by_key_skips"]
        assert p["by_key_varbytes"] == int(tct.Code.NotImplemented)


def test_one_process_group_equals_virtual_world(tctx):
    """A process group of one process (V = 4 shards, gloo, an in-memory
    store) runs the join as the virtual world does, shard for shard, and
    finalize destroys the group it created."""
    import torch.distributed as dist

    ctx = tct.CylonContext.InitDistributed(tct.MultiHostConfig(
        num_processes=1, backend="gloo", shards_per_process=W),
        device="cpu")
    try:
        assert dist.is_initialized() and ctx.get_process_count() == 1
        assert ctx.local_shard_indices() == list(range(W))
        assert ctx.comm_budget_bytes() is None
        got, _ = child.run_case(tct, ctx, "join_outer")
        exp, _ = child.run_case(tct, tctx, "join_outer")
        ge, ee = child.export(got, ctx), child.export(exp, tctx)
        assert np.array_equal(ge["sid"], ee["sid"])
        for name, a in ee["cols"].items():
            assert list(map(repr, ge["cols"][name])) == \
                list(map(repr, a)), name
        ctx.barrier()
    finally:
        ctx.finalize()
    assert not dist.is_initialized()


def test_context_refuses_what_the_machine_lacks():
    """NCCL off CUDA, and CUDA (the default device) where there is none,
    raise typed errors before any process group starts."""
    import torch.distributed as dist

    with pytest.raises(tct.CylonError, match="NCCL") as e:
        tct.CylonContext.InitDistributed(tct.MultiHostConfig(
            num_processes=1, backend="nccl"), device="cpu")
    assert e.value.code == tct.Code.Invalid
    if not torch.cuda.is_available():
        with pytest.raises(tct.CylonError, match="CUDA is not available"):
            tct.CylonContext.InitDistributed(tct.MultiHostConfig(
                num_processes=1, backend="gloo"))
    with pytest.raises(ValueError):
        tct.MultiHostConfig(backend="mpi")
    assert not dist.is_initialized()
