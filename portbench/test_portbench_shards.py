"""A one-process cell runs a virtual world of its ``shards_per_process``
shards: each accepted cell, copied as data with the key at 4, runs at
world 4 through the exchange and is correct; a cell without the key
keeps world 1 and never calls ``shard.distribute``; a key the harness
cannot lay out is refused before any run."""
import json

import pytest

from portbench import testing

SEED = ["--seed", str(2 ** 31 + 303)]
ROWS = 3000
CELLS = ["cylon_join_200m.inner", "cylon_union_200m.union",
         "h2o_groupby_1e8.q5"]

# counts, in the run's process, the worlds built, the harness's calls of
# shard.distribute and the virtual world's exchanges, and keeps the share
# and the input rows the metric readers get; printed at exit (``harness``
# is the run's own module)
SPY = """
import atexit, json, sys
import cylon_tpu_torch as ct
from cylon_tpu_torch.parallel import comm, shard
seen = {"world": [], "distribute": 0, "all_to_all": 0}
_init, _dist, _a2a, _reading = (ct.CylonContext.InitDistributed,
                                shard.distribute,
                                comm.VirtualComm.all_to_all, harness.Reading)
def reading(*a, **k):
    r = _reading(*a, **k)
    seen.update(share=r.stats["share"], rows_per_query=r.rows_per_query)
    return r
def init(config=None, device=None):
    ctx = _init(config, device=device)
    seen["world"].append(ctx.get_world_size())
    return ctx
def distribute(t, ctx):
    caller = sys._getframe(1).f_code.co_filename
    seen["distribute"] += caller.endswith("harness.py")
    return _dist(t, ctx)
def all_to_all(send):
    seen["all_to_all"] += 1
    return _a2a(send)
ct.CylonContext.InitDistributed = staticmethod(init)
shard.distribute = distribute
comm.VirtualComm.all_to_all = staticmethod(all_to_all)
harness.Reading = reading
atexit.register(lambda: print("SPY " + json.dumps(seen), file=sys.stderr))
"""


def spied(proc) -> dict:
    line = [x for x in proc.stderr.splitlines() if x.startswith("SPY ")]
    assert line, proc.stderr[-4000:]
    return json.loads(line[-1][4:])


def with_layout(root, cell: str, suffix: str, **keys) -> str:
    """A copy of ``cell`` named ``cell + suffix``, added as data, its
    workload file carrying ``keys``."""
    wl = json.loads((root / "portbench" / "workloads" / f"{cell}.json")
                    .read_text())
    wl.update(keys)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = dict(next(w for w in bench["workloads"] if w["name"] == cell))
    entry.update(name=cell + suffix, traffic=entry["traffic"] + suffix)
    bench["workloads"].append(entry)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell in m.get("workloads", ()):
            m["workloads"].append(cell + suffix)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root / "portbench" / "workloads" / f"{cell}{suffix}.json").write_text(
        json.dumps(wl))
    return cell + suffix


def run(root, cell: str, trace: str = "0"):
    return testing.run_cpu(root, ["--workload", cell, *SEED, "--seconds",
                                  "0.3", "--trace", trace], prelude=SPY)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_at_four_virtual_shards(tmp_path, cell):
    root = testing.tiny_checkout(tmp_path / "c", rows=ROWS)
    v4 = with_layout(root, cell, "-v4", shards_per_process=4)
    traces = ("0", "1") if cell == CELLS[0] else ("0",)
    for tr in traces:
        proc = run(root, v4, tr)
        res = testing.result(proc)
        assert res["correct"], res
        assert res["attempted"] >= 1 and res["failed"] == 0
        for k, c in res["checks"].items():
            assert c["value"] <= c["limit"], (k, c)
            if k != "gap":
                assert c["value"] == 0, (k, c)
        assert res["device"]["count"] == 1
        seen = spied(proc)
        tables = 1 if cell.startswith("h2o") else 2
        assert seen["world"] == [4]
        assert seen["distribute"] == tables
        # the one process does every shard's work, on every input row
        assert seen["share"] == 1.0
        assert seen["rows_per_query"] == tables * ROWS
        # every query, the two warm ones with them, exchanges alike
        assert seen["all_to_all"] > 0
        assert seen["all_to_all"] % (res["attempted"] + 2) == 0, seen
        assert "portbench: world 4 shards in 1 process" in proc.stderr
        if tr == "1":
            # the CPU has no device ops; the host's gaps are named
            assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
            assert res["breakdown"]["idle_gaps"], res["breakdown"]
            assert res["device"]["window_s"] > 0


def test_cell_without_the_key_keeps_world_one(tmp_path):
    root = testing.tiny_checkout(tmp_path / "c", rows=ROWS)
    proc = run(root, CELLS[0])
    assert testing.result(proc)["correct"]
    seen = spied(proc)
    assert seen == {"world": [1], "distribute": 0, "all_to_all": 0,
                    "share": 1.0, "rows_per_query": 2 * ROWS}, seen


@pytest.mark.parametrize("keys", [
    {"shards_per_process": 4, "processes_per_chip": 2},
    {"shards_per_process": 0}], ids=["several-processes", "zero"])
def test_layout_refused_before_any_run(tmp_path, keys):
    root = testing.tiny_checkout(tmp_path / "c", rows=ROWS)
    bad = with_layout(root, CELLS[0], "-bad", **keys)
    proc = testing.run_cpu(root, ["--workload", bad, *SEED, "--seconds",
                                  "0.3", "--trace", "0"])
    assert proc.returncode == 2 and proc.stdout == "", proc
    assert "shards_per_process" in proc.stderr
