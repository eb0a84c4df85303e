"""A later change adds cells, configurations and metrics as files and
entries alone: a throwaway cell and metric run from a copy without an
edit to any file that is there, and a cell of two processes (gloo, the
CPU's stand-in for one process a card over NCCL) runs as data."""
import json

import pytest

from portbench import testing

SEED = ["--seed", str(2 ** 31 + 101)]


def add(root, config=None, workload=None, bench=None, files=None):
    b = json.loads((root / "BENCHMARK.json").read_text())
    for k, entries in (bench or {}).items():
        b[k].extend(entries)
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    for path, text in (files or {}).items():
        (root / path).write_text(text)


def test_throwaway_cell_and_metric_as_files(tmp_path):
    root = testing.tiny_checkout(tmp_path / "c", rows=3000)
    cfg = {"name": "toy", "source": "a test", "reduced": [], "tables": {
        "a": {"rows": 3000, "columns": {
            "k": {"dtype": "int32", "dist": "uniform_int", "low": 0,
                  "high": 500},
            "x": {"dtype": "float32", "dist": "uniform_float", "low": -1.0,
                  "high": 1.0}}}}}
    wl = {"config": "toy", "query": {"op": "groupby", "table": "a",
                                     "by": "k", "columns": ["x", "x"],
                                     "aggs": ["sum", "count"]},
          "warmup_queries": 1,
          "check": {"key_column": 0, "sort_columns": [0],
                    "exact_columns": [0, 2], "gap_columns": [1]},
          "limits": {"rows_gap": 0, "mismatched": 0, "gap": 1e-5}}
    metric = ('UNIT, LAYER, MOVES = "groups", "device", '
              '"input_rows_per_s"\n\n\ndef read(r):\n'
              '    return float(r.stats["out_rows"])\n')
    add(root,
        bench={"configs": [{"name": "toy", "source": "a test",
                            "file": "portbench/configs/toy.json",
                            "reduced": [], "why": "a test"}],
               "workloads": [{"name": "toy.sums", "config": "toy",
                              "traffic": "sums", "chips": 1,
                              "why": "a test"}],
               "per_layer": [{"name": "toy_groups", "unit": "groups",
                              "better": "higher", "source":
                              "program_counter", "layer": "device",
                              "moves": "input_rows_per_s",
                              "workloads": ["toy.sums"]}]},
        files={"portbench/configs/toy.json": json.dumps(cfg),
               "portbench/workloads/toy.sums.json": json.dumps(wl),
               "portbench/metrics/toy_groups.py": metric})
    for tr in ("0", "1"):
        res = testing.result(testing.run_cpu(
            root, ["--workload", "toy.sums", *SEED, "--seconds", "0.5",
                   "--trace", tr]))
        assert res["correct"] and res["attempted"] >= 1
        if tr == "1":
            assert 400 <= res["metrics"]["toy_groups"]["value"] <= 500
        else:
            assert set(res["metrics"]) == {
                "input_rows_per_s", "query_p90_ms", "setup_s"}


@pytest.mark.parametrize("cell", ["cylon_join_200m.inner",
                                  "h2o_groupby_1e8.q5"])
def test_two_process_cell_as_data(tmp_path, cell):
    root = testing.tiny_checkout(tmp_path / "c", rows=6000)
    wl = json.loads((root / "portbench" / "workloads" / f"{cell}.json")
                    .read_text())
    wl["processes_per_chip"] = 2
    base = json.loads((root / "BENCHMARK.json").read_text())
    entry = dict(next(w for w in base["workloads"] if w["name"] == cell))
    entry.update(name=cell + "-2p", traffic=entry["traffic"] + "-2p")
    add(root, bench={"workloads": [entry]},
        files={f"portbench/workloads/{cell}-2p.json": json.dumps(wl)})
    for tr in ("0", "1"):
        res = testing.result(testing.run_cpu(
            root, ["--workload", cell + "-2p", *SEED, "--seconds", "0.5",
                   "--trace", tr]))
        assert res["correct"], res
        assert res["attempted"] >= 1 and res["failed"] == 0
        assert all(c["value"] == 0 for k, c in res["checks"].items()
                   if k != "gap")
