"""The distributed operators' telemetry against cylon_tpu's, on the CPU at
world 4 (the JAX package's tests/test_telemetry.py::test_dist_phase_logs
and tests/test_observatory.py's host-sync counter tests pin the same
surfaces there).

For each operator the same seeded numpy inputs run through both
packages, and two things must be equal:

* the phase-log labels under ``collect_phases``, as multisets, with each
  ``#seq`` suffix stripped (each package numbers its own operations);
* the ``cylon_host_syncs_total{site=...}`` deltas, site by site.

Each case fails where a distributed operator opens none of the JAX
package's spans and phases, or fetches from the device without counting
the fetch. The one deliberate difference is named where it applies: the
port fetches a varbytes column's shard bounds in one copy
(``distribute.varbytes`` counts 1) where the JAX package makes three
``device_get`` calls (it counts 3).

The port's own sites, which the JAX package does not have, are listed in
PORT_ONLY_SITES; the CSV writer's and the local group-by's are held by
cases here, the process group's and the long-key sort's across processes
by tests/test_torch_port_multiprocess.py's runs. At world 1 the
distributed join and group-by run the local ones, whose stage spans and
one fetch each are the port's own: a case here holds their counts.
"""
import re
from collections import Counter

import numpy as np
import pytest

import cylon_tpu as jct
from cylon_tpu import telemetry as jtel
from cylon_tpu.ops import groupby as jgroupby
from cylon_tpu.ops import join as jjoin
from cylon_tpu.ops import setops as jsetops
from cylon_tpu.parallel import dist_ops as jdist

import cylon_tpu_torch as tct
from cylon_tpu_torch import telemetry as ttel
from cylon_tpu_torch.ops import groupby as tgroupby
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.ops import setops as tsetops
from cylon_tpu_torch.parallel import dist_ops as tdist

PKG = {"jax": (jct, jtel, jjoin, jsetops, jgroupby, jdist),
       "torch": (tct, ttel, tjoin, tsetops, tgroupby, tdist)}
N = 400
SITE = re.compile(r'^cylon_host_syncs_total\{site="([^"]+)"\}$')
# host-sync sites of the port alone: the numeric CSV writer's one fetch of
# a table's columns (the JAX package's writer fetches without counting),
# the local group-by's one fetch of its group count, and the processes
# agreeing a host value on a process group
PORT_ONLY_SITES = ("io.write_csv", "groupby.count", "comm.all_reduce",
                   "comm.all_gather_host", "distributed_sort.host_keys")


@pytest.fixture(scope="module")
def ctxs(request):
    return {"jax": request.getfixturevalue("dist_ctx"),
            "torch": tct.CylonContext.InitDistributed(
                tct.VirtualWorldConfig(4), device="cpu")}


def _data(seed: int, strings: bool = False):
    rng = np.random.default_rng(seed)
    sides = []
    for val in ("v", "w"):
        d = {"k": rng.integers(0, 64, N).astype(np.int32),
             val: rng.normal(size=N).astype(np.float32)}
        if strings:
            d["s"] = np.array([f"row-{i:05d}-" + "y" * int(m) for i, m in
                               enumerate(rng.integers(1, 40, N))])
        sides.append(d)
    return sides


def _syncs(tel) -> Counter:
    out = Counter()
    for key, v in tel.metrics_snapshot().items():
        m = SITE.match(key)
        if m:
            out[m.group(1)] = v
    return out


def _observe(pkg: str, ctx, run):
    """(label multiset, host-sync deltas by site) of one run."""
    ct, tel = PKG[pkg][:2]
    before = _syncs(tel)
    with tel.collect_phases() as cp:
        run(ct, ctx, *PKG[pkg][2:])
    after = _syncs(tel)
    labels = Counter(re.sub(r"#\d+$", "", l) for l in cp.labels)
    deltas = {s: after[s] - before[s] for s in after
              if after[s] != before[s]}
    return labels, deltas


def _tables(ct, ctx, seed, strings=False):
    return [ct.Table.from_pydict(ctx, d) for d in _data(seed, strings)]


def _join(how, fn="distributed_join", strings=False):
    def run(ct, ctx, join, setops, groupby, dist):
        a, b = _tables(ct, ctx, 1, strings)
        cfg = join.JoinConfig(join.JoinType[how], [0], [0])
        if fn == "broadcast_hash_join":
            return dist.broadcast_hash_join(a, b, cfg, 1)
        return getattr(dist, fn)(a, b, cfg)
    return run


def _setop(op):
    def run(ct, ctx, join, setops, groupby, dist):
        a, b = _tables(ct, ctx, 2)
        return dist.distributed_set_op(a, b, setops.SetOp[op])
    return run


def _groupby(pre_aggregate, ops=("SUM", "MEAN", "COUNT")):
    def run(ct, ctx, join, setops, groupby, dist):
        a, _b = _tables(ct, ctx, 3)
        return dist.distributed_groupby(
            a, 0, [1] * len(ops), [groupby.AggregationOp[o] for o in ops],
            pre_aggregate=pre_aggregate)
    return run


def _sort(ct, ctx, join, setops, groupby, dist):
    a, _b = _tables(ct, ctx, 4)
    return dist.distributed_sort(a, "k")


def _hash_partition(ct, ctx, join, setops, groupby, dist):
    a, _b = _tables(ct, ctx, 5)
    return dist.hash_partition(a, ["k"], 4)


def _table_join(ct, ctx, join, setops, groupby, dist):
    """The JAX package's test_dist_phase_logs: Table.distributed_join."""
    t1 = ct.Table.from_pydict(ctx, {"k": np.arange(64) % 8,
                                    "v": np.arange(64.0)})
    t2 = ct.Table.from_pydict(ctx, {"k": np.arange(64) % 8,
                                    "w": np.arange(64.0)})
    return t1.distributed_join(t2, "inner", on="k")


CASES = {
    "join_inner": _join("INNER"),
    "join_left": _join("LEFT"),
    "join_full_outer": _join("FULL_OUTER"),
    "table_distributed_join": _table_join,
    "ring_inner": _join("INNER", "distributed_join_ring"),
    "ring_left": _join("LEFT", "distributed_join_ring"),
    "broadcast_inner": _join("INNER", "broadcast_hash_join"),
    "set_union": _setop("UNION"),
    "set_intersect": _setop("INTERSECT"),
    "groupby_pre_aggregate": _groupby(True),
    "groupby_rows": _groupby(False),
    "sort": _sort,
    "hash_partition": _hash_partition,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_labels_and_host_syncs_equal(ctxs, case):
    j_labels, j_syncs = _observe("jax", ctxs["jax"], CASES[case])
    t_labels, t_syncs = _observe("torch", ctxs["torch"], CASES[case])
    assert t_labels == j_labels
    assert t_syncs == j_syncs
    assert j_syncs, "every operator here fetches from the device"


@pytest.mark.parametrize("case", ["join_inner", "ring_inner", "ring_left",
                                  "broadcast_inner"])
def test_kernel_route_labels_and_host_syncs_equal(ctxs, monkeypatch, case):
    """The port's kernel route (K1-K4's plain versions through the real
    call sites, as on the card) counts the same: the ring's W step plans
    and its unmatched rows come back in one fetch, as the JAX package's
    one count program does."""
    from cylon_tpu_torch.parallel import shuffle as tshuffle

    j_labels, j_syncs = _observe("jax", ctxs["jax"], CASES[case])
    monkeypatch.setattr(tjoin, "STREAM_PLAN", True)
    monkeypatch.setattr(tshuffle, "PARTITION_KERNEL", True)
    t_labels, t_syncs = _observe("torch", ctxs["torch"], CASES[case])
    assert t_labels == j_labels
    assert t_syncs == j_syncs


def test_dist_phase_logs_prefixes(ctxs):
    """The JAX package's test_dist_phase_logs prefixes, in the port's
    phase log."""
    labels, _ = _observe("torch", ctxs["torch"], _table_join)
    for prefixes in (("distributed_join.shuffle",),
                     ("distributed_join.plan",),
                     ("distributed_join.materialize",),
                     ("shuffle.count",),
                     ("shuffle.exchange", "shuffle.exchange_pair")):
        assert any(labels[p] for p in prefixes), (prefixes, labels)


def test_string_join_differs_only_in_distribute_varbytes(ctxs):
    """A join with a varbytes payload column: the labels are equal, and
    the host syncs are equal site by site but for the named difference
    (one shard-bounds copy a distributed varbytes column in the port,
    three device_gets in the JAX package)."""
    run = _join("INNER", strings=True)
    j_labels, j_syncs = _observe("jax", ctxs["jax"], run)
    t_labels, t_syncs = _observe("torch", ctxs["torch"], run)
    assert t_labels == j_labels
    assert j_syncs.pop("distribute.varbytes") == \
        3 * t_syncs.pop("distribute.varbytes") == 6
    assert t_syncs == j_syncs


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_chip_smoke_join_telemetry_is_the_references(ctxs, monkeypatch,
                                                     route):
    """chip_smoke.py phase 25d holds phase 2's join on the card to
    REFERENCE_JOIN_TELEMETRY: the reference gives it on the CPU, and so
    does the port on either route (the kernel route's switches forced on,
    their plain versions running, as on the card)."""
    import chip_smoke
    from cylon_tpu_torch.parallel import shuffle as tshuffle

    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    ref = chip_smoke.join_telemetry(jct, ctxs["jax"], 4096, 0)
    if route == "kernel":
        monkeypatch.setattr(tjoin, "STREAM_PLAN", True)
        monkeypatch.setattr(tshuffle, "PARTITION_KERNEL", True)
    got = chip_smoke.join_telemetry(tct, ctxs["torch"], 4096, 0)
    want = chip_smoke.REFERENCE_JOIN_TELEMETRY
    assert ref["labels"] == got["labels"] == want["labels"]
    assert ref["host_syncs"] == got["host_syncs"] == want["host_syncs"]
    assert ref["rows"] == got["rows"]


@pytest.mark.parametrize("strings", [False, True])
def test_write_csv_counts_its_own_site(ctxs, tmp_path, strings):
    """Writing a world-4 join result: the numeric table comes to the host
    in one counted fetch at the port-only site ``io.write_csv``, which the
    JAX package does not count; a table with a string column goes through
    pandas and counts nothing there. Every other site is equal."""
    def run(ct, ctx, join, setops, groupby, dist):
        a, b = _tables(ct, ctx, 3, strings)
        cfg = join.JoinConfig(join.JoinType.INNER, [0], [0])
        out = dist.distributed_join(a, b, cfg)
        out.to_csv(str(tmp_path / f"{ct.__name__}.csv"))

    j_labels, j_syncs = _observe("jax", ctxs["jax"], run)
    t_labels, t_syncs = _observe("torch", ctxs["torch"], run)
    assert t_labels == j_labels
    assert t_syncs.pop("io.write_csv", 0) == (0 if strings else 1)
    if strings:
        assert j_syncs.pop("distribute.varbytes") == \
            3 * t_syncs.pop("distribute.varbytes")
    assert t_syncs == j_syncs
    assert not set(j_syncs) & set(PORT_ONLY_SITES)


# the world-1 distributed join and group-by: the local ops' spans, in
# order (the join's plan stages open on the kernel route alone), and
# their one fetch each
WORLD1 = {
    "join_inner": (_join("INNER"), "join.plan", (
        "join", "join.prepare", "join.plan", "join.plan.hash",
        "join.plan.sort", "join.plan.stream", "join.materialize",
        "join.rebuild")),
    "groupby_sum": (_groupby(False, ("SUM",)), "groupby.count", (
        "groupby", "groupby.keys", "groupby.sort", "groupby.gather",
        "groupby.aggregate", "groupby.rebuild")),
}


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("case", sorted(WORLD1))
def test_world1_port_sites_and_stage_spans(monkeypatch, case, route):
    """At one shard the port's own telemetry: the local op's stage spans
    once each and one fetch at its site (``join.plan``, the JAX package's
    name; ``groupby.count``, the port's), so a planner that drops,
    doubles or renames a site or a span fails here."""
    from cylon_tpu_torch.parallel import shuffle as tshuffle

    run, site, labels = WORLD1[case]
    if route == "kernel":
        monkeypatch.setattr(tjoin, "STREAM_PLAN", True)
        monkeypatch.setattr(tshuffle, "PARTITION_KERNEL", True)
    else:
        labels = tuple(x for x in labels if not x.startswith("join.plan."))
    ctx = tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(1),
                                           device="cpu")
    t_labels, t_syncs = _observe("torch", ctx, run)
    assert t_labels == Counter(labels)
    assert t_syncs == {site: 1}
