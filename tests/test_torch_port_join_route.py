"""The join's route table, on the CPU: ``ops/join.join_route``'s answer and
the route the planner (``ops/join.plan_join``) is handed by the local join
and by the world-4 distributed join, for every key shape, join type,
algorithm and ``STREAM_PLAN`` setting.

The stream routes are off on the CPU unless ``STREAM_PLAN`` is True
(where the kernel wrappers run their plain versions), so None and False
plan every join on the plan route. With True:

* ``join_route`` answers "plan" for FULL_OUTER, and for the other join
  types what ``ON`` lists under the algorithm;
* the local join plans that route; a FULL_OUTER join runs as LEFT under
  the same algorithm plus a tail of unmatched right rows wherever AUTO's
  LEFT route is not "plan", and ``ON``'s second row is that LEFT join's
  route;
* the distributed joins take no algorithm: every join type but
  FULL_OUTER plans AUTO's route, FULL_OUTER the plan route.

Both joins return the same number of rows.
"""
import itertools

import numpy as np
import pytest

import cylon_tpu_torch as ct
from cylon_tpu_torch.data import strings as S
from cylon_tpu_torch.data import table as T
from cylon_tpu_torch.ops import join as J
from cylon_tpu_torch.parallel import dist_ops as D

N = 64
ALGS = (J.JoinAlgorithm.SORT, J.JoinAlgorithm.HASH, J.JoinAlgorithm.AUTO)
# key shape: (routes of INNER, LEFT and RIGHT under SORT, HASH and AUTO;
# routes of FULL_OUTER's local LEFT join under SORT, HASH and AUTO), with
# STREAM_PLAN True
ON = {
    "int32": (("stream", "hash", "stream"), ("stream", "hash", "stream")),
    "int64": (("plan", "hash", "hash"), ("plan", "hash", "hash")),
    "bool": (("plan", "hash", "hash"), ("plan", "hash", "hash")),
    "two_int32": (("plan", "hash", "hash"), ("plan", "hash", "hash")),
    # three words and the byte length: four lanes, byte-exact
    "word_lanes": (("plan", "hash", "hash"), ("plan", "hash", "hash")),
    # four int64 columns: eight lanes, past K8's six
    "over_budget": (("plan", "plan", "plan"), ("plan", "plan", "plan")),
}


def _side(shape: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 16, N)
    if shape == "int32":
        d = {"k": k.astype(np.int32)}
    elif shape == "int64":
        d = {"k": k.astype(np.int64)}
    elif shape == "bool":
        d = {"k": k % 2 == 0}
    elif shape == "two_int32":
        d = {"k": k.astype(np.int32), "k2": (k % 3).astype(np.int32)}
    elif shape == "word_lanes":
        d = {"k": np.array([f"key-{x:06d}" for x in k])}
    else:
        d = {f"k{i}": (k + i).astype(np.int64) for i in range(4)}
    d["v"] = rng.random(N)
    return d


def _expected(shape, jt, alg, stream_plan):
    """(join_route's answer, the local join's planned route, the
    distributed join's)."""
    if not stream_plan:
        return "plan", "plan", "plan"
    keyed, full_outer = ON[shape]
    a = ALGS.index(alg)
    if jt == J.JoinType.FULL_OUTER:
        return "plan", full_outer[a], "plan"
    return keyed[a], keyed[a], keyed[ALGS.index(J.JoinAlgorithm.AUTO)]


@pytest.fixture(scope="module")
def ctxs():
    return (ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(1),
                                            device="cpu"),
            ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                            device="cpu"))


@pytest.mark.parametrize("shape,jt,alg,stream_plan", list(itertools.product(
    sorted(ON), list(J.JoinType), ALGS, [None, True, False])))
def test_join_route_table(ctxs, monkeypatch, shape, jt, alg, stream_plan):
    monkeypatch.setattr(S, "DICT_MAX_VOCAB", 0)
    monkeypatch.setattr(J, "STREAM_PLAN", stream_plan)
    planned = []
    plan_join = J.plan_join

    def spy(route, *args, **kw):
        planned.append(route)
        return plan_join(route, *args, **kw)

    monkeypatch.setattr(J, "plan_join", spy)
    want_route, want_local, want_dist = _expected(shape, jt, alg,
                                                  stream_plan)
    idx = list(range(len(_side(shape, 0)) - 1))
    cfg = J.JoinConfig(jt, idx, idx, alg)

    left, right = (ct.Table.from_pydict(ctxs[0], _side(shape, s))
                   for s in (1, 2))
    lcols, rcols = T.align_key_columns(left, right, idx, idx)
    lkeys, lkvalid, raw = T._expanded_keys(lcols, rcols)
    rkeys, rkvalid, _ = T._expanded_keys(rcols, lcols)
    lbits, _lkv = J.key_bits(T._rows(lkeys), T._rows(lkvalid), raw)
    rbits, _rkv = J.key_bits(T._rows(rkeys), T._rows(rkvalid), raw)
    assert len(lbits) == {"word_lanes": 4, "over_budget": 4}.get(shape,
                                                                 len(idx))
    assert J.join_route(lbits, rbits, jt, alg) == want_route

    local_rows = T.join(left, right, cfg).row_count
    assert planned == [want_local]

    planned.clear()
    left, right = (ct.Table.from_pydict(ctxs[1], _side(shape, s))
                   for s in (1, 2))
    assert D.distributed_join(left, right, cfg).row_count == local_rows
    assert planned == [want_dist]
