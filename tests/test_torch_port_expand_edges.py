"""K4 edge cases: the plain join_expand_stream of cylon_tpu_torch on the
port's own plan against the JAX package's Pallas join_expand_stream, run
eagerly in interpret mode on the CPU, bit for bit.

The cases are the ones a tiled K4 on the card must get right, so the
plain version that the card's stress tests trust is held against the TPU
kernel on them: a probe key matched by more build rows than one K4 tile,
a LEFT join with dead emitting rows, and one empty shard in a world-4
plan. One module-scoped fixture per case; one Pallas call per case
(block_rows=8, ~8 s each in interpret mode)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import join as jjoin
from cylon_tpu.ops import tpu_kernels as tk

from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.ops import kernels as K


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pallas_blocks(x):
    """One shard's [n] int32 plan plane as the Pallas kernel's padded
    (rows, 128) uint32 block, with the BR + 8 slack rows it reads."""
    x = x.numpy().view(np.uint32)
    rows = -(-(-(-len(x) // 128) + 16) // 8) * 8
    out = np.zeros(rows * 128, np.uint32)
    out[:len(x)] = x
    return jnp.asarray(out.reshape(rows, 128))


def _edge_plan(case):
    """(join type, counts, a_streams, b_streams, cap_e, shards to hold
    against Pallas) of the port's plain K3 on one edge case: in a world,
    the empty shard (the others are held by
    ``test_expand_edge_shards_are_independent`` and the plan tests of
    ``test_torch_port_kernels.py``)."""
    rng = np.random.default_rng(len(case))
    w, na, nb = (4, 60, 50) if case == "empty_shard_w4" else (1, 40, 2_300)
    lk = rng.integers(0, 30, (w, na)).astype(np.int32)
    rk = rng.integers(0, 30, (w, nb)).astype(np.int32)
    lemit = np.ones((w, na), bool)
    jt = jjoin.JoinType.INNER
    if case == "heavy_key":      # one probe row, 2,200 build rows of key 7
        lk[lk == 7] = 8
        lk[0, 5] = 7
        rk[0, :2_200] = 7
    elif case == "left_dead_rows":  # unmatched probe rows and nulls
        jt = jjoin.JoinType.LEFT
        lk[0, :15] += 100
        nb = 40
        rk = rk[:, :nb]
    else:                        # shard 2 emits no probe row
        lemit[2] = False
    lkval = [None] if case != "left_dead_rows" else [
        rng.random((w, na)) < 0.8]
    ldat = (_t(lk), _t(rng.normal(size=(w, na)).astype(np.float32)))
    rdat = (_t(rk), _t(rng.normal(size=(w, nb)).astype(np.float32)))
    lv = rv = (None, None)
    a_desc, b_desc = tjoin.plan_lane_descs(ldat, lv, rdat, rv, jt)
    lbits, lkv = tjoin.key_bits([_t(lk)], [None if x is None else _t(x)
                                           for x in lkval])
    rbits, rkv = tjoin.key_bits([_t(rk)], [None])
    counts, a, b = tjoin.plan_program_stream(
        lbits, lkv, _t(lemit), rbits, rkv, _t(np.ones((w, nb), bool)),
        ldat, lv, rdat, rv, jt, a_desc=a_desc, b_desc=b_desc)
    n_out = int(counts[:, 0].max())
    cap_e = -(-n_out // 1024) * 1024  # whole (8 x 128)-row Pallas blocks
    return jt, counts, a, b, cap_e, ([2] if w > 1 else [0])


@pytest.fixture(scope="module",
                params=["heavy_key", "left_dead_rows", "empty_shard_w4"])
def expand_edge(request):
    jt, counts, a, b, cap_e, shards = _edge_plan(request.param)
    plain = K.join_expand_stream(counts, a, b, cap_e)
    pallas = {}
    for s in shards:
        pallas[s] = tk.join_expand_stream(
            jnp.asarray(counts[s].numpy()), [_pallas_blocks(x[s]) for x in a],
            [_pallas_blocks(x[s]) for x in b], cap_e, block_rows=8,
            interpret=True)
    return dict(case=request.param, jt=jt, counts=counts, a=a, b=b,
                cap_e=cap_e, plain=plain, pallas=pallas)


def test_expand_edge_case_holds(expand_edge):
    """Each case has the shape it is named for."""
    c = expand_edge["counts"]
    aidx, bidx, _al, _bl = expand_edge["plain"]
    case = expand_edge["case"]
    if case == "heavy_key":      # one run longer than a 2,048-row K4 tile
        live = aidx[0][aidx[0] >= 0]
        assert int(torch.unique(live, return_counts=True)[1].max()) >= 2_100
    elif case == "left_dead_rows":  # valid outputs without a build row
        assert bool(((aidx >= 0) & (bidx < 0)).any())
    else:
        assert int(c[2, 1]) == 0 and int(c[2, 0]) == 0
        assert int(c[:, 1].min()) == 0 < int(c[:, 1].max())


def test_expand_edge_plain_matches_pallas(expand_edge):
    aidx, bidx, al, bl = expand_edge["plain"]
    for s, (jaidx, jbidx, jal, jbl) in expand_edge["pallas"].items():
        assert np.array_equal(np.asarray(jaidx), aidx[s].numpy())
        assert np.array_equal(np.asarray(jbidx), bidx[s].numpy())
        assert len(jal) == len(al) and len(jbl) == len(bl)
        for x, y in zip(tuple(jal) + tuple(jbl), al + bl):
            assert np.array_equal(np.asarray(x), y[s].numpy().view(np.uint32))


def test_expand_edge_shards_are_independent(expand_edge):
    """The plain K4 over W shards equals it over each shard alone, so the
    shards held against Pallas stand for the others."""
    c, a, b, cap_e = (expand_edge[k] for k in ("counts", "a", "b", "cap_e"))
    whole = expand_edge["plain"]
    for s in range(c.shape[0]):
        one = K.join_expand_stream(c[s:s + 1], a[:, s:s + 1], b[:, s:s + 1],
                                   cap_e)
        assert torch.equal(one[0][0], whole[0][s])
        assert torch.equal(one[1][0], whole[1][s])
        for x, y in zip(one[2] + one[3], whole[2] + whole[3]):
            assert torch.equal(x[0], y[s])
