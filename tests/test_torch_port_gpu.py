"""cylon_tpu_torch kernels K1-K4 against their plain PyTorch versions on
the card, bit for bit.

Needs CUDA: every test here is marked ``gpu`` and skips without a card.
This file imports neither jax nor cylon_tpu, so it also runs on a machine
that has only torch; there, skip the JAX package's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""
import numpy as np
import pytest
import torch

from cylon_tpu_torch.ops import join as J
from cylon_tpu_torch.ops import kernels as K
from cylon_tpu_torch.parallel import shuffle as S
from cylon_tpu_torch.status import CylonError

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _plan_equal(ref, got):
    """Counts equal, and groups A/B equal over their counted prefixes."""
    (c0, a0, b0), (c1, a1, b1) = ref, got
    assert torch.equal(c0, c1), (c0, c1)
    for w in range(c0.shape[0]):
        ne, nb = int(c0[w, 1]), int(c0[w, 2])
        for x, y in zip(a0, a1):
            assert torch.equal(x[w, :ne], y[w, :ne])
        for x, y in zip(b0, b1):
            assert torch.equal(x[w, :nb], y[w, :nb])


@pytest.mark.parametrize("world", [2, 4, 8, 255])
def test_partition_kernels_match_plain(cuda, world):
    rng = np.random.default_rng(world)
    n = 70_001
    t = rng.integers(0, world + 1, (3, n)).astype(np.int32)
    t = torch.from_numpy(t).to(cuda)
    legs = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 3, n),
                                         dtype=np.int64).astype(np.int32)
                            ).to(cuda)
    hist = K.partition_hist(t, world + 1)
    assert torch.equal(hist, K.plain_partition_hist(t, world + 1))
    out = K.partition_scatter(t, legs, world + 1, hist)
    torch.cuda.synchronize()
    assert torch.equal(out, K.plain_partition_scatter(t, legs, world + 1))


def test_partition_past_the_bucket_limit_raises(cuda):
    """Past K1/K2's bucket limit the partition raises on the card; it does
    not take the stable sort."""
    world = K.MAX_BUCKETS
    t = torch.zeros(world, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(CylonError, match="not yet ported"):
        S._padded_partition(world, 1, {"x": t}, t, t == 0)


def _join_inputs(dev, rng, w, na, nb, hash_mode, two_keys):
    keys = 2 if two_keys else 1
    lk = [torch.from_numpy(rng.integers(0, na // 3, (w, na)).astype(
        np.int32)).to(dev) for _ in range(keys)]
    rk = [torch.from_numpy(rng.integers(0, na // 3, (w, nb)).astype(
        np.int32)).to(dev) for _ in range(keys)]
    lval = torch.from_numpy(rng.random((w, na)) < 0.9).to(dev)
    lemit = torch.from_numpy(rng.random((w, na)) < 0.95).to(dev)
    remit = torch.from_numpy(rng.random((w, nb)) < 0.95).to(dev)
    lbits, lkv = J.key_bits(lk, [lval] + [None] * (keys - 1))
    rbits, rkv = J.key_bits(rk, [None] * keys)
    ldat = (lk[0], torch.from_numpy(rng.normal(size=(w, na)).astype(
        np.float32)).to(dev))
    rdat = (rk[0], torch.from_numpy(rng.normal(size=(w, nb)).astype(
        np.float32)).to(dev))
    lv = (lval, torch.ones_like(lval))
    rv = (torch.ones_like(remit), torch.ones_like(remit))
    return lbits, lkv, lemit, rbits, rkv, remit, ldat, lv, rdat, rv


@pytest.mark.parametrize("jt,hash_mode", [
    (J.JoinType.INNER, False), (J.JoinType.LEFT, False),
    (J.JoinType.INNER, True)])
def test_join_kernels_match_plain(cuda, jt, hash_mode):
    rng = np.random.default_rng(int(jt) + 10 * hash_mode)
    args = _join_inputs(cuda, rng, 3, 40_000, 50_000, hash_mode, hash_mode)
    a_desc, b_desc = J.plan_lane_descs(*args[6:], jt)
    kw = J.stream_plan_inputs(*args, jt, a_desc, b_desc, hash_mode)
    got = K.join_plan_stream(**kw)
    ref = K.plain_join_plan_stream(**kw)
    torch.cuda.synchronize()
    _plan_equal(ref, got)
    cap_e = J.stream_expand_capacity(int(ref[0][:, 0].max()), 8)
    e_got = K.join_expand_stream(ref[0], ref[1], ref[2], cap_e)
    e_ref = K.plain_join_expand_stream(ref[0], ref[1], ref[2], cap_e)
    torch.cuda.synchronize()
    assert torch.equal(e_got[0], e_ref[0])
    assert torch.equal(e_got[1], e_ref[1])
    for x, y in zip(e_got[2] + e_got[3], e_ref[2] + e_ref[3]):
        assert torch.equal(x, y)
