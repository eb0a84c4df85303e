"""The port's DDP demo (examples/torch_port/torch_ddp_demo.py) on the
CPU: two processes of two shards each (W = 4, gloo) run the distributed
ETL, hand each process its own shards' rows (``to_pydict_local``) and
train DistributedDataParallel over the process group the context
created. Both processes must print DDPOK after two finite epochs, and
each process's feed must equal the port's virtual world at W = 4 shard
for shard: process p's rows are the live rows of shards 2p and 2p + 1,
bit for bit, in the same order.
"""
import importlib.util
from pathlib import Path

import numpy as np

import cylon_tpu_torch as tct

ROOT = Path(__file__).resolve().parent.parent
DEMO = ROOT / "examples" / "torch_port" / "torch_ddp_demo.py"


def _demo():
    spec = importlib.util.spec_from_file_location("port_torch_ddp_demo",
                                                  DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_process_ddp_demo(tmp_path):
    demo = _demo()
    outs = demo.launch(nproc=2, device="cpu", timeout=240,
                       feed_dir=str(tmp_path))
    for pid, out in enumerate(outs):
        assert f"DDPOK {pid}" in out
        losses = [float(ln.split("loss ")[1].split()[0])
                  for ln in out.splitlines() if "] epoch " in ln]
        assert len(losses) == 2 and np.isfinite(losses).all()

    ctx = tct.CylonContext.InitDistributed(tct.VirtualWorldConfig(4),
                                           device="cpu")
    users, events = demo.make_local_tables(ctx)
    table = users.distributed_join(events.groupby(0, ["spend"], ["sum"]),
                                   "inner", on="uid")
    whole = table.to_pydict_local()
    emit = table.emit_mask().numpy()
    cap = emit.shape[0] // 4
    per_process = [int(emit[p * 2 * cap:(p + 1) * 2 * cap].sum())
                   for p in range(2)]
    feeds = [dict(np.load(tmp_path / f"feed{p}.npz")) for p in range(2)]
    assert [len(next(iter(f.values()))) for f in feeds] == per_process
    assert list(feeds[0]) == list(whole)
    for name, col in whole.items():
        got = np.concatenate([f[name] for f in feeds])
        assert got.dtype == col.dtype
        assert np.array_equal(got.view(np.uint8), col.view(np.uint8)), name
    # every user is fed to exactly one process
    assert sorted(np.concatenate([f["lt-0"] for f in feeds]).tolist()) == \
        sorted(whole["lt-0"].tolist())


def test_demo_main_parses_its_workers(monkeypatch):
    """main() returns each worker's losses and rows as they printed
    them."""
    demo = _demo()
    fake = ["[rank 0] epoch 0: loss 1.5000 on 7 local rows\n"
            "[rank 0] epoch 1: loss 0.2500 on 7 local rows\nDDPOK 0\n",
            "[rank 1] epoch 0: loss 1.0000 on 9 local rows\n"
            "[rank 1] epoch 1: loss 0.5000 on 9 local rows\nDDPOK 1\n"]
    monkeypatch.setattr(demo, "launch", lambda device=None: fake)
    assert demo.main("cpu") == {0: {"losses": [1.5, 0.25], "rows": 7},
                                1: {"losses": [1.0, 0.5], "rows": 9}}
