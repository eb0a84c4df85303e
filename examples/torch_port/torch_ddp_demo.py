"""Distributed data engineering for ML: multi-process cylon_tpu_torch
ETL -> torch DistributedDataParallel training (reference:
cpp/src/tutorial/demo_pytorch_distributed.py:1-50 — per-MPI-rank pycylon
ETL feeding torch DDP; the port's counterpart of
examples/torch_ddp_demo.py).

Two processes each own 2 shards of a world of 4 (``MultiHostConfig``
over gloo: both share the one card, which NCCL would refuse):

  1. per-rank ingest (`assemble_process_local` of in-memory tables),
  2. distributed ETL on the card — groupby, then distributed_join (K1/K2
     exchange, K3/K4 join),
  3. `Table.to_pydict_local()` hands each process exactly ITS shards'
     rows (no global gather),
  4. torch DDP trains on the per-process feed over the SAME process group
     the context created; gradient all-reduce is torch's, data placement
     is ours.

Run: python examples/torch_port/torch_ddp_demo.py [--device cpu]
         (spawns both workers)
     python examples/torch_port/torch_ddp_demo.py --worker PID NPROC RDV
         [--device cpu] [--feed-dir DIR]
"""
import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHARDS_PER_PROCESS = 2


def make_local_tables(ctx, n_per_shard=4096):
    """Every process generates the SAME seeded global frame and keeps
    only its own shards' slices — the reference's per-rank CSV convention
    without the filesystem."""
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.parallel import shard as _shard

    world = ctx.get_world_size()
    rng = np.random.default_rng(7)
    n = n_per_shard * world
    uid = np.arange(n, dtype=np.int64)
    age = rng.integers(18, 80, n).astype(np.float32)
    spend_uid = rng.integers(0, n, n).astype(np.int64)
    spend = rng.exponential(20.0, n).astype(np.float32)

    def shard_tables(cols_by_name):
        out = []
        for s in ctx.local_shard_indices():
            lo, hi = s * n_per_shard, (s + 1) * n_per_shard
            out.append(ct.Table.from_pydict(
                ctx, {k: v[lo:hi] for k, v in cols_by_name.items()}))
        return out

    users = _shard.assemble_process_local(
        shard_tables({"uid": uid, "age": age}), ctx)
    events = _shard.assemble_process_local(
        shard_tables({"uid": spend_uid, "spend": spend}), ctx)
    return users, events


def etl(ctx) -> dict:
    """Total spend per user (hash-shuffled groupby), joined back onto the
    user features across the world; this process's shards' rows."""
    users, events = make_local_tables(ctx)
    per_user = events.groupby(0, ["spend"], ["sum"])
    table = users.distributed_join(per_user, "inner", on="uid")
    return table.to_pydict_local()  # THIS process's shards only


def worker(pid: int, nproc: int, rdv: str, device=None,
           feed_dir=None) -> list:
    """One process: ETL, then two epochs of DDP; returns its losses."""
    import torch

    import cylon_tpu_torch as ct

    ctx = ct.CylonContext.InitDistributed(ct.MultiHostConfig(
        num_processes=nproc, process_id=pid, backend="gloo",
        shards_per_process=SHARDS_PER_PROCESS, init_method=f"file://{rdv}"),
        device=device)
    feed = etl(ctx)
    if feed_dir:
        np.savez(os.path.join(feed_dir, f"feed{pid}.npz"), **feed)
    # join output names columns positionally (lt-*/rt-*, pycylon
    # parity): [uid, age, uid, spend_sum]
    vals = list(feed.values())
    age = np.asarray(vals[1], dtype=np.float32)
    spend = np.nan_to_num(np.asarray(vals[3], dtype=np.float32))
    x = np.stack([age, np.zeros_like(age)], axis=1)
    y = (spend > 100.0).astype(np.float32)

    torch.manual_seed(0)
    dev = ctx.device
    model = torch.nn.Sequential(torch.nn.Linear(2, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 1)).to(dev)
    # the default process group is the one the context created
    model = torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss_fn = torch.nn.BCEWithLogitsLoss()
    ds = torch.utils.data.TensorDataset(torch.from_numpy(x),
                                        torch.from_numpy(y))
    dl = torch.utils.data.DataLoader(ds, batch_size=256, shuffle=True)
    losses = []
    for epoch in range(2):
        total = torch.zeros((), device=dev)
        # the processes hold different row counts: join() lets the one
        # with fewer batches shadow the other's all-reduces
        with model.join():
            for xb, yb in dl:
                xb, yb = xb.to(dev), yb.to(dev)
                opt.zero_grad()
                loss = loss_fn(model(xb).squeeze(-1), yb)
                loss.backward()  # DDP all-reduces gradients here
                opt.step()
                total += loss.detach() * len(xb)
        losses.append(float(total) / len(ds))
        print(f"[rank {pid}] epoch {epoch}: loss {losses[-1]:.4f}"
              f" on {len(ds)} local rows", flush=True)
    ctx.finalize()
    print(f"DDPOK {pid}", flush=True)
    return losses


def launch(nproc: int = 2, device=None, timeout: int = 540,
           feed_dir=None) -> list:
    """Spawn the workers; returns their outputs (asserts success)."""
    rdv = os.path.join(tempfile.mkdtemp(prefix="ddp_rdv_"), "rdv")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    extra = (["--device", device] if device else []) + \
        (["--feed-dir", feed_dir] if feed_dir else [])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(pid),
         str(nproc), rdv, *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"DDPOK {pid}" in out, out[-2000:]
    return outs


def main(device=None) -> dict:
    """Runs both workers; prints their outputs and returns each worker's
    losses and local rows, parsed from what they printed."""
    outs = launch(device=device)
    result = {}
    for pid, out in enumerate(outs):
        print(out, end="")
        epochs = [ln for ln in out.splitlines() if "] epoch " in ln]
        result[pid] = {
            "losses": [float(ln.split("loss ")[1].split()[0])
                       for ln in epochs],
            "rows": int(epochs[0].split(" on ")[1].split()[0])}
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--worker", nargs=3, metavar=("PID", "NPROC", "RDV"))
    ap.add_argument("--feed-dir", default=None)
    args = ap.parse_args()
    if args.worker:
        pid, nproc, rdv = args.worker
        worker(int(pid), int(nproc), rdv, args.device, args.feed_dir)
    else:
        main(args.device)
