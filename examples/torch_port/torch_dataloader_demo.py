"""Data engineering for ML on the card: cylon_tpu_torch ETL -> torch
training (reference: cpp/src/tutorial/demo_pytorch.py and
python/examples/cylon_sequential_mnist.py; the port's counterpart of
examples/torch_dataloader_demo.py).

The framework does the relational work (aggregate an event table, join
it onto the user features) on the card; the model trains on the same
device from dense blocks of the result. The multi-process variant is
torch_ddp_demo.py.

    python examples/torch_port/torch_dataloader_demo.py [--device cpu]
"""
import argparse

import numpy as np
import torch

import cylon_tpu_torch as ct


def make_features(ctx, n=20_000):
    rng = np.random.default_rng(0)
    users = ct.Table.from_pydict(ctx, {
        "uid": np.arange(n, dtype=np.int64),
        "age": rng.integers(18, 80, n).astype(np.float32),
    })
    events = ct.Table.from_pydict(ctx, {
        "uid": rng.integers(0, n, 5 * n).astype(np.int64),
        "spend": rng.exponential(20.0, 5 * n).astype(np.float32),
    })
    # label: did the user spend > 100 total
    per_user = events.groupby(0, ["spend"], ["sum"])
    return users.join(per_user, "left", on="uid")


def main(device=None) -> dict:
    """Prints and returns the feature rows, the positive labels and each
    epoch's mean loss."""
    ctx = ct.CylonContext.Init(device)
    table = make_features(ctx)

    x = table.project([1, 3]).to_numpy(order="C").astype(np.float32)
    x = np.nan_to_num(x)
    y = (x[:, 1] > 100.0).astype(np.float32)
    x[:, 1] = 0.0  # don't leak the label

    torch.manual_seed(0)
    dev = ctx.device
    ds = torch.utils.data.TensorDataset(torch.from_numpy(x),
                                        torch.from_numpy(y))
    dl = torch.utils.data.DataLoader(ds, batch_size=256, shuffle=True)
    model = torch.nn.Sequential(torch.nn.Linear(2, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 1)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss_fn = torch.nn.BCEWithLogitsLoss()
    losses = []
    for epoch in range(2):
        total = torch.zeros((), device=dev)
        for xb, yb in dl:
            xb, yb = xb.to(dev), yb.to(dev)
            opt.zero_grad()
            loss = loss_fn(model(xb).squeeze(-1), yb)
            loss.backward()
            opt.step()
            total += loss.detach() * len(xb)
        losses.append(float(total) / len(ds))
        print(f"epoch {epoch}: loss {losses[-1]:.4f}")
    return {"rows": len(ds), "positives": int(y.sum()), "losses": losses}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
