"""Minimal end-to-end example, the counterpart of
`examples/train_node_synthetic.py`: train a KAGCN (FastKAN basis, dropout
0.1) full batch on a synthetic four-community node-classification graph,
printing the loss and validation accuracy every 20 epochs and the test
accuracy at the end.

    python -m kagnn_tpu_torch.experiments.train_node_synthetic

Runs on the card; `KAGNN_PLATFORM=cpu` runs the plain PyTorch path on the
CPU.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    import torch

    from kagnn_tpu_torch.data import community_node_graph
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.models import NodeClassifier
    from kagnn_tpu_torch.train import losses, make_node_steps
    from kagnn_tpu_torch.utils.platform import platform_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=100)
    args = p.parse_args(argv)
    device = platform_device()
    d = community_node_graph(n_nodes=400, n_classes=4, num_features=16, seed=0)
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"],
                     device=device)
    pad = g.n_node_pad - d["n_node"]

    def mask(name):
        return torch.from_numpy(np.concatenate([d["masks"][name],
                                                np.zeros(pad, bool)])).to(device)

    model = NodeClassifier(conv_type="gcn", architecture="fastkan", mp_layers=2,
                           num_features=16, hidden_channels=32, num_classes=4,
                           grid_size=6, dropout=0.1, device=device)
    train_step, evaluate = make_node_steps(model, torch.optim.Adam(model.parameters(), lr=5e-3))
    trace = []
    for epoch in range(args.epochs):
        loss = float(train_step(g, mask("train")))
        trace.append(loss)
        if epoch % 20 == 0:
            acc = float(losses.masked_accuracy(evaluate(g), g.y, mask("val")))
            print(f"epoch {epoch:3d}  loss {loss:.4f}  val acc {acc:.3f}")
    test = float(losses.masked_accuracy(evaluate(g), g.y, mask("test")))
    print("test acc:", test)
    return {"losses": trace, "test_acc": test}


if __name__ == "__main__":
    main()
