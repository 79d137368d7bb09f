"""The plain float32 reference of a KAGINE train step, the KAGNN paper's
graph regression model (arXiv:2406.18380, `graph_regression/models.py`):
OGB's AtomEncoder and BondEncoder (a table a feature column, the rows
summed), GINE convs (messages ReLU(x_j + e_ij) summed into each receiver,
added to x_i) over 2-deep B-spline KAN update nets, BatchNorm after each
conv, global add pooling, a KAN head, the L1 loss averaged over the graphs
and Adam, trained through `kan_node.train`'s loop on the batch's
concatenated graphs in their raw edge order. Imports nothing of the
program. It defines no operation or byte counts, so the metrics built on
them read nothing for this model."""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import kan_node

# ogb.utils.features: get_atom_feature_dims(), get_bond_feature_dims()
ATOM_VOCAB = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_VOCAB = (5, 6, 2)


def kan_layers(config: dict, num_targets: int):
    H, L = config["hidden_channels"], config["hidden_layers"]
    out = [(f"convs.{i}.update.layers.{j}", H, H)
           for i in range(config["gnn_layers"]) for j in range(L)]
    head = [H] * L + [num_targets]
    return out + [(f"head.layers.{j}", a, b) for j, (a, b) in enumerate(zip(head[:-1], head[1:]))]


def param_specs(config: dict, num_features: int, num_classes: int):
    """The encoders' tables (xavier-uniform), each KANLinear's weights
    (as `kan_node.param_specs`), BatchNorm's ones and zeros."""
    if num_features != len(ATOM_VOCAB):
        raise ValueError(f"{num_features} atom columns; OGB's encoder reads {len(ATOM_VOCAB)}")
    G, k, H = config["grid_size"], config["spline_order"], config["hidden_channels"]
    specs = [(f"{enc}.emb.{i}", (v, H), math.sqrt(6.0 / (v + H)))
             for enc, vocab in (("atom_encoder", ATOM_VOCAB), ("bond_encoder", BOND_VOCAB))
             for i, v in enumerate(vocab)]
    for prefix, fin, fout in kan_layers(config, num_classes):
        specs += [(f"{prefix}.base_weight", (fout, fin), 1.0 / math.sqrt(fin)),
                  (f"{prefix}.spline_weight", (fout, fin, G + k), 0.1 / G),
                  (f"{prefix}.spline_scaler", (fout, fin), 1.0 / math.sqrt(fin))]
    for i in range(config["gnn_layers"]):
        specs += [(f"norms.{i}.weight", (H,), ("const", 1.0)),
                  (f"norms.{i}.bias", (H,), ("const", 0.0))]
    return specs


def reference_inputs(data, device) -> dict:
    """The batch's graphs concatenated: edges shifted by each graph's first
    node, in the order the generator made them; `train_mask` marks every
    graph, whose losses the step averages."""
    graphs = data.graphs
    first = np.cumsum([0] + [g["n_node"] for g in graphs])[:-1]

    def cat(key, shift=False):
        return torch.from_numpy(np.concatenate(
            [g[key].astype(np.int64) + (o if shift else 0) for g, o in zip(graphs, first)])
        ).to(device)

    return {"senders": cat("senders", True), "receivers": cat("receivers", True),
            "nodes": cat("nodes"), "edges": cat("edges"),
            "node_graph": torch.from_numpy(np.concatenate(
                [np.full(g["n_node"], i) for i, g in enumerate(graphs)])).to(device),
            "targets": torch.from_numpy(np.concatenate([g["y"] for g in graphs])).to(device),
            "train_mask": torch.ones(len(graphs), dtype=torch.bool, device=device)}


def predictions(p: dict, data: dict, config: dict, rnd) -> torch.Tensor:
    G, k, H = config["grid_size"], config["spline_order"], config["hidden_channels"]
    snd, rcv = data["senders"], data["receivers"]

    def encode(name, vocab, cols):
        return sum(p[f"{name}.emb.{i}"][cols[:, i]] for i in range(len(vocab)))

    def layer(x, prefix):
        return kan_node.kan_linear(x, p, prefix, kan_node.knots(x.shape[1], G, k, x.device), k, rnd)

    x = rnd(encode("atom_encoder", ATOM_VOCAB, data["nodes"]))
    e = encode("bond_encoder", BOND_VOCAB, data["edges"])
    for i in range(config["gnn_layers"]):
        z = x.index_add(0, rcv, torch.relu(x[snd] + e))
        for j in range(config["hidden_layers"]):
            z = layer(z, f"convs.{i}.update.layers.{j}")
        x = rnd(kan_node.batch_norm(z, p[f"norms.{i}.weight"], p[f"norms.{i}.bias"]))
    n_graphs = data["train_mask"].shape[0]
    x = x.new_zeros((n_graphs, H)).index_add(0, data["node_graph"], x)
    for j in range(config["hidden_layers"]):
        x = layer(x, f"head.layers.{j}")
    return x


def loss(p: dict, data: dict, config: dict, rnd, mask) -> torch.Tensor:
    """The mean absolute error over the graphs of `mask`."""
    err = (predictions(p, data, config, rnd)[:, 0] - data["targets"]).abs()
    return err[mask].mean()


def train(weights, data, config, lr, steps, grad_step, **kw):
    return kan_node.train(weights, data, config, lr, steps, grad_step, loss=loss, **kw)


rounding_to = kan_node.rounding_to
