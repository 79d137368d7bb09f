"""The plain float32 reference of a KAGCN train step: GCN convs (PyG
GCNConv, symmetric norm with self-loops, a bias) over B-spline KANLinear
transforms, BatchNorm, a KANLinear head, masked cross-entropy and Adam,
trained through `kan_node.train`'s loop. Imports nothing of the program.
Also the step's operation and byte counts, which `port_bench/work.py`
takes from here."""
from __future__ import annotations

import math

import torch

from port_bench.reference import kan_node
from port_bench.work import ITEMSIZE


def kan_layers(config: dict, num_features: int, num_classes: int):
    H = config["hidden_channels"]
    return ([(f"convs.{i}.transform", num_features if i == 0 else H, H)
             for i in range(config["mp_layers"])] + [("head", H, num_classes)])


def param_specs(config: dict, num_features: int, num_classes: int):
    G, k, H = config["grid_size"], config["spline_order"], config["hidden_channels"]
    specs = []
    for prefix, fin, fout in kan_layers(config, num_features, num_classes):
        specs += [(f"{prefix}.base_weight", (fout, fin), 1.0 / math.sqrt(fin)),
                  (f"{prefix}.spline_weight", (fout, fin, G + k), 0.1 / G),
                  (f"{prefix}.spline_scaler", (fout, fin), 1.0 / math.sqrt(fin))]
    for i in range(config["mp_layers"]):
        specs += [(f"convs.{i}.bias", (H,), ("const", 0.0)),
                  (f"norms.{i}.weight", (H,), ("const", 1.0)),
                  (f"norms.{i}.bias", (H,), ("const", 0.0))]
    return specs


def logits(p, data, config, rnd):
    G, k = config["grid_size"], config["spline_order"]
    snd, rcv = data["senders"], data["receivers"]
    x = rnd(data["nodes"])
    n = x.shape[0]
    dinv = torch.rsqrt(torch.zeros(n, device=x.device).index_add_(
        0, rcv, torch.ones(rcv.shape[0], device=x.device)) + 1.0)[:, None]

    def layer(x, prefix):
        return kan_node.kan_linear(x, p, prefix, kan_node.knots(x.shape[1], G, k, x.device), k, rnd)

    for i in range(config["mp_layers"]):
        h = layer(x, f"convs.{i}.transform") * dinv
        x = rnd(dinv * kan_node.gin_sum(h, snd, rcv)) + p[f"convs.{i}.bias"]
        x = rnd(kan_node.batch_norm(x, p[f"norms.{i}.weight"], p[f"norms.{i}.bias"]))
    return layer(x, "head")


def loss(p, data, config, rnd, mask):
    return kan_node.masked_cross_entropy(logits(p, data, config, rnd), data["labels"], mask)


def train(weights, data, config, lr, steps, grad_step, **kw):
    return kan_node.train(weights, data, config, lr, steps, grad_step, loss=loss, **kw)


rounding_to = kan_node.rounding_to


def kan_layer_work(config: dict, graph: dict):
    """(bytes, operations) of each KANLinear forward and backward a step:
    8 products a weight and row, twice in the backward (once where the
    input is the node features)."""
    s, n = ITEMSIZE[config["compute_dtype"]], graph["n_nodes"]
    nb = config["grid_size"] + config["spline_order"] + 1
    items = []
    for prefix, d, o in kan_layers(config, graph["num_features"], graph["num_classes"]):
        w, dx = nb * d * o, prefix != "convs.0.transform"
        items += [(s * (n * d + w + n * o), 2 * n * w),
                  (s * (n * d * (1 + dx) + 2 * w + n * o), 2 * n * w * (1 + dx))]
    return items


def message_passing_work(config: dict, graph: dict):
    """(bytes, operations) of each GCN aggregation a step, forward and
    backward: the rows read and written once, the CSR, an add an edge and
    column."""
    s, n, e, H = (ITEMSIZE[config["compute_dtype"]], graph["n_nodes"], graph["n_edges"],
                  config["hidden_channels"])
    return [(s * 2 * n * H + 4 * e + 4 * (n + 1), e * H)] * (2 * config["mp_layers"])
