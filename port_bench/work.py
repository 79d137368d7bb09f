"""The operations and bytes a train step needs, from the model's shapes and
the graph's counts alone, so that they are the same whatever kernel does
the work; and the H100's published peaks that turn them into a least time.

Every input of an operation is counted as read once and every output as
written once, in the compute dtype (bf16: 2 bytes) where the program computes
in it, f32 where it keeps f32 (GAT's attention logits), int32 for the edge
list and its row pointer. A KAN layer's operations are its products: 8 a
weight and row (SiLU's base term and the 7 B-spline bases at grid 4, order
3), two each; its backward makes them twice (dW and dx), once when its input
needs no gradient (the node features). The aggregations count one add an
edge and column. The bound arithmetic is `chip_smoke.py`'s, copied.

These counts are those of the built-in `NodeClassifier` with GIN or GAT
convs and B-spline KAN layers. A configuration's reference module (the
`"reference"` its file names) may define `kan_layer_work`,
`message_passing_work` and `model_flops`, each `(config, graph)`, in their
place; a count that neither covers is None, and a metric that needs it then
reads nothing.
"""
from __future__ import annotations

from port_bench import manifest
from port_bench.reference.kan_node import kan_layers

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def least_ms(items, dtype: str) -> float:
    """Σ over (bytes, operations) of the larger of bytes over the memory
    rate and operations over the peak rate of `dtype`, in ms."""
    return sum(max(b / PEAK_BYTES, o / PEAK_FLOPS[dtype]) for b, o in items) * 1e3


def _needs_dx(prefix: str) -> bool:
    """Only the first layer of conv 0 reads the node features, which need no
    gradient."""
    return prefix not in ("convs.0.update.layers.0", "convs.0.transform")


def _counted(config: dict, hook: str):
    """The reference module's count `hook`, or None where it defines none."""
    if not config.get("reference"):
        return None
    return getattr(manifest.reference(config), hook, None)


def _node_kan(config: dict) -> bool:
    """Whether the built-in counts below apply: a NodeClassifier of GIN or
    GAT convs with B-spline KAN layers."""
    return (config.get("model", "NodeClassifier") == "NodeClassifier"
            and config.get("architecture", "kan") == "kan"
            and config["conv_type"] in ("gin", "gat"))


def kan_layer(config: dict, graph: dict) -> list[tuple[float, float]] | None:
    """(bytes, operations) of every KAN layer forward and backward a step."""
    hook = _counted(config, "kan_layer_work")
    if hook is not None:
        return hook(config, graph)
    if not _node_kan(config):
        return None
    s = ITEMSIZE[config["compute_dtype"]]
    n = graph["n_nodes"]
    nb1 = config["grid_size"] + config["spline_order"] + 1
    n_knots = config["grid_size"] + 2 * config["spline_order"] + 1
    items = []
    for prefix, d, o in kan_layers(config, graph["num_features"], graph["num_classes"]):
        w = nb1 * d * o
        items.append((s * (n * d + n_knots * d + w + n * o), 2 * n * w))
        dx = _needs_dx(prefix)
        items.append((s * (n * d * (2 if dx else 1) + n_knots * d + 2 * w + n * o),
                      2 * n * w * (2 if dx else 1)))
    return items


def message_passing(config: dict, graph: dict) -> list[tuple[float, float]] | None:
    """(bytes, operations) of every aggregation forward and backward a step:
    GIN's neighbour sum, GAT's attention (logits, softmax per receiver,
    weighted sum)."""
    hook = _counted(config, "message_passing_work")
    if hook is not None:
        return hook(config, graph)
    if not _node_kan(config):
        return None
    s = ITEMSIZE[config["compute_dtype"]]
    n, e = graph["n_nodes"], graph["n_edges"]
    csr = 4 * e + 4 * (n + 1)
    H, heads = config["hidden_channels"], config.get("heads", 1)
    items = []
    for i in range(config["mp_layers"]):
        if config["conv_type"] == "gin":
            d = graph["num_features"] if i == 0 else H
            items.append((s * 2 * n * d + csr, e * d))
            if i > 0:
                items.append((s * 2 * n * d + csr, e * d))
        else:
            hc = H * heads
            items.append((s * 2 * n * hc + 4 * 2 * n * heads + csr,
                          2 * e * hc + 4 * e * heads))
            items.append((s * 3 * n * hc + 4 * 4 * n * heads + csr,
                          4 * e * hc + 8 * e * heads))
    return items


def model_flops(config: dict, graph: dict) -> float | None:
    """The operations of a train step: the KAN layers' products, the
    aggregations, GAT's attention-logit products (2 a row, head and column,
    for each of a_src and a_dst, forward; twice that backward)."""
    hook = _counted(config, "model_flops")
    if hook is not None:
        return hook(config, graph)
    kan, mp = kan_layer(config, graph), message_passing(config, graph)
    if kan is None or mp is None:
        return None
    ops = sum(o for _, o in kan) + sum(o for _, o in mp)
    if config["conv_type"] == "gat":
        hc = config["hidden_channels"] * config["heads"]
        ops += config["mp_layers"] * 3 * (2 * 2 * graph["n_nodes"] * hc)
    return float(ops)
