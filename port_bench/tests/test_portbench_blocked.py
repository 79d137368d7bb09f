"""The reference in blocks equals the one-shot reference on the CPU: the
edge gathers and scatters bit for bit, forward and backward, against both
the one-shot blocks and the one-shot expressions they replace; the KAN
layer in blocks of rows within round-off of its weight gradients' sums."""
import pytest
import torch
import torch.nn.functional as F

from port_bench import check, inputs, manifest
from port_bench.reference import kan_node

BENCH = manifest.load()
CONFIGS = {c: manifest.resolve(BENCH, w["name"])
           for w in BENCH["workloads"] for c in [w["config"]]}
GRAPH = {"n_nodes": 600, "n_edges": 5000, "train_nodes": 300, "num_features": 24}
WHOLE = 2 ** 62


def _gin_sum_one_shot(x, snd, rcv):
    return x.index_add(0, rcv, x.index_select(0, snd))


def _gat_attention_one_shot(h, att_src, att_dst, snd, rcv, heads):
    n = h.shape[0]
    h3 = h.view(n, heads, -1)
    a_src, a_dst = (h3 * att_src).sum(-1), (h3 * att_dst).sum(-1)
    e_logit = F.leaky_relu(a_src[snd] + a_dst[rcv], kan_node.GAT_SLOPE)
    s_logit = F.leaky_relu(a_src + a_dst, kan_node.GAT_SLOPE)
    with torch.no_grad():
        top = s_logit.scatter_reduce(0, rcv[:, None].expand_as(e_logit), e_logit, "amax")
    e_exp, s_exp = torch.exp(e_logit - top[rcv]), torch.exp(s_logit - top)
    denom = s_exp.index_add(0, rcv, e_exp)
    msgs = h3[snd] * (e_exp / denom[rcv])[..., None]
    out = (h3 * (s_exp / denom)[..., None]).index_add(0, rcv, msgs)
    return out.reshape(n, -1)


def _train(config, monkeypatch, edge_bytes=WHOLE, basis_bytes=WHOLE, one_shot=False):
    """3 steps of the configuration's reference (the module its
    `"reference"` names, built on `kan_node`'s blocked primitives) with
    `kan_node`'s block sizes, or its one-shot expressions, in place."""
    monkeypatch.setattr(kan_node, "EDGE_BLOCK_BYTES", edge_bytes)
    monkeypatch.setattr(kan_node, "BASIS_BLOCK_BYTES", basis_bytes)
    if one_shot:
        monkeypatch.setattr(kan_node, "gin_sum", _gin_sum_one_shot)
        monkeypatch.setattr(kan_node, "gat_attention", _gat_attention_one_shot)
    dev = torch.device("cpu")
    graph = {**config["traffic"]["graph"], **GRAPH}
    gen = inputs.generator(2 ** 35 + 3, dev)
    data = inputs.make_inputs(graph, 2 ** 35 + 3, gen, dev)
    ref = manifest.reference(config["config"])
    weights = inputs.make_weights(
        ref.param_specs(config["config"], data.num_features, data.num_classes), gen, dev)
    rdata = inputs.reference_inputs(ref, data, dev)
    losses, grads, params = ref.train(weights, rdata, config["config"],
                                      config["traffic"]["optimizer"]["lr"], 3, 2)
    monkeypatch.undo()
    return {"losses": losses, "grads": grads, "params": params, "weights": weights}


def _equal(a, b):
    assert a["losses"] == b["losses"]
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k
        assert torch.equal(a["params"][k], b["params"][k]), k


def _gaps(a, b) -> dict:
    """`check.gaps` of a against b: the largest relative loss gap, and by
    the worst leaf the gap of the gradients' and the changes' norms."""
    return check.gaps(a, b, b["weights"])


def _edge_width(c):
    """The width of the rows the first conv gathers: GIN sums the features,
    the other convs their transform's output."""
    conf = c["config"]
    return GRAPH["num_features"] if conf["conv_type"] == "gin" else (
        conf["hidden_channels"] * conf.get("heads", 1))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_edge_blocks_are_bit_for_bit(config, monkeypatch):
    """Blocks of 7 edges (E is 5,000): the same losses, the gradient of
    step 2 and the parameters after step 3, bit for bit, as one block."""
    c = CONFIGS[config]
    whole = _train(c, monkeypatch)
    width = _edge_width(c)
    assert len(kan_node.blocks(GRAPH["n_edges"], width * 4, 7 * width * 4)) > 700
    _equal(_train(c, monkeypatch, edge_bytes=7 * width * 4), whole)


def test_gin_blocks_are_the_one_shot_expression(monkeypatch):
    """GIN's sum, blocked or not, is `x.index_add(0, rcv, x.index_select(0,
    snd))` and its autograd backward, bit for bit."""
    c = CONFIGS["kagin"]
    _equal(_train(c, monkeypatch, edge_bytes=7 * _edge_width(c) * 4),
           _train(c, monkeypatch, one_shot=True))


def test_gat_blocks_are_the_one_shot_expression(monkeypatch):
    """GAT's attention, blocked: the forward and step 1's loss bit for bit
    as the one-shot expression; its senders' gradient is summed in edge
    order by `index_add_`, where autograd's backward of `h3[snd]` sums in
    another order (on the CPU neither `index_put_` nor `index_add_` repeats
    it), so the gradients and later steps agree to float32 round-off (read
    1.4e-7 on the losses, 6.3e-7 and 1.0e-7 on the worst leaf's gradient
    and change, by `check.gaps`): losses within 1e-6, leaves within 1e-5,
    a tenth of the smallest cell limit's thousandth."""
    c = CONFIGS["kagat"]
    blocked = _train(c, monkeypatch, edge_bytes=7 * _edge_width(c) * 4)
    one_shot = _train(c, monkeypatch, one_shot=True)
    assert blocked["losses"][0] == one_shot["losses"][0]
    g = _gaps(blocked, one_shot)
    assert g["loss_gap"] <= 1e-6 and g["grad_gap"] <= 1e-5 and g["change_gap"] <= 1e-5, g


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_kan_row_blocks_within_round_off(config, monkeypatch):
    """Blocks of 50 rows (N is 600; edges in blocks too): the operations
    that are not bit for bit are the KAN layer's products on the CPU (its
    matrix product sums a row in an order that depends on the block's
    height: kagat's step 1 loss moves by 1.3e-7) and its weight gradients,
    sums over rows that now add 12 blocks' partial sums. By `check.gaps`
    (read up to 1.3e-7 on the losses, 1.0e-6 and 1.8e-7 on the worst
    leaf's gradient and change): losses within 1e-6, leaves within 1e-5."""
    c = CONFIGS[config]
    whole = _train(c, monkeypatch)
    # the widest fan-in, from the reference's `param_specs`
    widest = max(w.shape[1] for k, w in whole["weights"].items() if k.endswith(".base_weight"))
    grid = c["config"]["grid_size"] + 2 * c["config"]["spline_order"] + 1
    rows = _train(c, monkeypatch, edge_bytes=64 * 4, basis_bytes=50 * widest * grid * 4)
    g = _gaps(rows, whole)
    assert g["loss_gap"] <= 1e-6 and g["grad_gap"] <= 1e-5 and g["change_gap"] <= 1e-5, g
    assert any(not torch.equal(rows["grads"][k], whole["grads"][k]) for k in whole["grads"])
