"""The plain float32 reference of a full-batch KAN node-classification
train step: GIN or GAT convs with B-spline KANLinear layers, MaskedBatchNorm,
a KANLinear head, masked cross-entropy and Adam.

It follows the KAGNN reference (arXiv:2406.18380; efficient-kan's `ekan.py`
KANLinear, PyG's GINConv sum and GATConv attention with its implicit
self-loop, BatchNorm over the labelled graph's nodes, `F.cross_entropy` on
the training nodes, `torch.optim.Adam`'s update) in plain PyTorch on the raw
edge list, with TF32 off. It imports nothing of the program: the knots, the
edge orderings, the degrees and the per-step state are worked out here
again. Parameters are named as the program's state_dict names them, so one
dict of weights fills both sides.

Departures from the published reference, each also the program's: GIN's eps
is 0 and not trained; BatchNorm's running statistics are not kept (a train
step never reads them); dropout is 0.

At any size it holds a bounded amount at a time: the gathers and scatters
over the edges run in blocks of at most `EDGE_BLOCK_BYTES` of gathered rows,
in edge order, forward and backward (`_NeighborSum`, `_WeightedNeighborSum`);
a KAN layer whose B-spline basis would pass `BASIS_BLOCK_BYTES` is computed
in blocks of rows, each recomputed in the backward. The arithmetic and its
rounding points are those of the one-shot form; two sums add in another
order: the blocked KAN layer's weight gradients (its blocks' partial sums)
and GAT's senders' gradient (`_WeightedNeighborSum`).

`rounding` puts a lower precision in the reference's place, for the
control: a function applied where the program rounds to its compute dtype
(the features, each KAN layer's input, weights and output, the attention's
output, BatchNorm's output), in the forward and to the gradient flowing back.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
BN_EPS = 1e-5
GAT_SLOPE = 0.2
# the most bytes of gathered edge rows, and of a KAN layer's knot-wide basis,
# held at a time; the arxiv-sized cells take one block of each
EDGE_BLOCK_BYTES = 2 ** 31
BASIS_BLOCK_BYTES = 2 ** 31


def blocks(n: int, row_bytes: int, budget: int) -> list[tuple[int, int]]:
    """[start, end) ranges covering n rows, in order, of at most `budget`
    bytes at `row_bytes` a row (at least one row each)."""
    step = max(1, budget // max(1, row_bytes))
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def kan_layers(config: dict, num_features: int, num_classes: int):
    """(prefix, fan_in, fan_out) of every KANLinear, in the program's names."""
    H, heads = config["hidden_channels"], config.get("heads", 1)
    out = []
    for i in range(config["mp_layers"]):
        if config["conv_type"] == "gin":
            fin = num_features if i == 0 else H
            sizes = [fin] + [H] * (config["hidden_layers"] - 1) + [H]
            out += [(f"convs.{i}.update.layers.{j}", a, b)
                    for j, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))]
        elif config["conv_type"] == "gat":
            fin = num_features if i == 0 else H * heads
            out.append((f"convs.{i}.transform", fin, H * heads))
        else:
            raise ValueError(f"no reference for conv_type {config['conv_type']!r}")
    out.append(("head", H * heads if config["conv_type"] == "gat" else H, num_classes))
    return out


def param_specs(config: dict, num_features: int, num_classes: int):
    """(name, shape, bound) of every parameter: U(-bound, bound), or
    ("const", v). KANLinear: efficient-kan's kaiming bound 1/sqrt(fan_in)
    for the base weight and the spline scaler, the spline coefficients
    within scale_noise / grid_size (efficient-kan fits noise of half that
    amplitude); GAT: glorot's sqrt(6 / (heads + C)) for the attention
    vectors, a zero bias; BatchNorm: ones and zeros."""
    G, k = config["grid_size"], config["spline_order"]
    H, heads = config["hidden_channels"], config.get("heads", 1)
    specs = []
    for prefix, fin, fout in kan_layers(config, num_features, num_classes):
        specs += [(f"{prefix}.base_weight", (fout, fin), 1.0 / math.sqrt(fin)),
                  (f"{prefix}.spline_weight", (fout, fin, G + k), 0.1 / G),
                  (f"{prefix}.spline_scaler", (fout, fin), 1.0 / math.sqrt(fin))]
    width = H * heads if config["conv_type"] == "gat" else H
    for i in range(config["mp_layers"]):
        if config["conv_type"] == "gat":
            bound = math.sqrt(6.0 / (heads + H))
            specs += [(f"convs.{i}.att_src", (1, heads, H), bound),
                      (f"convs.{i}.att_dst", (1, heads, H), bound),
                      (f"convs.{i}.bias", (H * heads,), ("const", 0.0))]
        specs += [(f"norms.{i}.weight", (width,), ("const", 1.0)),
                  (f"norms.{i}.bias", (width,), ("const", 0.0))]
    return specs


def knots(fin: int, grid_size: int, order: int, device) -> torch.Tensor:
    """efficient-kan's uniform extended grid on [-1, 1]: (fin, G + 2k + 1)."""
    h = 2.0 / grid_size
    pts = torch.arange(-order, grid_size + order + 1, dtype=torch.float32, device=device)
    return (pts * h - 1.0).expand(fin, -1).contiguous()


def b_splines(x: torch.Tensor, grid: torch.Tensor, order: int) -> torch.Tensor:
    """efficient-kan `KANLinear.b_splines`: (N, D) -> (N, D, G + k)."""
    x = x.unsqueeze(-1)
    bases = ((x >= grid[:, :-1]) & (x < grid[:, 1:])).to(x.dtype)
    for k in range(1, order + 1):
        bases = ((x - grid[:, :-(k + 1)]) / (grid[:, k:-1] - grid[:, :-(k + 1)]) * bases[..., :-1]
                 + (grid[:, k + 1:] - x) / (grid[:, k + 1:] - grid[:, 1:-k]) * bases[..., 1:])
    return bases


def kan_linear(x, p: dict, prefix: str, grid, order: int, rnd: Callable):
    """SiLU(x) Wbᵀ + B(x) (Ws ⊙ scaler)ᵀ, recomputed in the backward (the
    basis of a 169k x 256 input and its ladder would not fit otherwise), in
    blocks of rows where the basis would pass `BASIS_BLOCK_BYTES`; the
    roundings apply to whole tensors (a float8 control's scale is the
    tensor's)."""
    wb, ws, sc = (p[f"{prefix}.{n}"] for n in ("base_weight", "spline_weight", "spline_scaler"))
    rows = blocks(x.shape[0], x.shape[1] * grid.shape[1] * 4, BASIS_BLOCK_BYTES)
    x, w_base, w_spline = rnd(x), rnd(wb), rnd(ws * sc[..., None])

    def f(x, w_base, w_spline):
        return F.silu(x) @ w_base.T + (b_splines(x, grid, order).reshape(x.shape[0], -1)
                                       @ w_spline.reshape(w_spline.shape[0], -1).T)

    parts = x.split([b - a for a, b in rows])
    return rnd(torch.cat([checkpoint(f, xb, w_base, w_spline, use_reentrant=False)
                          for xb in parts]))


def batch_norm(x, w, b):
    """Training-mode BatchNorm over every node of the graph (biased variance)."""
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) * torch.rsqrt(var + BN_EPS) * w + b


class _NeighborSum(torch.autograd.Function):
    """x + Σ_{edges j→i} x_j into row i: `x.index_add(0, rcv,
    x.index_select(0, snd))` and its autograd backward (the gradient plus
    its gather by receiver summed into the senders' rows), in blocks of
    edges."""

    @staticmethod
    def forward(ctx, x, snd, rcv):
        ctx.save_for_backward(snd, rcv)
        out = x.clone()
        for a, b in blocks(snd.shape[0], x.shape[1] * x.element_size(), EDGE_BLOCK_BYTES):
            out.index_add_(0, rcv[a:b], x.index_select(0, snd[a:b]))
        return out

    @staticmethod
    def backward(ctx, g):
        snd, rcv = ctx.saved_tensors
        s = torch.zeros_like(g)
        for a, b in blocks(snd.shape[0], g.shape[1] * g.element_size(), EDGE_BLOCK_BYTES):
            s.index_add_(0, snd[a:b], g.index_select(0, rcv[a:b]))
        return g + s, None, None


class _WeightedNeighborSum(torch.autograd.Function):
    """base + Σ_{edges j→i} alpha_e ⊙ h_j into row i, for h (N, heads, C)
    and alpha (E, heads): `base.index_add(0, rcv, h[snd] * alpha[..., None])`
    and its autograd backward, in blocks of edges. The senders' gradient is
    summed by `index_add_` in edge order, where autograd's backward of
    `h[snd]` sums in an order of its own: the one difference in rounding."""

    @staticmethod
    def forward(ctx, h, alpha, base, snd, rcv):
        ctx.save_for_backward(h, alpha, snd, rcv)
        out = base.clone()
        row = h[0].numel() * h.element_size()
        for a, b in blocks(snd.shape[0], row, EDGE_BLOCK_BYTES):
            out.index_add_(0, rcv[a:b], h[snd[a:b]] * alpha[a:b, :, None])
        return out

    @staticmethod
    def backward(ctx, g):
        h, alpha, snd, rcv = ctx.saved_tensors
        gh, galpha = torch.zeros_like(h), torch.empty_like(alpha)
        for a, b in blocks(snd.shape[0], h[0].numel() * h.element_size(), EDGE_BLOCK_BYTES):
            gm = g.index_select(0, rcv[a:b])
            galpha[a:b] = (gm * h[snd[a:b]]).sum(-1)
            gh.index_add_(0, snd[a:b], gm * alpha[a:b, :, None])
        return gh, galpha, g, None, None


def gin_sum(x, snd, rcv):
    """(1 + 0)·x_i + Σ_{edges j→i} x_j."""
    return _NeighborSum.apply(x, snd, rcv)


def gat_attention(h, att_src, att_dst, snd, rcv, heads: int):
    """PyG GATConv's attention over the edges and each node's implicit
    self-loop: LeakyReLU(0.2) logits, a softmax per receiver, the weighted
    sum of the senders' rows; heads concatenated."""
    n = h.shape[0]
    h3 = h.view(n, heads, -1)
    a_src, a_dst = (h3 * att_src).sum(-1), (h3 * att_dst).sum(-1)
    e_logit = F.leaky_relu(a_src[snd] + a_dst[rcv], GAT_SLOPE)
    s_logit = F.leaky_relu(a_src + a_dst, GAT_SLOPE)
    with torch.no_grad():
        top = s_logit.scatter_reduce(0, rcv[:, None].expand_as(e_logit), e_logit, "amax")
    e_exp, s_exp = torch.exp(e_logit - top[rcv]), torch.exp(s_logit - top)
    denom = s_exp.index_add(0, rcv, e_exp)
    alpha = e_exp / denom[rcv]
    out = _WeightedNeighborSum.apply(h3, alpha, h3 * (s_exp / denom)[..., None], snd, rcv)
    return out.reshape(n, -1)


def logits(p: dict, data: dict, config: dict, rnd: Callable) -> torch.Tensor:
    G, k = config["grid_size"], config["spline_order"]
    heads = config.get("heads", 1)
    snd, rcv = data["senders"], data["receivers"]
    grids = {}

    def layer(x, prefix):
        fin = x.shape[1]
        if fin not in grids:
            grids[fin] = knots(fin, G, k, x.device)
        return kan_linear(x, p, prefix, grids[fin], k, rnd)

    x = rnd(data["nodes"])
    for i in range(config["mp_layers"]):
        if config["conv_type"] == "gin":
            x = gin_sum(x, snd, rcv)
            for j in range(config["hidden_layers"]):
                x = layer(x, f"convs.{i}.update.layers.{j}")
        else:
            h = layer(x, f"convs.{i}.transform")
            x = rnd(gat_attention(h, p[f"convs.{i}.att_src"], p[f"convs.{i}.att_dst"],
                                  snd, rcv, heads)) + p[f"convs.{i}.bias"]
        x = rnd(batch_norm(x, p[f"norms.{i}.weight"], p[f"norms.{i}.bias"]))
    return layer(x, "head")


def masked_cross_entropy(out, labels, mask):
    return F.cross_entropy(out[mask], labels[mask])


def train(weights: dict, data: dict, config: dict, lr: float, steps: int,
          grad_step: int, rounding: Optional[Callable] = None,
          loss_mask: Optional[torch.Tensor] = None, loss: Optional[Callable] = None):
    """`steps` full-batch Adam steps from `weights`. Returns (the losses,
    the gradient of step `grad_step` by parameter, the parameters after the
    last step). `loss_mask` replaces `data["train_mask"]` in the loss (a
    fault the check must catch); `loss(params, data, config, rnd, mask)`,
    the loss of another model (by default `logits`' masked cross-entropy),
    lets another reference module train through this loop."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(weights, data, config, lr, steps, grad_step,
                      rounding or (lambda t: t),
                      data["train_mask"] if loss_mask is None else loss_mask,
                      loss or node_loss)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def node_loss(p: dict, data: dict, config: dict, rnd: Callable, mask) -> torch.Tensor:
    return masked_cross_entropy(logits(p, data, config, rnd), data["labels"], mask)


def _train(weights, data, config, lr, steps, grad_step, rnd, mask, loss_of):
    names = list(weights)
    params = {n: weights[n].detach().float().clone().requires_grad_() for n in names}
    m1 = {n: torch.zeros_like(v) for n, v in params.items()}
    m2 = {n: torch.zeros_like(v) for n, v in params.items()}
    (b1, b2), losses, grads = ADAM_BETAS, [], None
    for t in range(1, steps + 1):
        loss = loss_of(params, data, config, rnd, mask)
        gs = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        if t == grad_step:
            grads = {n: g.detach().clone() for n, g in zip(names, gs)}
        with torch.no_grad():
            for n, g in zip(names, gs):
                m1[n].mul_(b1).add_(g, alpha=1 - b1)
                m2[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (m2[n] / (1 - b2 ** t)).sqrt_().add_(ADAM_EPS)
                params[n].sub_(lr * (m1[n] / (1 - b1 ** t)) / denom)
    return losses, grads, {n: v.detach() for n, v in params.items()}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def rounding_to(dtype: torch.dtype) -> Callable:
    """Round to `dtype` and back to f32, in the forward and in the backward.
    A float8 format gets a per-tensor scale that maps the tensor's largest
    magnitude to the format's largest, as float8 training scales."""
    fmax = torch.finfo(dtype).max

    def fn(t):
        if dtype.itemsize >= 2:
            return t.to(dtype).float()
        scale = fmax / t.detach().abs().amax().float().clamp_min(1e-30)
        return (t * scale).to(dtype).float() / scale

    return lambda t: _Round.apply(t, fn)
