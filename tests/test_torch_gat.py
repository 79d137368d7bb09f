"""The port's GAT pieces against the JAX package on the same numpy inputs:
`segment_max`, `segment_softmax`, `neighbor_sum_attn` and `gat_attention`
(ops/segment.py) against the JAX ops, the plain versions of the three GAT
kernels (kernels/gat_fused.py, kernels/gat_bwd.py) against
`pallas/gat_fused.py` and `pallas/gat_bwd.py` in interpret mode, the
`GatAttention` custom VJP against `gat_attention_fused`, and `GATConv`
against the JAX layer.

On the CPU every wrapper runs its plain PyTorch version; the CUDA kernels
are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances (measured worst beside each, on these seeds):
  * f32 against the JAX plain ops and fused=False modules: values rtol 1e-4
    / atol 1e-5, gradients rtol 1e-3 / atol 1e-5, the same f32 arithmetic
    in another order;
  * f32 against the JAX GAT kernels, whose weighted sums and per-head dots
    carry f32 operands as bf16 hi/lo pairs (about 16 significant bits): the
    rtol applies to the output's scale, max |jax| (worst 2.1e-5 of the
    scale for values against 1e-4, 2.0e-4 for gradients against 1e-3);
  * bf16: 4 bf16 ulps (4 * 2^-8) of the output's scale per kernel (worst
    0.32 ulps), 8 through a whole conv (worst 0.23)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.kan.layers import FastKANLayer as JFastKANLayer
from kagnn_tpu.kan.layers import KANLinear as JKANLinear
from kagnn_tpu.nn import convs as jconvs
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.pallas.gat_bwd import gat_bwd_dadst, gat_bwd_sender
from kagnn_tpu.pallas.gat_fused import IMAX, _gat_fwd_parts, gat_attention_fused
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import gat_bwd as gbw
from kagnn_tpu_torch.kernels import gat_fused as gfu
from kagnn_tpu_torch.nn import GATConv, fastkan_transform, kan_transform
from kagnn_tpu_torch.ops import segment

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
SLOPE = 0.2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def close(got, want, dt, grad=False, err_msg="", scaled=False, ulps=4):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    if dt == "f32" and not scaled:
        np.testing.assert_allclose(got, want, err_msg=err_msg,
                                   **(GRAD if grad else VAL))
        return
    c = (GRAD if grad else VAL)["rtol"] if dt == "f32" else ulps * BF16_ULP
    tol = c * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{err_msg}: max err {err} > {tol}"


def _graphs(rng, n=200, e=900, isolated=30, f=8, edge_pad=128):
    """A random graph whose last `isolated` nodes receive no edge."""
    snd = rng.integers(0, n, e)
    rcv = rng.integers(0, n - isolated, e)
    nodes = (rng.normal(size=(n, f)) * 0.5).astype(np.float32)
    kw = dict(nodes=nodes, edge_pad_multiple=edge_pad)
    return (jax_single_graph(snd, rcv, **kw),
            single_graph(snd, rcv, device="cpu", **kw))


def _attention_inputs(rng, n, heads, c, jd):
    """h (n, H*C), amat (H*C, H) from an att (H, C) rounded as GATConv
    rounds it, asrc = h @ amat (the JAX layer's dot), adst (n, H)."""
    h = rng.normal(size=(n, heads * c)).astype(np.float32)
    att = (rng.normal(size=(heads, c)) * 0.3).astype(np.float32)
    amat = (att[:, :, None] * np.eye(heads)[:, None, :]).reshape(heads * c, heads)
    amat = _np32(jnp.asarray(amat, jd))
    hj = jnp.asarray(h, jd)
    asrc = _np32(jax.lax.dot_general(hj, jnp.asarray(amat, jd),
                                     (((1,), (0,)), ((), ())),
                                     preferred_element_type=jnp.float32))
    adst = rng.normal(size=(n, heads)).astype(np.float32)
    return _np32(hj), amat, asrc, adst


def test_segment_max_and_softmax_match_jax(rng):
    """segment_max (an empty segment gives -inf) and segment_softmax with a
    mask and extra logits, values and the gradient of a weighted sum of
    both outputs through logits and extra logits."""
    e, n, heads = 300, 40, 3
    seg = np.sort(rng.integers(0, n - 5, e)).astype(np.int32)
    logits = rng.normal(size=(e, heads)).astype(np.float32) * 3
    extra = rng.normal(size=(n, heads)).astype(np.float32)
    mask = rng.random(e) > 0.2
    we, wx = (rng.normal(size=(e, heads)).astype(np.float32),
              rng.normal(size=(n, heads)).astype(np.float32))
    np.testing.assert_array_equal(
        _np32(segment.segment_max(torch.from_numpy(logits),
                                  torch.from_numpy(seg), n)),
        _np32(jsegment.segment_max(jnp.asarray(logits), jnp.asarray(seg), n)))

    def jloss(lg, ex):
        a, b = jsegment.segment_softmax(lg, jnp.asarray(seg), n,
                                        mask=jnp.asarray(mask),
                                        extra_logits=ex)
        return jnp.sum(a * we) + jnp.sum(b * wx), (a, b)

    (_, (ja, jb)), (jgl, jge) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                             jnp.asarray(extra))
    lt = torch.from_numpy(logits).requires_grad_(True)
    et = torch.from_numpy(extra).requires_grad_(True)
    ta, tb = segment.segment_softmax(lt, torch.from_numpy(seg), n,
                                     mask=torch.from_numpy(mask),
                                     extra_logits=et)
    ((ta * torch.from_numpy(we)).sum() + (tb * torch.from_numpy(wx)).sum()
     ).backward()
    close(ta, ja, "f32", err_msg="edge weights")
    close(tb, jb, "f32", err_msg="extra weights")
    close(lt.grad, jgl, "f32", grad=True, err_msg="dlogits")
    close(et.grad, jge, "f32", grad=True, err_msg="dextra")


def test_neighbor_sum_attn_matches_jax(rng):
    """The attention-weighted aggregate and its gradients in x and in the
    weights, against the JAX fallback."""
    gj, gt = _graphs(rng, n=50, e=200, isolated=5)
    n, heads = gt.n_node_pad, 2
    x = rng.normal(size=(n, heads * 8)).astype(np.float32)
    w = rng.random((gt.n_edge_pad, heads)).astype(np.float32)
    cot = rng.normal(size=(n, heads * 8)).astype(np.float32)
    with jsegment.use_pallas_spmm(False):
        out_j, vjp = jax.vjp(lambda a, b: jsegment.neighbor_sum_attn(a, gj, b),
                             jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out_t = segment.neighbor_sum_attn(xt, gt, wt)
    out_t.backward(torch.from_numpy(cot))
    close(out_t, out_j, "f32", err_msg="out")
    close(xt.grad, dx_j, "f32", grad=True, err_msg="dx")
    close(wt.grad, dw_j, "f32", grad=True, err_msg="dw")


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gat_fwd_plain_matches_jax_kernel(rng, dt, c):
    """out and alpha of the plain forward against `_gat_fwd_parts` in
    interpret mode (the GATConv call: asrc recomputed from h and amat in
    the JAX kernel, read from the host in the port)."""
    jd, td = DTYPES[dt]
    gj, gt = _graphs(rng)
    n, heads = gt.n_node_pad, 2
    h, amat, asrc, adst = _attention_inputs(rng, n, heads, c, jd)
    out_j, (_, alpha_j) = _gat_fwd_parts(
        jnp.asarray(h, jd), jnp.asarray(asrc), jnp.asarray(adst),
        jnp.asarray(amat), gj.senders, gj.receivers, gj.edge_mask, heads,
        SLOPE, True)
    out_t, alpha_t = gfu.gat_fwd(torch.from_numpy(h).to(td),
                                 torch.from_numpy(asrc), torch.from_numpy(adst),
                                 gt.senders, gt.recv_row_ptr, gt.n_edge, SLOPE)
    assert out_t.dtype == td and alpha_t.dtype == torch.float32
    close(out_t, out_j, dt, err_msg="out", scaled=True)
    close(alpha_t, alpha_j, "f32", err_msg="alpha", scaled=True)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gat_bwd_plain_match_jax_kernels(rng, dt):
    """dadst, dh and dasrc of the plain backward versions against
    `gat_bwd_dadst` and `gat_bwd_sender` in interpret mode, fed as the JAX
    backward feeds them (tests/test_gat_bwd.py): the forward's alpha, S and
    the sender-order gathers."""
    jd, td = DTYPES[dt]
    gj, gt = _graphs(rng, n=300, e=1200, isolated=40)
    n, heads, c = gt.n_node_pad, 2, 16
    hc = heads * c
    h, amat, asrc, adst = _attention_inputs(rng, n, heads, c, jd)
    dout = _np32(jnp.asarray(rng.normal(size=(n, hc)), jd))
    hj, dj = jnp.asarray(h, jd), jnp.asarray(dout, jd)
    out_j, (msgs, alpha) = _gat_fwd_parts(
        hj, jnp.asarray(asrc), jnp.asarray(adst), jnp.asarray(amat),
        gj.senders, gj.receivers, gj.edge_mask, heads, SLOPE, True)
    s = jnp.sum((dj * out_j).astype(jnp.float32).reshape(n, heads, c), axis=2)
    recv_m = jnp.where(gj.edge_mask, gj.receivers, IMAX)
    dadst_j = gat_bwd_dadst(msgs, recv_m, dj, jnp.asarray(adst), alpha, s,
                            jnp.asarray(amat), heads, hc, SLOPE, interpret=True)

    def hilo(x):
        hi = x.astype(jnp.bfloat16)
        return hi.astype(jd), (x - hi.astype(jnp.float32)).astype(jnp.bfloat16).astype(jd)

    nrw = jnp.concatenate([*hilo(jnp.asarray(adst)), *hilo(alpha), *hilo(s)],
                          axis=1)
    rbs = gj.receivers_by_sender
    snd_m = jnp.where(gj.edge_mask_by_sender, gj.senders_sorted, IMAX)
    dh_j, dasrc_j = gat_bwd_sender(
        (jnp.take(dj, rbs, axis=0),), jnp.take(nrw, rbs, axis=0), snd_m, hj,
        jnp.asarray(amat), heads, hc, SLOPE, interpret=True,
        part_widths=(hc,))
    t = {k: torch.from_numpy(_np32(v)) for k, v in
         dict(asrc=asrc, adst=adst, alpha=alpha, s=s).items()}
    ht, dt_ = torch.from_numpy(h).to(td), torch.from_numpy(dout).to(td)
    dadst_t = gbw.gat_dadst(ht, t["asrc"], t["adst"], t["alpha"], t["s"], dt_,
                            gt.senders, gt.recv_row_ptr, gt.n_edge, SLOPE)
    dh_t, dasrc_t = gbw.gat_sender(ht, t["asrc"], t["adst"], t["alpha"],
                                   t["s"], dt_, gt.receivers_by_sender,
                                   gt.send_row_ptr, gt.n_edge, SLOPE)
    for name, a, b in (("dadst", dadst_t, dadst_j), ("dh", dh_t, dh_j),
                       ("dasrc", dasrc_t, dasrc_j)):
        assert a.dtype == torch.float32
        close(a, b, "f32", grad=True, err_msg=name, scaled=True)


@pytest.mark.parametrize("with_amat", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gat_attention_fused_matches_jax(rng, dt, with_amat):
    """gat_attention(fused=True) (GatAttention over the plain versions)
    against `gat_attention_fused` in interpret mode: values and the
    gradients in h, asrc and adst of a nonlinear loss. Without the logit
    matrix both round a free-standing f32 asrc to h's dtype in the kernels
    and read it unrounded in the backward's self terms."""
    jd, td = DTYPES[dt]
    gj, gt = _graphs(rng)
    n, heads, c = gt.n_node_pad, 2, 16
    h, amat, asrc, adst = _attention_inputs(rng, n, heads, c, jd)
    if not with_amat:
        asrc = asrc + rng.normal(size=asrc.shape).astype(np.float32) * 0.01
    am_j = jnp.asarray(amat) if with_amat else None
    am_t = torch.from_numpy(amat) if with_amat else None

    def jloss(a, b, d):
        o = gat_attention_fused(a, b, d, gj, SLOPE, True, att_src_matrix=am_j)
        o32 = o.astype(jnp.float32)
        return jnp.sum(o32 * jnp.cos(o32)), o

    (_, out_j), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(h, jd), jnp.asarray(asrc), jnp.asarray(adst))
    ins = [torch.from_numpy(h).to(td), torch.from_numpy(asrc),
           torch.from_numpy(adst)]
    ins = [t.requires_grad_(True) for t in ins]
    out_t = segment.gat_attention(*ins, gt, SLOPE, att_src_matrix=am_t,
                                  fused=True)
    o32 = out_t.float()
    (o32 * torch.cos(o32)).sum().backward()
    assert out_t.dtype == td and ins[0].grad.dtype == td
    close(out_t, out_j, dt, err_msg="out", scaled=True)
    for name, a, b in zip(("dh", "dasrc", "dadst"), ins, grads_j):
        close(a.grad, b, dt, grad=True, err_msg=name, scaled=True)


def test_gat_attention_plain_path_matches_jax_fallback(rng):
    """gat_attention(fused=False), the segment_softmax + neighbor_sum_attn
    composition, and the kernel path on the CPU, both against the JAX
    fallback in f32 with its gradients."""
    gj, gt = _graphs(rng)
    n, heads, c = gt.n_node_pad, 2, 8
    h, amat, asrc, adst = _attention_inputs(rng, n, heads, c, jnp.float32)

    def jloss(a, b, d):
        o = jsegment.gat_attention(a, b, d, gj, SLOPE)
        return jnp.sum(o * jnp.cos(o)), o

    with jsegment.use_pallas_spmm(False):
        (_, out_j), grads_j = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h), jnp.asarray(asrc), jnp.asarray(adst))
    for fused in (False, True):
        ins = [torch.from_numpy(a).requires_grad_(True) for a in (h, asrc, adst)]
        out_t = segment.gat_attention(*ins, gt, SLOPE, fused=fused)
        (out_t * torch.cos(out_t)).sum().backward()
        close(out_t, out_j, "f32", err_msg=f"out fused={fused}")
        for name, a, b in zip(("dh", "dasrc", "dadst"), ins, grads_j):
            close(a.grad, b, "f32", grad=True, err_msg=f"{name} fused={fused}")


def test_gat_isolated_nodes_large_logits_and_padded_edges(rng):
    """An isolated node's output is its own h and its alpha its self
    logit; logits of magnitude ~100 stay finite in values and gradients;
    the padded edges, which all point at the pad row, take no part: the pad
    row's softmax holds only its self-loop, as in the JAX kernel."""
    gj, gt = _graphs(rng, n=120, e=400, isolated=20, edge_pad=512)
    n, heads, c = gt.n_node_pad, 2, 8
    assert gt.n_edge_pad - gt.n_edge > 100  # many padded edges at the pad row
    h = rng.normal(size=(n, heads * c)).astype(np.float32)
    asrc = (rng.normal(size=(n, heads)) * 30).astype(np.float32)
    adst = (rng.normal(size=(n, heads)) * 30).astype(np.float32)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (h, asrc, adst)]
    out, alpha = gfu.gat_fwd(*[t.detach() for t in ins], gt.senders,
                             gt.recv_row_ptr, gt.n_edge, SLOPE)
    deg = gt.in_degrees.numpy()
    lonely = np.flatnonzero(deg == 0)
    assert n - 1 in lonely and lonely.size > 20
    np.testing.assert_allclose(out.numpy()[lonely], h[lonely], rtol=1e-6,
                               atol=1e-6)
    zs = asrc[lonely] + adst[lonely]
    np.testing.assert_allclose(alpha.numpy()[lonely],
                               np.where(zs >= 0, zs, SLOPE * zs), rtol=1e-6,
                               atol=1e-5)
    out_t = segment.gat_attention(*ins, gt, SLOPE, fused=True)
    (out_t * torch.cos(out_t)).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in ins)

    def jloss(a, b, d):
        o = gat_attention_fused(a, b, d, gj, SLOPE, True)
        return jnp.sum(o * jnp.cos(o)), o

    (_, out_j), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(h), jnp.asarray(asrc), jnp.asarray(adst))
    close(out_t, out_j, "f32", err_msg="out", scaled=True)
    for name, a, b in zip(("dh", "dasrc", "dadst"), ins, grads_j):
        close(a.grad, b, "f32", grad=True, err_msg=name, scaled=True)


def _port_conv(arch, fin, hidden, heads, variables, fused, cd=None):
    kw = dict(fused=fused, compute_dtype=cd, device="cpu")
    make = kan_transform(**kw) if arch == "kan" else fastkan_transform(**kw)
    conv = GATConv(fin, hidden, heads, make, fused=fused, device="cpu")
    p = variables["params"]
    sd = {k: p[k] for k in ("att_src", "att_dst", "bias")}
    if arch == "kan":
        sd.update({f"transform.{k}": v for k, v in p["KANLinear_0"].items()})
        sd["transform.grid"] = variables["buffers"]["KANLinear_0"]["grid"]
    else:
        t = p["FastKANLayer_0"]
        sd.update({"transform.spline_linear.weight": t["spline_weight"],
                   "transform.base_linear.weight": t["base_weight"],
                   "transform.base_linear.bias": t["base_bias"],
                   "transform.layernorm.weight": t["layernorm"]["scale"],
                   "transform.layernorm.bias": t["layernorm"]["bias"]})
    conv.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return conv


def _jax_conv(arch, fin, hidden, heads, fused=False, cd=None):
    """The JAX GATConv with the transform NodeClassifier gives it."""
    def make(i, o):
        if arch == "kan":
            return JKANLinear(i, o, grid_size=4, fused=fused, compute_dtype=cd)
        return JFastKANLayer(i, o, num_grids=4, fused=fused, compute_dtype=cd)
    return jconvs.GATConv(fin, hidden, heads=heads, transform=make)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch", ["kan", "fastkan"])
def test_gatconv_matches_jax(rng, arch, fused):
    """GATConv with each transform: value and every parameter gradient of a
    masked loss against the JAX fused=False module, in f32."""
    fin, hidden, heads = 8, 8, 2
    gj, gt = _graphs(rng, n=60, e=240, isolated=6, f=fin)
    nm = gt.node_mask.numpy()
    jm = _jax_conv(arch, fin, hidden, heads)
    with jsegment.use_pallas_spmm(False):
        v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), gj, gj.nodes))

        def jloss(params):
            o = jm.apply(dict(v, params=params), gj, gj.nodes)
            return jnp.sum(jnp.where(gj.node_mask[:, None], jnp.sin(o), 0.0)), o

        (_, out_j), gp = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    conv = _port_conv(arch, fin, hidden, heads, v, fused)
    out = conv(gt, gt.nodes)
    close(out[gt.node_mask], np.asarray(out_j)[nm], "f32", err_msg="out")
    torch.where(gt.node_mask[:, None], torch.sin(out),
                torch.zeros(())).sum().backward()
    want = _port_conv(arch, fin, hidden, heads, dict(v, params=gp),
                      False).state_dict()
    for name, p in conv.named_parameters():
        close(p.grad, want[name], "f32", grad=True, err_msg=name)


@pytest.mark.parametrize("arch", ["kan", "fastkan"])
def test_gatconv_bf16_matches_jax_fused(rng, arch):
    """Under a bf16 compute dtype the logit matrices are rounded once and
    the f32 bias promotes the conv's output to f32 on both sides. Port
    kernel path against the JAX fused module (Pallas kernels in interpret
    mode), values within 8 bf16 ulps of the output's scale."""
    fin, hidden, heads = 8, 8, 2
    gj, gt = _graphs(rng, n=60, e=240, isolated=6, f=fin)
    nm = gt.node_mask.numpy()
    jm = _jax_conv(arch, fin, hidden, heads, fused=True, cd=jnp.bfloat16)
    with jsegment.use_pallas_spmm(True, interpret=True):
        v = jax.tree.map(np.asarray, jm.init(jax.random.key(1), gj, gj.nodes))
        out_j = jm.apply(v, gj, gj.nodes)
    conv = _port_conv(arch, fin, hidden, heads, v, True, torch.bfloat16)
    out_t = conv(gt, gt.nodes)
    assert out_j.dtype == jnp.float32 and out_t.dtype == torch.float32
    close(out_t[gt.node_mask], np.asarray(out_j)[nm], "bf16", ulps=8)


def test_gatconv_init_draws_from_the_generator():
    """att_src and att_dst (1, H, C) within flax's glorot bound
    sqrt(6 / (H + C)), the same for the same generator seed; the bias
    starts at zero."""
    def make(seed):
        return GATConv(8, 16, 4, kan_transform(device="cpu"), device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    bound = (6.0 / (4 + 16)) ** 0.5
    assert a.att_src.shape == (1, 4, 16) and a.bias.shape == (64,)
    assert a.att_src.abs().max() <= bound and a.att_dst.abs().max() <= bound
    assert torch.equal(a.att_dst, b.att_dst)
    assert not torch.equal(a.att_src, c.att_src)
    assert not a.bias.any()


def test_cpu_wrappers_run_plain_and_count_no_launch(rng):
    _, gt = _graphs(rng, n=30, e=80, isolated=3)
    n, heads, c = gt.n_node_pad, 2, 8
    h = torch.randn(n, heads * c)
    a = torch.randn(n, heads)
    fns = (gfu.gat_fwd, gbw.gat_dadst, gbw.gat_sender)
    before = [f.launches for f in fns]
    gfu.gat_fwd(h, a, a, gt.senders, gt.recv_row_ptr, gt.n_edge, SLOPE)
    gbw.gat_dadst(h, a, a, a, a, h, gt.senders, gt.recv_row_ptr, gt.n_edge,
                  SLOPE)
    gbw.gat_sender(h, a, a, a, a, h, gt.receivers_by_sender, gt.send_row_ptr,
                   gt.n_edge, SLOPE)
    assert [f.launches for f in fns] == before
