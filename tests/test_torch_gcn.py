"""The port's GCN pieces against the JAX package on the same numpy inputs:
the gcn_agg kernel module (kernels/gcn_agg.py) against
`pallas/gcn_agg.py` in interpret mode, `ops/segment.py::gcn_aggregate`
against the JAX fallback, and `nn/convs.py::GCNConv` with a KANLinear or a
FastKANLayer transform against the JAX `fused=False` path, plus the two
reference quirks the port copies: the in-degree cast to bf16 before the +1
(a degree above 256 rounds) and the f32 bias that promotes the conv's bf16
output to f32.

On the CPU the gcn_agg wrapper runs its plain PyTorch version; the CUDA
kernel is held against it on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances:
  * f32 values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5: the
    same f32 arithmetic in another summation order. Against the JAX
    gcn_agg kernel, whose one-hot MXU segment sum carries each f32 message
    as a bf16 hi/lo pair (16 significant bits), the rtol applies to the
    output's scale (max |jax|);
  * bf16: max |port - jax| <= 4 bf16 ulps (4 * 2^-8) of the output's scale:
    both round the same f32 sums to bf16 once; through a whole conv
    (transform, scale, aggregate, bias) 8 ulps, since PyTorch and XLA may
    round the elementwise steps between the kernels at other points."""
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
from kagnn_tpu.pallas.gcn_agg import gcn_aggregate as jax_gcn_agg
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import gcn_agg as ga
from kagnn_tpu_torch.nn import GCNConv, fastkan_transform, kan_transform
from kagnn_tpu_torch.nn import convs
from kagnn_tpu_torch.ops import segment

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, dt, grad=False, err_msg="", scaled=False, ulps=4):
    got, want = _np32(got), _np32(want)
    if dt == "f32" and not scaled:
        np.testing.assert_allclose(got, want, err_msg=err_msg,
                                   **(GRAD if grad else VAL))
        return
    c = (GRAD if grad else VAL)["rtol"] if dt == "f32" else ulps * BF16_ULP
    tol = c * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{err_msg}: max err {err} > {tol}"


def _graphs(rng, n=40, e=160, f=8, hub=0):
    """A random graph; with hub > 0, node 0 receives `hub` more edges, one
    from each of the first `hub` nodes."""
    snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
    if hub:
        snd = np.concatenate([snd, np.arange(hub)])
        rcv = np.concatenate([rcv, np.zeros(hub, np.int64)])
    nodes = (rng.normal(size=(n, f)) * 0.5).astype(np.float32)
    return (jax_single_graph(snd, rcv, nodes=nodes),
            single_graph(snd, rcv, nodes=nodes, device="cpu"))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gcn_agg_value_and_dhs_match_jax(rng, dt):
    """out = dinv ⊙ (A·hs + hs) and its VJP dhs = Aᵀ(dout·dinv) + dout·dinv
    against the JAX kernel in interpret mode; dinv gets no gradient."""
    jd, td = DTYPES[dt]
    gj, gt = _graphs(rng)
    n = gt.n_node_pad
    hs = rng.normal(size=(n, 8)).astype(np.float32)
    dinv = np.array(jnp.asarray(rng.uniform(0.2, 1.0, n), jd)
                      .astype(jnp.float32))  # values of the compute dtype
    nm = gt.node_mask.numpy()
    cot = rng.normal(size=(n, 8)).astype(np.float32) * nm[:, None]
    out_j, vjp = jax.vjp(lambda h: jax_gcn_agg(h, gj, jnp.asarray(dinv),
                                               interpret=True),
                         jnp.asarray(hs, jd))
    (dhs_j,) = vjp(jnp.asarray(cot, jd))
    ht = torch.from_numpy(hs).to(td).requires_grad_(True)
    dt_ = torch.from_numpy(dinv).requires_grad_(True)
    out_t = ga.gcn_aggregate_fused(ht, gt, dt_)
    out_t.backward(torch.from_numpy(cot).to(td))
    assert out_t.dtype == td and ht.grad.dtype == td and dt_.grad is None
    close(out_t[gt.node_mask], _np32(out_j)[nm], dt, err_msg="out",
          scaled=True)
    close(ht.grad, dhs_j, dt, grad=True, err_msg="dhs", scaled=True)


@pytest.mark.parametrize("fused", [True, False])
def test_gcn_aggregate_matches_jax_fallback(rng, fused):
    """ops.segment.gcn_aggregate, kernel path and plain path, against the
    JAX fallback (neighbor_sum + epilogue) in f32, value and dhs."""
    gj, gt = _graphs(rng)
    n = gt.n_node_pad
    hs = rng.normal(size=(n, 6)).astype(np.float32)
    dinv = rng.uniform(0.2, 1.0, n).astype(np.float32)
    cot = rng.normal(size=(n, 6)).astype(np.float32)
    with jsegment.use_pallas_spmm(False):
        out_j, vjp = jax.vjp(lambda h: jsegment.gcn_aggregate(
            h, gj, jnp.asarray(dinv)), jnp.asarray(hs))
        (dhs_j,) = vjp(jnp.asarray(cot))
    ht = torch.from_numpy(hs).requires_grad_(True)
    out_t = segment.gcn_aggregate(ht, gt, torch.from_numpy(dinv), fused=fused)
    out_t.backward(torch.from_numpy(cot))
    close(out_t, out_j, "f32", err_msg="out")
    close(ht.grad, dhs_j, "f32", grad=True, err_msg="dhs")


def _port_conv(arch, fin, fout, variables, fused, cd=None):
    kw = dict(fused=fused, compute_dtype=cd, device="cpu")
    make = kan_transform(**kw) if arch == "kan" else fastkan_transform(**kw)
    conv = GCNConv(fin, fout, make, fused=fused, device="cpu")
    p = variables["params"]
    sd = {"bias": p["bias"]}
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


def _jax_conv(arch, fin, fout, fused=False, cd=None):
    """The JAX GCNConv with the transform NodeClassifier gives it."""
    def make(i, o):
        if arch == "kan":
            return JKANLinear(i, o, grid_size=4, fused=fused, compute_dtype=cd)
        return JFastKANLayer(i, o, num_grids=4, fused=fused, compute_dtype=cd)
    return jconvs.GCNConv(fin, fout, transform=make)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch", ["kan", "fastkan"])
def test_gcnconv_matches_jax(rng, arch, fused):
    """GCNConv with each transform: value and every parameter gradient of a
    masked loss against the JAX fused=False module."""
    fin, fout = 8, 6
    gj, gt = _graphs(rng, f=fin)
    nm = gt.node_mask.numpy()
    jm = _jax_conv(arch, fin, fout)
    with jsegment.use_pallas_spmm(False):
        v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), gj, gj.nodes))

        def jloss(params):
            o = jm.apply(dict(v, params=params), gj, gj.nodes)
            return jnp.sum(jnp.where(gj.node_mask[:, None], jnp.sin(o), 0.0)), o

        (_, out_j), gp = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    conv = _port_conv(arch, fin, fout, v, fused)
    out = conv(gt, gt.nodes)
    close(out[gt.node_mask], np.asarray(out_j)[nm], "f32", err_msg="out")
    torch.where(gt.node_mask[:, None], torch.sin(out),
                torch.zeros(())).sum().backward()
    want = _port_conv(arch, fin, fout, dict(v, params=gp), False).state_dict()
    for name, p in conv.named_parameters():
        close(p.grad, want[name], "f32", grad=True, err_msg=name)


def test_bf16_degree_rounds_before_the_plus_one(rng):
    """A node of in-degree 301: under bf16 the degree is cast before the +1
    and the rsqrt, as in the JAX layer, so d = bf16(bf16(301) + 1) = 302,
    not 302 from an exact count; the port's degrees and norms equal the JAX
    ones bit for bit at every node."""
    gj, gt = _graphs(rng, n=310, e=200, hub=301)
    assert int(gt.in_degrees[0]) >= 301
    deg_t = convs._degree_with_self_loops(gt, torch.bfloat16)
    deg_j = jconvs._degree_with_self_loops(gj, jnp.bfloat16)
    np.testing.assert_array_equal(_np32(deg_t), _np32(deg_j))
    exact = gt.in_degrees.float() + 1.0
    assert (deg_t.float() != exact).any()  # some degree rounded
    np.testing.assert_array_equal(_np32(torch.rsqrt(deg_t)),
                                  _np32(jax.lax.rsqrt(deg_j)))


@pytest.mark.parametrize("arch", ["kan", "fastkan"])
def test_gcnconv_bf16_output_is_f32_and_matches_jax_fused(rng, arch):
    """Under a bf16 compute dtype the f32 bias promotes the conv's output
    to f32 on both sides (so the model's MaskedBatchNorm runs in f32 on the
    GCN path). Port kernel path against the JAX fused module (Pallas
    kernels in interpret mode) on the graph with the in-degree-301 hub."""
    fin, fout = 8, 6
    gj, gt = _graphs(rng, n=310, e=200, f=fin, hub=301)
    nm = gt.node_mask.numpy()
    jm = _jax_conv(arch, fin, fout, fused=True, cd=jnp.bfloat16)
    with jsegment.use_pallas_spmm(True, interpret=True):
        v = jax.tree.map(np.asarray, jm.init(jax.random.key(1), gj, gj.nodes))
        out_j = jm.apply(v, gj, gj.nodes)
    conv = _port_conv(arch, fin, fout, v, True, torch.bfloat16)
    out_t = conv(gt, gt.nodes)
    assert out_j.dtype == jnp.float32 and out_t.dtype == torch.float32
    close(out_t[gt.node_mask], np.asarray(out_j)[nm], "bf16", ulps=8)


def test_cpu_wrapper_runs_plain_and_counts_no_launch(rng):
    gj, gt = _graphs(rng, n=20, e=60, f=4)
    before = ga.gcn_agg_fwd.launches
    ga.gcn_agg_fwd(gt.nodes, torch.ones(gt.n_node_pad), gt.senders,
                   gt.recv_row_ptr, gt.receivers)
    assert ga.gcn_agg_fwd.launches == before
