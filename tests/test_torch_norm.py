"""The port's `MaskedBatchNorm` (`kagnn_tpu_torch/ops/norm.py`) against the
JAX layer (`kagnn_tpu/ops/norm.py`) on the CPU, where it runs its plain
version, and the routing that sends a training forward on the card to the
fused kernels of `kernels/masked_bn.py` (held to the plain version on the
card by `tests/test_torch_cuda.py`).

  * two training steps in f32 and bf16, with no mask, a random mask and
    every row masked (the count clamps to 1): y, the running mean and
    variance after each step, and the gradients of x, weight and bias;
    masked rows come out zero in y and in dx; the running averages (eval);
  * `fused_route`: the plain path for CPU tensors, for dtypes other than
    f32 and bf16, for the running averages and under halo mode;
  * a CPU step launches no kernel and records the `kagnn.norm` span.

Tolerances: f32 values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol
1e-5 (the same f32 operations, sums in another order); bf16 outputs within
4 bf16 ulps of their largest magnitude (XLA on the CPU may keep a product in
f32 where PyTorch rounds it to bf16); the running buffers are f32 on both
sides."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.ops.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from kagnn_tpu_torch.kernels import launch_counters
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.ops.norm import MaskedBatchNorm, fused_route
from kagnn_tpu_torch.utils import profiling

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
N, C = 37, 5


def _np32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def close(got, want, dt, grad=False, what="", scale=None):
    got, want = _np32(got), _np32(want)
    if dt == "f32":
        np.testing.assert_allclose(got, want, err_msg=what, **(GRAD if grad else VAL))
        return
    if scale is None:
        scale = float(np.abs(want).max())
    tol = 4 * BF16_ULP * max(scale, 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} > {tol}"


def _param_grad_scale(x, dy, mask):
    """The scale of the bf16 weight and bias gradients before they cancel:
    both sides round the gradients of a and b (in x's dtype) to bf16, and
    dweight = rstd (da - mean db) then subtracts the two, so an ulp of
    rstd (|sum g x| + |mean| |sum g|) is the least their rounding costs."""
    x, g = _np32(x).astype(np.float64), _np32(dy).astype(np.float64)
    m = np.ones(N, bool) if mask is None else mask
    n = max(int(m.sum()), 1)
    mean = x[m].sum(0) / n
    rstd = 1.0 / np.sqrt(((x[m] - mean) ** 2).sum(0) / n + 1e-5)
    terms = np.abs((g * x)[m].sum(0)) + np.abs(mean) * np.abs(g[m].sum(0))
    return float((rstd * terms).max())


def _mask(kind, rng):
    if kind == "none":
        return None
    if kind == "random":
        m = rng.random(N) < 0.6
        m[:2] = True, False
        return m
    return np.zeros(N, bool)


def _pair(rng, dt):
    """The port's module and the JAX layer's variables with the same
    weight and bias."""
    w = (rng.normal(size=C) * 0.3 + 1.0).astype(np.float32)
    b = (rng.normal(size=C) * 0.2).astype(np.float32)
    bn = MaskedBatchNorm(C, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    jv = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
          "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    return bn, jv


def _inputs(rng, dt):
    """x (scaled and shifted, so the mean is far from 0) and dy, the same
    values on both sides (bf16 rounded first)."""
    td, jd = DTYPES[dt]
    x = torch.from_numpy((rng.normal(size=(N, C)) * 2.0 + 3.0).astype(np.float32)).to(td)
    dy = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32)).to(td)
    return x, dy, jnp.asarray(_np32(x), jd), jnp.asarray(_np32(dy), jd)


def _jax_step(jv, xj, dyj, mask):
    """The JAX layer's training forward and its vjp: y, the new batch
    stats and the cotangents of x and the parameters."""
    layer = JaxMaskedBatchNorm(C)
    mj = None if mask is None else jnp.asarray(mask)

    def f(params, x):
        y, mut = layer.apply({"params": params, "batch_stats": jv["batch_stats"]}, x,
                             mask=mj, use_running_average=False, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    y, vjp, stats = jax.vjp(f, jv["params"], xj, has_aux=True)
    dparams, dx = vjp(dyj.astype(y.dtype))
    return y, stats, dx, dparams


@pytest.mark.parametrize("kind", ["none", "random", "all_masked"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_two_training_steps_match_jax(dt, kind):
    rng = np.random.default_rng(7)
    bn, jv = _pair(rng, dt)
    bn.train()
    mask = _mask(kind, rng)
    mt = None if mask is None else torch.from_numpy(mask)
    for step in range(2):
        x, dy, xj, dyj = _inputs(rng, dt)
        x.requires_grad_(True)
        y = bn(x, mt)
        y.backward(dy)
        yj, stats, dxj, dpj = _jax_step(jv, xj, dyj, mask)
        jv = dict(jv, batch_stats=stats)
        what = f"step {step}"
        assert y.dtype == x.dtype
        close(y, yj, dt, what=f"{what} y")
        close(x.grad, dxj, dt, grad=True, what=f"{what} dx")
        scale = _param_grad_scale(x, dy, mask) if dt == "bf16" else None
        close(bn.weight.grad, dpj["scale"], dt, grad=True, what=f"{what} dweight",
              scale=scale)
        close(bn.bias.grad, dpj["bias"], dt, grad=True, what=f"{what} dbias", scale=scale)
        np.testing.assert_allclose(_np32(bn.running_mean), _np32(stats["mean"]), **VAL)
        np.testing.assert_allclose(_np32(bn.running_var), _np32(stats["var"]), **VAL)
        if mask is not None:
            assert not _np32(y)[~mask].any() and not _np32(x.grad)[~mask].any()
        bn.weight.grad = bn.bias.grad = None
    if kind == "all_masked":
        # n clamps to 1: mean 0, var 0, the running buffers only decay
        np.testing.assert_allclose(_np32(bn.running_mean), 0.0)
        np.testing.assert_allclose(_np32(bn.running_var), 0.9 ** 2, rtol=1e-6)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_running_averages_match_jax(dt):
    rng = np.random.default_rng(8)
    bn, jv = _pair(rng, dt)
    jv["batch_stats"] = {"mean": jnp.asarray(rng.normal(size=C), jnp.float32),
                         "var": jnp.asarray(rng.random(C) + 0.5, jnp.float32)}
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor(np.array(jv["batch_stats"]["mean"])))
        bn.running_var.copy_(torch.tensor(np.array(jv["batch_stats"]["var"])))
    bn.eval()
    x, _, xj, _ = _inputs(rng, dt)
    mask = _mask("random", rng)
    y = bn(x, torch.from_numpy(mask))
    yj = JaxMaskedBatchNorm(C).apply(jv, xj, mask=jnp.asarray(mask), use_running_average=True)
    close(y, yj, dt)
    assert not _np32(y)[~mask].any()


def _like(device, dtype):
    """What fused_route reads of x: its device and dtype (a CUDA device
    needs no card to be named)."""
    class X:
        pass
    x = X()
    x.device, x.dtype = torch.device(device), dtype
    return x


def _halo():
    return segment.halo_mode(segment.HaloState(
        axis=object(), n_local=4, send_idx=torch.zeros((2, 1), dtype=torch.int64),
        send_mask=torch.zeros((2, 1), dtype=torch.bool)))


@pytest.mark.parametrize("device,dtype,batch_stats,halo,fused", [
    ("cuda", torch.float32, True, False, True),
    ("cuda", torch.bfloat16, True, False, True),
    ("cpu", torch.float32, True, False, False),
    ("cpu", torch.bfloat16, True, False, False),
    ("cuda", torch.float16, True, False, False),
    ("cuda", torch.float64, True, False, False),
    ("cuda", torch.float32, False, False, False),
    ("cuda", torch.float32, True, True, False),
    ("cuda", torch.bfloat16, True, True, False),
])
def test_fused_route(device, dtype, batch_stats, halo, fused):
    x = _like(device, dtype)
    if halo:
        with _halo():
            assert fused_route(x, batch_stats) is fused
    else:
        assert fused_route(x, batch_stats) is fused


def test_cpu_step_launches_no_kernel_and_records_its_span(tmp_path):
    rng = np.random.default_rng(9)
    bn, _ = _pair(rng, "f32")
    counter = launch_counters()["masked_bn"]
    before = counter.launches
    x, dy, _, _ = _inputs(rng, "f32")
    x.requires_grad_(True)
    with profiling.trace(str(tmp_path / "t")):
        bn(x, torch.from_numpy(_mask("random", rng))).backward(dy)
    assert counter.launches == before
    events = json.loads(Path(tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert [e for e in events if e.get("ph") == "X" and e["name"] == profiling.NORM]
