"""The port's `AttentionWithFastKANTransform` against the JAX module, the
counterpart of tests/test_fastkan_attention.py (which holds the JAX module
against the reference torch module, absent here): the same five unfused
FastKANLayers (`linear_q`, `linear_k`, `linear_v`, `linear_g` with gating,
`linear_o`), their JAX weights carried by `utils/port.py`
(`fastkan_from_jax` / `fastkan_to_jax`), the softmax over the keys before
the additive bias, the sigmoid gate; batched and unbatched inputs, with
and without gating and bias; the output and the gradients of the inputs
and of every weight.

Tolerance: f32 values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol
1e-5: the same arithmetic in another summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.kan.layers import AttentionWithFastKANTransform as JAttn
from kagnn_tpu_torch.kan import AttentionWithFastKANTransform
from kagnn_tpu_torch.utils.port import fastkan_from_jax, fastkan_to_jax

torch.set_num_threads(1)
VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
QD, KD, VD, HD, H = 8, 6, 7, 4, 2


def _inputs(rng, batch, lq=5, lk=7, bias=False):
    lead = (batch,) if batch else ()
    q = rng.normal(size=lead + (lq, QD)).astype(np.float32)
    k = rng.normal(size=lead + (lk, KD)).astype(np.float32)
    v = rng.normal(size=lead + (lk, VD)).astype(np.float32)
    b = rng.normal(size=lead + (lq, lk)).astype(np.float32) if bias else None
    return q, k, v, b


@pytest.mark.parametrize("gating", [True, False], ids=["gating", "no_gating"])
@pytest.mark.parametrize("batch,bias", [(3, False), (0, True), (2, True)],
                         ids=["batched", "unbatched-bias", "batched-bias"])
def test_attention_matches_jax(rng, gating, batch, bias):
    q, k, v, b = _inputs(rng, batch, bias=bias)
    jm = JAttn(QD, KD, VD, HD, H, gating=gating)
    variables = jm.init(jax.random.key(0), q, k, v, b)
    tm = AttentionWithFastKANTransform(QD, KD, VD, HD, H, gating=gating, device="cpu")
    sd = fastkan_from_jax(variables)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    names = ["linear_q", "linear_k", "linear_v", "linear_o"] + (["linear_g"] if gating else [])
    assert sorted(n for n, _ in tm.named_children()) == sorted(names)
    ref = rng.normal(size=q.shape).astype(np.float32)

    def f(params, q, k, v):
        out = jm.apply({"params": params}, q, k, v, b)
        return (out * ref).sum(), out

    (_, want), (gp, gq, gk, gv) = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        variables["params"], jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tm(*ts, None if b is None else torch.from_numpy(b))
    (out * torch.from_numpy(ref)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **VAL)
    for t, g in zip(ts, (gq, gk, gv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD)
    want_grads = fastkan_from_jax({"params": gp})
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[n].numpy(), **GRAD, err_msg=n)


def test_attention_weights_carry_both_ways(rng):
    """The port's state_dict -> JAX variables -> the port, bit for bit, and
    the JAX module on the carried variables computes the port's output."""
    q, k, v, _ = _inputs(rng, 2)
    tm = AttentionWithFastKANTransform(QD, KD, VD, HD, H, device="cpu",
                                       generator=torch.Generator().manual_seed(3))
    variables = fastkan_to_jax(tm.state_dict())
    back = fastkan_from_jax(variables)
    assert all(torch.equal(back[n], t) for n, t in tm.state_dict().items())
    want = JAttn(QD, KD, VD, HD, H).apply(variables, q, k, v)
    got = tm(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
