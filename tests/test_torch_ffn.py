"""unirec_tpu_torch/ops/ffn.py against the JAX package.

On CPU tensors the port's ``fused_ffn`` runs its plain versions; the JAX
``fused_ffn`` runs its Pallas kernels in interpret mode, with the block of
1,024 tokens the model uses, over a token count that is not a multiple of
it. The same numpy inputs go through both; the output and all five
gradients are compared. Tolerances: f32 1e-5 of each output's largest
magnitude (reassociation of f32 sums); bf16 two bf16 ulps (2^-6) of it,
since the two round at the same points and only a sum's order can flip a
rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.ops import ffn as jax_ffn
from unirec_tpu_torch.ops import ffn as FF

T, D, F = 1100, 16, 32
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -6)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)  # noqa: E731
    return (mk(T, D), mk(D, F, std=0.3), mk(F, std=0.3), mk(F, D, std=0.3),
            mk(D, std=0.3), mk(T, D))


def _jax(args, dy, act, jdt):
    xs = [jnp.asarray(a, jdt) for a in args]
    y, vjp = jax.vjp(lambda *a: jax_ffn.fused_ffn(*a, act, 1024, True), *xs)
    return [np.asarray(t, np.float32) for t in (y, *vjp(jnp.asarray(dy, jdt)))]


def _port(args, dy, act, tdt):
    xs = [torch.tensor(a, dtype=tdt, requires_grad=True) for a in args]
    y = FF.fused_ffn(*xs, act)
    y.backward(torch.tensor(dy, dtype=tdt))
    assert all(a.grad.dtype == tdt for a in xs)
    return [t.detach().float().numpy() for t in (y, *(a.grad for a in xs))]


@pytest.mark.parametrize("act", FF.ACTS)
def test_matches_jax_f32(act):
    *args, dy = _inputs()
    for name, a, b in zip(("y", "dx", "dw1", "db1", "dw2", "db2"),
                          _port(args, dy, act, torch.float32),
                          _jax(args, dy, act, jnp.float32)):
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max()), (act, name)


@pytest.mark.parametrize("act", ["swish", "gelu"])
def test_matches_jax_bf16(act):
    *args, dy = _inputs(1)
    for name, a, b in zip(("y", "dx", "dw1", "db1", "dw2", "db2"),
                          _port(args, dy, act, torch.bfloat16),
                          _jax(args, dy, act, jnp.bfloat16)):
        assert np.abs(a - b).max() <= 2.0 ** -6 * max(1.0, np.abs(b).max()), (act, name)


@pytest.mark.parametrize("act", FF.ACTS)
def test_activation_derivative_is_the_derivative(act):
    pre = torch.linspace(-3, 3, 61, dtype=torch.float64)[1::2]  # avoids 0
    pre.requires_grad_(True)
    h, dact = FF.act_and_grad(pre, act)
    (auto,) = torch.autograd.grad(h.sum(), pre)
    np.testing.assert_allclose(dact.detach().numpy(), auto.numpy(), atol=1e-10)


def test_unsupported_operands_raise():
    *args, _ = _inputs()
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError):
        FF._check(*t, "elu")
    with pytest.raises(TypeError):
        FF._check(t[0].double(), *t[1:], "swish")
    with pytest.raises(ValueError):
        FF._check(t[0], t[1], t[2], t[3].T, t[4], "swish")
    assert FF.fused_ffn.launches == 0 and FF.fused_ffn_bwd.launches == 0
