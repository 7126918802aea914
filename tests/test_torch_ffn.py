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
from unirec_tpu_torch.ops import layer as LY

T, D, F = 1100, 16, 32
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -6)}


def _inputs(seed=0, T=T, D=D, F=F):
    rng = np.random.default_rng(seed)
    mk = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)  # noqa: E731
    # wider layers get smaller weights, so pre and y keep the 16 x 32 case's scale
    w1, w2 = 0.3 * (16 / D) ** 0.5, 0.3 * (32 / F) ** 0.5
    return (mk(T, D), mk(D, F, std=w1), mk(F, std=0.3), mk(F, D, std=w2),
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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wide_matches_jax(dtype):
    """(D, F) = (256, 1024) at 40 tokens: on the card the CUDA-core bodies'
    F chunks and a shrunk row tile, in both dtypes; here the plain versions
    against the Pallas kernels."""
    jdt, tdt, tol = DTYPES[dtype]
    *args, dy = _inputs(2, T=40, D=256, F=1024)
    for name, a, b in zip(("y", "dx", "dw1", "db1", "dw2", "db2"),
                          _port(args, dy, "swish", tdt), _jax(args, dy, "swish", jdt)):
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), (name, dtype)


@pytest.mark.parametrize("D,Fi,rows_fwd,rows_bwd,body_bf16", [
    (64, 128, 64, 32, "mma"), (64, 512, 64, 32, "mma"), (64, 2048, 64, 32, "mma"),
    (256, 1024, 64, 32, "cuda"), (2048, 8192, 8, 8, "cuda"), (2048, 64, 16, 8, "cuda"),
    (16, 32, 64, 32, "mma"), (72, 128, 64, 32, "cuda"), (64, 100, 64, 32, "cuda")])
def test_body_and_tile_rules(D, Fi, rows_fwd, rows_bwd, body_bf16):
    """csrc/ffn.cu's rules, held here in plain Python (tests/test_torch_gpu.py
    holds them against the C side): the CUDA-core bodies' row tile halves
    from 64 (forward) or 32 (backward) until the tile's shared memory fits a
    block, which no longer grows with F; the bf16 backward takes the
    tensor-core body at D a multiple of 16 up to 64 and F a multiple of 16;
    f32 always the CUDA-core body."""
    assert FF._rows(False, D, Fi) == rows_fwd and FF._rows(True, D, Fi) == rows_bwd
    for bwd, r in ((False, rows_fwd), (True, rows_bwd)):
        assert FF._smem_bytes(bwd, r, D, Fi) <= LY._SMEM_LIMIT
        assert r == (64 if not bwd else 32) or FF._smem_bytes(bwd, 2 * r, D, Fi) > LY._SMEM_LIMIT
    assert FF._smem_bytes(True, 8, 2048, 1 << 20) == FF._smem_bytes(True, 8, 2048, 256)
    assert FF._bwd_body(torch.bfloat16, D, Fi) == body_bf16
    assert FF._bwd_body(torch.float32, D, Fi) == "cuda"


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


@pytest.mark.parametrize("act", FF.ACTS)
def test_forward_matches_jax_bf16_every_activation(act):
    """The forward's plain version (what the card's bf16 tensor-core body is
    held to) against the interpret-mode Pallas forward in bf16, for all six
    activations: two bf16 ulps of the largest output."""
    *args, _ = _inputs(3)
    xs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    ref = np.asarray(jax_ffn.fused_ffn(*xs, act, 1024, True), np.float32)
    y = FF.fused_ffn(*(torch.tensor(a, dtype=torch.bfloat16) for a in args), act)
    assert y.dtype == torch.bfloat16
    assert np.abs(y.float().numpy() - ref).max() <= 2.0 ** -6 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dtype,D,Fi,body", [
    (torch.bfloat16, 64, 128, "mma"), (torch.float32, 64, 128, "cuda"),
    (torch.bfloat16, 80, 128, "cuda"), (torch.bfloat16, 64, 100, "cuda"),
    (torch.bfloat16, 48, 144, "mma"), (torch.bfloat16, 16, 16, "mma")])
def test_forward_body_rule(dtype, D, Fi, body):
    """ops/ffn.py's copy of the forward's rule (the backward's: bf16, D a
    multiple of 16 up to 64, F a multiple of 16) and of its shared memory:
    W1, W2 of one chunk of at most 128 columns of F and two 128-token
    stages of x, within a block at every D it takes, whatever F."""
    assert FF._fwd_body(dtype, D, Fi) == body
    assert FF._fwd_mma_smem_bytes(64, 128) == 73_216
    assert FF._fwd_mma_smem_bytes(D, Fi) <= LY._SMEM_LIMIT
    assert FF._fwd_mma_smem_bytes(64, 1 << 14) == FF._fwd_mma_smem_bytes(64, 128)
