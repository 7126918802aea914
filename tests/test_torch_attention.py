"""unirec_tpu_torch/ops/attention.py against the JAX package.

On CPU tensors the port's ``fused_attention`` runs its plain versions; the
JAX ``fused_attention`` runs its Pallas kernels in interpret mode (which
only takes dropout 0). The same numpy inputs go through both. Tolerances:
f32 1e-5 (reassociation of f32 sums only); bf16 one bf16 ulp (2^-7) of the
largest output, since the two round at the same points and only a sum's
order can flip a rounding. Dropout is checked on the port alone: keep rate,
scale, the Philox element keying, and that the backward replays the
forward's mask (finite differences of the forward with the same seed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.ops.attention as jax_attn
from unirec_tpu_torch.ops import attention as A
from unirec_tpu_torch.ops import layer as LY

B, H, HD = 3, 2, 8
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_attn, "_INTERPRET", True)


def _inputs(L, mask_heads, seed=0, hd=HD):
    """q, k, v [B, H, L, hd] and an additive mask [B, mask_heads, L, L]:
    causal -1e4 triangle plus padded keys; example 0's keys are all padded
    (a fully masked row attends uniformly over the real keys)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, hd)).astype(np.float32) for _ in range(3))
    masks = []
    for _ in range(mask_heads):
        seq = rng.integers(0, 3, size=(B, L))
        seq[:, -2:] = 1
        seq[0] = 0
        allowed = (seq > 0)[:, None, :] & np.tril(np.ones((L, L), bool))[None]
        masks.append(np.where(allowed, 0.0, -1e4).astype(np.float32))
    return q, k, v, np.stack(masks, axis=1)


def _jax(q, k, v, mask, g, jdt):
    args = [jnp.asarray(t, jdt) for t in (q, k, v)]
    seed = jnp.zeros((1,), jnp.int32)
    out, vjp = jax.vjp(lambda a, b, c: jax_attn.fused_attention(
        a, b, c, jnp.asarray(mask), 0.0, seed), *args)
    grads = vjp(jnp.asarray(g, jdt))
    return [np.asarray(t, np.float32) for t in (out, *grads)]


def _port(q, k, v, mask, g, tdt, p_drop=0.0, seed=None):
    args = [torch.tensor(t, dtype=tdt, requires_grad=True) for t in (q, k, v)]
    out = A.fused_attention(*args, torch.from_numpy(mask), p_drop, seed)
    out.backward(torch.tensor(g, dtype=tdt))
    return [t.detach().float().numpy() for t in (out, *(a.grad for a in args))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mask_heads", [1, H])
@pytest.mark.parametrize("L", [10, 50])  # both pad to a multiple of 8 in JAX
def test_forward_and_gradients_match_jax(interpret, L, mask_heads, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, mask = _inputs(L, mask_heads)
    g = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    ref = _jax(q, k, v, mask, g, jdt)
    got = _port(q, k, v, mask, g, tdt)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), name


def test_fully_masked_row_attends_over_all_real_keys():
    """Example 0 has every key at the soft -1e4, a shift shared by the whole
    row, so it attends as with no mask, over its L real keys (a -inf mask
    would give NaN). Tolerance: a score near -1e4 keeps f32 steps of 2^-10."""
    q, k, v, mask = (torch.from_numpy(t) for t in _inputs(10, 1))
    out = A._fwd_plain(q, k, v, mask)
    free = A._fwd_plain(q[:1], k[:1], v[:1], torch.zeros(1, 1, 10, 10))
    np.testing.assert_allclose(out[:1].numpy(), free.numpy(), atol=2e-3)


def test_plain_helpers_match_jax():
    q, k, v, mask = _inputs(10, 1)
    ref = jax_attn.xla_attention(*(jnp.asarray(t) for t in (q, k, v, mask)))
    got = A.xla_attention(*(torch.from_numpy(t) for t in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_gate():
    q = torch.zeros(2, H, 50, 32)
    assert A.fused_supported(q, torch.zeros(2, 1, 50, 50))
    assert A.fused_supported(q, torch.zeros(2, H, 50, 50))
    assert not A.fused_supported(q, torch.zeros(2, 3, 50, 50))
    assert not A.fused_supported(torch.zeros(1, 1, 513, 8), torch.zeros(1, 1, 513, 513))
    # the JAX gate takes L=500 at any head width, and so do the kernels: the
    # tiled pair at head width 64, and at head width 192 too, where it holds
    # the head width in chunks of 128 columns
    big = torch.zeros(1, 1, 500, 64)
    assert A.fused_supported(big, torch.zeros(1, 1, 500, 500))
    assert A._tiled(500, 64) and not A._tiled(50, 32)
    A._operands(big, big, big, torch.zeros(1, 1, 500, 500))
    wide = torch.zeros(1, 1, 500, 192)
    A._operands(wide, wide, wide, torch.zeros(1, 1, 500, 500))
    assert A._tiled(500, 192)
    assert max(A._fwd_tiled_smem_bytes(500, 192), A._bwd_tiled_smem_bytes(500, 192)) \
        == max(A._fwd_tiled_smem_bytes(500, 128), A._bwd_tiled_smem_bytes(500, 128)) \
        <= LY._SMEM_LIMIT
    A._operands(q, q, q, torch.zeros(2, 1, 50, 50))             # the slice's shape


@pytest.mark.parametrize("dtype,L,hd,body", [
    (torch.bfloat16, 50, 32, "mma"), (torch.bfloat16, 10, 32, "mma"),
    (torch.bfloat16, 64, 64, "mma"), (torch.bfloat16, 1, 1, "mma"),
    (torch.bfloat16, 65, 32, "whole"), (torch.bfloat16, 50, 72, "whole"),
    (torch.bfloat16, 300, 32, "tiled"), (torch.float32, 50, 32, "whole"),
    (torch.float32, 512, 64, "tiled")])
def test_backward_body_selector(dtype, L, hd, body):
    """csrc/attention.cu's rule for the backward: the bf16 tensor-core body
    at L <= 64 and head width <= 64; f32 and longer or wider bf16 sequences
    keep the CUDA-core bodies (whole-sequence, then tiled past L = 285 at
    head width 32). tests/test_torch_gpu.py holds it against the C rule."""
    assert A._bwd_body(dtype, L, hd) == body


@pytest.mark.parametrize("dtype,L,hd,body", [
    (torch.bfloat16, 50, 32, "mma"), (torch.bfloat16, 17, 64, "mma"),
    (torch.bfloat16, 65, 32, "whole"), (torch.bfloat16, 50, 136, "whole"),
    (torch.bfloat16, 50, 256, "tiled"),
    (torch.float32, 10, 32, "whole"), (torch.float32, 512, 256, "tiled")])
def test_forward_body_selector(dtype, L, hd, body):
    """The forward takes the backward's rule: the bf16 tensor-core body at L
    <= 64 and head width <= 64, else the CUDA-core whole-sequence body, or
    its tiled pair where one head's K and V (and their gradients) exceed a
    block's shared memory, at L = 50 from head width 256 on.
    tests/test_torch_gpu.py holds the rule against the C side's."""
    assert A._fwd_body(dtype, L, hd) == body == A._bwd_body(dtype, L, hd)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wide_heads_match_jax(interpret, dtype):
    """Head width 136 (the tiled pair's two column chunks on the card) at
    L=16, mask per example, against the Pallas kernels."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, mask = _inputs(16, 1, hd=136)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    ref = _jax(q, k, v, mask, g, jdt)
    got = _port(q, k, v, mask, g, tdt)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape == (B, H, 16, 136)
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), name


# ------------------------------------------------------------------ dropout
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_and_scale(p):
    """q = k = 0 and no mask make every probability 1/L; v = 1 then turns
    each output into (kept keys of the row) / L / (1 - p)."""
    L = 40
    z = torch.zeros(8, H, L, HD)
    drop = LY.drop_params(p, 0.0, True, 1234)
    out = A._fwd_plain(z, z, torch.ones_like(z), torch.zeros(8, 1, L, L), drop)
    keep = A._keep(drop, 8, H, L, "cpu")
    rate = float(keep.float().mean())
    assert abs(rate - (1 - p)) < 4 * (p * (1 - p) / keep.numel()) ** 0.5
    expect = keep.float().sum(-1, keepdim=True) / L / (1 - p)
    np.testing.assert_allclose(out.numpy(), expect.expand_as(out).numpy(), rtol=1e-5)


def test_mask_keys_are_seed_head_example_element():
    """Element (i, j) of head h of example b is kept iff Philox word 0 of
    counter (i*L + j, b) under key (seed, h) clears round(p * 2^32); the
    generator itself matches the published Philox4x32-10 known answer."""
    assert int(LY.philox_bits(0, 0, torch.tensor([0]), torch.tensor([0]))) == 0x6627E8D5
    L = 6
    drop = LY.drop_params(0.3, 0.0, True, 99)
    keep = A._keep(drop, 4, H, L, "cpu")
    for b, h, i, j in [(0, 0, 0, 0), (3, 1, 5, 2), (2, 0, 1, 4)]:
        bits = int(LY.philox_bits(99, h, torch.tensor([b]), torch.tensor([i * L + j])))
        assert bool(keep[b, h, i, j]) == (bits >= drop.t_attn)
    # the public entry draws nothing without a seed or outside dropout
    assert A._keep(LY.drop_params(0.3, 0.0, True, None), 4, H, L, "cpu") is None


def test_backward_replays_the_dropout_mask():
    """The gradient of <out, g> against a central finite difference of the
    forward with the same seed, along a random direction of each input.
    The mask is the causal triangle alone: a row whose keys are all masked
    has its scores near -1e4, where f32 steps of 2^-10 would swamp a finite
    difference."""
    L = 12
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(L, 1, seed=3))
    mask = torch.where(torch.ones(L, L).tril().bool(), 0.0, -1e4).expand(B, 1, L, L)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (A.fused_attention(*args, mask, 0.3, 77) * g).sum().backward()
    rng = np.random.default_rng(5)
    for n in range(3):
        d = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))

        def f(eps):
            xs = [t.clone() for t in (q, k, v)]
            xs[n] = xs[n] + eps * d
            return float((A.fused_attention(*xs, mask, 0.3, 77) * g).sum())

        # a step of 1e-2: f32 rounding of the sum over ~600 terms swamps 1e-3
        fd = (f(1e-2) - f(-1e-2)) / 2e-2
        an = float((args[n].grad * d).sum())
        assert abs(fd - an) <= 2e-3 * max(1.0, abs(an)), (n, fd, an)


def test_no_dropout_outside_train_or_without_rng():
    from unirec_tpu_torch.models.modules import DropoutRNG
    q, k, v, mask = (torch.from_numpy(t) for t in _inputs(10, 1))
    plain = A.fused_attention(q, k, v, mask)
    assert torch.equal(A.short_attention(q, k, v, mask, 0.5, None, True), plain)
    assert torch.equal(A.short_attention(q, k, v, mask, 0.5, DropoutRNG(0, "cpu"),
                                         False), plain)
    assert not torch.equal(A.short_attention(q, k, v, mask, 0.5, DropoutRNG(0, "cpu"),
                                             True), plain)
    assert A.fused_attention.launches == 0 and A.fused_attention_bwd.launches == 0
    assert A.fused_attention_bwd.launches_mma == 0
