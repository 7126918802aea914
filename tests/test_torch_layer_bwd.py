"""Backward of unirec_tpu_torch/ops/layer.py, and its dropout.

The port's plain backward versions (what its CUDA backward kernels compute,
held against them on the card by tests/test_torch_gpu.py) against JAX's
``jax.grad`` through the interpret-mode Pallas backward kernels, in f32 with
dropout 0: dx and every weight leaf within 1e-5 + 1e-3 * max|g|
(tests/test_kernels.py's rule). The plain backward is also held against
torch autograd of the plain forward, with dropout on. Dropout masks cannot
match the TPU's hardware PRNG; they are checked by keep rate, by their
independence of how the batch is split, and by forward/backward replay
against a central finite difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.ops.layer as jax_layer
from unirec_tpu.models import modules as jax_modules
from unirec_tpu_torch.ops import layer as LY

B, D, NH, F = 4, 16, 2, 32
EPS = 1e-12


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_layer, "_INTERPRET", True)


def _case(L, seed, causal):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    seq = rng.integers(0, 3, size=(B, L))
    seq[:, -3:] = 1
    seq[0] = 0                                    # fully padded row
    mask = jax_modules.causal_attention_mask(jnp.asarray(seq), bidirectional=not causal)
    madd = np.array(mask[:, 0, -1, :], np.float32)
    lin = lambda i, o: (rng.normal(size=(i, o)).astype(np.float32) * 0.3,  # noqa: E731
                        rng.normal(size=(o,)).astype(np.float32) * 0.05)
    ln = lambda: ((1 + 0.1 * rng.normal(size=D)).astype(np.float32),  # noqa: E731
                  (0.1 * rng.normal(size=D)).astype(np.float32))
    params = (lin(D, D), lin(D, D), lin(D, D), lin(D, D), ln(), lin(D, F), lin(F, D), ln())
    return x, madd, params


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err < 1e-5 + 1e-3 * float(np.abs(ref).max()), err


def _torch_grads(fn, x, madd, params, dy):
    xt = torch.from_numpy(x).requires_grad_()
    pt = tuple(tuple(torch.from_numpy(t.copy()).requires_grad_() for t in pair)
               for pair in params)
    y = fn(xt, torch.from_numpy(madd), pt)
    (y * torch.from_numpy(dy)).sum().backward()
    return xt.grad.numpy(), [t.grad.numpy() for pair in pt for t in pair]


def _jax_grads(fn, x, madd, params, dy):
    def loss(xx, pp):
        return jnp.sum(fn(xx, jnp.asarray(madd), pp) * jnp.asarray(dy))
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, params))
    return np.asarray(gx), [np.asarray(t) for pair in gp for t in pair]


@pytest.mark.parametrize("L", [10, 16])             # 10 pads to Lp=16
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("act", ["swish", "gelu", "relu"])
def test_layer_backward_matches_jax(interpret, act, causal, L):
    x, madd, params = _case(L, seed=L + 3 * causal, causal=causal)
    dy = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    kw = dict(n_heads=NH, inner_size=F, hidden_act=act, layer_norm_eps=EPS, causal=causal)
    gx, gp = _torch_grads(lambda a, m, p: LY.fused_transformer_layer(a, m, p, **kw),
                          x, madd, params, dy)
    jx, jp = _jax_grads(lambda a, m, p: jax_layer.fused_transformer_layer(
        a, m, p, p_attn=0.0, p_hidden=0.0, train=False, **kw), x, madd, params, dy)
    _close(gx, jx)
    assert len(gp) == len(jp) == 16
    for g, j in zip(gp, jp):
        _close(g, j)


@pytest.mark.parametrize("L,q_index", [(10, None), (16, None), (16, 11)])
@pytest.mark.parametrize("act", ["swish", "gelu", "relu"])
def test_last_query_backward_matches_jax(interpret, act, L, q_index):
    x, madd, params = _case(L, seed=50 + L, causal=True)
    dy = np.random.default_rng(2).normal(size=(B, D)).astype(np.float32)
    kw = dict(n_heads=NH, inner_size=F, hidden_act=act, layer_norm_eps=EPS,
              q_index=q_index)
    gx, gp = _torch_grads(lambda a, m, p: LY.fused_last_query_layer(a, m, p, **kw),
                          x, madd, params, dy)
    jx, jp = _jax_grads(lambda a, m, p: jax_layer.fused_last_query_layer(
        a, m, p, p_attn=0.0, p_hidden=0.0, train=False, **kw), x, madd, params, dy)
    _close(gx, jx)
    for g, j in zip(gp, jp):
        _close(g, j)


def _padded(L, seed, causal):
    x, madd, params = _case(L, seed, causal)
    xp, mp, _ = LY._pad_L(torch.from_numpy(x), torch.from_numpy(madd), L)
    return xp, mp, tuple(tuple(torch.from_numpy(t) for t in pair) for pair in params)


def _autograd_of(fwd, xp, flat, dy):
    xg = xp.clone().requires_grad_()
    fg = [w.clone().requires_grad_() for w in flat]
    (fwd(xg, fg) * dy).sum().backward()
    return xg.grad, [w.grad for w in fg]


@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_layer_backward_is_autograd_of_plain_forward(causal, p):
    xp, mp, params = _padded(10, 7, causal)
    flat = LY._layer_weights(params, torch.float32)
    drop = LY.drop_params(p, p, True, 99)
    dy = torch.randn(xp.shape, generator=torch.Generator().manual_seed(3))
    args = (NH, "swish", EPS, causal, drop)
    dx, grads = LY._layer_bwd_plain(xp, mp, flat, dy, *args)
    ax, agrads = _autograd_of(lambda a, w: LY._layer_fwd_plain(a, mp, w, *args), xp, flat, dy)
    _close(dx.numpy(), ax.numpy())
    for g, a in zip(grads, agrads):
        _close(g.numpy(), a.numpy())


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_plain_last_query_backward_is_autograd_of_plain_forward(p):
    xp, mp, params = _padded(10, 8, True)
    flat = LY._lastq_weights(params, torch.float32)
    drop = LY.drop_params(p, p, True, 77)
    dy = torch.randn(B, D, generator=torch.Generator().manual_seed(4))
    args = (9, NH, "gelu", EPS, drop)
    dx, grads = LY._lastq_bwd_plain(xp, mp, flat, dy, *args)
    ax, agrads = _autograd_of(lambda a, w: LY._lastq_fwd_plain(a, mp, w, *args), xp, flat, dy)
    _close(dx.numpy(), ax.numpy())
    for g, a in zip(grads, agrads):
        _close(g.numpy(), a.numpy())


# ------------------------------------------------------------------ dropout
@pytest.mark.parametrize("p", [0.1, 0.3])
def test_keep_rate_within_four_sigma(p):
    keep = LY.keep_mask(12345, LY._thresh(p), 1, 32, (16, 16), "cpu")
    n = keep.numel()
    assert abs(float(keep.float().mean()) - (1 - p)) < 4 * (p * (1 - p) / n) ** 0.5


def test_masks_do_not_depend_on_how_the_batch_is_split():
    """A block of examples b0..b1 draws exactly the rows b0..b1 of the
    whole-batch mask: the kernels may launch any grid."""
    t = LY._thresh(0.3)
    whole = LY.keep_mask(7, t, 2, 16, (8, 8), "cpu")
    elem = torch.arange(64).view(1, 8, 8)
    for b0, b1 in ((0, 8), (8, 16), (3, 11)):
        part = LY.philox_bits(7, 2, torch.arange(b0, b1).view(-1, 1, 1), elem) >= t
        assert torch.equal(part, whole[b0:b1])
    # the site and the seed each change the mask
    assert not torch.equal(whole, LY.keep_mask(7, t, 3, 16, (8, 8), "cpu"))
    assert not torch.equal(whole, LY.keep_mask(8, t, 2, 16, (8, 8), "cpu"))


def test_philox_matches_the_published_known_answer():
    """Random123's Philox4x32-10 known-answer vector: counter 0, key 0 ->
    word 0 is 0x6627e8d5."""
    assert int(LY.philox_bits(0, 0, torch.tensor([0]), torch.tensor([0]))) == 0x6627E8D5


@pytest.mark.parametrize("which", ["layer", "lastq"])
def test_dropout_replays_in_backward(which):
    """Directional derivative against a central finite difference, f32,
    dropout 0.2 on every site: the backward regenerates the forward's masks."""
    x, madd, params = _case(10, 11, True)
    pt = tuple(tuple(torch.from_numpy(t).double().float() for t in pair) for pair in params)
    kw = dict(n_heads=NH, inner_size=F, hidden_act="swish", layer_norm_eps=1e-6,
              p_attn=0.2, p_hidden=0.2, train=True, seed=4242)
    if which == "layer":
        fn = lambda a: LY.fused_transformer_layer(a, torch.from_numpy(madd), pt,  # noqa: E731
                                                  causal=True, **kw)
    else:
        fn = lambda a: LY.fused_last_query_layer(a, torch.from_numpy(madd), pt, **kw)  # noqa: E731
    g = torch.Generator().manual_seed(5)
    x0 = torch.from_numpy(x)
    w = torch.randn(fn(x0).shape, generator=g)
    v = torch.randn(x0.shape, generator=g)
    xg = x0.clone().requires_grad_()
    (fn(xg) * w).sum().backward()
    dd = float((xg.grad * v).sum())
    h = 1e-2
    with torch.no_grad():
        fd = float(((fn(x0 + h * v) - fn(x0 - h * v)) * w).sum()) / (2 * h)
    assert abs(dd - fd) <= 5e-2 * (abs(fd) + 1), (dd, fd)
    with torch.no_grad():
        y0 = fn(x0)
        assert torch.equal(y0, fn(x0))                       # same seed, same masks
        assert not torch.equal(y0, LY.fused_transformer_layer(
            x0, torch.from_numpy(madd), pt, causal=True, **dict(kw, seed=4243))
            if which == "layer" else LY.fused_last_query_layer(
                x0, torch.from_numpy(madd), pt, **dict(kw, seed=4243)))


def test_dropout_is_off_outside_train_mode():
    """As the JAX wrappers' drop_on: eval mode, or no seed, means p = 0."""
    assert LY.drop_params(0.5, 0.5, False, 3) == LY.NO_DROP
    assert LY.drop_params(0.5, 0.5, True, None) == LY.NO_DROP
    assert LY.drop_params(0.0, 0.0, True, 3) == LY.NO_DROP
    d = LY.drop_params(0.1, 0.0, True, 3)
    assert d.t_attn == round(0.1 * 2 ** 32) and d.t_hidden == 0 and d.inv_hidden == 1.0


def test_backward_gates_admit_the_bench_shape():
    assert LY.fused_layer_supported(torch.zeros(2, 50, 64), "swish", 2, 128)
    assert LY._layer_bwd_smem_bytes(56, 64, 128, 2) <= LY._SMEM_LIMIT
    assert LY._lastq_bwd_smem_bytes(56, 64, 128, 2) <= LY._SMEM_LIMIT


# ------------------------------------------- the bench's length, the tensor-core body's rule
def _case_bf16(L, seed, causal, B=3, D=32, F=64):
    """The bench's sequence shape at small widths: madd from padded
    sequences (example 0 fully padded), weights scaled so the bf16 layer
    stays O(1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    seq = rng.integers(0, 3, size=(B, L))
    seq[:, -3:] = 1
    seq[0] = 0
    mask = jax_modules.causal_attention_mask(jnp.asarray(seq), bidirectional=not causal)
    madd = np.array(mask[:, 0, -1, :], np.float32)
    lin = lambda i, o: (rng.normal(size=(i, o)).astype(np.float32) * (1.0 / i) ** 0.5,  # noqa: E731
                        rng.normal(size=(o,)).astype(np.float32) * 0.05)
    ln = lambda: ((1 + 0.1 * rng.normal(size=D)).astype(np.float32),  # noqa: E731
                  (0.1 * rng.normal(size=D)).astype(np.float32))
    params = (lin(D, D), lin(D, D), lin(D, D), lin(D, D), ln(), lin(D, F), lin(F, D), ln())
    return x, madd, params


def _rel_close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1e-30), (err, float(np.abs(ref).max()))


@pytest.mark.parametrize("act", ["swish", "gelu"])
@pytest.mark.parametrize("causal", [True, False])
def test_layer_backward_matches_jax_at_the_bench_length_bf16(interpret, causal, act):
    """L=50 (Lp=56, the shape the card's tensor-core body takes) in bf16,
    dropout 0: the port's plain backward (what both card bodies are held
    to) against jax.grad through the interpret-mode Pallas backward. Both
    round to bf16 at the same points and sum in f32 in another order, so a
    rounding can flip and later ones carry it: each output within 5e-2 of
    its own largest value, the card's backward tolerance."""
    D, Fi = 32, 64
    x, madd, params = _case_bf16(50, 31 + causal, causal, D=D, F=Fi)
    dy = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    kw = dict(n_heads=NH, inner_size=Fi, hidden_act=act, layer_norm_eps=EPS, causal=causal)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    pt = tuple(tuple(torch.from_numpy(t.copy()).requires_grad_() for t in pair)
               for pair in params)
    y = LY.fused_transformer_layer(xt, torch.from_numpy(madd), pt, **kw)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(dy)).sum().backward()
    gp = [t.grad.float().numpy() for pair in pt for t in pair]

    def loss(xx, pp):
        pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), pp)
        out = jax_layer.fused_transformer_layer(xx, jnp.asarray(madd), pb, p_attn=0.0,
                                                p_hidden=0.0, train=False, **kw)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dy))
    jx, jp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jnp.bfloat16),
                                             jax.tree_util.tree_map(jnp.asarray, params))
    _rel_close(xt.grad.float().numpy(), np.asarray(jx, np.float32), 5e-2)
    jp = [np.asarray(t, np.float32) for pair in jp for t in pair]
    assert len(gp) == len(jp) == 16
    for i, (g, j) in enumerate(zip(gp, jp)):
        if i == 3:   # the key bias: zero in exact arithmetic, held to the query bias's scale
            assert np.abs(g - j).max() <= 5e-2 * np.abs(jp[1]).max()
        else:
            _rel_close(g, j, 5e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_padding_to_64_rows_leaves_the_gradients_unchanged(causal):
    """Pitfall 1 of the tensor-core backward, in the plain version: padding
    an Lp=56 batch to the MMA tile's 64 rows with zero x and dy rows and
    hard-banned (-1e30) keys leaves dx on the first 56 rows and every
    weight gradient as they were, and gives dx = 0 exactly on the new rows
    (f32, dropout 0: the masks' element index is counted in Lp)."""
    x, madd, params = _case_bf16(50, 41 + causal, causal, B=4)
    xp, mp, Lp = LY._pad_L(torch.from_numpy(x), torch.from_numpy(madd), 50)
    assert Lp == 56
    pt = tuple(tuple(torch.from_numpy(t) for t in pair) for pair in params)
    flat = LY._layer_weights(pt, torch.float32)
    dy = torch.randn(xp.shape, generator=torch.Generator().manual_seed(6))
    dy[:, 50:] = 0.0
    args = (NH, "swish", EPS, causal)
    dx, grads = LY._layer_bwd_plain(xp, mp, flat, dy, *args)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 8))  # noqa: E731
    dx64, grads64 = LY._layer_bwd_plain(pad(xp), torch.nn.functional.pad(
        mp, (0, 8), value=LY.PAD_MASK), flat, pad(dy), *args)
    assert torch.equal(dx64[:, 56:], torch.zeros_like(dx64[:, 56:]))
    _close(dx64[:, :56].numpy(), dx.numpy())
    for g64, g in zip(grads64, grads):
        _close(g64.numpy(), g.numpy())


@pytest.mark.parametrize("dtype,Lp,D,Fi,nh,body", [
    (torch.bfloat16, 56, 64, 128, 2, "mma"),    # the training path's layer
    (torch.float32, 56, 64, 128, 2, "cuda"),    # f32 stays on the CUDA cores
    (torch.bfloat16, 64, 64, 128, 4, "mma"),    # Lp at the tile's 64, head width 16
    (torch.bfloat16, 72, 64, 128, 2, "cuda"),   # Lp past one 64-row tile
    (torch.bfloat16, 56, 48, 112, 3, "mma"),
    (torch.bfloat16, 56, 80, 128, 2, "cuda"),   # D past 64 (head width 40)
    (torch.bfloat16, 56, 64, 112, 2, "mma"),
    (torch.bfloat16, 56, 64, 144, 2, "cuda"),   # its buffers pass a block's shared memory
    (torch.bfloat16, 56, 64, 256, 2, "cuda"),
    (torch.bfloat16, 56, 64, 128, 8, "cuda"),   # head width 8
])
def test_layer_bwd_body_rule(dtype, Lp, D, Fi, nh, body):
    """ops/layer.py's copy of csrc/layer_bwd.cu's rule at its boundaries
    (tests/test_torch_gpu.py holds the two together on the card): the
    tensor-core body's shared memory fits a block wherever the rule takes
    a shape, and is 226,304 bytes at the training path's widths."""
    assert LY._layer_bwd_body(dtype, Lp, D, Fi, nh) == body
    smem = LY._layer_bwd_mma_smem_bytes(D, Fi, nh)
    assert (smem <= LY._SMEM_LIMIT) or body == "cuda"
    assert LY._layer_bwd_mma_smem_bytes(64, 128, 2) == 226_304


@pytest.mark.parametrize("dtype,Lp,D,Fi,nh,body", [
    (torch.bfloat16, 56, 64, 128, 2, "mma"),    # the paths' layer (training and serving)
    (torch.float32, 56, 64, 128, 2, "cuda"),    # f32 stays on the CUDA cores
    (torch.bfloat16, 64, 64, 128, 4, "mma"),    # Lp at the tile's 64, head width 16
    (torch.bfloat16, 72, 64, 128, 2, "cuda"),   # Lp past one 64-row tile
    (torch.bfloat16, 56, 48, 112, 3, "mma"),
    (torch.bfloat16, 56, 80, 128, 2, "cuda"),   # D past 64 (head width 40)
    (torch.bfloat16, 56, 64, 120, 2, "cuda"),   # F not a multiple of 16
    (torch.bfloat16, 56, 64, 256, 2, "mma"),    # its buffers fill a block exactly
    (torch.bfloat16, 56, 64, 272, 2, "cuda"),   # and pass it
    (torch.bfloat16, 56, 64, 128, 8, "cuda"),   # head width 8
])
def test_layer_fwd_body_rule(dtype, Lp, D, Fi, nh, body):
    """ops/layer.py's copy of csrc/layer_fwd.cu's rule at its boundaries
    (tests/test_torch_gpu.py holds the two together on the card): the
    tensor-core forward's shared memory fits a block wherever the rule takes
    a shape, and is 197,632 bytes at the paths' widths (the weights once and
    two groups' buffers)."""
    assert LY._layer_fwd_body(dtype, Lp, D, Fi, nh) == body
    smem = LY._layer_fwd_mma_smem_bytes(D, Fi)
    assert (smem <= LY._SMEM_LIMIT) or body == "cuda"
    assert LY._layer_fwd_mma_smem_bytes(64, 128) == 197_632
    assert LY._layer_fwd_mma_smem_bytes(64, 256) == LY._SMEM_LIMIT


@pytest.mark.parametrize("dtype,Lp,D,Fi,nh,body", [
    (torch.bfloat16, 56, 64, 128, 2, "mma"),    # the training path's last layer
    (torch.float32, 56, 64, 128, 2, "cuda"),
    (torch.bfloat16, 64, 64, 128, 4, "mma"),
    (torch.bfloat16, 72, 64, 128, 2, "cuda"),
    (torch.bfloat16, 56, 48, 112, 3, "mma"),
    (torch.bfloat16, 56, 80, 128, 2, "cuda"),
    (torch.bfloat16, 56, 64, 120, 2, "cuda"),
    (torch.bfloat16, 56, 64, 384, 2, "mma"),    # the widest F whose buffers fit
    (torch.bfloat16, 56, 64, 400, 2, "cuda"),
    (torch.bfloat16, 56, 64, 128, 8, "cuda"),
])
def test_lastq_bwd_body_rule(dtype, Lp, D, Fi, nh, body):
    """ops/layer.py's copy of csrc/lastq_bwd.cu's rule at its boundaries;
    its shared memory is 140,040 bytes at the training path's widths."""
    assert LY._lastq_bwd_body(dtype, Lp, D, Fi, nh) == body
    smem = LY._lastq_bwd_mma_smem_bytes(D, Fi, nh)
    assert (smem <= LY._SMEM_LIMIT) or body == "cuda"
    assert LY._lastq_bwd_mma_smem_bytes(64, 128, 2) == 140_040


@pytest.mark.parametrize("dtype,Lp,D,Fi,nh,body", [
    (torch.bfloat16, 56, 64, 128, 2, "mma"),    # the paths' last layer (training and serving)
    (torch.float32, 56, 64, 128, 2, "cuda"),    # f32 stays on the CUDA cores
    (torch.bfloat16, 64, 64, 128, 4, "mma"),    # Lp at the tile's 64, head width 16
    (torch.bfloat16, 72, 64, 128, 2, "cuda"),   # Lp past one 64-row tile
    (torch.bfloat16, 56, 48, 112, 3, "mma"),
    (torch.bfloat16, 56, 80, 128, 2, "cuda"),   # D past 64 (head width 40)
    (torch.bfloat16, 56, 64, 120, 2, "cuda"),   # F not a multiple of 16
    (torch.bfloat16, 56, 64, 384, 2, "mma"),    # the widest F whose buffers fit
    (torch.bfloat16, 56, 64, 400, 2, "cuda"),
    (torch.bfloat16, 56, 64, 128, 8, "cuda"),   # head width 8
])
def test_lastq_fwd_body_rule(dtype, Lp, D, Fi, nh, body):
    """ops/layer.py's copy of csrc/lastq_fwd.cu's rule at its boundaries
    (tests/test_torch_gpu.py holds the two together on the card): the
    tensor-core forward's shared memory fits a block wherever the rule takes
    a shape, and is 155,264 bytes at the paths' widths (the weights once and
    two groups' buffers)."""
    assert LY._lastq_fwd_body(dtype, Lp, D, Fi, nh) == body
    smem = LY._lastq_fwd_mma_smem_bytes(D, Fi, nh)
    assert (smem <= LY._SMEM_LIMIT) or body == "cuda"
    assert LY._lastq_fwd_mma_smem_bytes(64, 128, 2) == 155_264


@pytest.mark.parametrize("act", ["swish", "gelu"])
def test_last_query_forward_matches_jax_at_the_bench_length_bf16(interpret, act):
    """Row 3 at L=50 (Lp=56, which the card's tensor-core forward pads to
    64 rows) in bf16: the port's plain forward (what both card bodies are
    held to) against the interpret-mode Pallas forward, from the same f32
    parameters, within two bf16 ulps of the largest LayerNorm output (2^-6
    of it), as the whole layer's test below. Padding the 56 rows to 64 with
    zero x rows and hard-banned keys leaves the output bit for bit."""
    D, Fi = 32, 64
    x, madd, params = _case_bf16(50, 81, True, D=D, F=Fi)
    kw = dict(n_heads=NH, inner_size=Fi, hidden_act=act, layer_norm_eps=EPS)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    pt = tuple(tuple(torch.from_numpy(t) for t in pair) for pair in params)
    y = LY.fused_last_query_layer(xb, torch.from_numpy(madd), pt, **kw)
    assert y.dtype == torch.bfloat16 and y.shape == (3, D)
    jy = jax_layer.fused_last_query_layer(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                          jnp.asarray(madd), params, p_attn=0.0,
                                          p_hidden=0.0, train=False, **kw)
    jy = np.asarray(jy, np.float32)
    err = float(np.abs(y.float().numpy() - jy).max())
    assert err <= 2.0 ** -6 * float(np.abs(jy).max()), (err, float(np.abs(jy).max()))
    xp, mp, Lp = LY._pad_L(xb, torch.from_numpy(madd), 50)
    assert Lp == 56
    flat = LY._lastq_weights(pt, torch.bfloat16)
    y64 = LY._lastq_fwd_plain(torch.nn.functional.pad(xp, (0, 0, 0, 8)),
                              torch.nn.functional.pad(mp, (0, 8), value=LY.PAD_MASK),
                              flat, 49, NH, act, EPS)
    assert torch.equal(y64, y)


@pytest.mark.parametrize("act", ["swish", "gelu"])
@pytest.mark.parametrize("causal", [True, False])
def test_layer_forward_matches_jax_at_the_bench_length_bf16(interpret, causal, act):
    """Row 1 at L=50 (Lp=56, the shape the card's tensor-core forward takes)
    in bf16: the port's plain forward (what both card bodies are held to)
    against the interpret-mode Pallas forward, from the same f32 parameters
    (both cast the matmul weights to bf16 and keep the LayerNorm's in f32).
    Both round to bf16 at the same points and sum in f32 in another order,
    so a rounding can flip and later ones carry it: within two bf16 ulps of
    the largest LayerNorm output (2^-6 of it)."""
    D, Fi = 32, 64
    x, madd, params = _case_bf16(50, 61 + causal, causal, D=D, F=Fi)
    kw = dict(n_heads=NH, inner_size=Fi, hidden_act=act, layer_norm_eps=EPS, causal=causal)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    pt = tuple(tuple(torch.from_numpy(t) for t in pair) for pair in params)
    y = LY.fused_transformer_layer(xb, torch.from_numpy(madd), pt, **kw)
    assert y.dtype == torch.bfloat16 and y.shape == (3, 50, D)
    jy = jax_layer.fused_transformer_layer(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                           jnp.asarray(madd), params, p_attn=0.0,
                                           p_hidden=0.0, train=False, **kw)
    jy = np.asarray(jy, np.float32)
    err = float(np.abs(y.float().numpy() - jy).max())
    assert err <= 2.0 ** -6 * float(np.abs(jy).max()), (err, float(np.abs(jy).max()))


@pytest.mark.parametrize("act", ["swish", "gelu"])
def test_last_query_backward_matches_jax_at_the_bench_length_bf16(interpret, act):
    """Row 4 at L=50 (Lp=56, the shape the card's tensor-core body takes) in
    bf16, dropout 0: the port's plain backward against jax.grad through the
    interpret-mode Pallas last-query backward; each output within 5e-2 of its
    own largest value (the key bias, zero in exact arithmetic, against the
    query bias's), as the whole layer's test above."""
    D, Fi = 32, 64
    x, madd, params = _case_bf16(50, 71, True, D=D, F=Fi)
    dy = np.random.default_rng(10).normal(size=(x.shape[0], D)).astype(np.float32)
    kw = dict(n_heads=NH, inner_size=Fi, hidden_act=act, layer_norm_eps=EPS)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    pt = tuple(tuple(torch.from_numpy(t.copy()).requires_grad_() for t in pair)
               for pair in params)
    y = LY.fused_last_query_layer(xt, torch.from_numpy(madd), pt, **kw)
    assert y.dtype == torch.bfloat16 and y.shape == (3, D)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    gp = [t.grad.float().numpy() for pair in pt for t in pair]

    def loss(xx, pp):
        pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), pp)
        out = jax_layer.fused_last_query_layer(xx, jnp.asarray(madd), pb, p_attn=0.0,
                                               p_hidden=0.0, train=False, **kw)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dy))
    jx, jp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jnp.bfloat16),
                                             jax.tree_util.tree_map(jnp.asarray, params))
    _rel_close(xt.grad.float().numpy(), np.asarray(jx, np.float32), 5e-2)
    jp = [np.asarray(t, np.float32) for pair in jp for t in pair]
    assert len(gp) == len(jp) == 16
    for i, (g, j) in enumerate(zip(gp, jp)):
        if i == 3:   # the key bias: zero in exact arithmetic, held to the query bias's scale
            assert np.abs(g - j).max() <= 5e-2 * np.abs(jp[1]).max()
        else:
            _rel_close(g, j, 5e-2)


@pytest.mark.parametrize("qi", [49, 20])
def test_last_query_padding_to_64_rows_leaves_the_gradients_unchanged(qi):
    """The last-query twin of the test above: padding an Lp=56 batch to the
    MMA tile's 64 rows with zero x rows and hard-banned (-1e30) keys leaves
    dx on the first 56 rows and every weight gradient as they were, and
    gives dx = 0 exactly on the new rows (f32, dropout 0)."""
    x, madd, params = _case_bf16(50, 51 + qi, True, B=4)
    xp, mp, Lp = LY._pad_L(torch.from_numpy(x), torch.from_numpy(madd), 50)
    assert Lp == 56
    pt = tuple(tuple(torch.from_numpy(t) for t in pair) for pair in params)
    flat = LY._lastq_weights(pt, torch.float32)
    dy = torch.randn(4, x.shape[2], generator=torch.Generator().manual_seed(7))
    args = (qi, NH, "swish", EPS)
    dx, grads = LY._lastq_bwd_plain(xp, mp, flat, dy, *args)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 8))  # noqa: E731
    dx64, grads64 = LY._lastq_bwd_plain(pad(xp), torch.nn.functional.pad(
        mp, (0, 8), value=LY.PAD_MASK), flat, dy, *args)
    assert torch.equal(dx64[:, 56:], torch.zeros_like(dx64[:, 56:]))
    _close(dx64[:, :56].numpy(), dx.numpy())
    for g64, g in zip(grads64, grads):
        _close(g64.numpy(), g.numpy())
