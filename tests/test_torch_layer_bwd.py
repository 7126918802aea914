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
