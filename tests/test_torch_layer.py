"""unirec_tpu_torch/ops/layer.py against the JAX package.

The port's wrappers run their plain PyTorch versions on CPU tensors; these
tests hold them against both JAX paths on the same numpy inputs: the Pallas
kernels in interpret mode and the unfused flax modules (XLA). Everything is
f32, so the tolerance (atol = rtol = 1e-5) only covers f32 reassociation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.ops.layer as jax_layer
from unirec_tpu.models import modules as jax_modules
from unirec_tpu_torch.models import modules as torch_modules
from unirec_tpu_torch.ops import layer as torch_layer

B, D, NH, F = 4, 16, 2, 32
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_layer, "_INTERPRET", True)


def _inputs(L, seed, causal):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    item_seq = rng.integers(0, 3, size=(B, L))
    item_seq[:, -3:] = 1          # at least 3 real positions per row ...
    item_seq[0] = 0               # ... except a fully padded one (soft -1e4)
    mask = jax_modules.causal_attention_mask(jnp.asarray(item_seq),
                                             bidirectional=not causal)
    return x, item_seq, mask


def _jax_layer(act, causal, x, mask, last_query=False, **kw):
    ref = jax_modules.TransformerLayer(NH, D, F, 0.0, 0.0, act, 1e-12,
                                       last_query=last_query, fused_causal=causal,
                                       **kw)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x), mask, False)
    return ref, variables


def _params(variables):
    """The fused-layer parameter tuple from a flax TransformerLayer tree."""
    p = variables["params"]
    a, f = p["multi_head_attention"], p["feed_forward"]
    lin = lambda d: (d["kernel"], d["bias"])  # noqa: E731
    return (lin(a["query"]), lin(a["key"]), lin(a["value"]), lin(a["dense"]),
            (a["LayerNorm"]["scale"], a["LayerNorm"]["bias"]),
            lin(f["dense_1"]), lin(f["dense_2"]),
            (f["LayerNorm"]["scale"], f["LayerNorm"]["bias"]))


def _torch_params(params):
    return tuple(tuple(torch.from_numpy(np.asarray(t)) for t in pair)
                 for pair in params)


def _madd(mask):
    return np.asarray(mask[:, 0, -1, :], np.float32)


@pytest.mark.parametrize("L", [10, 16])          # 10 pads to Lp=16
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("act", ["swish", "gelu", "relu"])
def test_fused_transformer_layer_matches_jax(interpret, act, causal, L):
    x, _, mask = _inputs(L, seed=L, causal=causal)
    ref, variables = _jax_layer(act, causal, x, mask)
    params = _params(variables)
    kw = dict(n_heads=NH, inner_size=F, hidden_act=act, layer_norm_eps=1e-12)
    y_kernel = jax_layer.fused_transformer_layer(
        jnp.asarray(x), jnp.asarray(_madd(mask)), params, p_attn=0.0,
        p_hidden=0.0, causal=causal, train=False, **kw)
    y_xla = ref.apply(variables, jnp.asarray(x), mask, False)
    y = torch_layer.fused_transformer_layer(
        torch.from_numpy(x), torch.from_numpy(_madd(mask)),
        _torch_params(params), causal=causal, **kw).numpy()
    assert y.shape == (B, L, D)
    np.testing.assert_allclose(y, np.asarray(y_kernel), **TOL)
    np.testing.assert_allclose(y, np.asarray(y_xla), **TOL)


@pytest.mark.parametrize("L", [10, 16])
@pytest.mark.parametrize("act", ["swish", "gelu"])
def test_fused_last_query_layer_matches_jax(interpret, act, L):
    x, _, mask = _inputs(L, seed=100 + L, causal=True)
    ref, variables = _jax_layer(act, True, x, mask, last_query=True)
    params = _params(variables)
    kw = dict(n_heads=NH, inner_size=F, hidden_act=act, layer_norm_eps=1e-12)
    y_kernel = jax_layer.fused_last_query_layer(
        jnp.asarray(x), jnp.asarray(_madd(mask)), params, p_attn=0.0,
        p_hidden=0.0, train=False, **kw)
    y_xla = ref.apply(variables, jnp.asarray(x), mask, False)[:, 0]
    y = torch_layer.fused_last_query_layer(
        torch.from_numpy(x), torch.from_numpy(_madd(mask)),
        _torch_params(params), **kw).numpy()
    assert y.shape == (B, D)
    np.testing.assert_allclose(y, np.asarray(y_kernel), **TOL)
    np.testing.assert_allclose(y, np.asarray(y_xla), **TOL)


def _encoder_pair(fused, L=12, act="swish"):
    flags = dict(last_query_only=True, fused_layer=fused, fused_lastq=fused)
    jenc = jax_modules.TransformerEncoder(2, NH, D, F, 0.0, 0.0, act, 1e-12,
                                          **flags)
    tenc = torch_modules.TransformerEncoder(2, NH, D, F, act, 1e-12, **flags)
    return jenc, tenc


@pytest.mark.parametrize("fused", [True, False])
def test_padded_chain_matches_jax(interpret, fused):
    """Two layers: the padded fused chain (L=12 -> Lp=16, last query at
    the last REAL row) and the unfused loop, each against JAX."""
    from unirec_tpu_torch.utils.flax_bridge import load_flax_params
    x, item_seq, mask = _inputs(12, seed=7, causal=True)
    jenc, tenc = _encoder_pair(fused)
    variables = jenc.init(jax.random.PRNGKey(1), jnp.asarray(x), mask, False)
    y_jax = np.asarray(jenc.apply(variables, jnp.asarray(x), mask, False))
    load_flax_params(tenc, jax.tree_util.tree_map(np.asarray, variables["params"]))
    tmask = torch_modules.causal_attention_mask(torch.from_numpy(item_seq))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    with torch.no_grad():
        y = tenc(torch.from_numpy(x), tmask).numpy()
    assert y.shape == (B, 1, D)
    np.testing.assert_allclose(y, y_jax, **TOL)


def test_chain_launches_no_kernel_on_cpu():
    """On CPU tensors the wrappers take their plain versions: the launch
    counters stay where they were."""
    before = (torch_layer.fused_transformer_layer.launches,
              torch_layer.fused_last_query_layer.launches)
    x, item_seq, _ = _inputs(12, seed=3, causal=True)
    _, tenc = _encoder_pair(True)
    with torch.no_grad():
        tenc(torch.from_numpy(x),
             torch_modules.causal_attention_mask(torch.from_numpy(item_seq)))
    assert (torch_layer.fused_transformer_layer.launches,
            torch_layer.fused_last_query_layer.launches) == before


@pytest.mark.parametrize("n_heads,D_,L,ok", [
    (2, 64, 50, True),      # bench widths
    (16, 32, 50, False),    # SASRec.yaml's n_heads at d=32: head dim 2
    (2, 64, 513, False),    # longer than the JAX gate admits
    (2, 64, 400, False),    # [Lp, Lp] scores exceed a block's shared memory
])
def test_fused_layer_gate(n_heads, D_, L, ok):
    x = torch.zeros(2, L, D_)
    assert torch_layer.fused_layer_supported(x, "swish", n_heads, 2 * D_) is ok


def test_gate_refuses_unsupported_activation():
    assert not torch_layer.fused_layer_supported(torch.zeros(2, 8, 16),
                                                 "leakyrelu", 2, 32)


def test_pad_L_bans_fake_keys():
    x = torch.ones(2, 10, 16)
    madd = torch.zeros(2, 10)
    xp, mp, Lp = torch_layer._pad_L(x, madd, 10)
    assert Lp == 16 and xp.shape == (2, 16, 16)
    assert (xp[:, 10:] == 0).all() and (mp[:, 10:] == -1e30).all()
    jx, jm, jLp = jax_layer._pad_L(jnp.asarray(x.numpy()), jnp.asarray(madd.numpy()), 10)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(jm))
    assert jLp == Lp
