"""unirec_tpu_torch SASRec against the JAX model with the same weights.

A small SASRec (2 layers, d=16, 2 heads, inner 32, L=12) in f32: the port's
user_emb / all_item_emb / bias_terms against ``model.apply`` of the flax
model whose parameters it loaded through the flax bridge, with the fused
kernel flags off (XLA path) and on (Pallas kernels in interpret mode; the
port runs their plain versions), causal and bidirectional. atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.ops.layer as jax_layer
from unirec_tpu import config as jax_config
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.utils.flax_bridge import load_flax_params
from unirec_tpu_torch.utils.registry import get_model_class as torch_model_class

SMALL = dict(model="SASRec", n_users=20, n_items=60, embedding_size=16,
             n_heads=2, inner_size=32, n_layers=2, max_seq_len=12,
             compute_dtype="float32", has_item_bias=1)
FUSED = dict(last_query_only=1, fused_layer=1, fused_lastq=1)


def _item_seq(seed=0, B=6, L=12, n_items=60):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, n_items, size=(B, L))
    seq[0, :8] = 0                   # short history, left-padded
    seq[1] = 0                       # empty history
    seq[2, :11] = 0                  # one item
    return seq.astype(np.int32)


def _pair(overrides, monkeypatch):
    monkeypatch.setattr(jax_layer, "_INTERPRET", True)
    args = dict(SMALL, **overrides)
    cfg = jax_config.parse_arguments(args, argv=[])
    jmodel = jax_model_class("SASRec")(cfg=cfg)
    seq = _item_seq()
    batch = {"item_seq": jnp.asarray(seq), "user_id": jnp.zeros(6, jnp.int32),
             "item_id": jnp.zeros(6, jnp.int32), "label": jnp.zeros(6)}
    variables = jmodel.init(jax.random.PRNGKey(0), batch, train=False)
    tmodel = torch_model_class("SASRec")(
        torch_config.parse_arguments(args, argv=[], device="cpu"))
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, variables["params"]))
    return jmodel, variables, tmodel.eval(), batch, seq


@pytest.mark.parametrize("pos_emb", [1, 0])     # 0: bidirectional encoder
@pytest.mark.parametrize("fused", [False, True])
def test_user_and_item_embeddings_match_jax(monkeypatch, fused, pos_emb):
    over = dict(FUSED if fused else {}, use_position_emb=pos_emb)
    jmodel, variables, tmodel, batch, seq = _pair(over, monkeypatch)
    u_ref = np.asarray(jmodel.apply(variables, batch, method="user_emb"))
    i_ref = np.asarray(jmodel.apply(variables, method="all_item_emb"))
    with torch.no_grad():
        u = tmodel.user_emb({"item_seq": torch.from_numpy(seq)}).numpy()
        i = tmodel.all_item_emb().numpy()
    assert u.shape == (6, 16) and i.shape == (60, 16)
    np.testing.assert_allclose(u, u_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(i, i_ref)
    assert not i[0].any()            # padding item embeds to zeros


def test_bias_terms_match_jax(monkeypatch):
    jmodel, variables, tmodel, _, _ = _pair({}, monkeypatch)
    ub, ib = jmodel.apply(variables, method="bias_terms")
    tub, tib = tmodel.bias_terms()
    assert ub is None and tub is None
    np.testing.assert_array_equal(tib.detach().numpy(), np.asarray(ib))


def test_fused_chain_runs_the_kernel_wrappers(monkeypatch):
    """With the bench flags on, the encoder takes the padded fused chain:
    one whole-layer call, then one last-query call."""
    from unirec_tpu_torch.ops import layer as torch_layer
    calls = []
    for name in ("fused_transformer_layer", "fused_last_query_layer"):
        fn = getattr(torch_layer, name)
        monkeypatch.setattr(torch_layer, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    _, _, tmodel, _, seq = _pair(FUSED, monkeypatch)
    with torch.no_grad():
        tmodel.user_emb({"item_seq": torch.from_numpy(seq)})
    assert calls == ["fused_transformer_layer", "fused_last_query_layer"]


def test_layer_norm_eps_string_from_config():
    """Checkpoint configs carry layer_norm_eps as the YAML string '1e-10'."""
    cfg = torch_config.parse_arguments(dict(SMALL), argv=[], device="cpu")
    assert cfg["layer_norm_eps"] == "1e-10"
    model = torch_model_class("SASRec")(cfg)
    assert model.LayerNorm.eps == 1e-10
    assert model.trm_encoder.layer_0.feed_forward.LayerNorm.eps == 1e-10


def test_unported_options_raise():
    for extra in (dict(qkv_packed=1), dict(scan_embedding_grad=1)):
        with pytest.raises(NotImplementedError):
            torch_model_class("SASRec")(dict(SMALL, **extra))
