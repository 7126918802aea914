"""The JAX package's opt-in XLA variants and its four unused ranking
modules in the port, against the JAX package.

- The embedding-gradient variants (ops/embedding.py): each gather's forward
  and its table gradient against unirec_tpu/ops/embedding.py's on the same
  skewed ids (zeros and repeats) and cotangent, with the compute dtype f32
  and bf16. Tolerances: f32 1e-5 of the largest gradient entry (another
  summation order); bf16 sums (``gather_expand``, ``gather_sorted`` of a
  bf16 table) two bf16 ulps of it (2^-7; a rounding that flips moves later
  sums), the f32 accumulators (scan, cast) 1e-5 of it.
- The precedence of the flags (unirec_tpu/models/base.py:168-208): for
  each combination, the path the port's SASRec takes is the one the JAX
  SASRec takes (each package's gathers spied on); and a SASRec training
  step (loss and every gradient) under each flag against the JAX step, f32,
  as tests/test_torch_train.py holds the default step (1e-5 of the loss;
  1e-5 + 1e-3 of each leaf's largest).
- ``qkv_packed``: the packed ``qkv`` dense in SASRec's parameter tree
  (bridged strictly), eval user embeddings within 1e-5 and a training
  step's gradients as above, full-length and last-query.
- ``remat_attention``: a training step's loss and gradients with remat
  equal, bit for bit, to those without, at dropout 0.3 on the plain
  sites, the fused attention's kernel (plain version) and the fused layers
  (plain versions), the generators ending where they end without remat;
  and at dropout 0 against the JAX package's ``nn.remat`` step.
- ``Dice``, ``SequenceAttLayer``, ``ModulateHidden``, ``MMoEUnit``: the
  forward of each against the flax module's from the same (bridged)
  parameters, f32, 1e-6 (tests/test_kernels.py:150-200 runs the flax
  modules alone).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.models.modules as jax_modules
import unirec_tpu.ops.embedding as jax_emb
import unirec_tpu.ops.layer as jax_layer
import unirec_tpu.ops.scatter_accum as jax_sa
from tests.test_torch_train import BENCH_MINI, _batch, _flat
from unirec_tpu import config as jax_config
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.models import modules as port_modules
from unirec_tpu_torch.models.modules import DropoutRNG
from unirec_tpu_torch.ops import embedding as port_emb
from unirec_tpu_torch.ops import scatter_accum as port_sa
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_tree
from unirec_tpu_torch.utils.registry import get_model_class as torch_model_class

N, D = 40, 16
BF16_TOL = 2.0 ** -7
F32_TOL = 1e-5
# SASRec on the unfused path: the variants act on its item-table gathers
PLAIN = dict(BENCH_MINI, fused_layer=0, fused_lastq=0, vmem_embedding_grad=0,
             neg_membership_pallas=0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    for mod in (jax_layer, jax_sa):
        monkeypatch.setattr(mod, "_INTERPRET", True)


# ------------------------------------------------- embedding-gradient paths
def _ids_and_table(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, (6, 9))
    ids[:, :3] = 0                       # padding
    ids[0] = 7                           # one id many times
    table = rng.normal(size=(N, D)).astype(np.float32)
    return ids.astype(np.int32), table


VARIANTS = {
    # name: (port fn, jax fn) of (table, ids, compute dtype); the table
    # dtype each takes in the model (expand: the table cast first)
    "scan": (lambda t, i, dt: port_emb.gather_scan(t, i, dt),
             lambda t, i, dt: jax_emb.gather_scan(t, i, dt), "f32"),
    "sorted": (lambda t, i, dt: port_emb.gather_sorted(t, i),
               lambda t, i, dt: jax_emb.gather(t, i), "cast"),
    "expand": (lambda t, i, dt: port_emb.gather_expand(t, i, 4),
               lambda t, i, dt: jax_emb.gather_expand(t, i, 4), "cast"),
    "cast": (lambda t, i, dt: port_emb.gather_cast(t, i, dt),
             lambda t, i, dt: jax_emb.gather_cast(t, i, dt), "f32"),
}
DTYPES = {"float32": (None, None, torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gradient_variant_matches_jax(variant, dtype):
    port_fn, jax_fn, table_kind = VARIANTS[variant]
    tdt, jdt, tcast, jcast = DTYPES[dtype]
    if variant == "cast" and tdt is None:
        tdt, jdt = torch.bfloat16, jnp.bfloat16   # gather_cast needs a compute dtype
    ids, table = _ids_and_table()
    g = np.random.default_rng(1).normal(size=ids.shape + (D,)).astype(np.float32)
    jt = jnp.asarray(table) if table_kind == "f32" else jnp.asarray(table).astype(jcast)
    out, vjp = jax.vjp(lambda t: jax_fn(t, jnp.asarray(ids), jdt), jt)
    (jgrad,) = vjp(jnp.asarray(g).astype(out.dtype))
    tt = torch.from_numpy(table)
    tt = (tt if table_kind == "f32" else tt.to(tcast)).requires_grad_(True)
    got = port_fn(tt, torch.from_numpy(ids), tdt)
    assert str(got.dtype).split(".")[-1] == str(out.dtype)
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(out, np.float32))
    got.backward(torch.from_numpy(g).to(got.dtype))
    assert tt.grad.dtype == tt.dtype
    want = np.asarray(jgrad, np.float32)
    bf16_sums = tt.dtype == torch.bfloat16
    tol = (BF16_TOL if bf16_sums else F32_TOL) * float(np.abs(want).max())
    assert float(np.abs(tt.grad.float().numpy() - want).max()) <= tol
    assert float(np.abs(want[7]).max()) > 0 and not np.any(want[ids.max() + 1:] != 0)


# flags -> the path both packages take
PRECEDENCE = [
    (dict(scan_embedding_grad=1, vmem_embedding_grad=1, sorted_embedding_grad=1,
          expand_embedding_grad=4, embedding_grad_f32=1), "scan"),
    (dict(vmem_embedding_grad=1, sorted_embedding_grad=1, expand_embedding_grad=4), "vmem"),
    (dict(vmem_embedding_grad=1, shard_embeddings=1, sorted_embedding_grad=1), "sorted"),
    (dict(sorted_embedding_grad=1, expand_embedding_grad=4, embedding_grad_f32=1), "sorted"),
    (dict(expand_embedding_grad=4, embedding_grad_f32=1), "expand"),
    (dict(expand_embedding_grad=1, embedding_grad_f32=1), "cast"),
    (dict(embedding_grad_f32=1, compute_dtype="float32"), "plain"),
    (dict(), "plain"),
]


def _spied_paths(monkeypatch, names):
    """Spies on each package's gathers, recording the path names taken."""
    seen = {"port": [], "jax": []}
    spies = {"port": [(port_emb, "gather_scan", "scan"), (port_emb, "gather_sorted", "sorted"),
                      (port_emb, "gather_expand", "expand"), (port_emb, "gather_cast", "cast"),
                      (port_sa, "gather_vmem", "vmem")],
             "jax": [(jax_emb, "gather_scan", "scan"), (jax_emb, "gather", "sorted"),
                     (jax_emb, "gather_expand", "expand"), (jax_emb, "gather_cast", "cast"),
                     (jax_sa, "gather_vmem", "vmem")]}
    for side in names:
        for mod, attr, name in spies[side]:
            fn = getattr(mod, attr)

            def spy(*a, _fn=fn, _name=name, _side=side):
                seen[_side].append(_name)
                return _fn(*a)
            monkeypatch.setattr(mod, attr, spy)
    return seen


@pytest.mark.parametrize("flags,path", PRECEDENCE, ids=[p for _, p in PRECEDENCE])
def test_flag_precedence_is_the_jax_packages(flags, path, interpret, monkeypatch):
    args = dict(PLAIN, **dict(dict(compute_dtype="bfloat16"), **flags))
    batch = _batch(torch_config.parse_arguments(dict(args), argv=[], device="cpu"))
    seen = _spied_paths(monkeypatch, ("port", "jax"))
    jcfg = jax_config.parse_arguments(dict(args), argv=[])
    jmodel = jax_model_class("SASRec")(cfg=jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(0), jb, train=False)["params"]
    seen["jax"].clear()        # each gather is chosen in the forward
    jmodel.apply({"params": params}, jb, train=True, rngs={"dropout": jax.random.PRNGKey(1)})
    tmodel = torch_model_class("SASRec")(torch_config.parse_arguments(dict(args), argv=[],
                                                                      device="cpu"))
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    loss, _ = tmodel({k: torch.from_numpy(v) for k, v in batch.items()}, train=True,
                     rng=DropoutRNG(0, "cpu"))
    loss.backward()
    want = set(seen["jax"]) or {"plain"}
    assert want == {path}
    assert (set(seen["port"]) or {"plain"}) == want
    with torch.no_grad():           # no autograd, no variant: the plain rows
        seen["port"].clear()
        tmodel({k: torch.from_numpy(v) for k, v in batch.items()}, train=False)
        assert seen["port"] == []


def _step(args, train=True, p_seed=4):
    """The port's and the JAX package's loss and gradients of one SASRec
    training step from the JAX initialization (dropout as ``args`` says:
    at 0 the two agree)."""
    jcfg = jax_config.parse_arguments(dict(args), argv=[])
    tcfg = torch_config.parse_arguments(dict(args), argv=[], device="cpu")
    batch = _batch(tcfg)
    jmodel = jax_model_class("SASRec")(cfg=jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(p_seed), jb, train=False)["params"]
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jb, train=train, rngs={"dropout": jax.random.PRNGKey(5)})[0])(params)
    tmodel = torch_model_class("SASRec")(tcfg)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    tparams = list(tmodel.parameters())
    tloss, _ = tmodel({k: torch.from_numpy(v) for k, v in batch.items()}, train=train,
                      rng=DropoutRNG(0, "cpu"))
    tgrads = torch.autograd.grad(tloss, tparams)
    return (float(tloss.detach()), float(jloss), dict(_flat(to_flax_tree(tmodel, tgrads))),
            dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads))), tmodel, params)


def _assert_step_matches(tloss, jloss, tg, jg):
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert set(tg) == set(jg)
    for k in jg:
        err = float(np.abs(tg[k] - jg[k]).max())
        assert err < 1e-5 + 1e-3 * float(np.abs(jg[k]).max()), (k, err)


STEP_FLAGS = {"scan": dict(scan_embedding_grad=1), "sorted": dict(sorted_embedding_grad=1),
              "expand": dict(expand_embedding_grad=3)}


@pytest.mark.parametrize("flag", sorted(STEP_FLAGS))
def test_training_step_under_each_variant_matches_jax(flag, interpret):
    tloss, jloss, tg, jg, _, _ = _step(dict(PLAIN, **STEP_FLAGS[flag]))
    _assert_step_matches(tloss, jloss, tg, jg)
    assert np.abs(tg[("item_embedding", "embedding")]).max() > 0


# --------------------------------------------------------------- qkv_packed
@pytest.mark.parametrize("last_query_only", [0, 1])
def test_qkv_packed_matches_jax(last_query_only, interpret):
    args = dict(PLAIN, qkv_packed=1, last_query_only=last_query_only)
    tloss, jloss, tg, jg, tmodel, params = _step(args)
    _assert_step_matches(tloss, jloss, tg, jg)
    layer = ("trm_encoder", "layer_0", "multi_head_attention")
    assert (*layer, "qkv", "kernel") in jg and (*layer, "query", "kernel") not in jg
    assert jg[(*layer, "qkv", "kernel")].shape == (16, 48)
    batch = _batch(torch_config.parse_arguments(dict(args), argv=[], device="cpu"))
    jmodel = jax_model_class("SASRec")(cfg=jax_config.parse_arguments(dict(args), argv=[]))
    want = np.asarray(jmodel.apply({"params": params}, {k: jnp.asarray(v) for k, v in
                                                        batch.items()}, method="user_emb"))
    with torch.no_grad():
        got = tmodel.eval().user_emb({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def test_qkv_packed_turns_the_fused_layers_off(monkeypatch):
    """As at modules.py:620, :634 and :712: no fused layer kernel runs."""
    from unirec_tpu_torch.ops import layer as LY
    calls = []
    for name in ("fused_transformer_layer", "fused_last_query_layer"):
        monkeypatch.setattr(LY, name, lambda *a, _n=name, **k: calls.append(_n))
    tmodel = torch_model_class("SASRec")(torch_config.parse_arguments(
        dict(BENCH_MINI, qkv_packed=1), argv=[], device="cpu"))
    assert not tmodel.trm_encoder.chain
    with torch.no_grad():
        tmodel.user_emb({"item_seq": torch.ones(2, 10, dtype=torch.int32)})
    assert calls == []


# ---------------------------------------------------------- remat_attention
REMAT_CASES = {
    "plain": dict(PLAIN, last_query_only=0),
    "plain_bits8": dict(PLAIN, dropout_bits=8),
    "fused_attention": dict(PLAIN, last_query_only=0, use_fused_attention=1),
    "fused_layers": dict(BENCH_MINI),
}


def _remat_step(args, remat):
    cfg = torch_config.parse_arguments(dict(args, remat_attention=remat), argv=[],
                                       device="cpu")
    model = torch_model_class("SASRec")(cfg)
    model.init_weights(torch.Generator().manual_seed(3))
    rng = DropoutRNG(11, "cpu")
    params = list(model.parameters())
    loss, _ = model({k: torch.from_numpy(v) for k, v in _batch(cfg).items()}, train=True,
                    rng=rng)
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), grads, rng.get_state()


@pytest.mark.parametrize("case", sorted(REMAT_CASES))
def test_remat_gradients_equal_those_without_remat(case):
    args = dict(REMAT_CASES[case], hidden_dropout_prob=0.3, attn_dropout_prob=0.3)
    loss, grads, state = _remat_step(args, 0)
    rloss, rgrads, rstate = _remat_step(args, 1)
    assert rloss == loss
    for a, b in zip(grads, rgrads):
        assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(state, rstate))
    # the dropout is live: without it the gradients differ
    off, off_grads, _ = _remat_step(dict(args, hidden_dropout_prob=0.0,
                                         attn_dropout_prob=0.0), 1)
    assert any(not torch.allclose(a, b) for a, b in zip(grads, off_grads))


def test_remat_step_matches_jax(interpret):
    tloss, jloss, tg, jg, _, _ = _step(dict(PLAIN, last_query_only=0, remat_attention=1))
    _assert_step_matches(tloss, jloss, tg, jg)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """Each layer's forward runs twice under remat (forward, recompute)."""
    calls = []
    forward = port_modules.TransformerLayer.forward

    def spy(self, *a, **k):
        calls.append(id(self))
        return forward(self, *a, **k)
    monkeypatch.setattr(port_modules.TransformerLayer, "forward", spy)
    _remat_step(dict(PLAIN, hidden_dropout_prob=0.3, attn_dropout_prob=0.3), 1)
    assert len(calls) == 4 and len(set(calls)) == 2


# ------------------------------------------------------ the four modules
def _module_pair(jmod, tmod, *inputs, seed=0):
    """The flax module's params (its init, then every leaf redrawn from
    normal(0.5) so that Dice's alpha is not zero) into the port module;
    returns (port output, flax output)."""
    params = jmod.init(jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in inputs])["params"]
    rng = np.random.default_rng(seed + 10)
    params = jax.tree_util.tree_map(
        lambda p: (0.5 * rng.normal(size=p.shape)).astype(np.float32), params)
    load_flax_params(tmod, params)
    want = np.asarray(jmod.apply({"params": params}, *[jnp.asarray(x) for x in inputs]))
    with torch.no_grad():
        got = tmod(*[torch.as_tensor(x) for x in inputs]).numpy()
    return got, want


def test_dice_matches_jax():
    x = np.random.default_rng(4).normal(size=(3, 8)).astype(np.float32)
    got, want = _module_pair(jax_modules.Dice(emb_size=8), port_modules.Dice(8), x)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("out_size", [8, 6])
def test_sequence_att_layer_matches_jax(out_size):
    rng = np.random.default_rng(5)
    B, T, L, H = 2, 3, 6, 8
    q = rng.normal(size=(B, T, H)).astype(np.float32)
    k = rng.normal(size=(B, L, H)).astype(np.float32)
    klen = np.asarray([4, 6], np.int32)
    got, want = _module_pair(jax_modules.SequenceAttLayer(H, out_size),
                             port_modules.SequenceAttLayer(H, out_size), q, k, klen)
    assert got.shape == (B, T, H)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_modulate_hidden_and_mmoe_match_jax():
    rng = np.random.default_rng(7)
    z = rng.normal(size=(4, 16)).astype(np.float32)
    x = rng.normal(size=(4, 3, 8)).astype(np.float32)
    got, want = _module_pair(jax_modules.ModulateHidden(input_size=8, emb_size=16),
                             port_modules.ModulateHidden(8, 16), x, z)
    assert got.shape == (4, 3, 8)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    for zz in (z, rng.normal(size=(4, 2, 16)).astype(np.float32)):
        got, want = _module_pair(jax_modules.MMoEUnit(8, 6, 16, expert_num=5),
                                 port_modules.MMoEUnit(8, 6, 16, expert_num=5), zz)
        assert got.shape == (4, 6, 8)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_module_init_draws_match_jax_in_distribution():
    """The port's jax_init draws each module's parameters as the flax
    initializers do: Dice's alpha zeros, the torch-linear uniforms bounded
    by 1/sqrt(fan_in) with their variance."""
    gen = torch.Generator().manual_seed(0)
    mmoe, mod, dice = (port_modules.MMoEUnit(8, 6, 16, expert_num=50),
                       port_modules.ModulateHidden(8, 64), port_modules.Dice(8))
    with torch.no_grad():
        for m in (mmoe, mod, dice):
            m.jax_init(gen)
    j = jax_modules.MMoEUnit(8, 6, 16, expert_num=50).init(
        jax.random.PRNGKey(0), jnp.ones((2, 16)))["params"]
    jm = jax_modules.ModulateHidden(8, 64).init(
        jax.random.PRNGKey(0), jnp.ones((2, 3, 8)), jnp.ones((2, 64)))["params"]
    for got, want in ((mmoe.weight, j["weight"]), (mmoe.gate_net.weight, j["gate_net"]["kernel"]),
                      (mod.gen_para_layer.weight, jm["gen_para_layer"]["kernel"])):
        got, want = got.detach().numpy(), np.asarray(want)
        assert abs(np.abs(got).max() - np.abs(want).max()) < 0.1 * np.abs(want).max()
        assert abs(got.std() - want.std()) < 0.1 * want.std()
    assert not dice.alpha.any() and not mod.gen_para_layer.bias.any()
