"""The training slice as a whole, against the JAX package, and the trainer.

One SASRec train step at bench.py's configuration in miniature (2 layers,
d=16, 2 heads, inner 32, L=10 padded to 16; the fused chain,
vmem_embedding_grad and neg_membership_pallas on; BCE with 3 negatives):
the same augmented batch and weights through both packages, the JAX
kernels in Pallas interpret mode and the port on its plain versions. In
f32 with dropout 0: the loss within 1e-5 relative, every parameter
gradient within 1e-5 + 1e-3 * max|g| of its leaf, and the parameters after
one Adam step within 1e-6. In bf16, within 0.05 as the JAX package's own
bf16-against-f32 layer test. Then the port's Trainer: fit lowers the loss,
resume is bit-identical to an uninterrupted run, and its checkpoint serves
through the port's reco-topk and loads into the JAX SASRec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import unirec_tpu.ops.layer as jax_layer
import unirec_tpu.ops.member as jax_member
import unirec_tpu.ops.scatter_accum as jax_sa
from unirec_tpu import config as jax_config
from unirec_tpu.core import optim as jax_optim
from unirec_tpu.utils import checkpoint as jax_ckpt
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.core.optim import build_optimizer
from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter, RawIdBatcher
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.facility.trainer import Trainer
from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
from unirec_tpu_torch.models.modules import DropoutRNG
from unirec_tpu_torch.utils.checkpoint import load_model_freely
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params, to_flax_tree
from unirec_tpu_torch.utils.registry import get_model_class as torch_model_class

N_USERS, N_ITEMS, CAP = 60, 80, 24
BENCH_MINI = dict(model="SASRec", n_users=N_USERS, n_items=N_ITEMS, embedding_size=16,
                  hidden_size=16, n_heads=2, inner_size=32, n_layers=2, max_seq_len=10,
                  loss_type="bce", n_sample_neg_train=3, dataloader="SeqRecDataset",
                  history_mask_mode="autoregressive", last_query_only=1, fused_layer=1,
                  fused_lastq=1, vmem_embedding_grad=1, neg_membership_pallas=1,
                  hidden_dropout_prob=0.0, attn_dropout_prob=0.0, learning_rate=1e-3,
                  compute_dtype="float32", group_size=-1)


@pytest.fixture
def interpret(monkeypatch):
    for mod in (jax_layer, jax_sa, jax_member):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def _history(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, CAP + 1, N_USERS).astype(np.int32)
    items = np.zeros((N_USERS, CAP), np.int32)
    m = np.arange(CAP)[None] < lens[:, None]
    items[m] = rng.integers(1, N_ITEMS, int(m.sum()))
    return UserHistory(items, lens)


def _batch(cfg, B=12, seed=1):
    """One augmented batch from the port's pipeline, as numpy."""
    rng = np.random.default_rng(seed)
    aug = DeviceAugmenter(cfg, _history(), device="cpu")
    raw = {"user_id": torch.from_numpy(rng.integers(1, N_USERS, B).astype(np.int32)),
           "item_id": torch.from_numpy(rng.integers(1, N_ITEMS, B).astype(np.int32)),
           "weight": torch.ones(B)}
    raw["weight"][-1] = 0.0                         # a padded row
    out = aug.augment(raw, torch.Generator().manual_seed(seed))
    return {k: v.numpy() for k, v in out.items()}


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _step_pair(dtype):
    args = dict(BENCH_MINI, compute_dtype=dtype)
    jcfg = jax_config.parse_arguments(dict(args), argv=[])
    tcfg = torch_config.parse_arguments(dict(args), argv=[], device="cpu")
    batch = _batch(tcfg)
    jmodel = jax_model_class("SASRec")(cfg=jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(4), jb, train=False)["params"]

    def loss_fn(p):
        return jmodel.apply({"params": p}, jb, train=True,
                            rngs={"dropout": jax.random.PRNGKey(5)})[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    tx = jax_optim.build_optimizer(jcfg)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, upd)

    tmodel = torch_model_class("SASRec")(tcfg)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    tparams = list(tmodel.parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, _ = tmodel(tb, train=True, rng=DropoutRNG(0, "cpu"))
    tgrads = torch.autograd.grad(tloss, tparams)
    opt = build_optimizer(tcfg)
    tupd, _ = opt.update(list(tgrads), opt.init(tparams), tparams)
    with torch.no_grad():
        for p, u in zip(tparams, tupd):
            p.add_(u)
    return (float(tloss.detach()), float(jloss), dict(_flat(to_flax_tree(tmodel, tgrads))),
            dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads))),
            dict(_flat(to_flax_params(tmodel))), dict(_flat(jnew)))


def test_one_train_step_matches_jax_f32(interpret):
    tloss, jloss, tg, jg, tp, jp = _step_pair("float32")
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert set(tg) == set(jg)
    for k in jg:
        err = float(np.abs(tg[k] - jg[k]).max())
        assert err < 1e-5 + 1e-3 * float(np.abs(jg[k]).max()), (k, err)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-6, rtol=0, err_msg=str(k))
    assert np.abs(tg[("item_embedding", "embedding")]).max() > 0


def test_one_train_step_bf16_close_to_jax(interpret):
    tloss, jloss, tg, jg, _, _ = _step_pair("bfloat16")
    assert abs(tloss - jloss) <= 0.05 * abs(jloss)
    for k in jg:
        err = float(np.abs(tg[k] - jg[k]).max())
        assert err <= 0.05 * float(np.abs(jg[k]).max()) + 1e-6, (k, err)


# ------------------------------------------------------------------ trainer
def _trainer(tmp_path, **over):
    cfg = torch_config.parse_arguments(dict(dict(
        BENCH_MINI, hidden_dropout_prob=0.1, attn_dropout_prob=0.1, dropout_bits=8,
        learning_rate=1e-2, epochs=2, output_path=str(tmp_path), exp_name="t",
        seed=3), **over), argv=[], device="cpu")
    tr = Trainer(cfg, torch_model_class("SASRec")(cfg), device="cpu")
    tr.set_device_augmenter(DeviceAugmenter(cfg, _history(), device="cpu"))
    rng = np.random.default_rng(8)
    data = RawIdBatcher(rng.integers(1, N_USERS, 96), rng.integers(1, N_ITEMS, 96), 32,
                        seed=5)
    return tr, data


def test_fit_lowers_the_loss(tmp_path):
    tr, data = _trainer(tmp_path, epochs=3)
    seen, step = [], tr.train_step
    tr.train_step = lambda b: seen.append(step(b)) or seen[-1]
    tr.fit(data)
    seen = [float(v) for v in seen]
    assert len(seen) == 9 and np.isfinite(seen).all()
    assert np.mean(seen[-3:]) < np.mean(seen[:3])
    assert tr._global_step == 9 and tr.cur_epoch == 3


def test_nan_guard_keeps_params_and_state(tmp_path):
    tr, data = _trainer(tmp_path)
    tr.init_params()
    before = [p.detach().clone() for p in tr.params]
    count = tr.opt_state["count"].clone()
    batch = {k: torch.as_tensor(v) for k, v in next(iter(data)).items()}
    batch["weight"] = torch.full_like(batch["weight"], float("nan"))
    assert not torch.isfinite(tr.train_step(batch))
    assert all(torch.equal(a, b) for a, b in zip(before, tr.params))
    assert torch.equal(tr.opt_state["count"], count)


def test_auto_resume_is_bit_identical(tmp_path):
    full, data = _trainer(tmp_path / "full", auto_resume=1)
    full.fit(data)
    first, data1 = _trainer(tmp_path / "cut", auto_resume=1, epochs=1)
    first.fit(data1)
    second, data2 = _trainer(tmp_path / "cut", auto_resume=1, epochs=2)
    second.fit(data2)
    assert second._global_step == full._global_step == 6
    for (k, a), (_, b) in zip(full.model.state_dict().items(),
                              second.model.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(full.opt_state["nu"], second.opt_state["nu"]):
        assert torch.equal(a, b)


def test_checkpoint_serves_and_loads_into_jax(tmp_path, interpret):
    tr, data = _trainer(tmp_path, epochs=1)
    tr.fit(data)
    path = str(tmp_path / "trained.pkl")
    tr.save_model(path, 1)
    model, cfg = load_model_freely(path, "cpu")
    hist = _history()
    users = np.arange(1, 21)
    ids = get_topk_recommendations(cfg, model, users, hist, 5)
    assert ids.shape == (20, 5) and ids.min() >= 1 and ids.max() < N_ITEMS
    rows, lens = hist.gather(users)
    for u in range(20):
        assert not set(ids[u]) & set(rows[u, :lens[u]].tolist())
    jmodel, params, _, jcfg = jax_ckpt.load_model_freely(path)
    seq, _ = hist.window(users, 10)
    ref = jmodel.apply({"params": params}, {"item_seq": jnp.asarray(seq)}, method="user_emb")
    with torch.no_grad():
        got = model.user_emb({"item_seq": torch.from_numpy(seq)})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # the optimizer state is numpy in the JAX layout, and resumes
    again, _ = _trainer(tmp_path)
    again.resume(path)
    assert int(again.opt_state["count"]) == 3
    for a, b in zip(tr.opt_state["mu"], again.opt_state["mu"]):
        assert torch.equal(a, b)


def test_unported_trainer_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        _trainer(tmp_path, enable_morec=1)
    with pytest.raises(NotImplementedError, match="item 12"):
        _trainer(tmp_path, mesh_data=2)
    tr, data = _trainer(tmp_path)
    with pytest.raises(NotImplementedError, match="item 5"):
        tr.fit(data, valid_data=data)


@pytest.mark.parametrize("bits8", [False, True])
def test_plain_dropout_sites_keep_rate_and_scale(bits8):
    """modules.apply_dropout (the sites outside the fused kernels): keep rate
    within 4 sigma of 1-p, kept values scaled by 1/keep_p; Dropout8 rounds
    p to a multiple of 1/256 (unirec_tpu/models/modules.py:100-111)."""
    from unirec_tpu_torch.models import modules
    x = torch.ones(200, 100)
    y = modules.apply_dropout(x, 0.1, True, DropoutRNG(0, "cpu"), bits8)
    p = round(0.1 * 256) / 256 if bits8 else 0.1
    assert abs(float((y != 0).float().mean()) - (1 - p)) < 4 * (p * (1 - p) / x.numel()) ** 0.5
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / (1 - p), rtol=1e-6)
    assert torch.equal(modules.apply_dropout(x, 0.1, False, None, bits8), x)
    with pytest.raises(ValueError):
        modules.apply_dropout(x, 0.1, True, None, bits8)
