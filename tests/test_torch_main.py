"""The slice as a whole: the port's main.run and cli train/test/infer, and one
train step of the slice's configuration against the JAX package.

- main.run(task=train) on tests/synth.py's dataset (SASRec with
  use_fused_attention and use_fused_ffn, one-vs-all validation and test,
  on the CPU): the loss falls, every epoch validates, the best checkpoint
  is written, and task=test from it reproduces the test metrics exactly.
  The JAX package's main.run(task=test) on the port's checkpoint gives the
  same metrics to 1e-5 (f32 scores of the same weights; tie noise of 1e-8
  breaks no rank between them).
- early stopping and the LR plateau step against the JAX trainer's rules.
- one train step at f32 with dropout 0: the port's plain versions against
  the JAX Pallas kernels in interpret mode; loss within 1e-5 relative,
  every gradient within 1e-5 + 1e-3 * max|g| of its leaf, the parameters
  after one Adam step within 1e-6 (the tolerances of tests/test_torch_train.py).
"""
import copy
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import unirec_tpu.ops.attention as jax_attn
import unirec_tpu.ops.member as jax_member
import unirec_tpu.ops.scatter_accum as jax_sa
from tests.synth import BASE_CONF
from tests.test_torch_train import BENCH_MINI, _batch, _flat
from unirec_tpu import config as jax_config
from unirec_tpu.core import optim as jax_optim
from unirec_tpu.facility.trainer import early_stopping as jax_early_stopping
from unirec_tpu.main import main as jax_main
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import cli
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.core.optim import build_optimizer
from unirec_tpu_torch.data.device_pipeline import RawIdBatcher
from unirec_tpu_torch.facility.trainer import Trainer, early_stopping
from unirec_tpu_torch.main import main
from unirec_tpu_torch.models.modules import DropoutRNG
from unirec_tpu_torch.ops import attention as AT
from unirec_tpu_torch.ops import layer as LY
from unirec_tpu_torch.ops import ffn as FF
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params, to_flax_tree
from unirec_tpu_torch.utils.registry import get_model_class

SLICE = dict(model="SASRec", dataloader="SeqRecDataset", embedding_size=16, hidden_size=16,
             n_layers=2, n_heads=2, inner_size=32, last_query_only=1, fused_layer=0,
             fused_lastq=0, use_fused_attention=1, use_fused_ffn=1, vmem_embedding_grad=1,
             neg_membership_pallas=1, hidden_dropout_prob=0.1, attn_dropout_prob=0.1)


@pytest.fixture(scope="module")
def trained(synth_dataset, tmp_path_factory):
    """One port training run: (config args, result, output dir, the losses)."""
    root, _ = synth_dataset
    out = str(tmp_path_factory.mktemp("port_main"))
    args = dict(BASE_CONF, **SLICE, dataset_path=root, output_path=out, exp_name="slice",
                epochs=3, learning_rate=0.01, early_stop=5, device="cpu")
    losses, step = [], Trainer.train_step

    def spy(self, batch):
        losses.append(float(step(self, batch)))
        return torch.tensor(losses[-1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "train_step", spy)
        result = main.run(copy.deepcopy(args))
    return args, result, out, losses


def test_train_validates_and_checkpoints_the_best(trained):
    args, result, out, losses = trained
    assert set(result) == {"hit@5", "hit@10", "ndcg@5", "ndcg@10"}
    assert all(0.0 <= v <= 1.0 for v in result.values())
    n = len(losses) // 3
    assert len(losses) == 3 * n and np.mean(losses[-n:]) < np.mean(losses[:n])
    with open(os.path.join(out, "checkpoint", "slice.pkl"), "rb") as f:
        ckpt = pickle.load(f)
    best = ckpt["best_valid_result"] or ckpt["best_valid_score"]
    assert "ndcg@5" in best and ckpt["cur_epoch"] in (0, 1, 2)
    assert ckpt["config"]["use_fused_attention"] == 1 and "device" not in ckpt["config"]
    assert os.path.exists(os.path.join(out, "slice.result.tsv"))
    assert glob.glob(os.path.join(out, "slice.*.log"))


def test_test_task_from_the_checkpoint_reproduces_the_metrics(trained):
    args, result, out, _ = trained
    again = main.run({"task": "test", "model_file": os.path.join(out, "checkpoint", "slice.pkl"),
                      "dataset_path": args["dataset_path"], "output_path": out + "_test",
                      "device": "cpu"})
    assert again == result


def test_jax_main_tests_the_port_checkpoint(trained):
    args, result, out, _ = trained
    ref = jax_main.run({"task": "test", "model_file": os.path.join(out, "checkpoint", "slice.pkl"),
                        "dataset_path": args["dataset_path"], "output_path": out + "_jax"})
    assert set(ref) == set(result)
    for m in result:
        assert abs(result[m] - ref[m]) <= 1e-5, (m, result[m], ref[m])


def test_cli_train_and_test(synth_dataset, tmp_path, capsys):
    root, _ = synth_dataset
    flags = ["--model", "SASRec", "--dataloader", "SeqRecDataset", "--dataset_path", root,
             "--output_path", str(tmp_path), "--exp_name", "cli", "--epochs", "1",
             "--embedding_size", "8", "--n_heads", "2", "--inner_size", "16",
             "--use_fused_attention", "1", "--use_fused_ffn", "1", "--device", "cpu",
             "--valid_protocol", "one_vs_all", "--test_protocol", "one_vs_all",
             "--user_history_filename", "user_history", "--n_sample_neg_train", "3",
             "--metrics", "['hit@10']", "--key_metric", "hit@10"]
    assert cli.main(["train", *flags]) == 0
    trained_out = capsys.readouterr().out
    ckpt = str(tmp_path / "checkpoint" / "cli.pkl")
    assert cli.main(["test", "--model_file", ckpt, "--dataset_path", root, "--device", "cpu",
                     "--output_path", str(tmp_path / "t")]) == 0
    tested_out = capsys.readouterr().out
    assert "hit@10" in trained_out and trained_out.splitlines()[-1] == tested_out.splitlines()[-1]
    assert cli.main(["infer", "--model_file", ckpt, "--dataset_path", root, "--device", "cpu",
                     "--output_path", str(tmp_path / "i")]) == 0
    scores = np.loadtxt(tmp_path / "i" / "cli.infer.txt")
    assert scores.shape == (200,) and np.isfinite(scores).all()   # one per test row


@pytest.mark.parametrize("bigger", [True, False])
@pytest.mark.parametrize("max_step", [0, 1, 3])
def test_early_stopping_matches_jax(bigger, max_step):
    seq = [0.1, 0.3, 0.3, 0.2, 0.25, 0.31, 0.1, 0.1, 0.1, 0.05, 0.4]
    a = b = (None, 0)
    for v in seq:
        ra = early_stopping(v, *a, max_step=max_step, bigger=bigger)
        rb = jax_early_stopping(v, *b, max_step=max_step, bigger=bigger)
        assert ra == rb
        a, b = ra[:2], rb[:2]


def _trainer(tmp_path, **over):
    from tests.test_torch_train import _history
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter
    cfg = torch_config.parse_arguments(dict(BENCH_MINI, **SLICE, epochs=6, output_path=str(tmp_path),
                                            exp_name="v", **over), argv=[], device="cpu")
    tr = Trainer(cfg, get_model_class("SASRec")(cfg), device="cpu")
    tr.set_device_augmenter(DeviceAugmenter(cfg, _history(), device="cpu"))
    rng = np.random.default_rng(8)
    return tr, RawIdBatcher(rng.integers(1, 60, 64), rng.integers(1, 80, 64), 32, seed=5)


@pytest.mark.parametrize("early_stop,epochs_run,lr", [(2, 3, 1e-3), (9, 6, 1e-5)])
def test_flat_validation_stops_early_and_lowers_the_lr(tmp_path, early_stop, epochs_run, lr):
    """A validation score that never improves: the first one is the best
    (checkpoint saved), patience runs out after early_stop more (JAX rule:
    stop when the count exceeds it, before the scheduler steps), and the
    plateau scheduler (patience 1, from the second validation on) cuts the
    lr by 10 at the 4th and the 6th."""
    tr, data = _trainer(tmp_path, early_stop=early_stop)
    seen = []
    tr.evaluate = lambda d, load_best_model=False: seen.append(d) or {"group_auc": 0.5}
    best = tr.fit(data, valid_data="valid")
    assert best == {"group_auc": 0.5} and os.path.exists(tr.saved_model_file)
    assert len(seen) == min(epochs_run + 1, 6) and tr._global_step == 2 * epochs_run
    assert float(tr.opt_state["learning_rate"]) == pytest.approx(lr)


def _step_pair(args):
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

    tmodel = get_model_class("SASRec")(tcfg)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    tparams = list(tmodel.parameters())
    tloss, _ = tmodel({k: torch.from_numpy(v) for k, v in batch.items()}, train=True,
                      rng=DropoutRNG(0, "cpu"))
    tgrads = torch.autograd.grad(tloss, tparams)
    opt = build_optimizer(tcfg)
    tupd, _ = opt.update(list(tgrads), opt.init(tparams), tparams)
    with torch.no_grad():
        for p, u in zip(tparams, tupd):
            p.add_(u)
    return (float(tloss.detach()), float(jloss), dict(_flat(to_flax_tree(tmodel, tgrads))),
            dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads))),
            dict(_flat(to_flax_params(tmodel))), dict(_flat(jnew)))


def test_one_train_step_of_the_slice_matches_jax_f32(monkeypatch):
    for mod in (jax_attn, jax_sa, jax_member):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    args = {**BENCH_MINI, **SLICE, "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0}
    tloss, jloss, tg, jg, tp, jp = _step_pair(args)
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert set(tg) == set(jg)
    for k in jg:
        err = float(np.abs(tg[k] - jg[k]).max())
        assert err < 1e-5 + 1e-3 * float(np.abs(jg[k]).max()), (k, err)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-6, rtol=0, err_msg=str(k))
    assert np.abs(tg[("trm_encoder", "layer_0", "feed_forward", "dense_1", "kernel")]).max() > 0


def test_the_slice_flags_reach_the_fused_wrappers(monkeypatch):
    """On the CPU the wrappers run their plain versions; the model under
    the slice's flags calls them (layer 0 attention, both FFNs) and draws
    the attention dropout from one kernel seed."""
    calls = {"attn": 0, "ffn": 0}
    real_attn, real_ffn = AT.fused_attention, FF.fused_ffn

    def attn(*a, **k):
        calls["attn"] += 1
        assert a[4] == 0.1 and isinstance(a[5], int)
        return real_attn(*a, **k)

    def ffn(*a, **k):
        calls["ffn"] += 1
        return real_ffn(*a, **k)

    monkeypatch.setattr(AT, "fused_attention", attn)
    monkeypatch.setattr(FF, "fused_ffn", ffn)
    cfg = torch_config.parse_arguments(dict(BENCH_MINI, **SLICE), argv=[], device="cpu")
    model = get_model_class("SASRec")(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, _ = model(batch, train=True, rng=DropoutRNG(1, "cpu"))
    loss.backward()
    assert calls == {"attn": 1, "ffn": 2}


@pytest.mark.parametrize("L,device,refused", [
    (50, "cuda", False), (285, "cuda", False), (300, "cuda", False), (512, "cuda", False),
    (513, "cuda", False), (300, "cpu", False)])
def test_fused_attention_lengths_the_kernels_do_not_take_are_refused_on_the_card(
        L, device, refused):
    """No sequence length is refused any more: csrc/attention.cu takes every
    L the JAX gate takes (L <= 512; the tiled kernels beyond L = 285 at head
    width 32), beyond the gate the model runs its plain attention, and on
    the CPU the plain versions take any L. The check reads the config alone,
    on any device, and the kernels' range is the gate's at every head width
    (the tiled pair's shared memory does not grow with it)."""
    cfg = dict(SLICE, hidden_size=64, n_heads=2, max_seq_len=L)
    assert not refused and device in ("cuda", "cpu")
    main._refuse_unported(cfg, "train")
    main._refuse_unported(dict(cfg, use_fused_attention=0), "train")
    if L <= AT.MAX_FUSED_SEQ_LEN:
        for hd in (8, 32, 64, 128, 136, 256):
            assert max(AT._fwd_tiled_smem_bytes(L, hd),
                       AT._bwd_tiled_smem_bytes(L, hd)) <= LY._SMEM_LIMIT
    assert AT._tiled(L, 32) == (285 < L)
