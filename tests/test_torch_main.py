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
import json
import os
import pickle
import sys

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
from unirec_tpu.facility.trainer import Trainer as JaxTrainer
from unirec_tpu.facility.trainer import early_stopping as jax_early_stopping
from unirec_tpu.main import main as jax_main
from unirec_tpu.utils import file_io as jax_file_io
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
from unirec_tpu_torch.utils.checkpoint import save_checkpoint
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params, to_flax_tree
from unirec_tpu_torch.utils.registry import get_model_class

SLICE = dict(model="SASRec", dataloader="SeqRecDataset", embedding_size=16, hidden_size=16,
             n_layers=2, n_heads=2, inner_size=32, last_query_only=1, fused_layer=0,
             fused_lastq=0, use_fused_attention=1, use_fused_ffn=1, vmem_embedding_grad=1,
             neg_membership_pallas=1, hidden_dropout_prob=0.1, attn_dropout_prob=0.1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread: six xdist workers with eight-thread teams
    each stall small ops by orders of magnitude (tests/test_torch_seq_family.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    cfg = torch_config.parse_arguments(dict(dict(BENCH_MINI, **SLICE, epochs=6,
                                                 output_path=str(tmp_path), exp_name="v"),
                                            **over), argv=[], device="cpu")
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


# ------------------------------------- repairs: freeze, use_pre_item_emb, orbax
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_freeze_holds_the_loaded_parameters_as_jax_does(tmp_path, wd):
    """A pretrained checkpoint with the item and position embeddings, loaded
    under freeze: the port marks the parameters the JAX trainer's
    _frozen_mask marks; after an epoch (2 steps) they are bit-identical
    without weight decay, and with it equal JAX's optax chain on zero
    gradients (the decayed-weight term moves them); the rest move."""
    tr, data = _trainer(tmp_path, freeze=1, weight_decay=wd, epochs=1)
    tr.init_params()
    full = jax.tree_util.tree_map(np.array, to_flax_params(tr.model))   # copies
    pre = {k: full[k] for k in ("item_embedding", "position_embedding")}
    path = str(tmp_path / "pre.pkl")
    save_checkpoint(path, {"config": {}, "params": pre})
    tr.fit(data, load_pretrained_model=True, model_file=path)
    assert tr._global_step == 2
    frozen = dict(_flat(to_flax_tree(tr.model, [torch.full(p.shape, float(f))
                                                for p, f in zip(tr.params, tr._frozen)])))
    jcfg = jax_config.parse_arguments(dict(tr.config), argv=[])
    jtr = JaxTrainer(jcfg, jax_model_class("SASRec")(cfg=jcfg))
    jtr.params = jax.tree_util.tree_map(jnp.asarray, full)
    jtr.load_model(path)
    jmask = dict(_flat(jtr._frozen_mask()))
    assert set(jmask) == set(frozen) and sum(map(bool, jmask.values())) == 2
    assert all(bool(jmask[k]) == bool(frozen[k].all()) == bool(frozen[k].any())
               for k in jmask)
    tx = jax_optim.build_optimizer(jcfg)
    p = jax.tree_util.tree_map(jnp.asarray, pre)
    state = tx.init(p)
    for _ in range(2):
        upd, state = tx.update(jax.tree_util.tree_map(jnp.zeros_like, p), state, p)
        p = optax.apply_updates(p, upd)
    after = dict(_flat(to_flax_params(tr.model)))
    for k, v in _flat(pre):
        if wd == 0:
            np.testing.assert_array_equal(after[k], v, err_msg=str(k))
        else:
            assert not np.array_equal(after[k], v)
        np.testing.assert_allclose(after[k], dict(_flat(p))[k], atol=1e-6, rtol=0,
                                   err_msg=str(k))
    moved = [k for k, v in _flat(full) if not jmask[k] and not np.array_equal(after[k], v)]
    assert len(moved) == len(jmask) - 2


def _write_item_emb(path, n_items, d, seed=0):
    """``id<TAB>v1,...`` lines for items 1..n_items-1 in shuffled order."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n_items - 1, d)).astype(np.float32)
    with open(path, "w") as f:
        for i in rng.permutation(n_items - 1):
            f.write(f"{i + 1}\t" + ",".join(repr(float(x)) for x in emb[i]) + "\n")
    return emb


def test_pre_item_emb_starts_the_item_table_from_the_file(synth_dataset, tmp_path):
    """main.run with use_pre_item_emb and item_emb_path: the port's item
    table starts as the file's rows under a zero padding row, equal to the
    JAX model's initial table from the same file."""
    root, _ = synth_dataset
    emb_path = str(tmp_path / "item_emb.txt")
    emb = _write_item_emb(emb_path, 301, 16)
    seen, fit = {}, Trainer.fit

    def spy(self, *a, **k):
        out = fit(self, *a, **k)
        seen["table"] = self.model.item_embedding.weight.detach().numpy().copy()
        return out

    args = dict(BASE_CONF, **SLICE, dataset_path=root, output_path=str(tmp_path / "out"),
                exp_name="pre_emb", epochs=0, data_valid_name="none", use_pre_item_emb=1,
                item_emb_path=emb_path, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "fit", spy)
        main.run(dict(args))
    padded = np.concatenate([np.zeros((1, 16), np.float32), emb])
    np.testing.assert_array_equal(main._padded_emb(main.file_io.load_pre_item_emb(emb_path)),
                                  padded)
    np.testing.assert_array_equal(seen["table"], padded)
    jcfg = jax_config.parse_arguments({k: v for k, v in args.items() if k != "device"},
                                      argv=[])
    jcfg["_pre_item_emb"] = jax_main._padded_emb(jax_file_io.load_pre_item_emb(emb_path))
    jb = {"item_seq": jnp.ones((2, 10), jnp.int32), "user_id": jnp.ones(2, jnp.int32),
          "item_id": jnp.ones(2, jnp.int32), "label": jnp.ones(2)}
    jparams = jax_model_class("SASRec")(cfg=jcfg).init(jax.random.PRNGKey(0), jb,
                                                         train=False)["params"]
    np.testing.assert_array_equal(np.asarray(jparams["item_embedding"]["embedding"]), padded)


def test_orbax_checkpoints_are_refused(synth_dataset, tmp_path):
    """checkpoint_backend=orbax writes the port's torch.distributed.checkpoint
    directory <file>.dcp (utils/checkpoint.py), which task=test reads back
    to the same metrics; a JAX .orbax directory is refused by name."""
    root, _ = synth_dataset
    out = tmp_path / "run"
    res = main.run(dict(BASE_CONF, **SLICE, dataset_path=root, output_path=str(out),
                        checkpoint_backend="orbax", epochs=1, device="cpu"))
    ckpt = out / "checkpoint" / f"{BASE_CONF['exp_name']}.pkl"
    assert (out / "checkpoint" / f"{ckpt.name}.dcp" / "side.pkl").exists()
    assert not ckpt.exists()
    again = main.run(dict(task="test", model_file=str(ckpt), dataset_path=root,
                          output_path=str(tmp_path / "test"), device="cpu"))
    assert again == res
    (tmp_path / "jax.pkl.orbax").mkdir()
    with pytest.raises(ValueError, match="JAX orbax checkpoint"):
        main.run(dict(task="test", model_file=str(tmp_path / "jax.pkl"), dataset_path=root,
                      output_path=str(tmp_path / "test"), device="cpu"))


# ----------------------------------------------------------- observability
def _scalars(event_dir):
    """{tag: [steps]} of the scalar events under ``event_dir``."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(event_dir)
    acc.Reload()
    return {t: [e.step for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}


def test_tensorboard_writes_the_jax_tags_at_the_jax_steps(synth_dataset, tmp_path, monkeypatch):
    """Two epochs with validation under use_tensorboard: the port's events
    hold the tags and steps of the JAX trainer's (whose writer is flushed
    here after each write, as the port's writer flushes itself)."""
    root, _ = synth_dataset
    args = dict(BASE_CONF, model="SASRec", dataloader="SeqRecDataset", embedding_size=8,
                hidden_size=8, n_heads=2, inner_size=16, epochs=2, n_sample_neg_train=3,
                dataset_path=root, exp_name="tb", use_tensorboard=1)
    main.run(dict(args, output_path=str(tmp_path / "port"), device="cpu"))
    log = JaxTrainer._log_scalars
    monkeypatch.setattr(JaxTrainer, "_log_scalars",
                        lambda self, *a: (log(self, *a), self._tb.flush()))
    jax_main.run(dict(args, output_path=str(tmp_path / "jax")))
    got = _scalars(str(tmp_path / "port" / "tensorboard"))
    ref = _scalars(str(tmp_path / "jax" / "tensorboard"))
    assert got == ref
    assert got["train/loss"] == [1, 2] and got["valid/ndcg@5"] == [0, 1]
    assert set(got) == {"train/loss", "train/epoch_seconds", "valid/hit@5", "valid/hit@10",
                        "valid/ndcg@5", "valid/ndcg@10"}


def test_use_wandb_warns_and_disables_without_the_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)     # import wandb raises ImportError
    tr, _ = _trainer(tmp_path, use_wandb=1, exp_name="wandb_off")
    assert tr._wandb is None and tr._tb is None
    tr._log_scalars({"train/loss": 1.0}, 1)
    logs = glob.glob(str(tmp_path / "wandb_off.*.log"))
    assert logs and "wandb unavailable; disabling" in open(logs[0]).read()


@pytest.mark.parametrize("outcome", ["returns", "raises"])
def test_profile_writes_a_trace_and_leaves_no_profiler_running(trained, tmp_path, outcome):
    """profile=1 on task=test from the slice's checkpoint: a Chrome trace
    under <output_path>/profile that holds the evaluation's ops, and no
    profiler left running; when run raises (no test table), the profiler
    stops too and no trace is written."""
    args, result, out, _ = trained
    data = args["dataset_path"] if outcome == "returns" else str(tmp_path / "empty")
    run = {"task": "test", "model_file": os.path.join(out, "checkpoint", "slice.pkl"),
           "dataset_path": data, "output_path": str(tmp_path), "profile": 1, "device": "cpu"}
    if outcome == "raises":
        with pytest.raises(FileNotFoundError):
            main.run(run)
    else:
        assert main.run(run) == result
    assert not torch.autograd._profiler_enabled()
    traces = glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))
    if outcome == "raises":
        assert traces == [] and not glob.glob(str(tmp_path / "profile" / "*.counters.json"))
        return
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("addmm" in e.get("name", "") or "matmul" in e.get("name", "") for e in events)


def test_profile_writes_the_runs_counters_beside_the_trace(trained, tmp_path, monkeypatch):
    """profile=1 writes tracing.counters() as <exp_name>.counters.json: every
    counter, as counted while the run was traced (what the process counted
    before is not in it); the trace holds the port's spans."""
    from unirec_tpu_torch.ops import topk as TK
    from unirec_tpu_torch.utils import tracing
    args, result, out, _ = trained
    monkeypatch.setattr(TK.fused_catalog_topk, "users", 7)
    monkeypatch.setattr(TK.catalog_blockmax, "launches", 5)
    run = {"task": "test", "model_file": os.path.join(out, "checkpoint", "slice.pkl"),
           "dataset_path": args["dataset_path"], "output_path": str(tmp_path), "profile": 1,
           "exp_name": "counted", "device": "cpu"}
    assert main.run(run) == result
    with open(tmp_path / "profile" / "counted.counters.json") as f:
        counted = json.load(f)
    assert set(counted) == set(tracing.counters())
    assert counted["topk_users"] == 0 and counted["blockmax"] == 0
    assert all(isinstance(v, int) and v >= 0 for v in counted.values())
    with open(tmp_path / "profile" / "counted.pt.trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"data.to_device", "model.user_emb"} <= names


# ------------- the slice's path: popularity negatives, T5 validation, sessions
POP_SESSION = dict(neg_by_pop_alpha=1.0, data_valid_name="test_multipos",
                   valid_file_format="user-item_seq", data_test_name="test_session",
                   test_file_format="user-item-label-session", test_protocol="session_aware",
                   metrics="['group_auc', 'hit@5;10', 'ndcg@5']", key_metric="hit@10")


@pytest.fixture(scope="module")
def pop_session(synth_dataset, tmp_path_factory):
    """main.run(task=train) with popularity negatives, multi-positive
    one-vs-all validation and a session-wise test, on the CPU."""
    root, _ = synth_dataset
    out = str(tmp_path_factory.mktemp("pop_session"))
    args = dict(BASE_CONF, **SLICE, **POP_SESSION, dataset_path=root, output_path=out,
                exp_name="pop", epochs=2, learning_rate=0.01, device="cpu")
    seen = {"losses": [], "valid": []}
    step, validate = Trainer.train_step, Trainer._validate

    def spy_step(self, batch):
        seen["alias"] = self._augmenter.use_alias
        seen["losses"].append(float(step(self, batch)))
        return torch.tensor(seen["losses"][-1])

    def spy_validate(self, data, *a, **k):
        seen["valid"].append(type(self.evaluator).__name__)
        return validate(self, data, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "train_step", spy_step)
        mp.setattr(Trainer, "_validate", spy_validate)
        result = main.run(copy.deepcopy(args))
    return args, result, out, seen


def test_pop_session_path_trains_and_evaluates(pop_session):
    args, result, out, seen = pop_session
    assert seen["alias"] and seen["valid"] == ["MultiPositiveEvaluator"] * 2
    assert set(result) == {"group_auc", "hit@5", "hit@10", "ndcg@5"}
    assert all(0.0 <= v <= 1.0 for v in result.values()) and 0.0 < result["group_auc"] < 1.0
    n = len(seen["losses"]) // 2
    assert np.isfinite(seen["losses"]).all()
    assert np.mean(seen["losses"][n:]) < np.mean(seen["losses"][:n])
    with open(os.path.join(out, "checkpoint", "pop.pkl"), "rb") as f:
        best = pickle.load(f)["best_valid_result"]
    assert set(best) == {"group_auc", "hit@5", "hit@10", "ndcg@5"}


def test_pop_session_test_from_the_checkpoint_repeats_and_matches_jax(pop_session):
    """task=test from the best checkpoint repeats the session metrics
    exactly; the JAX package's task=test on the port's checkpoint gives them
    within 1e-6 (the same noise on f32 scores that agree to about 1e-7)."""
    args, result, out, _ = pop_session
    run = {"task": "test", "model_file": os.path.join(out, "checkpoint", "pop.pkl"),
           "dataset_path": args["dataset_path"]}
    assert main.run(dict(run, output_path=out + "_test", device="cpu")) == result
    ref = jax_main.run(dict(run, output_path=out + "_jax"))
    assert set(ref) == set(result)
    for m in result:
        assert abs(result[m] - ref[m]) <= 1e-6, (m, result[m], ref[m])
