"""The port's ranking models (FM, BST, AdaRanker) and their data
(RankDataset, T7 libFM rows, the host T7 batches, load_xlearn_fm) against
the JAX package.

Small models (d=16, 40 items, 30 features, L=8, groups of 4, 2 layers of
2 heads, inner 24), inputs from a numpy seed, weights through the flax
bridge, dropout 0, f32, vmem_embedding_grad on (the JAX scatter kernel in
Pallas interpret mode, the port's plain version): ``predict`` scores, the
loss at ``train=False`` (the Ada-Ranker set encoder draws no noise there)
and every parameter gradient within 1e-5 absolute, for

- FM flat and grouped (``group_size``), which gathers through plain
  indexing in both packages;
- BST flat and grouped, plain and with ``use_fused_attention`` and
  ``use_fused_ffn`` (the JAX kernels in Pallas interpret mode, the port's
  plain versions), at the head width 16 and the odd length L + 1 = 9;
- AdaRanker for {GRU, SASRec} x {Base, Ada-Ranker} x
  ``ada_reference_init`` {0, 1}.

Also the AdaRanker initializers by mean and std against the JAX draws, the
fine-tuning of an Ada-Ranker from a Base checkpoint (the non-strict merge),
RankDataset's and T7's columns and the host T7 batches equal to JAX's,
``load_xlearn_fm`` equal to JAX's on one file, and ``main.run`` train ->
test of each model on tests/synth.py's rank data (auc above
tests/test_rank_models.py's gates), with the JAX ``main.run(task=test)``
on the port's BST checkpoint within 1e-5 of each metric.
"""
import copy
import math
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.ops.attention as jax_attn
import unirec_tpu.ops.scatter_accum as jax_sa
from tests.synth import BASE_CONF
from tests.test_rank_models import RANK_CONF
from tests.test_torch_cf import assert_model_matches_jax
from unirec_tpu import config as jax_config
from unirec_tpu.data import datasets as jax_ds
from unirec_tpu.data.pipeline import Batcher as JaxBatcher
from unirec_tpu.main import main as jax_main
from unirec_tpu.models import rank as jax_rank
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.data.datasets import get_dataset_class
from unirec_tpu_torch.data.pipeline import Batcher, make_train_batcher
from unirec_tpu_torch.facility.trainer import Trainer
from unirec_tpu_torch.main import main
from unirec_tpu_torch.models import rank as torch_rank
from unirec_tpu_torch.utils.checkpoint import load_checkpoint
from unirec_tpu_torch.utils.flax_bridge import to_flax_params
from unirec_tpu_torch.utils.registry import get_model_class as torch_model_class

B, L, N_ITEMS, N_FEATS, G, F_ = 5, 8, 40, 30, 4, 3
TRM = dict(n_layers=2, n_heads=2, inner_size=24, hidden_act="swish",
           hidden_dropout_prob=0.0, attn_dropout_prob=0.0, loss_type="bce", n_feats=N_FEATS)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    for mod in (jax_sa, jax_attn):
        monkeypatch.setattr(mod, "_INTERPRET", True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread: six xdist workers with eight-thread teams
    each stall small ops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(grouped=True, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, N_ITEMS, size=(B, L))
    seq[0, :5] = 0
    seq[1, :] = 0
    shape = (B, G) if grouped else (B,)
    label = np.zeros(shape, np.float32)
    if grouped:
        label[:, 0] = 1.0
    else:
        label[::2] = 1.0
    weight = np.ones(B, np.float32)
    weight[-1] = 0.0
    return {"user_id": rng.integers(1, 15, B).astype(np.int32),
            "item_id": rng.integers(1, N_ITEMS, shape).astype(np.int32),
            "label": label, "weight": weight, "item_seq": seq.astype(np.int32),
            "item_seq_len": (seq != 0).sum(1).astype(np.int32),
            "index_list": rng.integers(0, N_FEATS, (*shape, F_)).astype(np.int32),
            "value_list": rng.random((*shape, F_)).astype(np.float32)}


@pytest.mark.parametrize("grouped", [False, True])
def test_fm_matches_jax(grouped):
    batch = _batch(grouped)
    over = dict(TRM, group_size=-1)
    if not grouped:          # flat rows folded into groups of 5 by the loss
        over["group_size"] = B
    jg, _ = assert_model_matches_jax("FM", over, batch)
    assert np.abs(jg[("fm_embedding", "embedding")]).max() > 0


BST_CASES = [(g, fused) for g in (False, True) for fused in (False, True)]


@pytest.mark.parametrize("grouped,fused", BST_CASES,
                         ids=[f"{'grouped' if g else 'flat'}-{'fused' if f else 'plain'}"
                              for g, f in BST_CASES])
def test_bst_matches_jax(grouped, fused):
    """With both fused flags the JAX side runs its FFN kernel and its XLA
    attention: its fused attention reads BST's [B, 1, 1, L] mask out of
    its block (the next test)."""
    over = dict(TRM, use_fused_attention=int(fused), use_fused_ffn=int(fused),
                layer_norm_eps="1e-10", seq_decay=-0.3)
    jg, _ = assert_model_matches_jax("BST", over, _batch(grouped, seed=2),
                                     jax_over=dict(use_fused_attention=0))
    assert np.abs(jg[("position_embedding", "embedding")]).max() > 0


@pytest.mark.parametrize("L", [8, 9, 21])
def test_jax_fused_attention_reads_a_key_padding_mask_out_of_its_block(L):
    """The JAX package's fused attention takes BST's bidirectional mask
    [B, 1, 1, L] where its block spec reads [L, L] rows of it
    (unirec_tpu/ops/attention.py:315-335): its outputs are NaN (out of the
    block, in interpret mode) at every L; broadcast to [B, 1, L, L] they
    equal the XLA attention. The port expands the mask before its kernel
    (ops/attention.py::_operands): its plain version on the [B, 1, 1, L]
    mask equals the XLA attention within 1e-6."""
    from unirec_tpu_torch.ops import attention as AT
    rng = np.random.default_rng(L)
    q, k, v = (rng.normal(size=(4, 2, L, 16)).astype(np.float32) for _ in range(3))
    mask = np.where(rng.integers(0, 5, (4, 1, 1, L)) > 0, 0.0, -1e4).astype(np.float32)
    jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
    ref = np.asarray(jax_attn.xla_attention(jq, jk, jv, jm))
    assert np.isnan(np.asarray(jax_attn.short_attention(jq, jk, jv, jm))).any()
    full = jnp.broadcast_to(jm, (4, 1, L, L))
    np.testing.assert_allclose(np.asarray(jax_attn.short_attention(jq, jk, jv, full)), ref,
                               atol=1e-6, rtol=0)
    got = AT.short_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)), 0.0, None, False)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


ADA_CASES = [(base, tt, ref) for base in ("GRU", "SASRec") for tt in ("Base", "Ada-Ranker")
             for ref in (0, 1)]


@pytest.mark.parametrize("base,train_type,ref_init", ADA_CASES,
                         ids=[f"{b}-{t}-ref{r}" for b, t, r in ADA_CASES])
def test_adaranker_matches_jax(base, train_type, ref_init):
    over = dict(TRM, base_model=base, train_type=train_type, ada_reference_init=ref_init,
                n_layers=1)
    jg, _ = assert_model_matches_jax("AdaRanker", over, _batch(True, seed=3))
    assert np.abs(jg[("mlp_1", "kernel" if train_type == "Base" else "weight")]).max() > 0
    if train_type == "Ada-Ranker":
        assert np.abs(jg[("mem_w1", "index")]).max() > 0


def _leaf(tree, *path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float64).ravel()


INIT_LEAVES = [(0, ("mem_w1", "array")), (0, ("mem_b1", "array")), (1, ("mem_w1", "array")),
               (0, ("mem_w1", "index")), (0, ("mlp_1", "weight")), (0, ("mlp_1", "bias")),
               (0, ("extract_distribution_layer", "input_hidden", "kernel")),
               (0, ("extract_distribution_layer", "hidden_to_logsigma", "bias")),
               (1, ("extract_distribution_layer", "hidden_to_logsigma", "bias")),
               (0, ("film_affine_emb_scale", "bias")), (1, ("mem_b2", "array")),
               (0, ("dense", "kernel")), (0, ("gru_layers", "cell", "hr", "kernel"))]


@pytest.mark.parametrize("ref_init,path", INIT_LEAVES,
                         ids=[f"ref{r}-" + "/".join(p) for r, p in INIT_LEAVES])
def test_adaranker_init_draws_match_jax(ref_init, path):
    """Each leaf's draw against the JAX draw: equal constants, else the
    mean within 4 standard errors and the std within 5 (relative
    5 / sqrt(2n)) of the other's."""
    args = dict(TRM, model="AdaRanker", n_users=15, n_items=N_ITEMS, embedding_size=64,
                max_seq_len=L, ada_reference_init=ref_init, dropout_prob=0.0)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    jparams = jax_model_class("AdaRanker")(cfg=jax_config.parse_arguments(
        dict(args), argv=[])).init(jax.random.PRNGKey(7), jb)["params"]
    tmodel = torch_model_class("AdaRanker")(torch_config.parse_arguments(dict(args), argv=[],
                                                                         device="cpu"))
    tmodel.init_weights(torch.Generator().manual_seed(7))
    ref, got = _leaf(jparams, *path), _leaf(to_flax_params(tmodel), *path)
    assert ref.shape == got.shape
    if ref.std() == 0:
        np.testing.assert_array_equal(got, ref)
        return
    n = ref.size
    assert abs(got.mean() - ref.mean()) < 4 * ref.std() * math.sqrt(2.0 / n)
    assert abs(got.std() - ref.std()) < 5.0 / math.sqrt(2 * n) * ref.std()


def _rank_conf(root, tmp, model, **kw):
    conf = copy.deepcopy(BASE_CONF)
    conf.update(RANK_CONF)
    conf.update(model=model, dataset_path=root, task="train", device="cpu",
                output_path=os.path.join(tmp, model), data_train_name="rank_train",
                data_valid_name="rank_valid", data_test_name="rank_test",
                train_file_format="user-item_group-label_group",
                valid_file_format="user-item_group-label_group",
                test_file_format="user-item_group-label_group", dataloader="SeqRecDataset")
    conf.update(kw)
    return conf


FM_RUN = dict(dataloader="RankDataset", group_size=6, data_train_name="libfm_train",
              data_valid_name="libfm_valid", data_test_name="libfm_test",
              train_file_format="label-index_group-value_group",
              valid_file_format="label-index_group-value_group",
              test_file_format="label-index_group-value_group", epochs=8,
              learning_rate=0.05)


@pytest.mark.parametrize("group", [6, -1])
def test_rank_dataset_and_t7_columns_equal_jax(synth_dataset, group):
    root, info = synth_dataset
    cfg = dict(info, data_format="label-index_group-value_group", data_loader_task="train",
               group_size=group, batch_size=64, seed=3)
    ours = get_dataset_class("RankDataset")(dict(cfg), root, "libfm_train")
    ref = jax_ds.RankDataset(dict(cfg), root, "libfm_train")
    assert ours.n_rows == ref.n_rows and set(ours.cols) == set(ref.cols)
    for k in ref.cols:
        np.testing.assert_array_equal(ours.cols[k], ref.cols[k], err_msg=k)
    got = list(Batcher(ours, cfg, batch_size=64, seed=3, shuffle=True))
    want = list(JaxBatcher(ref, cfg, batch_size=64, seed=3, shuffle=True))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # T7 rows train on these host batches: no device augmenter
    batcher, aug = make_train_batcher(ours, dict(cfg, shuffle_train=1), None, device="cpu")
    assert aug is None and isinstance(batcher, Batcher) and batcher.shuffle


def test_t4_rank_rows_of_a_rank_dataset_equal_jax(synth_dataset):
    root, info = synth_dataset
    cfg = dict(info, data_format="user-item_group-label_group", data_loader_task="valid",
               group_size=3, eval_protocol="one_vs_k")
    ours = get_dataset_class("RankDataset")(dict(cfg), root, "rank_valid")
    ref = jax_ds.RankDataset(dict(cfg), root, "rank_valid")
    assert set(ours.cols) == set(ref.cols) == {"user_id", "user_id_group", "item_id", "label"}
    for k in ref.cols:
        np.testing.assert_array_equal(ours.cols[k], ref.cols[k], err_msg=k)


def test_load_xlearn_fm_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    n, d = 7, 3
    path = tmp_path / "fm.txt"
    with open(path, "w") as f:
        f.write(f"bias: {rng.normal():.6f}\n")
        for i in range(n):
            f.write(f"i_{i}: {rng.normal():.6f}\n")
        for i in range(n):
            f.write(f"v_{i}: " + " ".join(f"{x:.6f}" for x in rng.normal(size=d)) + "\n")
    got, want = torch_rank.load_xlearn_fm(str(path), n, d), jax_rank.load_xlearn_fm(str(path), n, d)
    assert got["fm_embedding"]["embedding"].shape == (n, d)
    for k in ("fm_linear_bias", "fm_linear_weight"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["fm_embedding"]["embedding"],
                                  want["fm_embedding"]["embedding"])


@pytest.fixture(scope="module")
def rank_runs(synth_dataset, tmp_path_factory):
    root, _ = synth_dataset
    out = str(tmp_path_factory.mktemp("rank"))
    runs = {}
    for name, model, over in (
            ("FM", "FM", FM_RUN),
            # attention dropout off: the plain version draws the kernel's
            # Philox masks, five times the CPU step (tests/test_torch_main.py
            # runs the fused attention with dropout)
            ("BST", "BST", dict(use_fused_attention=1, use_fused_ffn=1, attn_dropout_prob=0.0)),
            ("Base-GRU", "AdaRanker", dict(train_type="Base", base_model="GRU",
                                           learning_rate=0.01))):
        args = _rank_conf(root, out, model, exp_name=name, **over)
        args["output_path"] = os.path.join(out, name)
        runs[name] = (args, main.run(dict(args)))
    return runs


@pytest.mark.parametrize("name", ["FM", "BST", "Base-GRU"])
def test_main_run_trains_and_tests_from_the_checkpoint(rank_runs, name):
    """tests/test_rank_models.py's gates. An Ada-Ranker trained from
    scratch on this data leaves its starting plateau at some seeds only
    (the JAX package's at 2 of 3 seeds tried, the port's at 1 of 4), so
    the Ada-Ranker runs here start from the Base checkpoint (the last
    test)."""
    args, result = rank_runs[name]
    assert result["auc"] > 0.65, (name, result)
    if name != "Base-GRU":
        assert result["group_auc"] > 0.6, (name, result)
    ckpt = os.path.join(args["output_path"], "checkpoint", f"{name}.pkl")
    again = main.run({"task": "test", "model_file": ckpt, "dataset_path": args["dataset_path"],
                      "output_path": args["output_path"] + "_test", "device": "cpu"})
    assert again == result


def test_jax_main_tests_the_port_bst_checkpoint(rank_runs):
    """The JAX run takes use_fused_attention=0 over the checkpoint's 1: its
    fused attention is NaN on BST's mask (see above); the XLA attention is
    the same function."""
    args, result = rank_runs["BST"]
    ckpt = os.path.join(args["output_path"], "checkpoint", "BST.pkl")
    ref = jax_main.run({"task": "test", "model_file": ckpt, "dataset_path": args["dataset_path"],
                        "output_path": args["output_path"] + "_jax", "use_fused_attention": 0})
    assert set(ref) == set(result)
    for m in result:
        assert abs(result[m] - ref[m]) <= 1e-5, (m, result[m], ref[m])


def test_ada_ranker_fine_tunes_from_the_base_checkpoint(rank_runs, tmp_path):
    """load_pretrained_model: the Base run's item table, GRU and dense start
    the Ada-Ranker run (merged by path and shape, trainer.py:547), its
    modulation keeps its own init; the run trains to the rankers' gate."""
    base_args, _ = rank_runs["Base-GRU"]
    base_ckpt = os.path.join(base_args["output_path"], "checkpoint", "Base-GRU.pkl")
    args = dict(base_args, train_type="Ada-Ranker", load_pretrained_model=1,
                model_file=base_ckpt, exp_name="finetune", epochs=3,
                output_path=str(tmp_path / "finetune"))
    seen = {}
    load = Trainer.load_model

    def spy(self, filename, restore_optimizer=False):
        ckpt = load(self, filename, restore_optimizer)
        # the first load is fit's pretrained one
        seen.setdefault("params", copy.deepcopy(to_flax_params(self.model)))
        seen.setdefault("loaded", list(self._loaded))
        return ckpt

    with mock.patch.object(Trainer, "load_model", spy):
        result = main.run(dict(args))
    base = load_checkpoint(base_ckpt)["params"]
    for path in (("item_embedding", "embedding"), ("dense", "kernel"),
                 ("gru_layers", "cell", "ir", "kernel")):
        np.testing.assert_array_equal(_leaf(seen["params"], *path), _leaf(base, *path))
    assert "mem_w1" in seen["params"] and "mem_w1" not in base
    assert 0 < sum(seen["loaded"]) < len(seen["loaded"])
    assert result["auc"] > 0.65, result
