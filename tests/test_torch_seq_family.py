"""The port's sequential family (GRU, AvgHist, AttHist, SVDPlusPlus,
ConvFormer, FASTConvFormer) against the JAX models with the same weights.

Small models (L=12, d=32, 60 items, 2 layers, inner 40, conv_size 4, the
GRU's hidden 48), inputs from a numpy seed, weights through the flax
bridge, vmem_embedding_grad on (the JAX scatter kernel in Pallas interpret
mode, the port's plain version), dropout 0:

- f32: user embeddings, ``predict`` scores, the BCE loss of a grouped
  batch (a padded row included) and every parameter gradient within 1e-5
  absolute, the GRU's 12-step scan included. Cases cover the depthwise
  mixer's three padding modes, ``seq_merge`` and AvgHist with
  ``asymmetric`` on and off.
- bf16: user embeddings and scores within two bf16 ulps of the largest
  value.
- initialization: the GRU's lecun-normal and orthogonal kernels, the conv
  mixers' normal(init_ratio) and normal(0.02) draws and the attention
  pooling's normal(1.0) vector against the JAX draws by mean and std.
- ``main.run(task=train)`` of each model on tests/synth.py's data beats
  twice the random hit@5 (tests/test_seq_models.py:39-51), and the JAX
  ``main.run(task=test)`` reads the port's ConvFormer checkpoint to the
  same metrics.
"""
import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.ops.scatter_accum as jax_sa
from tests.synth import BASE_CONF
from unirec_tpu import config as jax_config
from unirec_tpu.main import main as jax_main
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.main import main
from unirec_tpu_torch.models.modules import DropoutRNG
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params, to_flax_tree
from unirec_tpu_torch.utils.registry import get_model_class as torch_model_class

B, L, N_ITEMS, N_USERS, N_NEG = 6, 12, 60, 20, 3
SMALL = dict(n_users=N_USERS, n_items=N_ITEMS, embedding_size=32, max_seq_len=L,
             conv_size=4, inner_size=40, n_layers=2, hidden_dropout_prob=0.0,
             attn_dropout_prob=0.0, dropout_prob=0.0, loss_type="bce",
             vmem_embedding_grad=1, compute_dtype="float32")
MODELS = {"GRU": dict(hidden_size=48), "AvgHist": {}, "AttHist": {},
          "SVDPlusPlus": {}, "ConvFormer": {}, "FASTConvFormer": {}}
CASES = [("GRU", {}), ("AvgHist", dict(asymmetric=True)), ("AvgHist", dict(asymmetric=False)),
         ("AttHist", {}), ("SVDPlusPlus", {}),
         ("ConvFormer", dict(padding_mode="circular")),
         ("ConvFormer", dict(padding_mode="reflect")),
         ("ConvFormer", dict(padding_mode="constant")),
         ("ConvFormer", dict(seq_merge=True)), ("FASTConvFormer", {}),
         ("FASTConvFormer", dict(seq_merge=True, seq_decay=-0.5))]
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(jax_sa, "_INTERPRET", True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread: the suite runs six workers on the
    machine's cores, where torch's thread teams in every worker stall each
    other's small ops (six concurrent copies of this file's training runs
    took over 900 s at eight threads each, 23 s at one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, N_ITEMS, size=(B, L))
    lens = np.full(B, L)
    for row, n in ((0, 4), (1, 0), (2, 1)):       # short, empty, one item
        seq[row, :L - n] = 0
        lens[row] = n
    item = rng.integers(1, N_ITEMS, size=(B, 1 + N_NEG))
    label = np.zeros((B, 1 + N_NEG), np.float32)
    label[:, 0] = 1.0
    weight = np.ones(B, np.float32)
    weight[-1] = 0.0                                 # a padded row
    return {"item_seq": seq.astype(np.int32), "item_seq_len": lens.astype(np.int32),
            "user_id": rng.integers(1, N_USERS, B).astype(np.int32),
            "item_id": item.astype(np.int32), "label": label, "weight": weight}


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _pair(name, over, seed=0):
    args = dict(SMALL, **MODELS[name], **over, model=name)
    jcfg = jax_config.parse_arguments(dict(args), argv=[])
    jmodel = jax_model_class(name)(cfg=jcfg)
    batch = _batch(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(seed), jb, train=False)["params"]
    tmodel = torch_model_class(name)(torch_config.parse_arguments(dict(args), argv=[],
                                                                  device="cpu"))
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jmodel, params, jb, tmodel.eval(), tb


@pytest.mark.parametrize("name,over", CASES,
                         ids=[n + "".join(f"-{k}={v}" for k, v in o.items()) for n, o in CASES])
def test_forward_loss_and_gradients_match_jax_f32(name, over):
    jmodel, params, jb, tmodel, tb = _pair(name, over)
    tol = F32_TOL
    ju = np.asarray(jmodel.apply({"params": params}, jb, method="user_emb"))
    jp = np.asarray(jmodel.apply({"params": params}, jb, method="predict"))

    def loss_fn(p):
        return jmodel.apply({"params": p}, jb, train=True,
                            rngs={"dropout": jax.random.PRNGKey(1)})[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    with torch.no_grad():
        tu, tp = tmodel.user_emb(tb), tmodel.predict(tb)
    assert tu.shape == (B, 32) and tp.shape == (B, 1 + N_NEG)
    np.testing.assert_allclose(tu.numpy(), ju, atol=tol, rtol=0)
    np.testing.assert_allclose(tp.numpy(), jp, atol=tol, rtol=0)
    params_t = list(tmodel.parameters())
    tloss, _ = tmodel(tb, train=True, rng=DropoutRNG(0, "cpu"))
    tgrads = dict(_flat(to_flax_tree(tmodel, torch.autograd.grad(tloss, params_t))))
    assert abs(float(tloss.detach()) - float(jloss)) <= tol
    jg = dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert set(tgrads) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tgrads[k], jg[k], atol=tol, rtol=0, err_msg=str(k))
    table = ("item_dst_embedding" if name == "SVDPlusPlus" or over.get("asymmetric")
             else "item_embedding", "embedding")
    assert np.abs(jg[table]).max() > 0 and not tgrads[table][0].any()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_matches_jax_within_two_ulps(name):
    jmodel, params, jb, tmodel, tb = _pair(name, dict(compute_dtype="bfloat16"), seed=3)
    ju = np.asarray(jmodel.apply({"params": params}, jb, method="user_emb"), np.float32)
    jp = np.asarray(jmodel.apply({"params": params}, jb, method="predict"), np.float32)
    with torch.no_grad():
        tu, tp = tmodel.user_emb(tb), tmodel.predict(tb)
    for got, ref in ((tu, ju), (tp, jp)):
        assert got.dtype == torch.float32     # flax's dtype=None promotion, as JAX
        ulp = 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), ref, atol=2 * ulp, rtol=0)


def _leaf(tree, *path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float64).ravel()


INIT_LEAVES = [("GRU", ("gru_layers", "cell", "ir", "kernel")),
               ("GRU", ("gru_layers", "cell", "hz", "kernel")),
               ("ConvFormer", ("mixer_0", "conv_kernel")),
               ("ConvFormer", ("mixer_0", "conv_bias")),
               ("FASTConvFormer", ("mixer_1", "conv_weight")),
               ("AttHist", ("attention", "h"))]


@pytest.mark.parametrize("name,path", INIT_LEAVES, ids=["/".join(p) for _, p in INIT_LEAVES])
def test_init_draws_match_jax_by_mean_and_std(name, path):
    """Each JAX initializer against the port's: the mean within 4 standard
    errors of 0, each std within 5 standard errors of a sample std
    (5 / sqrt(2n) relative) of the other and of the initializer's own; the
    biases of the GRU's input denses are zero in both."""
    args = dict(SMALL, model=name, embedding_size=64, hidden_size=96 if name == "GRU" else 64,
                conv_size=8, init_ratio=0.05)
    jcfg = jax_config.parse_arguments(dict(args), argv=[])
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    jparams = jax_model_class(name)(cfg=jcfg).init(jax.random.PRNGKey(7), jb)["params"]
    tmodel = torch_model_class(name)(torch_config.parse_arguments(dict(args), argv=[],
                                                                  device="cpu"))
    tmodel.init_weights(torch.Generator().manual_seed(7))
    tparams = to_flax_params(tmodel)
    ref, got = _leaf(jparams, *path), _leaf(tparams, *path)
    assert ref.shape == got.shape
    rel = 5.0 / math.sqrt(2 * ref.size)
    expected = {"conv_kernel": 0.05, "conv_bias": 0.05, "conv_weight": 0.02, "h": 1.0}
    if path[-1] in expected:
        assert abs(ref.std() - expected[path[-1]]) < rel * expected[path[-1]]
    for x in (ref, got):
        assert abs(x.mean()) < 4 * ref.std() / math.sqrt(x.size)
    assert abs(got.std() - ref.std()) < rel * ref.std()
    if name == "GRU":
        k = np.asarray(tparams["gru_layers"]["cell"]["hz"]["kernel"])
        np.testing.assert_allclose(k @ k.T, np.eye(96), atol=1e-5)   # orthogonal
        assert not tparams["gru_layers"]["cell"]["ir"]["bias"].any()
        assert "bias" not in tparams["gru_layers"]["cell"]["hr"]


def test_depthwise_padding_modes_differ_only_in_the_first_rows():
    """The three modes left-pad differently: only the first conv_size - 1
    positions can differ, the rest are the same valid convolution."""
    outs = {}
    for mode in ("circular", "reflect", "constant"):
        _, _, _, tmodel, tb = _pair("ConvFormer", dict(padding_mode=mode, n_layers=1))
        with torch.no_grad():
            x = torch.randn(2, L, 32, generator=torch.Generator().manual_seed(0))
            outs[mode] = tmodel.mixer_0(x)
    assert torch.allclose(outs["circular"][:, 3:], outs["constant"][:, 3:], atol=1e-6)
    assert torch.allclose(outs["reflect"][:, 3:], outs["constant"][:, 3:], atol=1e-6)
    assert not torch.allclose(outs["circular"][:, :3], outs["reflect"][:, :3])


RANDOM_HIT5 = 5.0 / 300.0
SEQ_CONF = dict(dataloader="SeqRecDataset", loss_type="fullsoftmax", n_sample_neg_train=0,
                epochs=6, learning_rate=0.005, hidden_dropout_prob=0.1, attn_dropout_prob=0.1,
                n_layers=1, n_heads=2, inner_size=64, conv_size=4)


@pytest.fixture(scope="module")
def convformer_run(synth_dataset, tmp_path_factory):
    root, _ = synth_dataset
    out = str(tmp_path_factory.mktemp("convformer"))
    args = dict(copy.deepcopy(BASE_CONF), **SEQ_CONF, model="ConvFormer", dataset_path=root,
                task="train", output_path=out, exp_name="convformer", device="cpu")
    return args, main.run(dict(args)), out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_main_run_trains_each_model(name, synth_dataset, tmp_path, convformer_run):
    if name == "ConvFormer":
        result = convformer_run[1]
    else:
        root, _ = synth_dataset
        args = dict(copy.deepcopy(BASE_CONF), **SEQ_CONF, model=name, dataset_path=root,
                    task="train", output_path=str(tmp_path), device="cpu")
        if name == "SVDPlusPlus":
            args["has_user_emb"] = True
        result = main.run(args)
    assert result["hit@5"] > 2 * RANDOM_HIT5, (name, result)
    assert result["hit@5"] <= result["hit@10"]


def test_jax_main_tests_the_port_convformer_checkpoint(convformer_run):
    args, result, out = convformer_run
    ckpt = os.path.join(out, "checkpoint", "convformer.pkl")
    again = main.run({"task": "test", "model_file": ckpt, "dataset_path": args["dataset_path"],
                      "output_path": out + "_test", "device": "cpu"})
    assert again == result
    ref = jax_main.run({"task": "test", "model_file": ckpt,
                        "dataset_path": args["dataset_path"], "output_path": out + "_jax"})
    assert set(ref) == set(result)
    for m in result:
        assert abs(result[m] - ref[m]) <= 1e-5, (m, result[m], ref[m])


def test_bce_of_a_confident_positive_is_nan_in_both_packages():
    """The reference's clamp of the sigmoid at 1 - 1e-8 is 1.0 in f32, so a
    score above about 16.6 leaves 1 - p at 0: the JAX package's loss is NaN
    on a confident positive and inf on a confident negative, and its
    trainer skips the step. The port takes 1 - p there as sigmoid(-s)
    clamped at 1e-8: the loss and its gradient equal the clamped formula in
    f64 (within 1e-6), and every row JAX computes finite is JAX's (within
    1e-6; the formula is the same op for op there)."""
    from unirec_tpu.ops import losses as jax_losses
    from unirec_tpu_torch.ops import losses as torch_losses
    scores = np.array([[18.0, -3.0], [2.0, -1.0], [-1.0, 17.5], [0.5, 25.0],
                       [-20.0, 1.5]], np.float32)
    labels = np.array([[1.0, 0.0]] * 5, np.float32)
    weight = np.ones(5, np.float32)
    _, jrow = jax_losses.bce_loss(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(weight))
    jrow = np.asarray(jrow)
    t = torch.from_numpy(scores).requires_grad_(True)
    loss, trow = torch_losses.bce_loss(t, torch.from_numpy(labels), torch.from_numpy(weight))
    (grad,) = torch.autograd.grad(loss, t)
    trow = trow.detach().numpy()
    assert np.isnan(jrow[0]) and np.isinf(jrow[2]) and np.isinf(jrow[3])
    finite = np.isfinite(jrow)
    np.testing.assert_allclose(trow[finite], jrow[finite], rtol=1e-6)

    s64, y = scores.astype(np.float64), labels.astype(np.float64)
    p = np.clip(1.0 / (1.0 + np.exp(-s64)), 1e-8, 1.0 - 1e-8)
    row = -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)).mean(-1)
    # d/ds of the clamped terms: 0 where the clamp holds, else p - y
    held = (p <= 1e-8) | (p >= 1.0 - 1e-8)
    g = np.where(held, 0.0, p - y) / (scores.size)
    assert np.isfinite(trow).all() and np.isfinite(grad.numpy()).all()
    np.testing.assert_allclose(trow, row, rtol=1e-6)
    # atol: p's last f32 step below 1.0 (2^-24), over the loss's 10 terms
    np.testing.assert_allclose(grad.numpy(), g, rtol=1e-6, atol=2.0 ** -24 / scores.size)


def test_cli_trains_and_tests_a_family_model(synth_dataset, tmp_path, capsys):
    """The port's cli with a family model: train, then test from its best
    checkpoint to the same metrics line."""
    from unirec_tpu_torch import cli
    root, _ = synth_dataset
    flags = ["--model", "AvgHist", "--dataloader", "SeqRecDataset", "--dataset_path", root,
             "--output_path", str(tmp_path), "--exp_name", "cli", "--epochs", "2",
             "--embedding_size", "16", "--device", "cpu", "--valid_protocol", "one_vs_all",
             "--test_protocol", "one_vs_all", "--user_history_filename", "user_history",
             "--n_sample_neg_train", "3", "--metrics", "['hit@10']", "--key_metric", "hit@10"]
    assert cli.main(["train", *flags]) == 0
    trained = capsys.readouterr().out
    assert cli.main(["test", "--model_file", str(tmp_path / "checkpoint" / "cli.pkl"),
                     "--dataset_path", root, "--device", "cpu",
                     "--output_path", str(tmp_path / "t")]) == 0
    tested = capsys.readouterr().out
    assert "hit@10" in trained and trained.splitlines()[-1] == tested.splitlines()[-1]
