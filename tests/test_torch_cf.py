"""The port's CF models (MF, MultiVAE) and their data (AERecDataset, the AERec
host and device rows, the KL anneal) against the JAX package.

Small models (d=16, 40 items, 15 users, L=8, MultiVAE's encoder [12] and
decoder [10]), inputs from a numpy seed, weights through the flax bridge,
vmem_embedding_grad on (the JAX scatter kernel in Pallas interpret mode,
the port's plain version), f32:

- MF under the bce, bpr and softmax losses and MultiVAE with
  ``train=False`` and ``eval_reparameter_sampling_times=0``: ``predict``
  scores, user embeddings, the loss of a batch with a padded row and an
  empty history, and every parameter gradient within 1e-5 absolute.
- MultiVAE's evaluation noise at 5 draws: the mean of 5 normals, std
  sqrt(1/5) in both packages (within 5 standard errors), fresh for each
  ``reparam_seed`` and repeated for the same one; the evaluators count
  their batches into it.
- ``kl_anneal`` equal to the JAX function, and the factor each train step
  receives through the device pipeline equal to the reference recurrence.
- AERecDataset's columns, the host ``aerec-train`` batches and the device
  pipeline's AERec rows equal to the JAX package's, with and without
  ``aerec_max_hist``.
- ``main.run`` train -> test for MF and MultiVAE on tests/synth.py's data
  (above chance, test from the checkpoint equal), and the JAX
  ``main.run(task=test)`` on the port's MF and MultiVAE (sampling 0)
  checkpoints within 1e-5 of each metric; reco-topk from the port's MF
  checkpoint equal to the JAX package's CSV (dense, fused, fused int8).
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
from unirec_tpu.data import datasets as jax_ds
from unirec_tpu.data.device_pipeline import DeviceAugmenter as JaxAugmenter
from unirec_tpu.data.history import UserHistory as JaxHistory
from unirec_tpu.data.pipeline import Batcher as JaxBatcher
from unirec_tpu.facility import trainer as jax_trainer
from unirec_tpu.main import main as jax_main
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.data.datasets import get_dataset_class
from unirec_tpu_torch.data.pipeline import Batcher, make_train_batcher
from unirec_tpu_torch.facility import trainer as torch_trainer
from unirec_tpu_torch.facility.evaluation import build_evaluator
from unirec_tpu_torch.main import main
from unirec_tpu_torch.models.modules import DropoutRNG
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_tree
from unirec_tpu_torch.utils.registry import get_model_class as torch_model_class

B, L, N_ITEMS, N_USERS, G = 5, 8, 40, 15, 4
SMALL = dict(n_users=N_USERS, n_items=N_ITEMS, embedding_size=16, max_seq_len=L,
             dropout_prob=0.0, compute_dtype="float32", vmem_embedding_grad=1)
VAE = dict(encoder_dims=[12], decoder_dims=[10], eval_reparameter_sampling_times=0)
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(jax_sa, "_INTERPRET", True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread: six xdist workers with eight-thread teams
    each stall small ops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, N_ITEMS, size=(B, L))
    seq[0, :5] = 0                                   # three items
    seq[1, :] = 0                                    # an empty history
    label = np.zeros((B, G), np.float32)
    label[:, 0] = 1.0
    weight = np.ones(B, np.float32)
    weight[-1] = 0.0                                 # a padded row
    return {"user_id": rng.integers(1, N_USERS, B).astype(np.int32),
            "item_id": rng.integers(1, N_ITEMS, (B, G)).astype(np.int32),
            "label": label, "weight": weight, "item_seq": seq.astype(np.int32),
            "item_seq_len": (seq != 0).sum(1).astype(np.int32)}


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _pair(name, over, batch, jax_over=None):
    args = dict(SMALL, **over, model=name)
    jmodel = jax_model_class(name)(cfg=jax_config.parse_arguments(
        dict(args, **(jax_over or {})), argv=[]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(0), jb, train=False)["params"]
    tmodel = torch_model_class(name)(torch_config.parse_arguments(dict(args), argv=[],
                                                                  device="cpu"))
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, jb, tmodel.eval(), {k: torch.as_tensor(v) for k, v in batch.items()}


def assert_model_matches_jax(name, over, batch, tol=F32_TOL, jax_over=None):
    """predict, the user embeddings (retrieval models), the loss at
    train=False and every gradient of it (zero for a parameter the loss
    does not reach), the port against JAX (with ``jax_over`` on top of
    ``over`` on the JAX side)."""
    jmodel, params, jb, tmodel, tb = _pair(name, over, batch, jax_over)
    jp = np.asarray(jmodel.apply({"params": params}, jb, method="predict"))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jb, train=False)[0])(params)
    with torch.no_grad():
        tp = tmodel.predict(tb)
    assert tp.shape == jp.shape
    np.testing.assert_allclose(tp.numpy(), jp, atol=tol, rtol=0)
    if not name.endswith(("FM", "BST", "AdaRanker")):
        ju = np.asarray(jmodel.apply({"params": params}, jb, method="user_emb"))
        with torch.no_grad():
            np.testing.assert_allclose(tmodel.user_emb(tb).numpy(), ju, atol=tol, rtol=0)
    params_t = list(tmodel.parameters())
    tloss, _ = tmodel(tb, train=False, rng=DropoutRNG(0, "cpu"))
    grads = torch.autograd.grad(tloss, params_t, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params_t)]
    tgrads = dict(_flat(to_flax_tree(tmodel, grads)))
    jg = dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert abs(float(tloss.detach()) - float(jloss)) <= tol * max(1.0, abs(float(jloss)))
    assert set(tgrads) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tgrads[k], jg[k], atol=tol, rtol=0, err_msg=str(k))
    return jg, tgrads


@pytest.mark.parametrize("loss_type", ["bce", "bpr", "softmax"])
def test_mf_matches_jax(loss_type):
    jg, _ = assert_model_matches_jax("MF", dict(loss_type=loss_type, has_user_emb=True),
                                     _batch())
    assert np.abs(jg[("user_embedding", "embedding")]).max() > 0


@pytest.mark.parametrize("anneal", [None, 0.05])
def test_multivae_matches_jax_without_noise(anneal):
    batch = _batch(1)
    batch["item_id"] = batch["item_id"][:, 0]
    if anneal is not None:
        batch["anneal"] = np.float32(anneal)
    jg, tg = assert_model_matches_jax("MultiVAE", VAE, batch)
    # the whole catalog's rows get gradient through the softmax; the padding row none
    assert np.abs(jg[("item_embedding", "embedding")][1:]).min(-1).max() > 0
    assert not tg[("item_embedding", "embedding")][0].any()


def test_multivae_bf16_scores_the_catalog_in_f32_as_jax_does():
    """Under compute_dtype bfloat16 MultiVAE's user embeddings are f32 (its
    denses promote) and the catalog's rows bf16: the one-vs-all scores
    (ops/topk.py::full_catalog_scores) promote to f32 as the JAX product
    does, within two bf16 ulps of the largest score."""
    from unirec_tpu_torch.ops.topk import full_catalog_scores
    batch = _batch(1)
    batch["item_id"] = batch["item_id"][:, 0]
    jmodel, params, jb, tmodel, tb = _pair("MultiVAE", dict(VAE, compute_dtype="bfloat16"),
                                           batch)
    v = {"params": params}
    ref = np.asarray(jmodel.apply(v, jb, method="user_emb")
                     @ jmodel.apply(v, method="all_item_emb").T, np.float32)
    with torch.no_grad():
        got = full_catalog_scores(tmodel, tb, tmodel.all_item_emb())
    assert got.dtype == torch.float32 and got.shape == (B, N_ITEMS)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(got.numpy(), ref, atol=2 * ulp, rtol=0)


def test_multivae_evaluation_noise_is_fresh_seeded_and_of_the_same_law():
    """S = 5 draws: eps is the mean of five normals in both packages (std
    sqrt(1/5) within 5 standard errors); the port's eps is a function of
    (seed, reparam_seed): the same seed repeats, another differs."""
    cfg = torch_config.parse_arguments(dict(SMALL, **dict(VAE, eval_reparameter_sampling_times=5),
                                            model="MultiVAE"),
                                       argv=[], device="cpu")
    model = torch_model_class("MultiVAE")(cfg)
    mu = torch.zeros(4096, 10)
    a, b, c = (model._eval_eps(mu, s) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4096, 10, 5)).mean(-1))
    want, se = math.sqrt(0.2), math.sqrt(0.2) / math.sqrt(2 * a.numel())
    for x in (a.numpy(), c.numpy(), ref):
        assert abs(x.std() - want) < 5 * se and abs(x.mean()) < 5 * want / math.sqrt(x.size)


def test_evaluators_count_their_batches_into_the_reparam_seed():
    """Each batch gets the next count, as the JAX evaluator's
    _eval_batch_counter; a new evaluator starts again at 1."""
    cfg = torch_config.parse_arguments(dict(SMALL, model="MF", has_user_emb=True),
                                       argv=[], device="cpu")
    seen = []

    class Spy(torch_model_class("MF")):
        def predict(self, batch):
            seen.append(batch["reparam_seed"])
            return super().predict(batch)

    model = Spy(cfg)
    batches = [{k: v[:, :1] if k in ("item_id", "label") else v
                for k, v in _batch(s).items()} for s in range(3)]
    for _ in range(2):
        ev = build_evaluator(cfg, model, "one_vs_k", "user-item", "cpu")
        ev.predict_scores(batches)
        ev.predict_scores(batches[:1])
    assert seen == [1, 2, 3, 4] * 2


@pytest.mark.parametrize("step", [0, 1, 5, 69, 70, 1000, 10**6])
def test_kl_anneal_equals_jax(step):
    for cap, total in ((0.2, 2_000_000), (0.3, 7.0), (1.0, 100)):
        assert torch_trainer.kl_anneal(step, cap, total) == jax_trainer.kl_anneal(step, cap,
                                                                                   total)


def _cf_conf(root, tmp, model, **kw):
    conf = copy.deepcopy(BASE_CONF)
    conf.update(model=model, dataset_path=root, output_path=os.path.join(tmp, model),
                task="train", device="cpu")
    conf.update(kw)
    return conf


VAE_RUN = dict(dataloader="AERecDataset", embedding_size=64, encoder_dims=[32],
               decoder_dims=[32], learning_rate=0.003)


def test_the_anneal_each_step_receives_follows_the_reference_recurrence(
        synth_dataset, tmp_path, monkeypatch):
    """The factor the model sees after the device pipeline's augmentation
    (which rebuilds the batch) is min(cap, k / total) at step k, as
    tests/test_e2e_cf.py holds the JAX trainer to."""
    root, _ = synth_dataset
    seen = []
    cls = torch_model_class("MultiVAE")
    forward = cls.forward

    def spy(self, batch, train=True, rng=None):
        seen.append(float(batch["anneal"]))
        assert "item_seq" in batch
        return forward(self, batch, train, rng)

    monkeypatch.setattr(cls, "forward", spy)
    cap, total = 0.3, 7.0
    main.run(_cf_conf(root, str(tmp_path), "MultiVAE", **VAE_RUN, epochs=2, batch_size=32,
                      anneal_cap=cap, total_anneal_steps=total, exp_name="vae-anneal",
                      eval_reparameter_sampling_times=0))
    ref, want = 0.0, []
    for _ in range(len(seen)):
        want.append(ref)
        ref = min(cap, ref + 1.0 / total)
    assert len(seen) >= 10
    np.testing.assert_allclose(seen, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,fmt", [("train", "user-item"),
                                      ("rank_train", "user-item_group-label_group")])
def test_aerec_dataset_columns_equal_jax(synth_dataset, name, fmt):
    root, info = synth_dataset
    cfg = dict(info, data_format=fmt, data_loader_task="train")
    ours = get_dataset_class("AERecDataset")(dict(cfg), root, name)
    ref = jax_ds.AERecDataset(dict(cfg), root, name)
    assert ours.fmt == ref.fmt == "aerec-train" and ours.n_rows == ref.n_rows
    assert set(ours.cols) == set(ref.cols)
    for k in ref.cols:
        np.testing.assert_array_equal(ours.cols[k], ref.cols[k], err_msg=k)
    # evaluation splits are SeqRecDataset's
    ev = dict(cfg, data_loader_task="valid", eval_protocol="one_vs_all",
              data_format="user-item")
    got, want = (get_dataset_class("AERecDataset")(dict(ev), root, "valid"),
                 jax_ds.AERecDataset(dict(ev), root, "valid"))
    assert got.fmt == want.fmt and all(np.array_equal(got.cols[k], want.cols[k])
                                       for k in want.cols)


@pytest.mark.parametrize("cap", [0, 7])
def test_aerec_host_and_device_rows_equal_jax(synth_dataset, cap):
    """The host Batcher's aerec-train batches and the device augmenter's
    AERec rows (the user-indexed matrix of the training split's histories)
    against the JAX package's, shuffled the same way."""
    root, info = synth_dataset
    cfg = dict(info, data_format="user-item", data_loader_task="train", batch_size=48,
               aerec_max_hist=cap, dataloader="AERecDataset", seed=5, shuffle_train=1,
               n_sample_neg_train=0, loss_type="fullsoftmax")
    ds = get_dataset_class("AERecDataset")(dict(cfg), root, "train")
    jds = jax_ds.AERecDataset(dict(cfg), root, "train")
    ours = list(Batcher(ds, cfg, batch_size=48, seed=5, shuffle=True))
    ref = list(JaxBatcher(jds, cfg, batch_size=48, seed=5, shuffle=True))
    assert len(ours) == len(ref) == -(-ds.n_rows // 48)
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    raw, aug = make_train_batcher(ds, cfg, None, device="cpu")
    cols = jds.cols
    mat = np.zeros((info["n_users"], cols["hist"].shape[1]), np.int32)
    lens = np.zeros(info["n_users"], np.int32)
    mat[cols["user_id"]] = cols["hist"]
    lens[cols["user_id"]] = cols["hist_len"]
    jaug = JaxAugmenter(cfg, JaxHistory(mat, lens), aerec=True)
    for rb in list(raw)[:3]:
        got = aug.augment({k: torch.from_numpy(v) for k, v in rb.items()},
                          torch.Generator().manual_seed(0))
        want = jaug.augment({k: jnp.asarray(v) for k, v in rb.items()},
                            jax.random.PRNGKey(0))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got["item_seq"].shape[1] == (cap or cols["hist"].shape[1])


@pytest.fixture(scope="module")
def cf_runs(synth_dataset, tmp_path_factory):
    root, _ = synth_dataset
    out = str(tmp_path_factory.mktemp("cf"))
    runs = {}
    for name, over in (("MF", dict(loss_type="bpr", dataloader="BaseDataset",
                                   has_user_emb=True)),
                       ("MultiVAE", dict(VAE_RUN, epochs=5,
                                         eval_reparameter_sampling_times=0)),
                       ("MultiVAE-noise", dict(VAE_RUN, epochs=3,
                                               eval_reparameter_sampling_times=5))):
        args = _cf_conf(root, out, name.split("-")[0], exp_name=name, **over)
        args["output_path"] = os.path.join(out, name)
        runs[name] = (args, main.run(dict(args)))
    return runs


@pytest.mark.parametrize("name,hit10", [("MF", 0.1), ("MultiVAE", 0.03),
                                        ("MultiVAE-noise", 0.03)])
def test_main_run_trains_and_tests_from_the_checkpoint(cf_runs, name, hit10):
    """Above tests/test_e2e_cf.py's gates; task=test from the best
    checkpoint repeats the run's metrics (with 5 evaluation draws too: a
    new evaluator counts its batches from 1 again, as in JAX)."""
    args, result = cf_runs[name]
    assert result["hit@10"] > hit10, result
    ckpt = os.path.join(args["output_path"], "checkpoint", f"{args['exp_name']}.pkl")
    again = main.run({"task": "test", "model_file": ckpt, "dataset_path": args["dataset_path"],
                      "output_path": args["output_path"] + "_test", "device": "cpu"})
    assert again == result


@pytest.mark.parametrize("name", ["MF", "MultiVAE"])
def test_jax_main_tests_the_port_checkpoint(cf_runs, name):
    args, result = cf_runs[name]
    ckpt = os.path.join(args["output_path"], "checkpoint", f"{args['exp_name']}.pkl")
    ref = jax_main.run({"task": "test", "model_file": ckpt, "dataset_path": args["dataset_path"],
                        "output_path": args["output_path"] + "_jax"})
    assert set(ref) == set(result)
    for m in result:
        assert abs(result[m] - ref[m]) <= 1e-5, (m, result[m], ref[m])


@pytest.mark.parametrize("extra", [dict(use_fused_topk=0), dict(use_fused_topk=1),
                                   dict(use_fused_topk=1, catalog_int8=1)],
                         ids=["dense", "fused", "fused_int8"])
def test_reco_topk_of_the_port_mf_checkpoint_equals_jax(cf_runs, tmp_path, extra):
    """reco-topk from the port's MF checkpoint (a user table, no history
    encoder): the top-10 CSV of 200 users equals the JAX package's in the
    dense, fused and fused int8 modes (f32 factors, no ties)."""
    from unirec_tpu.main import reco_topk as jax_reco
    from unirec_tpu_torch.main import reco_topk as torch_reco
    args, _ = cf_runs["MF"]
    ids_file = str(tmp_path / "users.txt")
    np.savetxt(ids_file, np.arange(1, 201), fmt="%i")
    conf = dict(model_file=os.path.join(args["output_path"], "checkpoint", "MF.pkl"),
                dataset_path=args["dataset_path"], dataset_name=ids_file,
                user_history_filename="user_history", topk=10, **extra)
    jax_reco.do_topk_reco(dict(conf, output_path=str(tmp_path / "jax.csv")))
    torch_reco.do_topk_reco(dict(conf, output_path=str(tmp_path / "torch.csv")), device="cpu")
    got, want = open(tmp_path / "torch.csv").read(), open(tmp_path / "jax.csv").read()
    assert len(got.splitlines()) == 200 and got == want
