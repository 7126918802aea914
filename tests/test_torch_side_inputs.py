"""The item side inputs (categorical features, frozen text embeddings, T6
time sequences) and distance_type=mlp in the port, against the JAX package.

- SASRec and AvgHist with each side input alone and all three together
  (L=12, d=32, 60 items, two feature fields of 5 and 7 ids, 24-wide text
  rows, 16 time buckets), the same weights and constants through the flax
  bridge, f32, dropout 0: user embeddings, ``predict`` scores, the
  full-catalog item table, the loss and every gradient within 1e-5.
- MLPScorer under its three broadcast rules against the flax module, and
  SASRec with distance_type=mlp, within 1e-5.
- T6 histories with their time rows, the device pipeline's and the host
  Batcher's time windows and feature gathers against the JAX package's.
- load_features on .tsv (no pandas) and .pkl against the JAX reader.
- main.run(task=train) of SASRec with all three side inputs on
  tests/synth.py's data (T6 histories written beside it): twice the random
  hit@5, its checkpoint's constants in the JAX layout, task=test repeats
  the metrics, the JAX main.run(task=test) reads the checkpoint to the
  same metrics, and infer-embedding and reco-topk take the features.
"""
import copy
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import unirec_tpu.ops.scatter_accum as jax_sa
from tests.synth import BASE_CONF, generate
from unirec_tpu import config as jax_config
from unirec_tpu.data.device_pipeline import DeviceAugmenter as JaxAugmenter
from unirec_tpu.data.history import UserHistory as JaxHistory
from unirec_tpu.data.pipeline import Batcher as JaxBatcher
from unirec_tpu.main import infer_embedding as jax_infer
from unirec_tpu.main import main as jax_main
from unirec_tpu.models import modules as jax_modules
from unirec_tpu.utils import file_io as jax_file_io
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.data.datasets import SeqRecDataset
from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.data.pipeline import Batcher
from unirec_tpu_torch.main import infer_embedding, main
from unirec_tpu_torch.main.reco_topk import do_topk_reco
from unirec_tpu_torch.models import modules
from unirec_tpu_torch.models.modules import DropoutRNG
from unirec_tpu_torch.utils import file_io
from unirec_tpu_torch.utils.checkpoint import load_model_freely
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_tree

B, L, N_ITEMS, N_USERS, N_NEG, TDIM, N_TIME = 6, 12, 60, 20, 3, 24, 16
SHAPE = [5, 7]
TOL = 1e-5
SMALL = dict(n_users=N_USERS, n_items=N_ITEMS, embedding_size=32, hidden_size=32,
             max_seq_len=L, n_layers=2, n_heads=2, inner_size=40, hidden_dropout_prob=0.0,
             attn_dropout_prob=0.0, dropout_prob=0.0, loss_type="bce",
             vmem_embedding_grad=1, compute_dtype="float32", asymmetric=True)
SIDES = {"features": dict(use_features=1, features_shape=SHAPE),
         "text": dict(use_text_emb=1, text_emb_size=TDIM),
         "time": dict(time_seq=N_TIME)}
SIDES["all"] = {k: v for d in SIDES.values() for k, v in d.items()}


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


def _constants(seed=0):
    rng = np.random.default_rng(seed)
    feats = np.stack([rng.integers(1, SHAPE[0], N_ITEMS),
                      SHAPE[0] + rng.integers(1, SHAPE[1], N_ITEMS)], 1).astype(np.int32)
    feats[0] = 0
    text = rng.normal(size=(N_ITEMS, TDIM)).astype(np.float32)
    text[0] = 0.0
    return feats, text


def _batch(feats, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, N_ITEMS, size=(B, L))
    lens = np.full(B, L)
    for row, n in ((0, 4), (1, 0), (2, 1)):
        seq[row, :L - n] = 0
        lens[row] = n
    item = rng.integers(1, N_ITEMS, size=(B, 1 + N_NEG))
    label = np.zeros((B, 1 + N_NEG), np.float32)
    label[:, 0] = 1.0
    weight = np.ones(B, np.float32)
    weight[-1] = 0.0
    return {"item_seq": seq.astype(np.int32), "item_seq_len": lens.astype(np.int32),
            "time_seq": np.where(seq > 0, rng.integers(1, N_TIME, seq.shape), 0).astype(np.int32),
            "item_seq_features": feats[seq], "item_features": feats[item],
            "user_id": rng.integers(1, N_USERS, B).astype(np.int32),
            "item_id": item.astype(np.int32), "label": label, "weight": weight}


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _pair(name, over):
    feats, text = _constants()
    args = dict(SMALL, **over, model=name, _item2features=feats, _text_emb=text)
    jmodel = jax_model_class(name)(cfg=jax_config.parse_arguments(dict(args), argv=[]))
    batch = _batch(feats)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jmodel.init(jax.random.PRNGKey(2), jb, train=False)
    tmodel = torch_model(name, args)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, variables["params"]))
    return jmodel, dict(variables), tmodel.eval(), batch


def torch_model(name, args):
    from unirec_tpu_torch.utils.registry import get_model_class
    return get_model_class(name)(torch_config.parse_arguments(dict(args), argv=[], device="cpu"))


def _check_against_jax(jmodel, variables, tmodel, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    const = {k: v for k, v in variables.items() if k != "params"}

    def apply(p, *a, **kw):
        return jmodel.apply({"params": p, **const}, *a, **kw)

    params = variables["params"]
    ju, jp = apply(params, jb, method="user_emb"), apply(params, jb, method="predict")
    ji = apply(params, method="all_item_emb")
    jloss, jgrads = jax.value_and_grad(
        lambda p: apply(p, jb, train=True, rngs={"dropout": jax.random.PRNGKey(1)})[0])(params)
    with torch.no_grad():
        outs = tmodel.user_emb(tb), tmodel.predict(tb), tmodel.all_item_emb()
    for got, ref in zip(outs, (ju, jp, ji)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    tparams = list(tmodel.parameters())
    tloss, _ = tmodel(tb, train=True, rng=DropoutRNG(0, "cpu"))
    tg = dict(_flat(to_flax_tree(tmodel, torch.autograd.grad(tloss, tparams))))
    jg = dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], atol=TOL, rtol=0, err_msg=str(k))
    return tg


@pytest.mark.parametrize("name", ["SASRec", "AvgHist"])
@pytest.mark.parametrize("side", sorted(SIDES))
def test_side_inputs_match_jax_f32(name, side):
    jmodel, variables, tmodel, batch = _pair(name, SIDES[side])
    consts = tmodel.constants()
    if side in ("features", "all"):
        np.testing.assert_array_equal(consts["item2features"],
                                      np.asarray(variables["constants"]["item2features"]))
    if side in ("text", "all"):
        np.testing.assert_array_equal(consts["text_embedding"],
                                      np.asarray(variables["constants"]["text_embedding"]))
        assert not any("text_embedding" in "/".join(k) for k in dict(_flat(
            to_flax_tree(tmodel, list(tmodel.parameters())))))   # frozen: no parameter
    tg = _check_against_jax(jmodel, variables, tmodel, batch)
    if side in ("time", "all"):
        g = tg[("time_embedding", "embedding")]
        assert np.abs(g).max() > 0 and not g[0].any()             # padding bucket masked


@pytest.mark.parametrize("shapes", [((B, 32), (9, 32)), ((B, 4, 32), (B, 32)),
                                    ((B, 32), (B, 4, 32))], ids=["BxM", "BGxB", "BxBG"])
def test_mlp_scorer_matches_flax_under_each_broadcast_rule(shapes):
    rng = np.random.default_rng(5)
    x, y = (rng.normal(size=s).astype(np.float32) for s in shapes)
    flax_mod = jax_modules.MLPScorer(32, 32, 0.0, "tanh")
    params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))["params"]
    ref = flax_mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    mod = modules.MLPScorer(32, 32, 0.0, "tanh")
    load_flax_params(mod, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_mlp_distance_matches_jax_f32():
    jmodel, variables, tmodel, batch = _pair("SASRec", dict(SIDES["features"],
                                                            distance_type="mlp"))
    tg = _check_against_jax(jmodel, variables, tmodel, batch)
    assert np.abs(tg[("mlp_scorer", "Dense_0", "kernel")]).max() > 0


# ------------------------------------------------------------------ data
def _t6_history(seed=7, n_users=50, cap=30):
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, cap, size=n_users).astype(np.int32)
    items = np.zeros((n_users, cap), np.int32)
    times = np.zeros((n_users, cap), np.int32)
    for u in range(n_users):
        items[u, :lens[u]] = rng.integers(1, 200, size=lens[u])
        times[u, :lens[u]] = np.sort(rng.integers(1, 64, size=lens[u]))
    return items, lens, times


def test_t6_history_from_a_table_matches_jax():
    items, lens, times = _t6_history()
    df = pd.DataFrame({"user_id": np.arange(1, 50),
                       "item_seq": [items[u, :lens[u]] for u in range(1, 50)],
                       "time_seq": [times[u, :lens[u]] for u in range(1, 50)]})
    for cap in (-1, 12):
        got = UserHistory.from_dataframe(df, 50, "user-item_seq-time_seq", cap, with_time=True)
        ref = JaxHistory.from_dataframe(df, 50, "user-item_seq-time_seq", cap, with_time=True)
        for a, b in ((got.items, ref.items), (got.lengths, ref.lengths),
                     (got.times, ref.times)):
            np.testing.assert_array_equal(a, b)
    assert UserHistory.from_dataframe(df, 50, "user-item_seq-time_seq").times is None


@pytest.mark.parametrize("mode,seq_last", [("autoregressive", 1), ("unorder", 0)])
def test_device_pipeline_time_windows_and_features_match_jax(mode, seq_last):
    items, lens, times = _t6_history()
    feats = np.random.default_rng(8).integers(1, 7, size=(200, 2)).astype(np.int32)
    cfg = {"n_items": 200, "n_sample_neg_train": 0, "max_seq_len": 8,
           "dataloader": "SeqRecDataset", "history_mask_mode": mode, "seq_last": seq_last,
           "time_seq": 64, "use_features": 1}
    rng = np.random.default_rng(9)
    uid = rng.integers(1, 50, size=40).astype(np.int32)
    pos = np.where(rng.random(40) < 0.6, items[uid, 2], rng.integers(1, 200, 40)).astype(np.int32)
    jaug = JaxAugmenter(cfg, JaxHistory(items, lens, times=times), features=feats)
    ref = jaug.augment({"user_id": jnp.asarray(uid), "item_id": jnp.asarray(pos),
                        "weight": jnp.ones(40)}, jax.random.PRNGKey(0))
    aug = DeviceAugmenter(cfg, UserHistory(items, lens, times), features=feats, device="cpu")
    got = aug.augment({"user_id": torch.from_numpy(uid), "item_id": torch.from_numpy(pos),
                       "weight": torch.ones(40)}, torch.Generator().manual_seed(0))
    for k in ("item_seq", "item_seq_len", "time_seq", "item_features", "item_seq_features"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    hseq, _, htseq = UserHistory(items, lens, times).sequence_batch(
        uid, pos, 8, mask_mode=mode, seq_last=bool(seq_last), with_time=True)
    np.testing.assert_array_equal(got["item_seq"].numpy(), hseq)
    np.testing.assert_array_equal(got["time_seq"].numpy(), htseq)


def test_host_batcher_time_windows_and_features_match_jax(tmp_path):
    items, lens, times = _t6_history()
    feats = np.random.default_rng(8).integers(1, 7, size=(200, 2)).astype(np.int32)
    rng = np.random.default_rng(10)
    pd.DataFrame({"user_id": rng.integers(1, 50, 37),
                  "item_id": rng.integers(1, 200, 37)}).to_pickle(tmp_path / "test.pkl")
    cfg = {"n_items": 200, "n_users": 50, "max_seq_len": 8, "data_format": "user-item",
           "history_mask_mode": "autoregressive", "time_seq": 64, "batch_size": 16,
           "data_loader_task": "test", "eval_protocol": "one_vs_all"}
    from unirec_tpu.data.datasets import SeqRecDataset as JaxSeqRecDataset
    got = Batcher(SeqRecDataset(cfg, str(tmp_path), "test"), cfg,
                  UserHistory(items, lens, times), features=feats)
    ref = JaxBatcher(JaxSeqRecDataset(cfg, str(tmp_path), "test"), cfg,
                     JaxHistory(items, lens, times=times), features=feats)
    n = 0
    for a, b in zip(got, ref):
        for k in ("item_seq", "item_seq_len", "time_seq", "item_features",
                  "item_seq_features", "weight"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n += 1
    assert n == 3


def test_t6_eval_rows_keep_their_time_groups(tmp_path):
    pd.DataFrame({"user_id": [1, 2], "item_seq": [np.array([3, 4, 5]), np.array([6])],
                  "time_seq": [np.array([1, 2, 3]), np.array([9])]}).to_pickle(
        tmp_path / "valid.pkl")
    cfg = {"data_format": "user-item_seq-time_seq", "data_loader_task": "valid",
           "eval_protocol": "one_vs_all"}
    ds = SeqRecDataset(cfg, str(tmp_path), "valid")
    from unirec_tpu.data.datasets import SeqRecDataset as JaxSeqRecDataset
    ref = JaxSeqRecDataset(cfg, str(tmp_path), "valid")
    for k in ("user_id", "item_id", "time_seq_raw"):
        np.testing.assert_array_equal(ds.cols[k], ref.cols[k])


@pytest.mark.parametrize("ext", [".tsv", ".csv", ".pkl"])
def test_load_features_matches_jax(tmp_path, ext):
    rows = [(1, "3,67"), (2, "5 70"), (4, "[9, 65]"), (7, "11")]
    path = str(tmp_path / f"feat{ext}")
    if ext == ".pkl":
        lists = [[3, 67], [5, 70], [9, 65], [11]]
        pd.DataFrame({"item_id": [i for i, _ in rows],
                      "features": [np.asarray(v) for v in lists]}).to_pickle(path)
    else:
        sep = "," if ext == ".csv" else "\t"
        with open(path, "w") as f:
            f.write(f"item_id{sep}features\n")
            for i, c in rows:
                f.write(f'{i}{sep}"{c}"\n' if sep == "," else f"{i}{sep}{c}\n")
    got = file_io.load_features(path, 8, 2)
    np.testing.assert_array_equal(got, jax_file_io.load_features(path, 8, 2))
    assert got[4].tolist() == [9, 65] and not got[0].any()


def test_load_features_reads_text_without_pandas(tmp_path):
    path = tmp_path / "feat.tsv"
    path.write_text("item_id\tfeatures\n1\t3,67\n")
    probe = ("import sys; sys.modules['pandas'] = None\n"
             "from unirec_tpu_torch.utils.file_io import load_features\n"
             f"print(load_features({str(path)!r}, 3, 2).tolist())")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[[0, 0], [3, 67], [0, 0]]"


# ------------------------------------------------------------- main.run
RANDOM_HIT5 = 5.0 / 300.0


@pytest.fixture(scope="module")
def side_run(tmp_path_factory):
    """SASRec with features, text and T6 time buckets through main.run on
    tests/synth.py's data, the histories written as T6 beside it."""
    root = str(tmp_path_factory.mktemp("side_data"))
    generate(root)
    hist = pd.read_pickle(os.path.join(root, "user_history.pkl"))
    rng = np.random.default_rng(3)
    hist["time_seq"] = [np.sort(rng.integers(1, N_TIME, len(s))) for s in hist["item_seq"]]
    hist.to_pickle(os.path.join(root, "user_history_t6.pkl"))
    out = str(tmp_path_factory.mktemp("side_out"))
    args = dict(copy.deepcopy(BASE_CONF), model="SASRec", dataloader="SeqRecDataset",
                dataset_path=root, output_path=out, exp_name="side", task="train",
                loss_type="fullsoftmax", n_sample_neg_train=0, epochs=6, learning_rate=0.005,
                hidden_dropout_prob=0.1, attn_dropout_prob=0.1, n_layers=1, n_heads=2,
                inner_size=64, use_features=1, features_shape=[7],
                features_filepath=os.path.join(root, "item_features.pkl"), use_text_emb=1,
                text_emb_size=24, text_emb_path=os.path.join(root, "text_emb.tsv"),
                time_seq=N_TIME, user_history_filename="user_history_t6",
                user_history_file_format="user-item_seq-time_seq", device="cpu")
    return args, main.run(dict(args)), out


def test_main_run_trains_with_every_side_input(side_run):
    args, result, out = side_run
    assert result["hit@5"] > 2 * RANDOM_HIT5, result
    with open(os.path.join(out, "checkpoint", "side.pkl"), "rb") as f:
        ckpt = pickle.load(f)
    consts = ckpt["constants"]
    assert set(consts) == {"item2features", "text_embedding"}
    assert consts["item2features"].dtype == np.int32 and consts["item2features"].shape == (301, 1)
    assert consts["text_embedding"].dtype == np.float32
    assert consts["text_embedding"].shape == (301, 24) and not consts["text_embedding"][0].any()
    np.testing.assert_array_equal(consts["item2features"], jax_file_io.load_features(
        args["features_filepath"], 301, 1))


def test_test_task_and_the_jax_package_read_the_side_checkpoint(side_run):
    args, result, out = side_run
    ckpt = os.path.join(out, "checkpoint", "side.pkl")
    again = main.run({"task": "test", "model_file": ckpt, "dataset_path": args["dataset_path"],
                      "output_path": out + "_test", "device": "cpu"})
    assert again == result
    ref = jax_main.run({"task": "test", "model_file": ckpt,
                        "dataset_path": args["dataset_path"], "output_path": out + "_jax"})
    assert set(ref) == set(result)
    for m in result:
        assert abs(result[m] - ref[m]) <= 1e-5, (m, result[m], ref[m])


@pytest.mark.parametrize("node_type", ["user", "item"])
def test_infer_embedding_takes_the_features_as_jax_does(side_run, node_type, monkeypatch):
    """The JAX run's constants are handed to its jitted encoder as device
    arrays (its loader returns numpy, which a traced text gather cannot
    index)."""
    args, _, out = side_run
    load = jax_infer.load_model_freely

    def on_device(path):
        model, params, consts, cfg = load(path)
        return model, params, jax.tree_util.tree_map(jnp.asarray, consts), cfg

    monkeypatch.setattr(jax_infer, "load_model_freely", on_device)
    common = {"model_file": os.path.join(out, "checkpoint", "side.pkl"),
              "dataset_path": args["dataset_path"], "node_type": node_type,
              "user_history_filename": "user_history", "test_batch_size": 64}
    ids, emb = infer_embedding.run(dict(common, output_emb_file=out + f"/{node_type}.tsv"),
                                   device="cpu")
    rids, ref = jax_infer.run(dict(common, output_emb_file=out + f"/{node_type}_jax.tsv"))
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_allclose(emb, ref, atol=TOL, rtol=0)


def test_reco_topk_scores_the_catalog_with_its_features(side_run, tmp_path):
    args, _, out = side_run
    ckpt = os.path.join(out, "checkpoint", "side.pkl")
    np.savetxt(tmp_path / "users.txt", np.arange(1, 41), fmt="%d")
    res = do_topk_reco({"model_file": ckpt, "dataset_path": args["dataset_path"],
                        "dataset_name": str(tmp_path / "users.txt"), "topk": 10,
                        "user_history_filename": "user_history",
                        "output_path": str(tmp_path / "top.csv")}, device="cpu")
    assert res.shape == (40, 10) and res.min() >= 1 and res.max() < 301
    model, _ = load_model_freely(ckpt, "cpu")
    plain = copy.deepcopy(model)
    plain.load_constants({"item2features": np.zeros((301, 1), np.int32),
                          "text_embedding": np.zeros((301, 24), np.float32)})
    with torch.no_grad():
        assert not torch.allclose(model.all_item_emb(), plain.all_item_emb())
        items = model.all_item_emb().numpy()
    from unirec_tpu.utils.checkpoint import load_model_freely as jax_load
    jmodel, params, consts, _ = jax_load(ckpt)
    ref = jmodel.apply({"params": params, "constants": consts}, method="all_item_emb")
    np.testing.assert_allclose(items, np.asarray(ref), atol=TOL, rtol=0)


def test_infer_task_on_the_side_checkpoint_matches_jax(side_run):
    """task=infer (one-vs-k scores of the test table's rows, the batches
    carrying the item features) of the port and of the JAX package on the
    same checkpoint; the negatives are drawn by each package's own
    sampler, so the positive's column is compared."""
    args, _, out = side_run
    common = {"task": "infer", "model_file": os.path.join(out, "checkpoint", "side.pkl"),
              "dataset_path": args["dataset_path"]}
    main.run(dict(common, output_path=out + "_infer", device="cpu"))
    jax_main.run(dict(common, output_path=out + "_infer_jax"))
    got = np.loadtxt(os.path.join(out + "_infer", "side.infer.txt"))
    ref = np.loadtxt(os.path.join(out + "_infer_jax", "side.infer.txt"))
    assert got.shape == ref.shape and got.shape[0] == 200 and np.isfinite(got).all()
    np.testing.assert_allclose(got.reshape(200, -1)[:, 0], ref.reshape(200, -1)[:, 0],
                               atol=TOL, rtol=0)
