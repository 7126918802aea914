"""reco-topk and infer-embedding of the port against the JAX package.

One checkpoint, written by the JAX package (with its optax state), serves
the tests/synth.py users through both packages' entry points. The catalog
has 4096 items (only the first 300 appear in histories), so with topk=10
the fused path runs both passes (kp < n_blocks and N > 4*k*16). Everything
is f32 and the random factors do not tie, so the id CSVs must be identical.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import unirec_tpu.ops.layer as jax_layer
from unirec_tpu import config as jax_config
from unirec_tpu.main import infer_embedding as jax_infer
from unirec_tpu.main import reco_topk as jax_reco
from unirec_tpu.utils import checkpoint as jax_ckpt
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import cli as torch_cli
from unirec_tpu_torch.main import infer_embedding as torch_infer
from unirec_tpu_torch.main import reco_topk as torch_reco

N_ITEMS = 4096


@pytest.fixture(scope="module")
def served(synth_dataset, tmp_path_factory):
    root, info = synth_dataset
    out = tmp_path_factory.mktemp("reco")
    cfg = jax_config.parse_arguments(dict(
        model="SASRec", dataset_path=root, n_items=N_ITEMS, embedding_size=16,
        n_heads=2, inner_size=32, n_layers=2, max_seq_len=12, init_std=0.1,
        compute_dtype="float32", has_item_bias=1, test_batch_size=64,
        last_query_only=1, fused_layer=1, fused_lastq=1,
        user_history_filename="user_history"), argv=[])
    model = jax_model_class("SASRec")(cfg=cfg)
    batch = {"item_seq": jnp.ones((2, 12), jnp.int32),
             "user_id": jnp.zeros(2, jnp.int32),
             "item_id": jnp.zeros(2, jnp.int32), "label": jnp.zeros(2)}
    params = model.init(jax.random.PRNGKey(11), batch, train=False)["params"]
    ckpt = str(out / "sasrec.pkl")
    jax_ckpt.save_checkpoint(ckpt, {"config": cfg, "params": params,
                                    "opt_state": optax.adam(1e-3).init(params)})
    ids_file = str(out / "users.txt")
    np.savetxt(ids_file, np.arange(1, 201), fmt="%i")
    return {"model_file": ckpt, "dataset_path": root, "dataset_name": ids_file,
            "user_history_filename": "user_history", "topk": 10}, out


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_layer, "_INTERPRET", True)


def _both(served, name, **extra):
    base, out = served
    conf = dict(base, **extra)
    jax_reco.do_topk_reco(dict(conf, output_path=str(out / f"jax_{name}.csv")))
    torch_reco.do_topk_reco(dict(conf, output_path=str(out / f"torch_{name}.csv")),
                            device="cpu")
    return (open(out / f"jax_{name}.csv").read(),
            open(out / f"torch_{name}.csv").read())


@pytest.mark.parametrize("name,extra", [
    ("fused", dict(use_fused_topk=1)),
    ("dense", dict(use_fused_topk=0)),
    ("last_item", dict(last_item=1)),
    ("fused_int8", dict(use_fused_topk=1, catalog_int8=1)),
])
def test_reco_topk_csv_identical_to_jax(served, interpret, name, extra):
    jax_csv, torch_csv = _both(served, name, **extra)
    rows = torch_csv.splitlines()
    assert len(rows) == 200 and all(len(r.split(",")) == 10 for r in rows)
    assert torch_csv == jax_csv


def test_reco_topk_item_file_scores_match_jax(served, interpret):
    base, out = served
    item_file = out / "items.tsv"
    rng = np.random.default_rng(0)
    with open(item_file, "w") as f:
        for u in range(1, 31):
            f.write(f"{u}\t" + ",".join(map(str, rng.integers(0, N_ITEMS, 5))) + "\n")
    jax_lines, torch_lines = _both(served, "item_file", item_file=str(item_file),
                                   last_item=1)
    jl = [ln.split("\t") for ln in jax_lines.splitlines()]
    tl = [ln.split("\t") for ln in torch_lines.splitlines()]
    assert len(tl) == len(jl) == 150
    assert [(a[0], a[1], a[3]) for a in tl] == [(a[0], a[1], a[3]) for a in jl]
    np.testing.assert_allclose([float(a[2]) for a in tl], [float(a[2]) for a in jl],
                               atol=1e-5, rtol=1e-5)


def test_infer_embedding_user_matches_jax(served, interpret):
    base, out = served
    conf = dict(model_file=base["model_file"], dataset_path=base["dataset_path"],
                node_type="user", user_history_filename="user_history")
    jids, jemb = jax_infer.run(dict(conf, output_emb_file=str(out / "jax_u.tsv")))
    tids, temb = torch_infer.run(dict(conf, output_emb_file=str(out / "torch_u.tsv")),
                                 device="cpu")
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(temb, jemb, atol=1e-5, rtol=1e-5)
    first = open(out / "torch_u.tsv").readline().split("\t")
    assert len(first[1].split(",")) == 16


def test_cli_reco_topk_on_cpu(served, interpret):
    base, out = served
    path = str(out / "cli.csv")
    argv = ["reco-topk", "--device", "cpu", "--output_path", path,
            "--use_fused_topk", "1"] + [t for k, v in base.items()
                                         for t in (f"--{k}", str(v))]
    assert torch_cli.main(argv) == 0
    ref = copy.deepcopy(base)
    ids = torch_reco.do_topk_reco(dict(ref, use_fused_topk=1,
                                       output_path=str(out / "direct.csv")),
                                  device="cpu")
    np.testing.assert_array_equal(np.loadtxt(path, delimiter=",", dtype=np.int64), ids)


def test_unported_serving_paths_raise(served):
    base, out = served
    for extra in (dict(mesh_model=2), dict(topk_recall_target=0.9)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            torch_reco.do_topk_reco(dict(base, output_path=str(out / "x.csv"),
                                         **extra), device="cpu")


def test_cuda_without_a_card_raises(served):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    base, out = served
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_reco.do_topk_reco(dict(base, output_path=str(out / "y.csv")))
    assert not os.path.exists(out / "y.csv")
