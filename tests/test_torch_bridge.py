"""The flax bridge, checkpoints shared with the JAX package, and the port's
independence from JAX."""
import ast
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unirec_tpu import config as jax_config
from unirec_tpu.utils import checkpoint as jax_ckpt
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.utils import checkpoint as torch_ckpt
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params
from unirec_tpu_torch.utils.registry import get_model_class as torch_model_class

REPO = Path(__file__).resolve().parents[1]
ARGS = dict(model="SASRec", n_users=20, n_items=60, embedding_size=16,
            n_heads=2, inner_size=32, n_layers=2, max_seq_len=8,
            compute_dtype="float32", has_item_bias=1)
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "unirec_tpu")


def _jax_model():
    cfg = jax_config.parse_arguments(dict(ARGS), argv=[])
    model = jax_model_class("SASRec")(cfg=cfg)
    batch = {"item_seq": jnp.ones((2, 8), jnp.int32),
             "user_id": jnp.zeros(2, jnp.int32),
             "item_id": jnp.zeros(2, jnp.int32), "label": jnp.zeros(2)}
    params = model.init(jax.random.PRNGKey(3), batch, train=False)["params"]
    return cfg, model, jax.tree_util.tree_map(np.asarray, params)


def _torch_model():
    return torch_model_class("SASRec")(
        torch_config.parse_arguments(dict(ARGS), argv=[], device="cpu"))


def _assert_trees_identical(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_flax_torch_flax_round_trip_is_exact():
    _, _, params = _jax_model()
    model = _torch_model()
    load_flax_params(model, params)
    _assert_trees_identical(params, to_flax_params(model))


def test_torch_flax_torch_round_trip_is_exact():
    model = _torch_model()
    model.init_weights(torch.Generator().manual_seed(5))
    again = _torch_model()
    load_flax_params(again, to_flax_params(model))
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k


def test_dense_kernels_are_transposed():
    _, _, params = _jax_model()
    model = _torch_model()
    load_flax_params(model, params)
    q = params["trm_encoder"]["layer_0"]["multi_head_attention"]["query"]["kernel"]
    w = model.trm_encoder.layer_0.multi_head_attention.query.weight
    np.testing.assert_array_equal(w.detach().numpy(), q.T)


@pytest.mark.parametrize("breakage", ["missing", "extra", "shape"])
def test_bridge_refuses_a_mismatched_tree(breakage):
    _, _, params = _jax_model()
    if breakage == "missing":
        del params["LayerNorm"]["scale"]
    elif breakage == "extra":
        params["user_bias"] = np.zeros(20, np.float32)
    else:
        params["item_bias"] = np.zeros(61, np.float32)
    with pytest.raises((KeyError, ValueError)):
        load_flax_params(_torch_model(), params)


def test_port_loads_a_jax_checkpoint_with_optax_state(tmp_path):
    cfg, jmodel, params = _jax_model()
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    path = str(tmp_path / "jax.pkl")
    jax_ckpt.save_checkpoint(path, {"config": cfg, "params": params,
                                    "opt_state": tx.init(params),
                                    "cur_epoch": 3})
    assert b"optax" in open(path, "rb").read()   # the pickle names optax classes
    model, ckpt_cfg = torch_ckpt.load_model_freely(path, "cpu")
    assert ckpt_cfg["n_items"] == 60 and not model.training
    _assert_trees_identical(params, to_flax_params(model))
    seq = np.array([[0, 0, 0, 5, 7, 9, 11, 13], [1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    ref = jmodel.apply({"params": params}, {"item_seq": jnp.asarray(seq)},
                       method="user_emb")
    with torch.no_grad():
        got = model.user_emb({"item_seq": torch.from_numpy(seq)})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_jax_loads_a_port_checkpoint(tmp_path):
    model = _torch_model()
    model.init_weights(torch.Generator().manual_seed(9))
    path = str(tmp_path / "port.pkl")
    cfg = dict(model.cfg, _private=np.zeros(3))
    torch_ckpt.save_checkpoint(path, {"config": cfg, "params": to_flax_params(model)})
    jmodel, params, _, jcfg = jax_ckpt.load_model_freely(path)
    assert "_private" not in jcfg
    _assert_trees_identical(jax.tree_util.tree_map(np.asarray, params),
                            to_flax_params(model))
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == {"config", "params"}


_IMPORT_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys
BANNED = {banned!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {repo!r})
import unirec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unirec_tpu_torch.__path__,
                                               "unirec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (defines functions only)
for name in ("unirec_tpu_torch.main.main", "unirec_tpu_torch.ops.attention",
             "unirec_tpu_torch.ops.ffn", "unirec_tpu_torch.facility.evaluation",
             "unirec_tpu_torch.ops.metrics", "unirec_tpu_torch.data.pipeline",
             "unirec_tpu_torch.models.sequential", "unirec_tpu_torch.models.modules",
             "unirec_tpu_torch.utils.file_io", "unirec_tpu_torch.data.history",
             "unirec_tpu_torch.main.infer_embedding", "unirec_tpu_torch.models.cf",
             "unirec_tpu_torch.models.rank", "unirec_tpu_torch.data.ranker_prep",
             "unirec_tpu_torch.models.solvers", "unirec_tpu_torch.ops.linalg",
             "unirec_tpu_torch.facility.solver", "unirec_tpu_torch.facility.sweep",
             "unirec_tpu_torch.utils.fastio", "unirec_tpu_torch.data.prepare",
             "unirec_tpu_torch.data.downloaders", "unirec_tpu_torch.cli"):
    assert name in sys.modules, name
from unirec_tpu_torch.utils.registry import get_model_class
for model in ("SASRec", "GRU", "AvgHist", "AttHist", "SVDPlusPlus", "ConvFormer",
              "FASTConvFormer", "MF", "MultiVAE", "FM", "BST", "AdaRanker",
              "EASE", "SLIM", "AdmmSLIM", "SAR", "UserCF"):
    get_model_class(model)
lazy = [m for m in ("pandas", "yaml", "scipy") if m in sys.modules]
assert not lazy, lazy
print("imported", len(names))
"""


def test_port_imports_without_jax_flax_optax_or_the_jax_package():
    probe = _IMPORT_PROBE.format(banned=BANNED, repo=str(REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(REPO / "tests"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in (REPO / "unirec_tpu_torch").rglob("*.py")]
    + ["card_cases.py", "chip_smoke.py"]))
def test_no_jax_import_anywhere_in_the_source(path):
    """Also covers imports inside functions, which the probe cannot reach."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not set(roots) & set(BANNED), (path, node.lineno, roots)


FFN_ARGS = dict(ARGS, use_fused_ffn=1, use_fused_attention=1, last_query_only=1)


def test_fused_ffn_tree_round_trips_without_a_new_mapping():
    """use_fused_ffn declares dense_1/dense_2 through _DenseParams with the
    same kernel/bias names (unirec_tpu/models/modules.py:414-428): the
    bridge maps the JAX tree of that configuration both ways exactly, and
    the port's eval user embedding equals the JAX model's."""
    cfg = jax_config.parse_arguments(dict(FFN_ARGS), argv=[])
    jmodel = jax_model_class("SASRec")(cfg=cfg)
    seq = np.array([[0, 0, 0, 5, 7, 9, 11, 13], [1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(4), {"item_seq": jnp.asarray(seq), "user_id": jnp.zeros(2, jnp.int32),
                                "item_id": jnp.zeros(2, jnp.int32), "label": jnp.zeros(2)},
        train=False)["params"])
    _, _, plain = _jax_model()
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(plain)
    model = torch_model_class("SASRec")(
        torch_config.parse_arguments(dict(FFN_ARGS), argv=[], device="cpu"))
    load_flax_params(model, params)
    _assert_trees_identical(params, to_flax_params(model))
    ref = jmodel.apply({"params": params}, {"item_seq": jnp.asarray(seq)}, method="user_emb")
    with torch.no_grad():
        got = model.user_emb({"item_seq": torch.from_numpy(seq)})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_flash_attention_needs_no_new_mapping():
    """Flash attention has no parameters: under use_pallas at L=256 (the
    flash path) the JAX tree equals the plain configuration's, and the
    bridge maps it both ways exactly."""
    args = dict(ARGS, max_seq_len=256, use_pallas=1)
    cfg = jax_config.parse_arguments(dict(args), argv=[])
    jmodel = jax_model_class("SASRec")(cfg=cfg)
    batch = {"item_seq": jnp.ones((2, 256), jnp.int32), "user_id": jnp.zeros(2, jnp.int32),
             "item_id": jnp.zeros(2, jnp.int32), "label": jnp.zeros(2)}
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(5), batch, train=False)["params"])
    _, _, plain = _jax_model()
    plain_tree = jax.tree_util.tree_structure(plain)
    assert jax.tree_util.tree_structure(params) == plain_tree
    model = torch_model_class("SASRec")(
        torch_config.parse_arguments(dict(args), argv=[], device="cpu"))
    load_flax_params(model, params)
    _assert_trees_identical(params, to_flax_params(model))
