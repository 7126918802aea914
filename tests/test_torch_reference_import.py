"""Importing reference (UniRec torch) checkpoints into the port
(utils/torch_import.py) against the JAX package's importer.

No reference checkpoint is at hand, so each case writes one: a small
model's parameters (the JAX package's initialization, seed 0) under the
reference's names (a Linear's weight [out, in], ``trm_encoder.layer.<i>``,
``LayerNorm.weight``, ``*embedding.weight``), plus keys neither importer
converts (a BatchNorm's counters, a raw parameter). For SASRec, MF, GRU,
BST and FM: the port's ``convert_state_dict`` gives the JAX package's tree
bit for bit and the same leftovers; ``load_reference_checkpoint`` warns
naming them, as the JAX one does; and the port model loaded from the
``.pth`` scores a batch as the JAX model does with the JAX conversion
(``predict``, f32, within 1e-5).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.ops.scatter_accum as jax_sa
from unirec_tpu import config as jax_config
from unirec_tpu.utils import torch_import as jax_import
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.utils import torch_import as port_import
from unirec_tpu_torch.utils.flax_bridge import load_flax_params
from unirec_tpu_torch.utils.registry import get_model_class as torch_model_class

B, L, N_USERS, N_ITEMS, N_FEATS, G, F_ = 5, 8, 15, 40, 30, 4, 3
BASE = dict(n_users=N_USERS, n_items=N_ITEMS, embedding_size=16, hidden_size=16,
            max_seq_len=L, compute_dtype="float32", dropout_prob=0.0,
            hidden_dropout_prob=0.0, attn_dropout_prob=0.0, n_layers=2, n_heads=2,
            inner_size=24, hidden_act="swish", loss_type="bce", group_size=-1)
MODELS = {
    "SASRec": dict(dataloader="SeqRecDataset"),
    "MF": dict(dataloader="BaseDataset", has_user_emb=1),
    "GRU": dict(dataloader="SeqRecDataset"),
    "BST": dict(dataloader="SeqRecDataset", layer_norm_eps="1e-10"),
    "FM": dict(dataloader="RankDataset", n_feats=N_FEATS),
}
# keys neither importer converts
EXTRA = {"batch_norm.num_batches_tracked": torch.tensor(3),
         "batch_norm.running_mean": torch.zeros(4)}
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(jax_sa, "_INTERPRET", True)


@pytest.fixture(autouse=True)
def package_loggers_propagate(monkeypatch):
    """A trainer or solver left at its default name sets up the logger
    "unirec_tpu" with propagation off (utils/logger.py), and the import
    warnings counted here come from its children: keep them reaching
    caplog whatever ran before in the process."""
    for name in ("unirec_tpu", "unirec_tpu_torch"):
        monkeypatch.setattr(logging.getLogger(name), "propagate", True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, N_ITEMS, size=(B, L))
    seq[0, :5] = 0
    seq[1, :] = 0
    label = np.zeros((B, G), np.float32)
    label[:, 0] = 1.0
    return {"user_id": rng.integers(1, N_USERS, B).astype(np.int32),
            "item_id": rng.integers(1, N_ITEMS, (B, G)).astype(np.int32),
            "label": label, "weight": np.ones(B, np.float32),
            "item_seq": seq.astype(np.int32),
            "item_seq_len": (seq != 0).sum(1).astype(np.int32),
            "index_list": rng.integers(0, N_FEATS, (B, G, F_)).astype(np.int32),
            "value_list": rng.random((B, G, F_)).astype(np.float32)}


def _reference_state_dict(tree, prefix=()):
    """A flax tree under the reference's torch names: kernels [in, out] as
    Linear weights [out, in], ``layer_<i>`` as ModuleList index ``layer.<i>``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_reference_state_dict(v, prefix + (k,)))
            continue
        parts = [p.replace("_", ".") if p.startswith("layer_") and p[6:].isdigit() else p
                 for p in prefix]
        arr = np.array(v, copy=True)
        if k == "kernel":
            arr = arr.T if arr.ndim == 2 else arr
        name = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(k, k)
        out[".".join(parts + [name])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _case(name):
    args = dict(BASE, model=name, **MODELS[name])
    jmodel = jax_model_class(name)(cfg=jax_config.parse_arguments(dict(args), argv=[]))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0), jb, train=False)["params"])
    sd = dict(_reference_state_dict(params), **EXTRA)
    tmodel = torch_model_class(name)(torch_config.parse_arguments(dict(args), argv=[],
                                                                  device="cpu"))
    return jmodel, jb, batch, sd, tmodel


def _raw(sd):
    """The model's parameters that are neither a weight nor a bias (FM's
    ``fm_linear_bias``): neither importer converts them either."""
    return {k: v for k, v in sd.items() if k not in EXTRA
            and k.split(".")[-1] not in ("weight", "bias")}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_convert_state_dict_equals_jax(name):
    _, _, _, sd, _ = _case(name)
    tree, left = port_import.convert_state_dict(sd)
    jtree, jleft = jax_import.convert_state_dict(sd)
    assert left == jleft == list(_raw(sd)) + list(EXTRA)
    got, want = dict(_flat(tree)), dict(_flat(jtree))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_imported_model_scores_as_jax(name, tmp_path, caplog):
    jmodel, jb, batch, sd, tmodel = _case(name)
    path = tmp_path / f"{name}.pth"
    torch.save({"state_dict": sd, "config": {"model": name}}, path)
    with caplog.at_level(logging.WARNING):
        cfg = port_import.load_reference_into(tmodel, str(path))
        jtree, jcfg = jax_import.load_reference_checkpoint(str(path))
    assert cfg == jcfg == {"model": name}
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    left = list(_raw(sd)) + list(EXTRA)
    assert warnings == [f"unconverted checkpoint keys: {left}"] * 2
    # the unconverted parameters, by hand into both models
    raw = {k: v.numpy() for k, v in _raw(sd).items()}
    load_flax_params(tmodel, raw, strict=False)
    jtree = dict(jtree, **raw)
    want = np.asarray(jmodel.apply({"params": jtree}, jb, method="predict"))
    with torch.no_grad():
        got = tmodel.eval().predict({k: torch.as_tensor(v) for k, v in batch.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def test_a_tree_with_every_parameter_loads_strictly():
    """Every port parameter has its reference name: the converted tree of a
    SASRec loads with the bridge's strict check."""
    _, _, _, sd, tmodel = _case("SASRec")
    tree, _ = port_import.convert_state_dict(sd)
    load_flax_params(tmodel, tree, strict=True)
