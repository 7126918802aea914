"""The port's serving export (torch.export programs with the fused kernels as
unirec::* operators) and approximate top-k against the JAX package.

- A SASRec checkpoint trained by the JAX package (as
  tests/test_serving_export.py makes it): the JAX ``export_model`` /
  ``ServingModel`` and the port's agree within 1e-5 (f32) on every
  function, at a symbolic and at a fixed batch, and the manifests carry the
  same keys (``kept_inputs`` lists every input: torch.export prunes none).
- Port checkpoints in the fused configurations: ``fused_layer`` +
  ``fused_lastq`` records ``unirec::layer_fwd`` and ``unirec::lastq_fwd``
  and no plain attention, ``use_fused_attention`` + ``use_fused_ffn``
  ``unirec::attention_fwd`` and ``unirec::ffn_fwd``, ``use_pallas`` at
  L=256 ``unirec::flash_fwd``; each artifact equals the live model (the
  exporter's own check) at any batch of the symbolic dimension.
- Each operator's CPU implementation equals its plain version (bit for
  bit, dropout on where it has any), and its fake implementation gives the
  real output's shape, dtype and strides.
- reco-topk with ``topk_recall_target`` writes the JAX package's CSV, and
  the ``export`` command runs through the port's CLI.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tests.synth import BASE_CONF
from unirec_tpu.main import main as jax_main
from unirec_tpu.main import reco_topk as jax_reco
from unirec_tpu.serving.export import ServingModel as JaxServingModel
from unirec_tpu.serving.export import export_model as jax_export_model
from unirec_tpu_torch import cli
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.main import reco_topk as torch_reco
from unirec_tpu_torch.ops import attention as AT
from unirec_tpu_torch.ops import ffn as FF
from unirec_tpu_torch.ops import layer as LY
from unirec_tpu_torch.ops import op_schemas
from unirec_tpu_torch.serving.export import ServingModel, custom_ops, export_model
from unirec_tpu_torch.utils.checkpoint import save_checkpoint
from unirec_tpu_torch.utils.flax_bridge import to_flax_params
from unirec_tpu_torch.utils.registry import get_model_class


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ckpt(synth_dataset, tmp_path_factory):
    """tests/test_serving_export.py's checkpoint: SASRec trained two epochs
    by the JAX package."""
    root, _ = synth_dataset
    out = str(tmp_path_factory.mktemp("jaxexport"))
    conf = copy.deepcopy(BASE_CONF)
    conf.update(model="SASRec", dataloader="SeqRecDataset", loss_type="fullsoftmax",
                n_sample_neg_train=0, n_layers=1, dataset_path=root, output_path=out,
                task="train", epochs=2, exp_name="exp")
    jax_main.run(conf)
    return os.path.join(out, "checkpoint", "exp.pkl"), root, out


@pytest.fixture(scope="module")
def artifacts(jax_ckpt):
    """Both packages' exports of the checkpoint, symbolic and fixed batch."""
    ckpt, _, out = jax_ckpt
    arts = {}
    for batch_size in (0, 6):
        jdir, tdir = (os.path.join(out, f"{p}-{batch_size}") for p in ("jax", "torch"))
        arts[batch_size] = (jax_export_model(ckpt, jdir, batch_size=batch_size),
                            export_model(ckpt, tdir, batch_size=batch_size, device="cpu"),
                            JaxServingModel(jdir), ServingModel(tdir))
    return arts


def _requests(manifest, B, seed=1):
    rng = np.random.default_rng(seed)
    L = manifest["max_seq_len"]
    users = np.arange(1, B + 1).astype(np.int32)
    seq = rng.integers(1, 300, size=(B, L)).astype(np.int32)
    seq[0, :4] = 0
    lens = (seq != 0).sum(1).astype(np.int32)
    cands = rng.integers(1, 300, size=(B, 32)).astype(np.int32)
    return {"user_emb": (users, seq, lens), "item_emb": (users,),
            "score": (users, seq, lens, cands)}


@pytest.mark.parametrize("batch_size", [0, 6])
@pytest.mark.parametrize("fn", ["user_emb", "item_emb", "score"])
def test_export_matches_jax(artifacts, batch_size, fn):
    jman, tman, jserve, tserve = artifacts[batch_size]
    for B in ((6,) if batch_size else (6, 3, 17)):
        args = _requests(tman, B)[fn]
        got, ref = getattr(tserve, fn)(*args), getattr(jserve, fn)(*args)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_manifest_keys_match_jax(artifacts, jax_ckpt):
    """The JAX manifest's keys (less its StableHLO-only ones), every input
    kept, the files on disk."""
    jman, tman, _, _ = artifacts[0]
    for k in ("model", "max_seq_len", "is_seqrec", "n_items", "n_users", "embedding_size"):
        assert tman[k] == jman[k], k
    assert set(tman["functions"]) == set(jman["functions"])
    for name, info in tman["functions"].items():
        ref = jman["functions"][name]
        assert info["in_shapes"] == ref["in_shapes"]
        assert info["kept_inputs"] == list(range(len(info["in_shapes"])))
        assert info["custom_ops"] == []           # the checkpoint runs no fused kernel
    out = os.path.join(jax_ckpt[2], "torch-0")
    assert json.load(open(os.path.join(out, "manifest.json"))) == tman
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt2")) == \
        ["item_emb.pt2", "score.pt2", "user_emb.pt2"]


FUSED = {"layer": (dict(last_query_only=1, fused_layer=1, fused_lastq=1, n_layers=2),
                   ["unirec::lastq_fwd", "unirec::layer_fwd"]),
         "attention_ffn": (dict(use_fused_attention=1, use_fused_ffn=1, n_layers=2),
                           ["unirec::attention_fwd", "unirec::ffn_fwd"]),
         "flash": (dict(use_pallas=1, use_fused_ffn=1, max_seq_len=256, n_layers=1,
                        attn_dropout_prob=0.0), ["unirec::ffn_fwd", "unirec::flash_fwd"])}


def write_port_checkpoint(path, **over):
    """A port checkpoint of a small SASRec, random weights from seed 0."""
    cfg = torch_config.parse_arguments(dict(
        dict(model="SASRec", n_users=50, n_items=100, max_seq_len=10, embedding_size=16,
             hidden_size=16, inner_size=32, n_heads=2, dataloader="SeqRecDataset",
             hidden_act="swish", init_std=0.1), **over), argv=[], device="cpu")
    model = get_model_class("SASRec")(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    save_checkpoint(str(path), {"config": cfg, "params": to_flax_params(model)})
    return str(path)


@pytest.mark.parametrize("kind", sorted(FUSED))
def test_fused_checkpoint_records_the_kernels(tmp_path, kind):
    over, ops = FUSED[kind]
    ckpt = write_port_checkpoint(tmp_path / "ck.pkl", **over)
    man = export_model(ckpt, str(tmp_path / "art"), device="cpu")   # checks each artifact
    assert man["functions"]["user_emb"]["custom_ops"] == ops
    assert man["functions"]["score"]["custom_ops"] == ops
    assert man["functions"]["item_emb"]["custom_ops"] == []
    ep = torch.export.load(str(tmp_path / "art" / "user_emb.pt2"))
    assert custom_ops(ep) == ops
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert not any("softmax" in t for t in targets), targets     # no plain attention
    serve = ServingModel(str(tmp_path / "art"))
    rng = np.random.default_rng(2)
    L = man["max_seq_len"]
    for B in (1, 5):                                 # the symbolic batch stays symbolic
        seq = rng.integers(1, 99, size=(B, L)).astype(np.int32)
        assert serve.user_emb(np.arange(1, B + 1), seq, np.full(B, L)).shape == (B, 16)


# ---------------------------------------------------------------- the ops
def _layer_args(rng, B=3, Lp=16, D=16, F=32, last=False):
    t = lambda *s: torch.as_tensor(rng.normal(size=s) * 0.3, dtype=torch.float32)  # noqa: E731
    params = ((t(D, D), t(D)), (t(D, D), t(D)), (t(D, D), t(D)), (t(D, D), t(D)),
              (1 + t(D), t(D)), (t(D, F), t(F)), (t(F, D), t(D)), (1 + t(D), t(D)))
    x = t(B, Lp, D)
    madd = torch.zeros(B, Lp)
    madd[0, :5] = -1e4
    madd[:, 12:] = LY.PAD_MASK
    flat = (LY._lastq_weights if last else LY._layer_weights)(params, torch.float32)
    return x, madd, flat


def _case(name, drop_on):
    rng = np.random.default_rng(0)
    drop = LY.drop_params(0.1, 0.2, True, 1234) if drop_on else LY.NO_DROP
    if name == "layer_fwd":
        x, madd, flat = _layer_args(rng)
        return ((x, madd, list(flat), 2, LY.SUPPORTED_ACTS.index("swish"), True, 1e-5, *drop),
                LY._layer_fwd_plain(x, madd, flat, 2, "swish", 1e-5, True, drop))
    if name == "lastq_fwd":
        x, madd, flat = _layer_args(rng, last=True)
        return ((x, madd, list(flat), 11, 2, LY.SUPPORTED_ACTS.index("gelu"), 1e-5, *drop),
                LY._lastq_fwd_plain(x, madd, flat, 11, 2, "gelu", 1e-5, drop))
    L = 256 if name == "flash_fwd" else 24           # flash attention's gate: L >= 256
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 2, L, 8)), dtype=torch.float32)
               for _ in range(3))
    mask = torch.where(torch.as_tensor(rng.uniform(size=(2, 1, L, L)) < 0.2), -1e4, 0.0)
    if name == "attention_fwd":
        return ((q, k, v, mask, drop.seed, drop.t_attn, drop.inv_attn),
                AT._fwd_plain(q, k, v, mask, drop))
    if name == "flash_fwd":
        return (q, k, v, mask), AT._flash_fwd_plain(q, k, v, mask)
    x = torch.as_tensor(rng.normal(size=(40, 16)), dtype=torch.float32)
    w1, w2 = (torch.as_tensor(rng.normal(size=s) * 0.3, dtype=torch.float32)
              for s in ((16, 32), (32, 16)))
    b1, b2 = torch.zeros(32) + 0.1, torch.zeros(16) - 0.1
    return (x, w1, b1, w2, b2, FF.ACTS.index("swish")), FF._fwd_plain(x, w1, b1, w2, b2, "swish")


@pytest.mark.parametrize("name", sorted(op_schemas.SCHEMAS))
def test_operator_cpu_is_the_plain_version_and_fake_matches(name):
    op = getattr(torch.ops.unirec, name).default
    for drop_on in ((False, True) if name in ("layer_fwd", "lastq_fwd", "attention_fwd")
                    else (False,)):
        args, ref = _case(name, drop_on)
        got = op(*args)
        outs, refs = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for g, r in zip(outs, refs):
            assert torch.equal(g, r), (name, drop_on)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                     [mode.from_tensor(t) for t in a] if isinstance(a, list) else a
                     for a in args]
        fake = op(*fake_args)
    fakes = fake if isinstance(fake, tuple) else (fake,)
    for f, g in zip(fakes, outs):
        assert (f.shape, f.dtype, f.stride()) == (g.shape, g.dtype, g.stride()), name
    assert str(op._schema) == f"unirec::{op_schemas.full_schema(name)}"


@pytest.mark.parametrize("name", sorted(op_schemas.SCHEMAS))
def test_cuda_implementation_launches_or_raises(name, monkeypatch):
    """No fallback: each operator has a CUDA kernel, the launcher, which
    builds and calls its kernel library or raises (here, with no library,
    it raises); only CPU tensors take the plain version."""
    from unirec_tpu_torch.ops import _build
    q = op_schemas.qualname(name)
    assert torch._C._dispatch_has_kernel_for_dispatch_key(q, "CUDA")
    assert torch._C._dispatch_has_kernel_for_dispatch_key(q, "CPU")

    def no_library(lib):
        raise RuntimeError(f"no kernel library {lib}")
    monkeypatch.setattr(_build, "library", no_library)
    for fn in (LY._entry, AT._entry, AT._flash_entry, FF._entry):
        fn.cache_clear()
    impl = {"layer_fwd": LY._layer_op("_layer_fwd_cuda"),
            "lastq_fwd": LY._lastq_op("_lastq_fwd_cuda"),
            "attention_fwd": AT._attention_op("_fwd_cuda"),
            "flash_fwd": AT._flash_op("_flash_fwd_cuda"), "ffn_fwd": FF._ffn_op("_fwd_cuda")}[name]
    args, _ = _case(name, False)
    with pytest.raises(RuntimeError, match="no kernel library"):
        impl(*args)
    for fn in (LY._entry, AT._entry, AT._flash_entry, FF._entry):
        fn.cache_clear()


# ------------------------------------------------------- approximate top-k
def test_reco_topk_recall_target_writes_the_jax_csv(jax_ckpt, tmp_path):
    ckpt, root, _ = jax_ckpt
    ids_file = str(tmp_path / "users.txt")
    np.savetxt(ids_file, np.arange(1, 61), fmt="%i")
    base = {"model_file": ckpt, "dataset_path": root, "dataset_name": ids_file,
            "user_history_filename": "user_history", "topk": 10,
            "topk_recall_target": 0.95}
    jax_reco.do_topk_reco(dict(base, output_path=str(tmp_path / "jax.csv")))
    got = torch_reco.do_topk_reco(dict(base, output_path=str(tmp_path / "torch.csv")),
                                  device="cpu")
    exact = torch_reco.do_topk_reco(dict(base, topk_recall_target=0,
                                         output_path=str(tmp_path / "exact.csv")), device="cpu")
    with open(tmp_path / "jax.csv") as a, open(tmp_path / "torch.csv") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(got, exact)


def test_cli_export(jax_ckpt, tmp_path, capsys):
    ckpt = jax_ckpt[0]
    out = str(tmp_path / "cli_art")
    assert cli.main(["export", "--model_file", ckpt, "--out_dir", out, "--batch_size", "4",
                     "--n_candidates", "8", "--device", "cpu"]) == 0
    man = json.load(open(os.path.join(out, "manifest.json")))
    assert man["functions"]["score"]["in_shapes"][3] == [4, 8]
    assert "'functions'" in capsys.readouterr().out
