"""unirec_tpu_torch's flash attention against the JAX package.

On CPU tensors the port's ``flash_attention`` runs its plain version, a
two-pass softmax in f32; the JAX ``flash_attention`` runs its Pallas kernel
(an online softmax over key blocks) in interpret mode, with
``unirec_tpu.ops.attention._INTERPRET`` set as tests/test_kernels.py sets
it. The same numpy inputs go through both, the mask [B, 1, L, L] to the
port and broadcast to [B, H, L, L] for the JAX kernel, as its wrapper does.

Tolerances, each relative to max(1, the largest reference value): f32 1e-5
(the two softmax orders and f32 sum orders differ); bf16 one bf16 ulp
(2^-7) for the output, which both round from f32 once, and two (2^-6) for
the gradients, whose f32 sums may flip a rounding of out or of the inputs'
products. Example 0 of each case has every key masked: its scores sit
near -1e4, where f32 keeps steps of 2^-10, so a dot product that differs
in its last bit can move a score, and with it a probability, by 2^-10
relative; its outputs and gradients are held to max(tol, 2^-10). lse is
f32 in both dtypes and held to 1e-5 of each row's own magnitude.

Then the dispatch gate of models/modules.py, a tiny SASRec at L=256 through
both packages (user embeddings in eval; loss and every gradient at dropout
0, as tests/test_torch_train.py holds a train step), and the infer task
through both packages' main.run.
"""
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import unirec_tpu.ops.attention as jax_attn
import unirec_tpu.ops.member as jax_member
import unirec_tpu.ops.scatter_accum as jax_sa
from tests.synth import BASE_CONF
from tests.test_torch_main import _step_pair
from tests.test_torch_train import BENCH_MINI
from unirec_tpu import config as jax_config
from unirec_tpu.main import main as jax_main
from unirec_tpu.utils.registry import get_model_class as jax_model_class
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.main import main
from unirec_tpu_torch.models.modules import DropoutRNG, MultiHeadAttention, causal_attention_mask
from unirec_tpu_torch.ops import attention as A
from unirec_tpu_torch.utils.flax_bridge import load_flax_params
from unirec_tpu_torch.utils.registry import get_model_class

B, H = 2, 2
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7, 2.0 ** -6)}


@pytest.fixture
def interpret(monkeypatch):
    for mod in (jax_attn, jax_sa, jax_member):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def _inputs(L, hd, seed=0):
    """q, k, v [B, H, L, hd] and the model's additive mask [B, 1, L, L]:
    the causal -1e4 triangle plus padded keys; example 0 is all padding (its
    rows attend uniformly over every key)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, hd)).astype(np.float32) for _ in range(3))
    seq = rng.integers(0, 3, size=(B, L))
    seq[:, -2:] = 1
    seq[0] = 0
    mask = causal_attention_mask(torch.from_numpy(seq)).numpy()
    return q, k, v, mask


def _close(got, ref, tol, name):
    """Examples 1.. to tol, the fully masked example 0 to max(tol, 2^-10),
    each relative to max(1, its largest reference value); a single example is
    held to the first of the two."""
    assert got.shape == ref.shape, name
    for sl, t in ((slice(1, None), tol), (slice(0, 1), max(tol, 2.0 ** -10))):
        if got[sl].size == 0:
            continue
        err = float(np.abs(got[sl] - ref[sl]).max())
        assert err <= t * max(1.0, float(np.abs(ref[sl]).max())), (name, sl, err)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("L,hd", [   # 264: no power-of-two tile >= 16 divides it
    (256, 8), (256, 32), (264, 8), (264, 32),
    (256, 136)])                      # a head wider than 128: one example and head
def test_flash_forward_lse_and_gradients_match_the_pallas_kernel(interpret, L, hd, dtype):
    jdt, tdt, tol_out, tol_grad = DTYPES[dtype]
    q, k, v, mask = _inputs(L, hd)
    if hd > 128:   # example 1 (not all padding), head 0, so the interpret run stays short
        q, k, v, mask = (t[1:2, :1] for t in (q, k, v, mask))
    g = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(t, jdt) for t in (q, k, v))
    jmask = jnp.broadcast_to(jnp.asarray(mask), (*q.shape[:2], L, L))
    jout, jlse = jax_attn._pallas_fwd(jq, jk, jv, jmask)
    _, vjp = jax.vjp(lambda a, b, c: jax_attn.flash_attention(a, b, c, jmask), jq, jk, jv)
    jgrads = vjp(jnp.asarray(g, jdt))

    tq, tk, tv = (torch.tensor(t, dtype=tdt, requires_grad=True) for t in (q, k, v))
    tmask = torch.from_numpy(mask)
    with torch.no_grad():
        out, lse = A._flash_fwd_plain(tq, tk, tv, tmask)
    assert out.dtype == tdt and lse.dtype == torch.float32
    A.flash_attention(tq, tk, tv, tmask).backward(torch.tensor(g, dtype=tdt))

    _close(out.detach().float().numpy(), np.asarray(jout, np.float32), tol_out, "out")
    ref_lse = np.asarray(jlse)[..., 0]
    assert np.all(np.abs(lse.numpy() - ref_lse) <= 1e-5 * np.maximum(1.0, np.abs(ref_lse)))
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), jgrads):
        assert t.grad.dtype == tdt
        _close(t.grad.float().numpy(), np.asarray(r, np.float32), tol_grad, name)
    assert A.flash_attention.launches == 0


def _tensor_core_flash(q, k, v, mask, split=True, blk=64):
    """The bf16 body of csrc/flash_attention.cu in plain torch: bf16 q, k, v
    (exact in f32), f32 sums, the scale on the f32 scores after Q K^T, an
    online softmax over tiles of ``blk`` keys, and P V as p_hi V + p_lo V
    with p_hi = bf16(p), p_lo = bf16(p - p_hi) (``split``; else one bf16
    p). Returns (out in f32 before its rounding, lse)."""
    B, H, L, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, L), -torch.inf)
    l = torch.zeros(B, H, L)
    acc = torch.zeros(B, H, L, hd)
    for c0 in range(0, L, blk):
        s = (qf @ kf[:, :, c0:c0 + blk].transpose(-1, -2)) * scale + mask[..., c0:c0 + blk]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if split else torch.zeros_like(p)
        acc = acc * alpha[..., None] + hi @ vf[:, :, c0:c0 + blk] + lo @ vf[:, :, c0:c0 + blk]
        l = l * alpha + p.sum(-1)
        m = m_new
    return acc / l[..., None], m + torch.log(l)


@pytest.mark.parametrize("L", [256, 264])   # 264: a ragged last tile of 8 keys
def test_tensor_core_arithmetic_matches_the_pallas_kernel(interpret, L):
    """The card's bf16 flash body rounds in another order than the Pallas
    kernel (scale after the product, p split into two bf16 halves for P V).
    Emulated here, it stays within FLASH_TOL of the Pallas kernel in bf16
    (two bf16 ulps of max(1, the largest output)) with lse within 1e-5
    relative; against a float64 reference the split keeps p to about 16
    bits, while a single bf16 p costs its 2^-9 per term."""
    q, k, v, mask = _inputs(L, 32, seed=4)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    jout, jlse = jax_attn._pallas_fwd(jq, jk, jv, jnp.broadcast_to(jnp.asarray(mask),
                                                                   (B, H, L, L)))
    tq, tk, tv = (torch.tensor(t).bfloat16() for t in (q, k, v))
    tmask = torch.from_numpy(mask)
    out32, lse = _tensor_core_flash(tq, tk, tv, tmask)
    ref = np.asarray(jout, np.float32)
    err = float(np.abs(out32.bfloat16().float().numpy() - ref).max())
    assert err <= 2.0 ** -6 * max(1.0, float(np.abs(ref).max())), err
    ref_lse = np.asarray(jlse)[..., 0]
    assert np.all(np.abs(lse.numpy() - ref_lse) <= 1e-5 * np.maximum(1.0, np.abs(ref_lse)))

    # rows with every key masked score near -1e4, where f32 itself keeps
    # steps of 2^-10: held above; here only rows that see a key
    s64 = (tq.double() @ tk.double().transpose(-1, -2)) / np.sqrt(32) + tmask.double()
    exact = torch.softmax(s64, -1) @ tv.double()
    seen = (tmask.amax(-1) == 0).expand(B, H, L)
    single, _ = _tensor_core_flash(tq, tk, tv, tmask, split=False)
    err_split = float((out32.double() - exact)[seen].abs().max())
    err_single = float((single.double() - exact)[seen].abs().max())
    print(f"L={L}: f32 output error, hi/lo split {err_split:.3g}, one bf16 p {err_single:.3g}")
    assert err_split <= 1e-5 and err_single > 20 * err_split


def test_causal_attention_entry_matches_jax(interpret):
    """The JAX entry point broadcasts the mask and calls the kernel; the
    port's reads the [B, 1, L, L] mask as it is. Below the gate both run
    xla_attention."""
    for L in (256, 16):
        q, k, v, mask = _inputs(L, 8, seed=2)
        with pytest.MonkeyPatch.context() as mp:
            if L < A.MIN_FLASH_SEQ_LEN:   # JAX in interpret mode takes every L % 8
                mp.setattr(jax_attn, "_INTERPRET", False)
            ref = jax_attn.causal_attention(*(jnp.asarray(t) for t in (q, k, v, mask)))
        got = A.causal_attention(*(torch.from_numpy(t) for t in (q, k, v, mask)))
        _close(got.numpy(), np.asarray(ref), 1e-5, f"L={L}")


@pytest.mark.parametrize("L,hd,flash", [(256, 8, True), (248, 8, False), (260, 8, False),
                                        (256, 12, False), (264, 16, True)])
def test_flash_gate(L, hd, flash):
    q = torch.zeros(B, H, L, hd)
    assert A.flash_supported(q, torch.zeros(B, 1, L, L)) == flash
    assert A.flash_supported(q, torch.zeros(B, H, L, L)) == flash
    assert A.flash_supported(q, torch.zeros(B, 1, 1, L)) == flash   # bidirectional mask
    assert not A.flash_supported(q, torch.zeros(B, 3, L, L))


@pytest.mark.parametrize("L,hd,train,p_attn,flash", [
    (256, 8, False, 0.0, True), (256, 8, False, 0.5, True), (256, 8, True, 0.0, True),
    (256, 8, True, 0.5, False), (248, 8, False, 0.0, False), (260, 8, False, 0.0, False),
    (256, 12, False, 0.0, False)])
def test_module_dispatch(monkeypatch, L, hd, train, p_attn, flash):
    """models/modules.py:MultiHeadAttention: use_pallas sends a shape the
    gate takes to flash attention unless attention dropout runs in train
    mode; others run the plain math. On the CPU no kernel launches."""
    calls = []
    real = A.causal_attention
    monkeypatch.setattr(A, "causal_attention", lambda *a: calls.append(1) or real(*a))
    mha = MultiHeadAttention(2, 2 * hd, 1e-12, use_flash=True, attn_dropout_prob=p_attn)
    seq = torch.ones(2, L, dtype=torch.long)
    seq[0, :L // 2] = 0
    x = torch.randn(2, L, 2 * hd, generator=torch.Generator().manual_seed(0))
    mha(x, causal_attention_mask(seq), train, DropoutRNG(0, "cpu"))
    assert bool(calls) == flash
    assert A.flash_attention.launches == 0


# ------------------------------------------------------------- model level
TINY = dict(BENCH_MINI, max_seq_len=256, fused_layer=0, fused_lastq=0, use_pallas=1,
            use_fused_attention=0, use_fused_ffn=0)


def _user_emb_pair(args):
    jcfg = jax_config.parse_arguments(dict(args), argv=[])
    tcfg = torch_config.parse_arguments(dict(args), argv=[], device="cpu")
    rng = np.random.default_rng(3)
    seq = np.zeros((3, 256), np.int32)
    for r, n in enumerate((200, 17, 256)):
        seq[r, 256 - n:] = rng.integers(1, BENCH_MINI["n_items"], n)
    jmodel = jax_model_class("SASRec")(cfg=jcfg)
    batch = {"item_seq": jnp.asarray(seq), "user_id": jnp.zeros(3, jnp.int32),
             "item_id": jnp.zeros(3, jnp.int32), "label": jnp.zeros(3)}
    params = jmodel.init(jax.random.PRNGKey(6), batch, train=False)["params"]
    ref = jmodel.apply({"params": params}, {"item_seq": batch["item_seq"]}, method="user_emb")
    tmodel = get_model_class("SASRec")(tcfg)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tmodel.user_emb({"item_seq": torch.from_numpy(seq).long()})
    return got.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.05)])
@pytest.mark.parametrize("last_query_only", [1, 0])
def test_sasrec_at_L256_matches_jax(interpret, monkeypatch, last_query_only, dtype, tol):
    """User embeddings in eval, then one train step at dropout 0: loss and
    every gradient leaf (f32: 1e-5 relative loss, 1e-5 + 1e-3 max|g| per
    leaf; bf16: 0.05 of each, as tests/test_torch_train.py, but 0.15 for
    the bias leaves: a bias gradient sums B*L = 3,072 rows, which the JAX
    package sums in bf16, and its value biases then lie 6-10% from its own
    f32 gradient, the port's within 1%). The flash path runs in both
    packages: counted on the port's side."""
    calls = []
    real = A.flash_attention
    monkeypatch.setattr(A, "flash_attention", lambda *a: calls.append(1) or real(*a))
    args = dict(TINY, last_query_only=last_query_only, compute_dtype=dtype)
    got, ref = _user_emb_pair(args)
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())
    assert len(calls) == (1 if last_query_only else 2)
    tloss, jloss, tg, jg, _, _ = _step_pair(args)
    assert abs(tloss - jloss) <= tol * abs(jloss)
    assert set(tg) == set(jg)
    for k in jg:
        err = float(np.abs(tg[k] - jg[k]).max())
        rel = 0.15 if k[-1] == "bias" else tol
        bound = (1e-5 + 1e-3 * float(np.abs(jg[k]).max()) if dtype == "float32"
                 else rel * float(np.abs(jg[k]).max()) + 1e-6)
        assert err <= bound, (k, err)
    assert np.abs(tg[("trm_encoder", "layer_0", "multi_head_attention", "query",
                      "kernel")]).max() > 0


# ------------------------------------------------------------ entry points
def test_infer_task_matches_jax(interpret, synth_dataset, tmp_path):
    """main.run(task=train) at L=256 on the CPU, then task=infer from its
    checkpoint: one finite score per real test row, equal to the JAX
    package's main.run(task=infer) from the same checkpoint within 1e-5
    (f32; the JAX side runs its flash kernel in Pallas interpret mode, the
    port its plain version). The synthetic dataset with its train table cut
    to two batches keeps the CPU work small."""
    src, _ = synth_dataset
    root = tmp_path / "data"
    root.mkdir()
    for f in Path(src).iterdir():
        if f.is_file():
            shutil.copy(f, root / f.name)
    pd.read_pickle(root / "train.pkl").iloc[:256].to_pickle(root / "train.pkl")
    root = str(root)
    args = dict(BASE_CONF, model="SASRec", dataloader="SeqRecDataset", dataset_path=root,
                output_path=str(tmp_path / "train"), exp_name="long", epochs=1,
                max_seq_len=256, embedding_size=16, hidden_size=16, n_heads=2,
                inner_size=32, n_layers=2, use_pallas=1, last_query_only=1,
                use_fused_ffn=1, hidden_dropout_prob=0.1, attn_dropout_prob=0.0,
                batch_size=128, device="cpu")
    assert main.run(args) is not None
    ckpt = str(tmp_path / "train" / "checkpoint" / "long.pkl")
    infer = {"task": "infer", "model_file": ckpt, "dataset_path": root}
    assert main.run(dict(infer, output_path=str(tmp_path / "port"), device="cpu")) is None
    assert jax_main.run(dict(infer, output_path=str(tmp_path / "jax"))) is None
    got = np.loadtxt(tmp_path / "port" / "long.infer.txt")
    ref = np.loadtxt(tmp_path / "jax" / "long.infer.txt")
    n_test = len(pd.read_pickle(f"{root}/test.pkl"))
    assert got.shape == ref.shape and got.shape[0] == n_test
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
