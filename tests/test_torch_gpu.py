"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

Each kernel against its plain PyTorch version on the same CUDA tensors, in
the working dtype. Tolerances: f32 outputs 1e-4 abs (summation order
only); bf16 LayerNorm outputs, which are O(1), 3e-2 abs (a bf16 rounding
that flips at one point moves later roundings); block maxima 1e-3 of the
largest score. Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have.)
"""
import ctypes

import numpy as np
import pytest
import torch

from unirec_tpu_torch.ops import _build
from unirec_tpu_torch.ops import layer as LY
from unirec_tpu_torch.ops import topk as TK

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer_case(dev, dtype, B=8, L=10, D=32, F=64, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=g, device=dev) * std  # noqa: E731
    x = rn(B, L, D).to(dtype)
    seq = torch.randint(0, 3, (B, L), generator=g, device=dev)
    seq[:, -2:] = 1
    seq[0] = 0                                    # fully padded row
    madd = torch.where(seq > 0, 0.0, LY.MASK_VALUE)
    lin = lambda i, o: (rn(i, o, std=0.2), rn(o, std=0.05))  # noqa: E731
    ln = lambda: (1.0 + rn(D, std=0.1), rn(D, std=0.1))  # noqa: E731
    params = (lin(D, D), lin(D, D), lin(D, D), lin(D, D), ln(), lin(D, F),
              lin(F, D), ln())
    return x, madd, params


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("act", LY.SUPPORTED_ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_fwd_matches_plain(cuda, dtype, act, causal):
    x, madd, params = _layer_case(cuda, dtype)
    kw = dict(n_heads=2, inner_size=64, hidden_act=act, layer_norm_eps=1e-10)
    before = LY.fused_transformer_layer.launches
    y = LY.fused_transformer_layer(x, madd, params, causal=causal, **kw)
    assert LY.fused_transformer_layer.launches == before + 1
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    ref = LY._layer_fwd_plain(xp, mp, LY._layer_weights(params, dtype), 2, act,
                              1e-10, causal)[:, :x.shape[1]]
    assert y.dtype == dtype and torch.isfinite(y).all()
    assert float((y.float() - ref.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lastq_fwd_matches_plain(cuda, dtype):
    x, madd, params = _layer_case(cuda, dtype, seed=1)
    kw = dict(n_heads=2, inner_size=64, hidden_act="gelu", layer_norm_eps=1e-10)
    before = LY.fused_last_query_layer.launches
    y = LY.fused_last_query_layer(x, madd, params, q_index=8, **kw)
    assert LY.fused_last_query_layer.launches == before + 1
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    ref = LY._lastq_fwd_plain(xp, mp, LY._lastq_weights(params, dtype), 8, 2,
                              "gelu", 1e-10)
    assert y.shape == (8, 32)
    assert float((y.float() - ref.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("N", [4096, 1000])       # 1000: ragged last chunk
@pytest.mark.parametrize("udt,idt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.int8),
                                     (torch.float32, torch.int8)])
def test_blockmax_matches_plain(cuda, udt, idt, N):
    g = torch.Generator(device=cuda).manual_seed(2)
    u = torch.randn(100, 65, generator=g, device=cuda).to(udt)
    items = torch.randn(N, 65, generator=g, device=cuda) * 0.05
    scale = None
    if idt == torch.int8:
        items, scale = TK.quantize_catalog(items)
    else:
        items = items.to(idt)
    bm = TK.catalog_blockmax(u, items, item_scale=scale)
    ref = TK._blockmax_plain(u, items, scale)
    assert bm.shape == (100, -(-N // 16))
    assert float((bm - ref).abs().max()) <= 1e-3 * float(ref.abs().max())


def test_fused_topk_equals_dense_top_k(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    u = torch.randn(64, 64, generator=g, device=cuda)
    items = torch.randn(20000, 64, generator=g, device=cuda)
    hist = torch.randint(1, 20000, (64, 30), generator=g, device=cuda)
    hlen = torch.randint(0, 31, (64,), generator=g, device=cuda)
    v, ids = TK.fused_catalog_topk(u, items, 50, hist_items=hist, hist_len=hlen,
                                   exclude_pad_item=True)
    dense = u @ items.T
    banned = torch.where(torch.arange(30, device=cuda)[None] < hlen[:, None], hist, 0)
    dense = dense.scatter(1, banned, float("-inf"))
    ref_v, ref_ids = torch.topk(dense, 50)
    assert torch.equal(ids, ref_ids)
    assert torch.allclose(v, ref_v, atol=1e-4)


def test_shared_memory_gate_matches_the_kernels(cuda):
    layer = _build.library("layer_fwd").unirec_layer_fwd_smem_bytes
    lastq = _build.library("lastq_fwd").unirec_lastq_fwd_smem_bytes
    layer.argtypes = [ctypes.c_int] * 3
    lastq.argtypes = [ctypes.c_int] * 4
    for Lp, D, F, nh in ((56, 64, 128, 2), (16, 32, 64, 2), (136, 64, 256, 4)):
        assert layer(Lp, D, F) == LY._layer_smem_bytes(Lp, D, F)
        assert lastq(Lp, D, F, nh) == LY._lastq_smem_bytes(Lp, D, F, nh)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, madd, params = _layer_case(cuda, torch.float16)
    with pytest.raises(TypeError):
        LY.fused_transformer_layer(x, madd, params, n_heads=2, inner_size=64,
                                   hidden_act="swish", layer_norm_eps=1e-10,
                                   causal=True)
    u = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        TK.catalog_blockmax(u, torch.zeros(32, 8, dtype=torch.int8, device=cuda))


def test_use_pallas_launches_flash_attention_in_both_layers(cuda):
    """use_pallas at L=256 launches flash attention in both layers, and the
    user embeddings agree with the same model through the plain versions
    within emb_tol (chip_smoke.py): bf16 LayerNorm outputs, 3e-2 or two bf16
    ulps of the largest embedding, since one rounding that flips moves an
    element by one ulp, 2^-5 for an output in [4, 8)."""
    from unittest import mock

    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.utils.registry import get_model_class
    L = 256
    cfg = config_mod.parse_arguments({
        "model": "SASRec", "n_users": 10, "n_items": 50, "embedding_size": 16,
        "n_heads": 2, "inner_size": 32, "max_seq_len": L, "use_pallas": 1,
        "compute_dtype": "bfloat16"})
    model = get_model_class("SASRec")(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(cuda).eval()
    seq = torch.randint(1, 50, (4, L), device=cuda)
    seq[0] = 0
    seq[1, :200] = 0
    before = AT.flash_attention.launches
    with torch.no_grad():
        u = model.user_emb({"item_seq": seq})
        assert AT.flash_attention.launches == before + 2
        with mock.patch.object(AT, "_flash_fwd_cuda", AT._flash_fwd_plain):
            ref = model.user_emb({"item_seq": seq})
    tol = max(3e-2, 2.0 ** -6 * float(ref.float().abs().max()))
    assert torch.isfinite(u).all() and float((u.float() - ref.float()).abs().max()) <= tol


def test_sasrec_kernels_agree_with_plain_path(cuda):
    """Bench flags on, bf16: the model through the kernels against the same
    model with the fused flags off (plain PyTorch, bf16 softmax/LN)."""
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.utils.registry import get_model_class
    args = {"model": "SASRec", "n_users": 10, "n_items": 500, "embedding_size": 64,
            "n_heads": 2, "inner_size": 128, "max_seq_len": 50}
    fused = get_model_class("SASRec")(config_mod.parse_arguments(
        dict(args, last_query_only=1, fused_layer=1, fused_lastq=1)))
    plain = get_model_class("SASRec")(config_mod.parse_arguments(args))
    fused.init_weights(torch.Generator().manual_seed(0))
    plain.load_state_dict(fused.state_dict())
    seq = torch.randint(1, 500, (32, 50), device=cuda)
    seq[:, :20] = 0
    before = LY.fused_last_query_layer.launches
    with torch.no_grad():
        a = fused.to(cuda).eval().user_emb({"item_seq": seq})
        b = plain.to(cuda).eval().user_emb({"item_seq": seq})
    assert LY.fused_last_query_layer.launches == before + 1
    assert float((a.float() - b.float()).abs().max()) <= 0.1


# ------------------------------------------------------------ training slice
# Backward tolerances are relative to the largest reference gradient: f32
# 1e-4 (summation order: the kernels sum weight gradients per block, then
# across blocks); bf16 5e-2 (the kernels and the plain versions round to
# bf16 at the same points, but a different f32 summation order can flip
# one rounding, which later roundings carry).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _rel_err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


def _drop(p=0.1, seed=1234):
    return LY.drop_params(p, p, True, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_forward_kernels_match_plain(cuda, dtype):
    x, madd, params = _layer_case(cuda, dtype, B=16, seed=4)
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    flat = LY._layer_weights(params, dtype)
    y = LY._layer_fwd_cuda(xp, mp, flat, 2, "swish", 1e-10, True, _drop())
    ref = LY._layer_fwd_plain(xp, mp, flat, 2, "swish", 1e-10, True, _drop())
    assert float((y.float() - ref.float()).abs().max()) <= TOL[dtype]
    assert float((y.float() - LY._layer_fwd_plain(xp, mp, flat, 2, "swish", 1e-10, True)
                  .float()).abs().max()) > 10 * TOL[dtype]    # dropout really ran
    fq = LY._lastq_weights(params, dtype)
    yq = LY._lastq_fwd_cuda(xp, mp, fq, 9, 2, "swish", 1e-10, _drop())
    rq = LY._lastq_fwd_plain(xp, mp, fq, 9, 2, "swish", 1e-10, _drop())
    assert float((yq.float() - rq.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal,act", [(True, "swish"), (False, "gelu"), (True, "relu")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_bwd_matches_plain(cuda, dtype, causal, act, p):
    x, madd, params = _layer_case(cuda, dtype, B=40, seed=5)
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    flat = LY._layer_weights(params, dtype)
    dy = torch.randn(xp.shape, device=cuda).to(dtype)
    args = (2, act, 1e-10, causal, _drop(p))
    before = LY.layer_bwd.launches
    dx, grads = LY.layer_bwd(xp, mp, flat, dy, *args)
    assert LY.layer_bwd.launches == before + 1
    rdx, rgrads = LY._layer_bwd_plain(xp, mp, flat, dy, *args)
    assert _rel_err(dx, rdx) <= BWD_TOL[dtype]
    for g, r, w in zip(grads, rgrads, flat):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel_err(g, r) <= BWD_TOL[dtype]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lastq_bwd_matches_plain(cuda, dtype, p):
    x, madd, params = _layer_case(cuda, dtype, B=40, seed=6)
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    flat = LY._lastq_weights(params, dtype)
    dy = torch.randn(xp.shape[0], xp.shape[2], device=cuda).to(dtype)
    args = (9, 2, "swish", 1e-10, _drop(p))
    before = LY.lastq_bwd.launches
    dx, grads = LY.lastq_bwd(xp, mp, flat, dy, *args)
    assert LY.lastq_bwd.launches == before + 1
    rdx, rgrads = LY._lastq_bwd_plain(xp, mp, flat, dy, *args)
    assert _rel_err(dx, rdx) <= BWD_TOL[dtype]
    for g, r in zip(grads, rgrads):
        assert _rel_err(g, r) <= BWD_TOL[dtype]


def test_backward_gates_match_the_kernels(cuda):
    lb = _build.library("layer_bwd")
    qb = _build.library("lastq_bwd")
    lb.unirec_layer_bwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    qb.unirec_lastq_bwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lb.unirec_layer_bwd_slab_floats.argtypes = [ctypes.c_int] * 2
    qb.unirec_lastq_bwd_slab_floats.argtypes = [ctypes.c_int] * 2
    for Lp, D, F, nh in ((56, 64, 128, 2), (16, 32, 64, 2)):
        assert lb.unirec_layer_bwd_smem_bytes(Lp, D, F, nh) == LY._layer_bwd_smem_bytes(Lp, D, F, nh)
        assert qb.unirec_lastq_bwd_smem_bytes(Lp, D, F, nh) == LY._lastq_bwd_smem_bytes(Lp, D, F, nh)
        x, madd, params = _layer_case(cuda, torch.float32, D=D, F=F)
        assert lb.unirec_layer_bwd_slab_floats(D, F) == sum(
            t.numel() for t in LY._layer_weights(params, torch.float32))
        assert qb.unirec_lastq_bwd_slab_floats(D, F) == sum(
            t.numel() for t in LY._lastq_weights(params, torch.float32))


def _layer_bwd_path_case(dev, B, seed, causal=True, act="swish", p=0.1, dtype=torch.bfloat16):
    """The training path's layer (L=50 -> Lp=56, D=64, 2 heads, F=128) on B
    examples, with dy on every real row, as the layer backward is called."""
    x, madd, params = _layer_case(dev, dtype, B=B, L=50, D=64, F=128, seed=seed)
    xp, mp, _ = LY._pad_L(x, madd, 50)
    flat = LY._layer_weights(params, dtype)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = LY._pad_L(torch.randn(x.shape, generator=g, device=dev).to(dtype), madd, 50)[0]
    return xp, mp, flat, dy, (2, act, 1e-10, causal, _drop(p))


def _hold_layer_bwd(got, ref, D=64):
    """Every output within BWD_TOL of its own largest value; the key bias's
    gradient, zero in exact arithmetic, against the query bias's scale."""
    (dx, grads), (rdx, rgrads) = got, ref
    assert _rel_err(dx, rdx) <= BWD_TOL[torch.bfloat16]
    for gr, r in zip(grads, rgrads):
        assert _rel_err(gr, r) <= BWD_TOL[torch.bfloat16]
    dbk, rdbq = grads[1][D:2 * D].float(), rgrads[1][:D].float()
    assert float(dbk.abs().max()) <= BWD_TOL[torch.bfloat16] * float(rdbq.abs().max())


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("act", LY.SUPPORTED_ACTS)
def test_layer_bwd_tensor_core_body_matches_plain(cuda, act, causal, p):
    """Row 2's bf16 tensor-core body at the path's widths (B=33: a ragged
    persistent grid), every activation, both masks, dropout 0 and 0.1."""
    xp, mp, flat, dy, args = _layer_bwd_path_case(cuda, 33, 20, causal, act, p)
    assert LY._layer_bwd_body(torch.bfloat16, 56, 64, 128, 2) == "mma"
    before = LY.layer_bwd.launches, LY.layer_bwd.launches_mma
    got = LY.layer_bwd(xp, mp, flat, dy, *args)
    assert (LY.layer_bwd.launches, LY.layer_bwd.launches_mma) == (before[0] + 1, before[1] + 1)
    _hold_layer_bwd(got, LY._layer_bwd_plain(xp, mp, flat, dy, *args))


@pytest.mark.parametrize("B", [1, 32767])
def test_layer_bwd_tensor_core_body_ragged_batches(cuda, B):
    xp, mp, flat, dy, args = _layer_bwd_path_case(cuda, B, 21)
    got = LY._layer_bwd_cuda(xp, mp, flat, dy, *args)
    _hold_layer_bwd(got, LY._layer_bwd_plain(xp, mp, flat, dy, *args))


def test_layer_bwd_tensor_core_masks_are_the_forwards(cuda):
    """The same seed gives the plain version's (and so row 1's forward's)
    masks: another seed moves the gradients far outside the tolerance."""
    xp, mp, flat, dy, args = _layer_bwd_path_case(cuda, 33, 22)
    dx, _ = LY._layer_bwd_cuda(xp, mp, flat, dy, *args)
    rdx, _ = LY._layer_bwd_plain(xp, mp, flat, dy, *args[:-1], _drop(0.1, seed=4321))
    assert _rel_err(dx, rdx) > 4 * BWD_TOL[torch.bfloat16]


def test_layer_bwd_f32_keeps_the_cuda_core_body(cuda):
    xp, mp, flat, dy, args = _layer_bwd_path_case(cuda, 9, 23, dtype=torch.float32)
    assert LY._layer_bwd_body(torch.float32, 56, 64, 128, 2) == "cuda"
    before = LY.layer_bwd.launches, LY.layer_bwd.launches_mma
    dx, grads = LY.layer_bwd(xp, mp, flat, dy, *args)
    assert (LY.layer_bwd.launches, LY.layer_bwd.launches_mma) == (before[0] + 1, before[1])
    rdx, rgrads = LY._layer_bwd_plain(xp, mp, flat, dy, *args)
    for a, r in zip((dx, *grads), (rdx, *rgrads)):
        assert _rel_err(a, r) <= BWD_TOL[torch.float32]


@pytest.mark.parametrize("Lp,D,F,nh", [(56, 64, 128, 2), (32, 64, 128, 4), (64, 32, 64, 2),
                                       (16, 32, 64, 2),
                                       (72, 64, 128, 2), (56, 64, 144, 2), (56, 48, 96, 3),
                                       (56, 64, 128, 8), (56, 80, 128, 2), (8, 16, 16, 1)])
def test_layer_bwd_body_selector(cuda, Lp, D, F, nh):
    """csrc/layer_bwd.cu's rule and shared memory against ops/layer.py's
    copies; where the tensor cores take a shape, the body agrees with the
    plain backward and moves its counter."""
    lib = _build.library("layer_bwd")
    takes, smem = lib.unirec_layer_bwd_mma_takes, lib.unirec_layer_bwd_mma_smem_bytes
    takes.argtypes, smem.argtypes = [ctypes.c_int] * 5, [ctypes.c_int] * 3
    body = LY._layer_bwd_body(torch.bfloat16, Lp, D, F, nh)
    assert bool(takes(1, Lp, D, F, nh)) == (body == "mma") and not takes(0, Lp, D, F, nh)
    assert smem(D, F, nh) == LY._layer_bwd_mma_smem_bytes(D, F, nh)
    if body != "mma":
        return
    x, madd, params = _layer_case(cuda, torch.bfloat16, B=17, L=Lp - 3, D=D, F=F, seed=24)
    xp, mp, _ = LY._pad_L(x, madd, Lp - 3)
    flat = LY._layer_weights(params, torch.bfloat16)
    dy = torch.randn(xp.shape, device=cuda).to(torch.bfloat16)
    args = (nh, "gelu", 1e-10, True, _drop(0.1))
    before = LY.layer_bwd.launches_mma
    dx, grads = LY._layer_bwd_cuda(xp, mp, flat, dy, *args)
    assert LY.layer_bwd.launches_mma == before + 1
    rdx, rgrads = LY._layer_bwd_plain(xp, mp, flat, dy, *args)
    for a, b in zip((dx, *grads), (rdx, *rgrads)):
        assert _rel_err(a, b) <= BWD_TOL[torch.bfloat16]


# ------------------------------------ rows 1 and 4 on the tensor cores
def _ln_tol(ref):
    """bf16 LayerNorm outputs: 3e-2, or two bf16 ulps of the largest output
    where that is more (an output in [4, 8) has ulp 2^-5 > 3e-2), since one
    rounding that flips moves an output by one ulp."""
    return max(TOL[torch.bfloat16], 2.0 ** -6 * float(ref.float().abs().max()))


def _layer_fwd_path_case(dev, B, seed, causal=True, act="swish", p=0.1, dtype=torch.bfloat16):
    """The paths' whole layer (L=50 -> Lp=56, D=64, 2 heads, F=128) on B
    examples, as fused_transformer_layer calls its forward."""
    x, madd, params = _layer_case(dev, dtype, B=B, L=50, D=64, F=128, seed=seed)
    xp, mp, _ = LY._pad_L(x, madd, 50)
    return xp, mp, LY._layer_weights(params, dtype), (2, act, 1e-10, causal, _drop(p))


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("act", ["swish", "gelu"])
def test_layer_fwd_tensor_core_body_matches_plain(cuda, act, causal, p):
    """Row 1's bf16 tensor-core forward at the paths' widths (B=33: the last
    block's second group idle), both activations of the paths, both masks,
    dropout 0 and 0.1."""
    xp, mp, flat, args = _layer_fwd_path_case(cuda, 33, 30, causal, act, p)
    assert LY._layer_fwd_body(torch.bfloat16, 56, 64, 128, 2) == "mma"
    before = LY.fused_transformer_layer.launches, LY.fused_transformer_layer.launches_mma
    y = LY._layer_fwd_cuda(xp, mp, flat, *args)
    assert (LY.fused_transformer_layer.launches,
            LY.fused_transformer_layer.launches_mma) == (before[0] + 1, before[1] + 1)
    ref = LY._layer_fwd_plain(xp, mp, flat, *args)
    assert torch.isfinite(y).all()
    assert float((y.float() - ref.float()).abs().max()) <= _ln_tol(ref)


@pytest.mark.parametrize("B,p", [(1, 0.1), (37, 0.1), (1000, 0.1), (256, 0.0)])
def test_layer_fwd_tensor_core_ragged_and_serving_batches(cuda, B, p):
    """Batches that fill no grid evenly, and the serving call (B=256, eval:
    no dropout), on the tensor-core forward."""
    xp, mp, flat, args = _layer_fwd_path_case(cuda, B, 31, p=p)
    if p == 0.0:
        args = args[:-1] + (LY.drop_params(0.1, 0.1, False, None),)
    before = LY.fused_transformer_layer.launches_mma
    y = LY._layer_fwd_cuda(xp, mp, flat, *args)
    assert LY.fused_transformer_layer.launches_mma == before + 1
    ref = LY._layer_fwd_plain(xp, mp, flat, *args)
    assert float((y.float() - ref.float()).abs().max()) <= _ln_tol(ref)


def test_layer_fwd_f32_keeps_the_cuda_core_body(cuda):
    xp, mp, flat, args = _layer_fwd_path_case(cuda, 9, 32, dtype=torch.float32)
    assert LY._layer_fwd_body(torch.float32, 56, 64, 128, 2) == "cuda"
    before = LY.fused_transformer_layer.launches, LY.fused_transformer_layer.launches_mma
    y = LY._layer_fwd_cuda(xp, mp, flat, *args)
    assert (LY.fused_transformer_layer.launches,
            LY.fused_transformer_layer.launches_mma) == (before[0] + 1, before[1])
    ref = LY._layer_fwd_plain(xp, mp, flat, *args)
    assert float((y - ref).abs().max()) <= TOL[torch.float32]


@pytest.mark.parametrize("Lp,D,F,nh", [(56, 64, 128, 2), (32, 64, 128, 4), (64, 32, 64, 2),
                                       (16, 32, 64, 2), (72, 64, 128, 2), (56, 64, 256, 2),
                                       (56, 64, 272, 2), (56, 48, 96, 3), (56, 64, 128, 8),
                                       (56, 80, 128, 2), (8, 16, 16, 1)])
def test_layer_fwd_body_selector(cuda, Lp, D, F, nh):
    """csrc/layer_fwd.cu's rule and shared memory against ops/layer.py's
    copies; where the tensor cores take a shape, the body agrees with the
    plain forward and moves its counter."""
    lib = _build.library("layer_fwd")
    takes, smem = lib.unirec_layer_fwd_mma_takes, lib.unirec_layer_fwd_mma_smem_bytes
    takes.argtypes, smem.argtypes = [ctypes.c_int] * 5, [ctypes.c_int] * 2
    body = LY._layer_fwd_body(torch.bfloat16, Lp, D, F, nh)
    assert bool(takes(1, Lp, D, F, nh)) == (body == "mma") and not takes(0, Lp, D, F, nh)
    assert smem(D, F) == LY._layer_fwd_mma_smem_bytes(D, F)
    if body != "mma":
        return
    x, madd, params = _layer_case(cuda, torch.bfloat16, B=17, L=Lp - 3, D=D, F=F, seed=33)
    xp, mp, _ = LY._pad_L(x, madd, Lp - 3)
    flat = LY._layer_weights(params, torch.bfloat16)
    args = (nh, "gelu", 1e-10, True, _drop(0.1))
    before = LY.fused_transformer_layer.launches_mma
    y = LY._layer_fwd_cuda(xp, mp, flat, *args)
    assert LY.fused_transformer_layer.launches_mma == before + 1
    ref = LY._layer_fwd_plain(xp, mp, flat, *args)
    assert float((y.float() - ref.float()).abs().max()) <= _ln_tol(ref)


def _lastq_bwd_path_case(dev, B, seed, act="swish", p=0.1, qi=49, dtype=torch.bfloat16):
    """The paths' last-query layer (L=50 -> Lp=56, D=64, 2 heads, F=128) on
    B examples, query row qi, as its backward is called."""
    x, madd, params = _layer_case(dev, dtype, B=B, L=50, D=64, F=128, seed=seed)
    xp, mp, _ = LY._pad_L(x, madd, 50)
    flat = LY._lastq_weights(params, dtype)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn(B, 64, generator=g, device=dev).to(dtype)
    return xp, mp, flat, dy, (qi, 2, act, 1e-10, _drop(p))


def _hold_lastq_bwd(got, ref):
    """Every output within BWD_TOL of its own largest value; the key bias's
    gradient (flat leaf 3), zero in exact arithmetic, against the query
    bias's scale (leaf 1)."""
    (dx, grads), (rdx, rgrads) = got, ref
    assert torch.isfinite(dx).all()
    assert _rel_err(dx, rdx) <= BWD_TOL[torch.bfloat16]
    for i, (gr, r) in enumerate(zip(grads, rgrads)):
        if i == 3:
            err = float((gr.float() - r.float()).abs().max())
            assert err <= BWD_TOL[torch.bfloat16] * float(rgrads[1].float().abs().max())
        else:
            assert _rel_err(gr, r) <= BWD_TOL[torch.bfloat16]


@pytest.mark.parametrize("qi", [49, 20])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("act", ["swish", "gelu"])
def test_lastq_bwd_tensor_core_body_matches_plain(cuda, act, p, qi):
    """Row 4's bf16 tensor-core backward at the paths' widths (B=33: a
    ragged persistent grid and a partial group of 16), both activations of
    the paths, dropout 0 and 0.1, the query at the last real row and inside
    another strip."""
    xp, mp, flat, dy, args = _lastq_bwd_path_case(cuda, 33, 40, act, p, qi)
    assert LY._lastq_bwd_body(torch.bfloat16, 56, 64, 128, 2) == "mma"
    before = LY.lastq_bwd.launches, LY.lastq_bwd.launches_mma
    got = LY.lastq_bwd(xp, mp, flat, dy, *args)
    assert (LY.lastq_bwd.launches, LY.lastq_bwd.launches_mma) == (before[0] + 1, before[1] + 1)
    _hold_lastq_bwd(got, LY._lastq_bwd_plain(xp, mp, flat, dy, *args))


@pytest.mark.parametrize("B", [1, 37, 1000])
def test_lastq_bwd_tensor_core_body_ragged_batches(cuda, B):
    xp, mp, flat, dy, args = _lastq_bwd_path_case(cuda, B, 41)
    got = LY._lastq_bwd_cuda(xp, mp, flat, dy, *args)
    _hold_lastq_bwd(got, LY._lastq_bwd_plain(xp, mp, flat, dy, *args))


def test_lastq_bwd_tensor_core_masks_are_the_forwards(cuda):
    """The same seed gives the plain version's (and so row 3's forward's)
    masks: another seed moves the gradients far outside the tolerance."""
    xp, mp, flat, dy, args = _lastq_bwd_path_case(cuda, 33, 42)
    dx, _ = LY._lastq_bwd_cuda(xp, mp, flat, dy, *args)
    rdx, _ = LY._lastq_bwd_plain(xp, mp, flat, dy, *args[:-1], _drop(0.1, seed=4321))
    assert _rel_err(dx, rdx) > 4 * BWD_TOL[torch.bfloat16]


def test_lastq_bwd_f32_keeps_the_cuda_core_body(cuda):
    xp, mp, flat, dy, args = _lastq_bwd_path_case(cuda, 9, 43, dtype=torch.float32)
    assert LY._lastq_bwd_body(torch.float32, 56, 64, 128, 2) == "cuda"
    before = LY.lastq_bwd.launches, LY.lastq_bwd.launches_mma
    dx, grads = LY.lastq_bwd(xp, mp, flat, dy, *args)
    assert (LY.lastq_bwd.launches, LY.lastq_bwd.launches_mma) == (before[0] + 1, before[1])
    rdx, rgrads = LY._lastq_bwd_plain(xp, mp, flat, dy, *args)
    for a, r in zip((dx, *grads), (rdx, *rgrads)):
        assert _rel_err(a, r) <= BWD_TOL[torch.float32]


@pytest.mark.parametrize("Lp,D,F,nh", [(56, 64, 128, 2), (32, 64, 128, 4), (64, 32, 64, 2),
                                       (16, 32, 64, 2), (72, 64, 128, 2), (56, 64, 256, 2),
                                       (56, 48, 96, 3), (56, 64, 128, 8), (56, 80, 128, 2),
                                       (8, 16, 16, 1)])
def test_lastq_bwd_body_selector(cuda, Lp, D, F, nh):
    """csrc/lastq_bwd.cu's rule and shared memory against ops/layer.py's
    copies; where the tensor cores take a shape, the body agrees with the
    plain backward and moves its counter."""
    lib = _build.library("lastq_bwd")
    takes, smem = lib.unirec_lastq_bwd_mma_takes, lib.unirec_lastq_bwd_mma_smem_bytes
    takes.argtypes, smem.argtypes = [ctypes.c_int] * 5, [ctypes.c_int] * 3
    body = LY._lastq_bwd_body(torch.bfloat16, Lp, D, F, nh)
    assert bool(takes(1, Lp, D, F, nh)) == (body == "mma") and not takes(0, Lp, D, F, nh)
    assert smem(D, F, nh) == LY._lastq_bwd_mma_smem_bytes(D, F, nh)
    if body != "mma":
        return
    x, madd, params = _layer_case(cuda, torch.bfloat16, B=17, L=Lp - 3, D=D, F=F, seed=44)
    xp, mp, _ = LY._pad_L(x, madd, Lp - 3)
    flat = LY._lastq_weights(params, torch.bfloat16)
    dy = torch.randn(17, D, device=cuda).to(torch.bfloat16)
    args = (Lp - 4, nh, "gelu", 1e-10, _drop(0.1))
    before = LY.lastq_bwd.launches_mma
    dx, grads = LY._lastq_bwd_cuda(xp, mp, flat, dy, *args)
    assert LY.lastq_bwd.launches_mma == before + 1
    rdx, rgrads = LY._lastq_bwd_plain(xp, mp, flat, dy, *args)
    for a, b in zip((dx, *grads), (rdx, *rgrads)):
        assert _rel_err(a, b) <= BWD_TOL[torch.bfloat16]


# ------------------------------------ row 3 on the tensor cores
def _lastq_fwd_path_case(dev, B, seed, act="swish", p=0.1, qi=49, dtype=torch.bfloat16):
    """The paths' last-query layer (L=50 -> Lp=56, D=64, 2 heads, F=128) on
    B examples, query row qi, as fused_last_query_layer calls its forward."""
    x, madd, params = _layer_case(dev, dtype, B=B, L=50, D=64, F=128, seed=seed)
    xp, mp, _ = LY._pad_L(x, madd, 50)
    return xp, mp, LY._lastq_weights(params, dtype), (qi, 2, act, 1e-10, _drop(p))


@pytest.mark.parametrize("qi", [49, 20])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("act", ["swish", "gelu"])
def test_lastq_fwd_tensor_core_body_matches_plain(cuda, act, p, qi):
    """Row 3's bf16 tensor-core forward at the paths' widths (B=33: a ragged
    persistent grid and partial groups of 16), both activations of the
    paths, dropout 0 and 0.1, the query at the last real row and inside
    another strip."""
    xp, mp, flat, args = _lastq_fwd_path_case(cuda, 33, 60, act, p, qi)
    assert LY._lastq_fwd_body(torch.bfloat16, 56, 64, 128, 2) == "mma"
    before = LY.fused_last_query_layer.launches, LY.fused_last_query_layer.launches_mma
    y = LY._lastq_fwd_cuda(xp, mp, flat, *args)
    assert (LY.fused_last_query_layer.launches,
            LY.fused_last_query_layer.launches_mma) == (before[0] + 1, before[1] + 1)
    ref = LY._lastq_fwd_plain(xp, mp, flat, *args)
    assert y.shape == (33, 64) and torch.isfinite(y).all()
    assert float((y.float() - ref.float()).abs().max()) <= _ln_tol(ref)


@pytest.mark.parametrize("B,p", [(1, 0.1), (37, 0.1), (1000, 0.1), (256, 0.0)])
def test_lastq_fwd_tensor_core_ragged_and_serving_batches(cuda, B, p):
    """Batches that fill no grid or group of 16 evenly, and the serving
    call (B=256, eval: no dropout), on the tensor-core forward."""
    xp, mp, flat, args = _lastq_fwd_path_case(cuda, B, 61, p=p)
    if p == 0.0:
        args = args[:-1] + (LY.drop_params(0.1, 0.1, False, None),)
    before = LY.fused_last_query_layer.launches_mma
    y = LY._lastq_fwd_cuda(xp, mp, flat, *args)
    assert LY.fused_last_query_layer.launches_mma == before + 1
    ref = LY._lastq_fwd_plain(xp, mp, flat, *args)
    assert float((y.float() - ref.float()).abs().max()) <= _ln_tol(ref)


def test_lastq_fwd_tensor_core_masks_are_the_backwards(cuda):
    """Through autograd with dropout 0.1 (train mode, a seed), the tensor-core
    forward and the tensor-core backward, which replays its masks from the
    seed, against the plain forward and backward: the output and every
    gradient agree, and another seed's plain output does not."""
    from unittest import mock
    x, madd, params = _layer_case(cuda, torch.bfloat16, B=35, L=50, D=64, F=128, seed=62)
    kw = dict(n_heads=2, inner_size=128, hidden_act="swish", layer_norm_eps=1e-10,
              q_index=49, p_attn=0.1, p_hidden=0.1, train=True)
    dy = torch.randn(35, 64, generator=torch.Generator(device=cuda).manual_seed(63),
                     device=cuda)

    def run(seed):
        xg = x.detach().requires_grad_()
        pg = tuple(tuple(t.detach().requires_grad_() for t in pair) for pair in params)
        y = LY.fused_last_query_layer(xg, madd, pg, seed=seed, **kw)
        (y.float() * dy).sum().backward()
        return y.detach(), [xg.grad] + [t.grad for pair in pg for t in pair]

    before = LY.fused_last_query_layer.launches_mma, LY.lastq_bwd.launches_mma
    y, grads = run(5)
    assert (LY.fused_last_query_layer.launches_mma, LY.lastq_bwd.launches_mma) == (
        before[0] + 1, before[1] + 1)
    with mock.patch.object(LY, "_lastq_fwd_cuda", LY._lastq_fwd_plain), \
            mock.patch.object(LY, "_lastq_bwd_cuda", LY._lastq_bwd_plain):
        ry, rgrads = run(5)
        other, _ = run(6)
    assert float((y.float() - ry.float()).abs().max()) <= _ln_tol(ry)
    assert float((y.float() - other.float()).abs().max()) > 4 * _ln_tol(ry)
    for i, (g, r) in enumerate(zip(grads, rgrads)):
        if i == 4:   # the key bias: zero in exact arithmetic, held to the query bias's scale
            err = float((g.float() - r.float()).abs().max())
            assert err <= BWD_TOL[torch.bfloat16] * float(rgrads[2].float().abs().max())
        else:
            assert _rel_err(g, r) <= BWD_TOL[torch.bfloat16]


def test_lastq_fwd_f32_keeps_the_cuda_core_body(cuda):
    xp, mp, flat, args = _lastq_fwd_path_case(cuda, 9, 64, dtype=torch.float32)
    assert LY._lastq_fwd_body(torch.float32, 56, 64, 128, 2) == "cuda"
    before = LY.fused_last_query_layer.launches, LY.fused_last_query_layer.launches_mma
    y = LY._lastq_fwd_cuda(xp, mp, flat, *args)
    assert (LY.fused_last_query_layer.launches,
            LY.fused_last_query_layer.launches_mma) == (before[0] + 1, before[1])
    ref = LY._lastq_fwd_plain(xp, mp, flat, *args)
    assert float((y - ref).abs().max()) <= TOL[torch.float32]


@pytest.mark.parametrize("Lp,D,F,nh", [(56, 64, 128, 2), (32, 64, 128, 4), (64, 32, 64, 2),
                                       (16, 32, 64, 2), (72, 64, 128, 2), (56, 64, 384, 2),
                                       (56, 64, 400, 2), (56, 48, 96, 3), (56, 64, 128, 8),
                                       (56, 80, 128, 2), (8, 16, 16, 1)])
def test_lastq_fwd_body_selector(cuda, Lp, D, F, nh):
    """csrc/lastq_fwd.cu's rule and shared memory against ops/layer.py's
    copies; where the tensor cores take a shape, the body agrees with the
    plain forward and moves its counter."""
    lib = _build.library("lastq_fwd")
    takes, smem = lib.unirec_lastq_fwd_mma_takes, lib.unirec_lastq_fwd_mma_smem_bytes
    takes.argtypes, smem.argtypes = [ctypes.c_int] * 5, [ctypes.c_int] * 3
    body = LY._lastq_fwd_body(torch.bfloat16, Lp, D, F, nh)
    assert bool(takes(1, Lp, D, F, nh)) == (body == "mma") and not takes(0, Lp, D, F, nh)
    assert smem(D, F, nh) == LY._lastq_fwd_mma_smem_bytes(D, F, nh)
    if body != "mma":
        return
    x, madd, params = _layer_case(cuda, torch.bfloat16, B=17, L=Lp - 3, D=D, F=F, seed=65)
    xp, mp, _ = LY._pad_L(x, madd, Lp - 3)
    flat = LY._lastq_weights(params, torch.bfloat16)
    args = (Lp - 4, nh, "gelu", 1e-10, _drop(0.1))
    before = LY.fused_last_query_layer.launches_mma
    y = LY._lastq_fwd_cuda(xp, mp, flat, *args)
    assert LY.fused_last_query_layer.launches_mma == before + 1
    ref = LY._lastq_fwd_plain(xp, mp, flat, *args)
    assert float((y.float() - ref.float()).abs().max()) <= _ln_tol(ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_matches_plain_and_index_add(cuda, dtype):
    from unirec_tpu_torch.ops import scatter_accum as SA
    g = torch.Generator(device=cuda).manual_seed(7)
    ids = torch.randint(0, 1003, (20011,), generator=g, device=cuda)
    rows = torch.randn(20011, 64, generator=g, device=cuda).to(dtype)
    before = SA.scatter_add_rows.launches
    out = SA.scatter_add_rows(ids, rows, 1003)
    out2 = SA.scatter_add_rows2(ids, rows, 1004)
    assert SA.scatter_add_rows.launches == before + 2
    ref = SA._scatter_plain(ids, rows, 1003)
    lib = torch.zeros(1003, 64, device=cuda).index_add_(0, ids, rows.float()).to(dtype)
    # f32 atomics in another order: 1e-4 abs on sums of ~20 unit rows in
    # f32; one bf16 rounding (3.9e-3 relative) in bf16
    tol = 1e-4 if dtype == torch.float32 else 8e-3 * float(ref.float().abs().max())
    assert out.dtype == dtype and out.shape == (1003, 64)
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float((out.float() - lib.float()).abs().max()) <= tol
    assert float((out2[:1003].float() - ref.float()).abs().max()) <= tol
    assert float(out2[1003].abs().max()) == 0.0


# ------------------------------------ row 6: the sorted-tile body
def _scatter_ids(kind, M, N, dev, seed=70):
    """Ids of M gradient rows into N: all one id, 80% padding (id 0) as the
    windows' left padding sends, Zipf-skewed over the catalog, or a quarter
    outside [0, N)."""
    rng = np.random.default_rng(seed)
    if kind == "equal":
        ids = np.full(M, 17)
    elif kind == "zero80":
        ids = np.where(rng.random(M) < 0.8, 0, rng.integers(1, N, M))
    elif kind == "zipf":
        ids = (rng.zipf(1.3, M) - 1) % N
    else:
        ids = np.where(rng.random(M) < 0.25, rng.choice([-5, N, N + 100], M),
                       rng.integers(0, N, M))
    return torch.from_numpy(ids.astype(np.int64)).to(dev)


def _scatter_close(out, ids, rows, N):
    """Element by element: the f32 sums in another order (1e-4, plus 2e-5 of
    the sum of the magnitudes added there), and in bf16 one rounding of the
    sum (2^-7 of it)."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    ref = SA._scatter_plain(ids, rows, N).float()
    mag = SA._scatter_plain(ids, rows.float().abs(), N).float()
    tol = 1e-4 + 2e-5 * mag + (2.0 ** -7 * ref.abs() if rows.dtype == torch.bfloat16 else 0.0)
    assert out.shape == ref.shape
    assert bool(((out.float() - ref).abs() <= tol).all()), float((out.float() - ref).abs().max())


@pytest.mark.parametrize("M", [20011, 1])
@pytest.mark.parametrize("kind", ["equal", "zero80", "zipf", "out_of_range"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_sorted_body_combines_hot_ids(cuda, dtype, kind, M):
    """Row 6's sorted-tile body on ids that pile onto few rows (what the
    per-row body serialises on), and on ids the sum must skip; a ragged last
    tile; scatter_add_rows2 through the same kernel."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    N = 1003
    ids = _scatter_ids(kind, M, N, cuda)
    rows = torch.randn(M, 64, generator=torch.Generator(device=cuda).manual_seed(71),
                       device=cuda).to(dtype)
    assert SA._scatter_body(dtype, 64, N) == "sorted"
    before = SA.scatter_add_rows.launches, SA.scatter_add_rows.launches_sorted
    out = SA.scatter_add_rows(ids, rows, N)
    out2 = SA.scatter_add_rows2(ids, rows, N + 1)
    assert (SA.scatter_add_rows.launches, SA.scatter_add_rows.launches_sorted) == (
        before[0] + 2, before[1] + 2)
    assert out.dtype == dtype
    _scatter_close(out, ids, rows, N)
    _scatter_close(out2[:N], ids, rows, N)
    if kind != "out_of_range":
        assert float(out2[N].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 18), (torch.float32, 30)])
def test_scatter_add_per_row_body_takes_other_widths(cuda, dtype, D):
    """A row width the sorted body does not take (not whole 4-column chunks)
    runs the per-row body."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    ids = _scatter_ids("zero80", 5001, 300, cuda)
    rows = torch.randn(5001, D, device=cuda).to(dtype)
    assert SA._scatter_body(dtype, D, 300) == "per_row"
    before = SA.scatter_add_rows.launches, SA.scatter_add_rows.launches_sorted
    out = SA.scatter_add_rows(ids, rows, 300)
    assert (SA.scatter_add_rows.launches, SA.scatter_add_rows.launches_sorted) == (
        before[0] + 1, before[1])
    _scatter_close(out, ids, rows, 300)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 8), (torch.bfloat16, 72),
                                     (torch.float32, 36), (torch.float32, 2048)])
def test_scatter_add_sorted_body_takes_any_whole_chunk_width(cuda, dtype, D):
    """The sorted body's walkers at widths other than the paths' 64: fewer
    chunks than lanes (some lanes idle) and more (a lane walks its span once
    a chunk), on hot ids."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    ids = _scatter_ids("zero80", 5001, 300, cuda)
    rows = torch.randn(5001, D, device=cuda).to(dtype)
    assert SA._scatter_body(dtype, D, 300) == "sorted"
    before = SA.scatter_add_rows.launches_sorted
    out = SA.scatter_add_rows(ids, rows, 300)
    assert SA.scatter_add_rows.launches_sorted == before + 1
    _scatter_close(out, ids, rows, 300)


@pytest.mark.parametrize("dtype,D,N", [(1, 64, 50000), (0, 64, 50000), (1, 8, 10), (1, 48, 10),
                                       (1, 512, 10), (0, 1024, 10), (0, 2048, 10),
                                       (1, 72, 10), (0, 36, 10), (1, 18, 10),
                                       (1, 64, 2 ** 21 - 1), (1, 64, 2 ** 21), (0, 4, 10)])
def test_scatter_add_body_selector(cuda, dtype, D, N):
    """csrc/scatter_add.cu's rule against ops/scatter_accum.py's copy."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    takes = _build.library("scatter_add").unirec_scatter_add_sorted_takes
    takes.argtypes = [ctypes.c_int] * 3
    tdt = (torch.float32, torch.bfloat16)[dtype]
    assert bool(takes(dtype, D, N)) == (SA._scatter_body(tdt, D, N) == "sorted")


def test_member_matches_plain(cuda):
    from unirec_tpu_torch.ops import member as MB
    g = torch.Generator(device=cuda).manual_seed(8)
    rows = torch.randint(0, 60, (1001, 200), generator=g, device=cuda, dtype=torch.int32)
    cand = torch.randint(0, 70, (1001, 36), generator=g, device=cuda, dtype=torch.int32)
    before = MB.member_mask.launches
    out = MB.member_mask(rows, cand)
    assert MB.member_mask.launches == before + 1
    assert torch.equal(out, MB._member_plain(rows, cand))


def test_augmenter_membership_launches_the_kernel_at_an_odd_batch(cuda):
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter
    from unirec_tpu_torch.data.history import UserHistory
    from unirec_tpu_torch.ops import member as MB
    rng = np.random.default_rng(3)
    items = rng.integers(1, 90, (1001, 40)).astype(np.int32)
    cfg = dict(n_items=100, n_sample_neg_train=9, neg_oversample_factor=4,
               max_seq_len=8, dataloader="SeqRecDataset", neg_membership_pallas=1)
    aug = DeviceAugmenter(cfg, UserHistory(items, np.full(1001, 40, np.int32)),
                          device=cuda)
    rows = torch.from_numpy(items).to(cuda)
    before = MB.member_mask.launches
    negs = aug.sample_negatives(torch.Generator(device=cuda).manual_seed(0), rows,
                                torch.ones(1001, 1, dtype=torch.int32, device=cuda))
    assert MB.member_mask.launches == before + 1
    hit = (negs[:, :, None] == rows[:, None, :]).any(-1) & (negs > 0)
    assert negs.shape == (1001, 9) and not bool(hit.any())


def test_training_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from unirec_tpu_torch.ops import member as MB
    from unirec_tpu_torch.ops import scatter_accum as SA
    x, madd, params = _layer_case(cuda, torch.float16)
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    flat = LY._layer_weights(params, torch.float16)
    with pytest.raises(TypeError):
        LY.layer_bwd(xp, mp, flat, torch.zeros_like(xp), 2, "swish", 1e-10, True)
    with pytest.raises(TypeError):
        LY.lastq_bwd(xp, mp, LY._lastq_weights(params, torch.float16),
                     torch.zeros_like(xp[:, 0]), 9, 2, "swish", 1e-10)
    with pytest.raises(TypeError):
        SA.scatter_add_rows(torch.zeros(4, dtype=torch.long, device=cuda),
                            torch.zeros(4, 8, dtype=torch.float16, device=cuda), 10)
    with pytest.raises(TypeError):
        MB.member_mask(torch.zeros(4, 8, device=cuda), torch.zeros(4, 3, device=cuda))
    with pytest.raises(ValueError):
        MB.member_mask(torch.zeros(4, 8000, dtype=torch.int32, device=cuda),
                       torch.zeros(4, 3, dtype=torch.int32, device=cuda))


# ------------------------------------------------ fused attention and FFN
# Forward and backward against the plain versions on the same CUDA tensors:
# f32 1e-5 of the largest output (summation order only); bf16 2^-6 of it
# (two bf16 ulps: the two round at the same points, a sum's order can flip
# one rounding). With dropout the masks are the same bits.
ATT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _att_case(dev, dtype, B=6, H=2, L=10, hd=32, mask_heads=1, seed=0):
    from unirec_tpu_torch.models.modules import causal_attention_mask
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, hd, generator=g, device=dev).to(dtype)
               for _ in range(3))
    masks = []
    for _ in range(mask_heads):
        seq = torch.randint(0, 3, (B, L), generator=g, device=dev)
        seq[:, -2:] = 1
        seq[0] = 0                                  # every key masked
        masks.append(causal_attention_mask(seq))
    return q, k, v, torch.cat(masks, dim=1)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


def _masked_ok(a, b, tol):
    """Examples 1.. within tol; example 0 of ``_att_case`` has every key
    masked, so its scores sit near -1e4, where f32 keeps steps of 2^-10: a
    product summed in another order can move one of them, and with it a
    probability, by 2^-10 relative, which is its tolerance. (The L <= 50
    cases hold it to tol: there no such step has been seen to flip.)"""
    return _rel(a[1:], b[1:]) <= tol and _rel(a[:1], b[:1]) <= max(tol, 2.0 ** -10)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("mask_heads", [1, 2])
@pytest.mark.parametrize("L", [10, 17, 50, 64])   # bf16: the tensor-core bodies
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_matches_plain(cuda, dtype, L, mask_heads, p):
    from unirec_tpu_torch.ops import attention as AT
    q, k, v, mask = _att_case(cuda, dtype, L=L, mask_heads=mask_heads)
    drop = LY.drop_params(p, 0.0, True, 4321)
    before = AT.fused_attention.launches, AT.fused_attention_bwd.launches
    mma = AT.fused_attention.launches_mma
    out = AT._fwd_cuda(q, k, v, mask, drop)
    assert AT.fused_attention.launches == before[0] + 1
    # bf16 at these lengths: the tensor-core forward
    assert (AT._fwd_body(dtype, L, 32) == "mma") == (dtype == torch.bfloat16)
    assert AT.fused_attention.launches_mma == mma + (dtype == torch.bfloat16)
    assert _rel(out, AT._fwd_plain(q, k, v, mask, drop)) <= ATT_TOL[dtype]
    do = torch.randn_like(q.float()).to(dtype)
    got = AT.fused_attention_bwd(q, k, v, mask, do, drop)
    assert AT.fused_attention_bwd.launches == before[1] + 1
    for a, b in zip(got, AT._bwd_plain(q, k, v, mask, do, drop)):
        assert a.dtype == dtype and a.shape == q.shape
        assert _rel(a, b) <= ATT_TOL[dtype]


@pytest.mark.parametrize("L,hd,body", [(10, 32, "mma"), (50, 32, "mma"), (64, 64, "mma"),
                                        (33, 8, "mma"), (100, 32, "whole"), (50, 72, "whole"),
                                        (300, 32, "tiled")])
def test_fused_attention_backward_body_selector(cuda, L, hd, body):
    """The bf16 backward takes the tensor-core body at L <= 64 and head
    width <= 64, the CUDA-core bodies beyond (f32 always): the selector
    agrees with the C rule, and the per-body counter moves with it."""
    from unirec_tpu_torch.ops import attention as AT
    takes = _build.library("attention").unirec_attention_bwd_mma_takes
    takes.argtypes = [ctypes.c_int] * 3
    assert AT._bwd_body(torch.bfloat16, L, hd) == body
    assert bool(takes(1, L, hd)) == (body == "mma")
    assert AT._bwd_body(torch.float32, L, hd) != "mma" and not takes(0, L, hd)
    q, k, v, mask = _att_case(cuda, torch.bfloat16, B=3, L=L, hd=hd)
    drop = LY.drop_params(0.1, 0.0, True, 4323)
    do = torch.randn_like(q.float()).to(torch.bfloat16)
    before = AT.fused_attention_bwd.launches, AT.fused_attention_bwd.launches_mma
    got = AT.fused_attention_bwd(q, k, v, mask, do, drop)
    assert AT.fused_attention_bwd.launches == before[0] + 1
    assert AT.fused_attention_bwd.launches_mma == before[1] + (body == "mma")
    for a, b in zip(got, AT._bwd_plain(q, k, v, mask, do, drop)):
        assert _masked_ok(a, b, BWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("L,hd,H,mask_heads,body", [
    (10, 32, 2, 1, "mma"), (50, 32, 2, 1, "mma"), (64, 64, 2, 2, "mma"), (33, 8, 3, 1, "mma"),
    (50, 64, 8, 1, "mma"), (64, 48, 5, 5, "mma"), (100, 32, 2, 1, "whole"),
    (50, 72, 2, 1, "whole"), (300, 32, 2, 1, "tiled")])
def test_fused_attention_forward_body_selector(cuda, L, hd, H, mask_heads, body):
    """The bf16 forward takes the tensor-core body by the backward's rule;
    its head groups (all heads of an example where a stage fits, 8 heads at
    head width 64 do not) and per-head masks run through the persistent
    grid; the per-body counter moves with the selector."""
    from unirec_tpu_torch.ops import attention as AT
    takes = _build.library("attention").unirec_attention_bwd_mma_takes
    takes.argtypes = [ctypes.c_int] * 3
    assert AT._fwd_body(torch.bfloat16, L, hd) == body
    assert bool(takes(1, L, hd)) == (body == "mma")
    q, k, v, mask = _att_case(cuda, torch.bfloat16, B=5, H=H, L=L, hd=hd,
                              mask_heads=mask_heads)
    drop = LY.drop_params(0.1, 0.0, True, 4324)
    before = AT.fused_attention.launches, AT.fused_attention.launches_mma
    out = AT._fwd_cuda(q, k, v, mask, drop)
    assert AT.fused_attention.launches == before[0] + 1
    assert AT.fused_attention.launches_mma == before[1] + (body == "mma")
    assert _masked_ok(out, AT._fwd_plain(q, k, v, mask, drop), ATT_TOL[torch.bfloat16])


@pytest.mark.parametrize("L", [16, 50])
def test_fused_attention_bwd_replays_the_forward_dropout_mask(cuda, L):
    """q = k = 0 and no mask make every probability 1/L, and dO with one-hot
    rows (dO[i, i] = 1) makes dV[j, i] = z[i, j] = rnd(keep[i, j] / L /
    (1 - p)) exactly: the tensor-core backward's dropout mask is the
    forward's (the plain keep mask) bit for bit."""
    from unirec_tpu_torch.ops import attention as AT
    B, H, hd = 3, 2, 64
    z = torch.zeros(B, H, L, hd, device=cuda, dtype=torch.bfloat16)
    do = torch.zeros_like(z)
    do[:, :, torch.arange(L), torch.arange(L)] = 1.0
    drop = LY.drop_params(0.3, 0.0, True, 97)
    m = torch.zeros(B, 1, L, L, device=cuda)
    before = AT.fused_attention_bwd.launches_mma
    _, _, dv = AT._bwd_cuda(z, z, z, m, do, drop)
    assert AT.fused_attention_bwd.launches_mma == before + 1
    keep = AT._keep(drop, B, H, L, cuda)
    want = torch.where(keep, torch.full_like(keep, 1.0 / L, dtype=torch.float32)
                       * drop.inv_attn, 0.0).to(torch.bfloat16)
    assert torch.equal(dv[..., :L, :L].transpose(-1, -2), want)
    assert 0 < int((want == 0).sum()) < want.numel()


def test_fused_attention_gate_matches_the_kernels(cuda):
    from unirec_tpu_torch.ops import attention as AT
    lib = _build.library("attention")
    fwd, bwd = lib.unirec_attention_fwd_smem_bytes, lib.unirec_attention_bwd_smem_bytes
    fwd_t, bwd_t = (lib.unirec_attention_fwd_tiled_smem_bytes,
                    lib.unirec_attention_bwd_tiled_smem_bytes)
    fwd.argtypes = bwd.argtypes = fwd_t.argtypes = bwd_t.argtypes = [ctypes.c_int] * 2
    for L, hd in ((50, 32), (10, 8), (285, 32), (286, 32), (512, 64), (512, 128),
                  (50, 136), (512, 136), (512, 256), (64, 1024)):
        assert fwd(L, hd) == AT._fwd_smem_bytes(L, hd)
        assert bwd(L, hd) == AT._bwd_smem_bytes(L, hd)
        assert fwd_t(L, hd) == AT._fwd_tiled_smem_bytes(L, hd)
        assert bwd_t(L, hd) == AT._bwd_tiled_smem_bytes(L, hd)
    # the whole-sequence kernels to L = 285 at head width 32, the tiled
    # pair beyond, whose shared memory does not grow with the head width:
    # together every L of the JAX gate at every head width
    assert not AT._tiled(285, 32) and AT._tiled(286, 32)
    for hd in (8, 32, 64, 128, 136, 256):
        for L in range(1, AT.MAX_FUSED_SEQ_LEN + 1):
            if AT._tiled(L, hd):
                assert max(fwd_t(L, hd), bwd_t(L, hd)) <= LY._SMEM_LIMIT
            else:
                assert max(fwd(L, hd), bwd(L, hd)) <= LY._SMEM_LIMIT
    mma, mma_f = lib.unirec_attention_bwd_mma_smem_bytes, lib.unirec_attention_fwd_mma_smem_bytes
    mma.argtypes = [ctypes.c_int] * 2
    mma_f.argtypes = [ctypes.c_int] * 4
    assert all(mma(L, hd) <= LY._SMEM_LIMIT for L in range(1, 65) for hd in range(1, 65))
    assert all(mma_f(L, hd, H, heads) <= LY._SMEM_LIMIT for L in range(1, 65)
               for hd in range(1, 65, 7) for H in (1, 2, 3, 8, 16) for heads in (0, 1))
    flash = _build.library("flash_attention").unirec_flash_fwd_smem_bytes
    flash.argtypes = [ctypes.c_int] * 4
    for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for hd in list(range(8, 129, 8)) + [136, 256, 512]:
            for H in (1, 2, 3, 4, 8):
                for heads in (0, 1):
                    want = AT._flash_smem_bytes(dt, hd, H, bool(heads))
                    assert flash(code, hd, H, heads) == want <= LY._SMEM_LIMIT


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L", [300, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_tiled_matches_plain(cuda, dtype, L, p):
    """Beyond the whole-sequence kernels' shared memory (L > 285 at head
    width 32) the tiled pair runs, with the same dropout mask replayed in
    the backward; both directions against the plain versions (example 0,
    every key masked, as ``_masked_ok`` says)."""
    from unirec_tpu_torch.ops import attention as AT
    assert AT._tiled(L, 32)
    q, k, v, mask = _att_case(cuda, dtype, B=3, L=L)
    drop = LY.drop_params(p, 0.0, True, 4322)
    out = AT._fwd_cuda(q, k, v, mask, drop)
    assert _masked_ok(out, AT._fwd_plain(q, k, v, mask, drop), ATT_TOL[dtype])
    do = torch.randn_like(q.float()).to(dtype)
    for a, b in zip(AT._bwd_cuda(q, k, v, mask, do, drop),
                    AT._bwd_plain(q, k, v, mask, do, drop)):
        assert a.dtype == dtype and _masked_ok(a, b, ATT_TOL[dtype])


@pytest.mark.parametrize("L", [300, 512])
def test_fused_attention_tiled_dropout_mask_is_bit_identical(cuda, L):
    """The tiled forward's mask is the plain version's bit for bit (q = k =
    0, v = identity columns: out = keep / L / (1 - p) exactly). Bit
    equality of whole arithmetic holds between the two CUDA-core bodies
    (whole-sequence and tiled); the bf16 tensor-core backward is held to
    BWD_TOL, and its mask to the forward's bit for bit above."""
    from unirec_tpu_torch.ops import attention as AT
    B, H = 2, 2
    z = torch.zeros(B, H, L, 32, device=cuda)
    v = torch.zeros(B, H, L, 32, device=cuda)
    v[:, :, :32] = torch.eye(32, device=cuda)
    drop = LY.drop_params(0.3, 0.0, True, 98)
    m = torch.zeros(B, 1, L, L, device=cuda)
    assert torch.equal(AT._fwd_cuda(z, z, v, m, drop), AT._fwd_plain(z, z, v, m, drop))


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L", [50, 512])
@pytest.mark.parametrize("hd", [136, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_wide_heads_match_plain(cuda, dtype, hd, L, p):
    """Head widths the JAX gate takes beyond 128: the whole-sequence bodies
    where they fit (L=50, hd=136), else the tiled pair in column chunks of
    128, both directions against the plain versions with the same dropout
    mask."""
    from unirec_tpu_torch.ops import attention as AT
    q, k, v, mask = _att_case(cuda, dtype, B=3, L=L, hd=hd)
    assert AT._fwd_body(dtype, L, hd) == ("whole" if (L, hd) == (50, 136) else "tiled")
    drop = LY.drop_params(p, 0.0, True, 4325)
    out = AT._fwd_cuda(q, k, v, mask, drop)
    assert out.dtype == dtype and _masked_ok(out, AT._fwd_plain(q, k, v, mask, drop),
                                             ATT_TOL[dtype])
    do = torch.randn_like(q.float()).to(dtype)
    for a, b in zip(AT._bwd_cuda(q, k, v, mask, do, drop),
                    AT._bwd_plain(q, k, v, mask, do, drop)):
        assert a.dtype == dtype and a.shape == q.shape and _masked_ok(a, b, ATT_TOL[dtype])


# flash attention: out within one bf16 ulp (2^-7) of max(1, the largest
# output) in bf16 and 1e-5 in f32 (the kernel's online softmax against the
# plain two-pass one), gradients within two ulps or 1e-5; lse within 1e-5 of
# each row's magnitude.
@pytest.mark.parametrize("L,B,hd,all_masked", [
    (256, 6, 32, False), (264, 4, 32, False), (1024, 2, 32, False), (256, 3, 128, False),
    (264, 3, 8, False), (256, 3, 64, False), (264, 3, 32, True),
    (256, 2, 136, False), (264, 2, 136, False), (256, 2, 256, False), (264, 2, 256, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, dtype, L, B, hd, all_masked):
    """all_masked: every key of every row at -1e4 (rows attend uniformly),
    so every example is held as ``_masked_ok`` holds example 0."""
    from unirec_tpu_torch.ops import attention as AT
    q, k, v, mask = _att_case(cuda, dtype, B=B, L=L, hd=hd)
    ok = _masked_ok
    if all_masked:
        mask = torch.full_like(mask, AT.MASK_VALUE)
        ok = lambda a, b, tol: _rel(a, b) <= max(tol, 2.0 ** -10)  # noqa: E731
    before = AT.flash_attention.launches
    out, lse = AT._flash_fwd_cuda(q, k, v, mask)
    assert AT.flash_attention.launches == before + 1
    ref, ref_lse = AT._flash_fwd_plain(q, k, v, mask)
    assert out.dtype == dtype and out.shape == q.shape
    assert ok(out, ref, 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)
    assert bool(((lse - ref_lse).abs() <= 1e-5 * ref_lse.abs().clamp(min=1.0)).all())
    # the autograd entry: forward through the kernel, backward as _flash_bwd
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    g = torch.randn_like(q.float()).to(dtype)
    AT.flash_attention(qs, ks, vs, mask).backward(g)
    refs = AT._flash_bwd(q, k, v, mask, ref, ref_lse, g)
    for t, r in zip((qs, ks, vs), refs):
        assert ok(t.grad, r, 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5)


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    """Head width 136, which the JAX gate takes, runs (the CUDA-core body in
    column chunks of 128) and agrees with the plain version; fp16 is
    refused."""
    from unirec_tpu_torch.ops import attention as AT
    q, k, v, mask = _att_case(cuda, torch.float32, B=2, L=256, hd=136)
    assert AT._flash_body(torch.float32, 136) == AT._flash_body(torch.bfloat16, 136) == "cuda"
    out, lse = AT._flash_fwd_cuda(q, k, v, mask)
    ref, ref_lse = AT._flash_fwd_plain(q, k, v, mask)
    assert _masked_ok(out, ref, 1e-5)
    assert bool(((lse - ref_lse).abs() <= 1e-5 * ref_lse.abs().clamp(min=1.0)).all())
    q, k, v, mask = _att_case(cuda, torch.float16, B=2, L=256)
    with pytest.raises(TypeError):
        AT._flash_fwd_cuda(q, k, v, mask)


def test_fused_attention_dropout_mask_is_bit_identical(cuda):
    """q = k = 0 and no mask: every probability is 1/L; v = identity makes
    out[b, h, i, j] = keep[b, h, i, j] / L / (1 - p), exactly, in f32."""
    from unirec_tpu_torch.ops import attention as AT
    B, H, L = 5, 2, 16
    z = torch.zeros(B, H, L, L, device=cuda)
    v = torch.eye(L, device=cuda).expand(B, H, L, L).contiguous()
    drop = LY.drop_params(0.3, 0.0, True, 99)
    out = AT._fwd_cuda(z, z, v, torch.zeros(B, 1, L, L, device=cuda), drop)
    assert torch.equal(out, AT._fwd_plain(z, z, v, torch.zeros(B, 1, L, L, device=cuda),
                                           drop))
    assert 0 < int((out == 0).sum()) < out.numel()


@pytest.mark.parametrize("T", [1100, 33])
@pytest.mark.parametrize("act", ["relu", "swish", "gelu", "tanh", "sigmoid", "leakyrelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_matches_plain(cuda, dtype, act, T):
    from unirec_tpu_torch.ops import ffn as FF
    g = torch.Generator(device=cuda).manual_seed(9)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=cuda) * std).to(dtype)  # noqa: E731
    x, w1, b1, w2, b2, dy = (rn(T, 64), rn(64, 128, std=0.2), rn(128, std=0.1),
                             rn(128, 64, std=0.2), rn(64, std=0.1), rn(T, 64))
    before = FF.fused_ffn.launches, FF.fused_ffn_bwd.launches, FF.fused_ffn_bwd.launches_mma
    y = FF._fwd_cuda(x, w1, b1, w2, b2, act)
    assert FF.fused_ffn.launches == before[0] + 1
    assert _rel(y, FF._fwd_plain(x, w1, b1, w2, b2, act)) <= ATT_TOL[dtype]
    got = FF.fused_ffn_bwd(x, w1, b1, w2, b2, dy, act)
    assert FF.fused_ffn_bwd.launches == before[1] + 1
    # bf16: the tensor-core backward (T=33: one ragged tile)
    assert FF.fused_ffn_bwd.launches_mma == before[2] + (dtype == torch.bfloat16)
    for a, b in zip(got, FF._bwd_plain(x, w1, b1, w2, b2, dy, act)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= ATT_TOL[dtype]


@pytest.mark.parametrize("D,Fi", [(64, 128), (64, 512), (32, 48), (16, 2048), (48, 144),
                                  (72, 128), (64, 100), (256, 1024)])
def test_fused_ffn_body_selector(cuda, D, Fi):
    """csrc/ffn.cu's rules against ops/ffn.py's copies: the bf16 backward's
    body (the tensor cores at D a multiple of 16 up to 64 and F a multiple
    of 16, F in chunks of 128), and the CUDA-core bodies' row tiles and
    shared memory; each body against the plain backward, its counter moving
    with the selector."""
    from unirec_tpu_torch.ops import ffn as FF
    lib = _build.library("ffn")
    takes, rows, smem = lib.unirec_ffn_bwd_mma_takes, lib.unirec_ffn_rows, lib.unirec_ffn_smem_bytes
    mma_smem = lib.unirec_ffn_bwd_mma_smem_bytes
    takes.argtypes = rows.argtypes = [ctypes.c_int] * 3
    smem.argtypes = [ctypes.c_int] * 4
    mma_smem.argtypes = [ctypes.c_int] * 2
    body = FF._bwd_body(torch.bfloat16, D, Fi)
    assert bool(takes(1, D, Fi)) == (body == "mma") and not takes(0, D, Fi)
    assert body == "cuda" or mma_smem(D, Fi) <= LY._SMEM_LIMIT
    for bwd in (0, 1):
        r = rows(bwd, D, Fi)
        assert r == FF._rows(bool(bwd), D, Fi) > 0
        assert smem(bwd, r, D, Fi) == FF._smem_bytes(bool(bwd), r, D, Fi) <= LY._SMEM_LIMIT
    g = torch.Generator(device=cuda).manual_seed(10)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=cuda) * std).to(  # noqa: E731
        torch.bfloat16)
    T = 777
    x, w1, b1, w2, b2, dy = (rn(T, D), rn(D, Fi, std=(2 / D) ** 0.5), rn(Fi, std=0.1),
                             rn(Fi, D, std=(1 / Fi) ** 0.5), rn(D, std=0.1), rn(T, D))
    before = FF.fused_ffn_bwd.launches_mma
    got = FF._bwd_cuda(x, w1, b1, w2, b2, dy, "gelu")
    assert FF.fused_ffn_bwd.launches_mma == before + (body == "mma")
    for a, b in zip(got, FF._bwd_plain(x, w1, b1, w2, b2, dy, "gelu")):
        assert _rel(a, b) <= ATT_TOL[torch.bfloat16]


@pytest.mark.parametrize("T", [1, 33, 32767])
@pytest.mark.parametrize("act", ["relu", "swish", "gelu", "tanh", "sigmoid", "leakyrelu"])
def test_fused_ffn_forward_tensor_core_body_matches_plain(cuda, act, T):
    """Row 12's bf16 tensor-core body at the path's widths (D=64, F=128) and
    token counts that are not a multiple of its 128-token tile: within two
    bf16 ulps of the largest output; its counter rises, and f32 keeps the
    CUDA-core body."""
    from unirec_tpu_torch.ops import ffn as FF
    g = torch.Generator(device=cuda).manual_seed(12)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    ws = (rn(64, 128, std=0.2), rn(128, std=0.1), rn(128, 64, std=0.2), rn(64, std=0.1))
    x = rn(T, 64)
    for dt, body in ((torch.bfloat16, "mma"), (torch.float32, "cuda")):
        args = (x.to(dt), *(w.to(dt) for w in ws), act)
        assert FF._fwd_body(dt, 64, 128) == body
        before = FF.fused_ffn.launches, FF.fused_ffn.launches_mma
        y = FF._fwd_cuda(*args)
        assert FF.fused_ffn.launches == before[0] + 1
        assert FF.fused_ffn.launches_mma == before[1] + (body == "mma")
        ref = FF._fwd_plain(*args)
        assert y.dtype == dt and y.shape == (T, 64)
        assert float((y.float() - ref.float()).abs().max()) <= \
            ATT_TOL[dt] * max(1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("D,Fi", [(16, 16), (48, 144), (64, 512), (32, 2048)])
def test_fused_ffn_forward_tensor_core_widths(cuda, D, Fi):
    """The forward's tensor-core body at other widths its rule takes: F in
    one chunk of at most 128 columns, or in chunks whose y sums stay in
    registers; its shared memory matches ops/ffn.py's copy."""
    from unirec_tpu_torch.ops import ffn as FF
    lib = _build.library("ffn")
    smem = lib.unirec_ffn_fwd_mma_smem_bytes
    smem.argtypes = [ctypes.c_int] * 2
    assert smem(D, Fi) == FF._fwd_mma_smem_bytes(D, Fi) <= LY._SMEM_LIMIT
    g = torch.Generator(device=cuda).manual_seed(13)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=cuda) * std).to(  # noqa: E731
        torch.bfloat16)
    x, w1, b1, w2, b2 = (rn(1001, D), rn(D, Fi, std=(2 / D) ** 0.5), rn(Fi, std=0.1),
                         rn(Fi, D, std=(1 / Fi) ** 0.5), rn(D, std=0.1))
    before = FF.fused_ffn.launches_mma
    y = FF._fwd_cuda(x, w1, b1, w2, b2, "swish")
    assert FF.fused_ffn.launches_mma == before + 1
    assert _rel(y, FF._fwd_plain(x, w1, b1, w2, b2, "swish")) <= ATT_TOL[torch.bfloat16]


@pytest.mark.parametrize("D,Fi", [(64, 2048), (256, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_wide_matches_plain(cuda, dtype, D, Fi):
    """Widths whose whole [rows, F] activation no longer fits a block: the
    CUDA-core bodies in F chunks of 128 (and a row tile of 8 to 64 tokens),
    the bf16 backward at D=64 on the tensor cores in 16 F chunks whose dx
    parts the wrapper sums."""
    from unirec_tpu_torch.ops import ffn as FF
    g = torch.Generator(device=cuda).manual_seed(11)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=cuda) * std).to(dtype)  # noqa: E731
    T = 1100
    x, w1, b1, w2, b2, dy = (rn(T, D), rn(D, Fi, std=(2 / D) ** 0.5), rn(Fi, std=0.1),
                             rn(Fi, D, std=(1 / Fi) ** 0.5), rn(D, std=0.1), rn(T, D))
    y = FF._fwd_cuda(x, w1, b1, w2, b2, "swish")
    assert _rel(y, FF._fwd_plain(x, w1, b1, w2, b2, "swish")) <= ATT_TOL[dtype]
    for a, b in zip(FF._bwd_cuda(x, w1, b1, w2, b2, dy, "swish"),
                    FF._bwd_plain(x, w1, b1, w2, b2, dy, "swish")):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= ATT_TOL[dtype]


def test_fused_attention_and_ffn_flags_launch_their_kernels(cuda):
    """use_fused_attention + use_fused_ffn on CUDA: a train-mode forward and
    backward through the model launches all four kernels and no raise."""
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.models.modules import DropoutRNG
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import ffn as FF
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = config_mod.parse_arguments({
        "model": "SASRec", "n_users": 10, "n_items": 50, "embedding_size": 64,
        "n_heads": 2, "inner_size": 128, "max_seq_len": 12, "last_query_only": 1,
        "use_fused_attention": 1, "use_fused_ffn": 1, "hidden_dropout_prob": 0.1,
        "attn_dropout_prob": 0.1})
    model = get_model_class("SASRec")(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(cuda)
    seq = torch.randint(1, 50, (4, 12), device=cuda)
    before = [AT.fused_attention.launches, AT.fused_attention_bwd.launches,
              FF.fused_ffn.launches, FF.fused_ffn_bwd.launches]
    u = model.encode_sequence(seq, train=True, rng=DropoutRNG(0, cuda))
    u.float().sum().backward()
    after = [AT.fused_attention.launches, AT.fused_attention_bwd.launches,
             FF.fused_ffn.launches, FF.fused_ffn_bwd.launches]
    # one attention layer (layer 1 is last-query), FFN in both layers
    assert [a - b for a, b in zip(after, before)] == [1, 1, 2, 2]
