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


@pytest.mark.parametrize("flag,L", [("use_fused_ffn", 12),
                                    ("use_fused_attention", 12),
                                    ("use_pallas", 256)])
def test_unported_kernel_flags_raise_on_cuda(cuda, flag, L):
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = config_mod.parse_arguments({
        "model": "SASRec", "n_users": 10, "n_items": 50, "embedding_size": 16,
        "n_heads": 2, "inner_size": 32, "max_seq_len": L, "use_pallas": 0,
        flag: 1})
    model = get_model_class("SASRec")(cfg).to(cuda).eval()
    with torch.no_grad(), pytest.raises(NotImplementedError, match="ROADMAP"):
        model.user_emb({"item_seq": torch.ones(2, L, dtype=torch.long, device=cuda)})


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
