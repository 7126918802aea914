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
