"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

Each kernel against its plain PyTorch version on the same CUDA tensors, in
the working dtype, at small shapes and at the shapes the paths run.
Tolerances, case builders and holders are card_cases.py's (shared with
chip_smoke.py, which times the kernels); block maxima within 1e-3 of the
largest score. Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have.)
"""
import ctypes

import numpy as np
import pytest
import torch

from card_cases import (ATT_TOL, BWD_TOL, FAMILY, LN_TOL, SOLVER_TOL, SOLVERS, adam_state,
                        att_case, cell_leaf_shapes, dtype_name, f32_ulps, guarded_update,
                        hold_pass2, hstu_case, layer_case, ln_tol, path_layer_case,
                        replayed_mask_mismatches)
from unirec_tpu_torch.ops import _build
from unirec_tpu_torch.ops import layer as LY
from unirec_tpu_torch.ops import topk as TK

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("act", LY.SUPPORTED_ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_fwd_matches_plain(cuda, dtype, act, causal):
    x, madd, params = layer_case(cuda, dtype)
    kw = dict(n_heads=2, inner_size=64, hidden_act=act, layer_norm_eps=1e-10)
    before = LY.fused_transformer_layer.launches
    y = LY.fused_transformer_layer(x, madd, params, causal=causal, **kw)
    assert LY.fused_transformer_layer.launches == before + 1
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    ref = LY._layer_fwd_plain(xp, mp, LY._layer_weights(params, dtype), 2, act,
                              1e-10, causal)[:, :x.shape[1]]
    assert y.dtype == dtype and torch.isfinite(y).all()
    assert float((y.float() - ref.float()).abs().max()) <= LN_TOL[dtype_name(dtype)]


# (B, L, D, F): a small case, and the serving path's (B=256, L=50, d=64)
@pytest.mark.parametrize("B,L,D,F", [(8, 10, 32, 64), (256, 50, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lastq_fwd_matches_plain(cuda, dtype, B, L, D, F):
    x, madd, params = layer_case(cuda, dtype, B=B, L=L, D=D, F=F, seed=1)
    kw = dict(n_heads=2, inner_size=F, hidden_act="gelu", layer_norm_eps=1e-10)
    before = LY.fused_last_query_layer.launches
    y = LY.fused_last_query_layer(x, madd, params, q_index=L - 2, **kw)
    assert LY.fused_last_query_layer.launches == before + 1
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    ref = LY._lastq_fwd_plain(xp, mp, LY._lastq_weights(params, dtype), L - 2, 2,
                              "gelu", 1e-10)
    assert y.shape == (B, D)
    assert float((y.float() - ref.float()).abs().max()) <= LN_TOL[dtype_name(dtype)]


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


def _catalog(dev, B, N, D, idt, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
    items = torch.randn(N, D, generator=g, device=dev) * 0.05
    if idt == torch.int8:
        return (u, *TK.quantize_catalog(items))
    return u, items.to(idt), None


def _hold_blockmax(bm, u, items, scale):
    ref = TK._blockmax_plain(u, items, scale)
    assert bm.shape == ref.shape
    assert float((bm - ref).abs().max()) <= 1e-3 * float(ref.abs().max())


@pytest.mark.parametrize("idt", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("N", [1000, 50_000])
@pytest.mark.parametrize("D", [64, 65, 128])
@pytest.mark.parametrize("B", [1, 100, 256])
def test_blockmax_tensor_core_body_matches_plain(cuda, B, D, N, idt):
    u, items, scale = _catalog(cuda, B, N, D, idt)
    assert TK._blockmax_body(u.dtype, items.dtype, D) == "mma"
    name = "launches_int8" if idt == torch.int8 else "launches"
    before = (getattr(TK.catalog_blockmax, name), getattr(TK.catalog_blockmax, f"{name}_mma"))
    bm = TK.catalog_blockmax(u, items, item_scale=scale)
    assert (getattr(TK.catalog_blockmax, name),
            getattr(TK.catalog_blockmax, f"{name}_mma")) == (before[0] + 1, before[1] + 1)
    _hold_blockmax(bm, u, items, scale)


@pytest.mark.parametrize("idt", [torch.bfloat16, torch.int8])
def test_blockmax_tensor_core_body_ragged_negative_chunk(cuda, idt):
    """A ragged last chunk whose every score is negative keeps its own max
    (an item past N must not enter it as a zero score); users above 256 take
    a second group, and a view at an odd offset is copied to 16 bytes."""
    u, items, scale = _catalog(cuda, 300, 1000 * 16 + 3, 64, idt, seed=5)
    u = u.abs()
    items[-3:] = -items[-3:].abs()
    bm = TK.catalog_blockmax(u, items, item_scale=scale)
    assert bool((bm[:, -1] < 0).all())
    _hold_blockmax(bm, u, items, scale)
    buf = items.new_empty(items.numel() + 1)
    buf[1:] = items.view(-1)
    odd = buf[1:].view(items.shape)             # 1 or 2 bytes past an aligned address
    assert odd.data_ptr() % 16
    _hold_blockmax(TK.catalog_blockmax(u, odd, item_scale=scale), u, items, scale)


def test_blockmax_tensor_core_body_takes_catalogs_past_the_old_grid(cuda):
    """N just past 65,535 x 256 items, which the CUDA-core body's grid
    refuses: the tensor-core body's grid comes from the SM count."""
    N = 65535 * 256 + 17
    u, items, _ = _catalog(cuda, 1, N, 64, torch.bfloat16, seed=6)
    assert TK._blockmax_body(u.dtype, items.dtype, 64) == "mma"
    _hold_blockmax(TK.catalog_blockmax(u, items), u, items, None)
    with pytest.raises(ValueError):
        TK.catalog_blockmax(u.float(), items)     # f32 users: the CUDA-core body


@pytest.mark.parametrize("udt,idt,D", [(1, 1, 64), (1, 2, 64), (1, 1, 65), (1, 2, 1),
                                       (1, 1, 128), (1, 1, 129), (1, 1, 0), (0, 1, 64),
                                       (0, 2, 64), (1, 0, 64), (0, 0, 64)])
def test_blockmax_body_selector(cuda, udt, idt, D):
    """csrc/blockmax.cu's rule against ops/topk.py's copy."""
    takes = _build.library("blockmax").unirec_blockmax_mma_takes
    takes.argtypes = [ctypes.c_int] * 3
    dts = (torch.float32, torch.bfloat16, torch.int8)
    assert bool(takes(udt, idt, D)) == (TK._blockmax_body(dts[udt], dts[idt], D) == "mma")


def test_serving_launches_the_tensor_core_blockmax(cuda):
    """fused_catalog_topk on bf16 users (the serving path's pass 1) with a
    bf16 and an int8 catalog: both new counters move, and the ids equal the
    dense top-k of the same scores."""
    g = torch.Generator(device=cuda).manual_seed(7)
    u = torch.randn(64, 64, generator=g, device=cuda).to(torch.bfloat16)
    items = (torch.randn(20000, 64, generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    q, scale = TK.quantize_catalog(items)
    for it, sc, name in ((items, None, "launches_mma"), (q, scale, "launches_int8_mma")):
        before = getattr(TK.catalog_blockmax, name)
        _, ids = TK.fused_catalog_topk(u, it, 50, item_scale=sc)
        assert getattr(TK.catalog_blockmax, name) == before + 1
        dense = u.float() @ it.float().T * (1.0 if sc is None else sc[None, :])
        assert torch.equal(ids.sort(1).values, torch.topk(dense, 50).indices.sort(1).values)


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


def _pass2_case(dev, B, N, D, k, udt=torch.bfloat16, idt=torch.bfloat16, hcap=0,
                keep=False, exclude_pad=False, invalid_from=None, max_invalid=0, seed=11):
    """Pass 2's inputs as fused_catalog_topk builds them: the users, the
    catalog (scale for int8), pass 1's chunk ids at its kp, and the bans."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn(B, D, generator=g, device=dev).to(udt)
    items = torch.randn(N, D, generator=g, device=dev) * 0.05
    scale = None
    if idt == torch.int8:
        items, scale = TK.quantize_catalog(items)
    else:
        items = items.to(idt)
    icap = (-(-max_invalid // 16) + 1) if invalid_from is not None else 0
    kp = k + (16 if N % 16 else 0) + int(exclude_pad) + hcap + icap
    _, blk = torch.topk(TK.catalog_blockmax(u, items, item_scale=scale), kp)
    bans = dict(exclude_pad_item=exclude_pad, invalid_from=invalid_from)
    if hcap:
        dense = u.float() @ items.float().T
        hist = torch.randint(1, N, (B, hcap), generator=g, device=dev)
        hist[:, :4] = torch.topk(dense, 4).indices      # ban each user's best items ...
        hlen = torch.randint(4, hcap + 1, (B,), generator=g, device=dev)
        bans.update(hist_items=hist, hist_len=hlen)
        if keep:
            bans["keep_ids"] = hist[:, 1].clone()       # ... but exempt the second
    return u, items, scale, blk, bans


PASS2_CASES = {   # name: (B, N, D, k, case options)
    "serve": (4096, 50_000, 64, 100, dict(hcap=200, exclude_pad=True)),
    "serve_int8": (4096, 50_000, 64, 100, dict(idt=torch.int8, hcap=200, exclude_pad=True)),
    "item_bias_d65": (512, 50_000, 65, 100, dict(hcap=200, exclude_pad=True)),
    "int8_d65": (256, 20_000, 65, 50, dict(idt=torch.int8, hcap=30, exclude_pad=True)),
    "f32_users_bf16_table": (256, 50_000, 64, 100, dict(udt=torch.float32, hcap=200,
                                                        exclude_pad=True)),
    "f32_table": (256, 20_000, 64, 50, dict(udt=torch.float32, idt=torch.float32)),
    "keep_ids_ragged": (256, 20_007, 64, 50, dict(hcap=40, keep=True, exclude_pad=True)),
    "sharded_invalid_from": (256, 250_000, 64, 301, dict(invalid_from=249_998,
                                                          max_invalid=2)),
    "wide_d256": (64, 20_000, 256, 10, dict(hcap=12, exclude_pad=True)),
    "wide_d512": (64, 20_000, 512, 10, dict(hcap=12, exclude_pad=True)),
    "wide_d1024": (32, 20_000, 1024, 10, dict(hcap=12, exclude_pad=True)),
    "f32_d20": (64, 20_000, 20, 10, dict(udt=torch.float32, idt=torch.float32)),
    # working sets past shared memory: the spill body, more users than its blocks
    "long_history_spill": (1100, 200_000, 32, 100, dict(hcap=3200, keep=True,
                                                        exclude_pad=True)),
    "int8_d65_spill": (64, 100_000, 65, 100, dict(idt=torch.int8, hcap=3200,
                                                  exclude_pad=True)),
    "large_k_spill": (64, 1_000_000, 64, 3500, {}),
}
BODIES = {0: "refused", 1: "scalar", 2: "vector", 3: "spill"}


def _body(items, kp, k, hcap, idt=None):
    """The body csrc/rescore_topk.cu picks for a call (its own rule)."""
    rule = _build.library("rescore_topk").unirec_rescore_topk_body
    rule.argtypes = [ctypes.c_int] * 7
    code = TK._ITEM_DTYPES[items.dtype] if idt is None else idt
    return BODIES[rule(code, items.shape[1], kp, k, hcap, items.shape[0],
                       int(items.data_ptr() % 16 == 0))]


@pytest.mark.parametrize("case", sorted(PASS2_CASES))
def test_rescore_topk_matches_plain(cuda, case):
    B, N, D, k, opts = PASS2_CASES[case]
    u, items, scale, blk, bans = _pass2_case(cuda, B, N, D, k, **opts)
    hcap = 0 if "hist_items" not in bans else bans["hist_items"].shape[1]
    assert (_body(items, blk.shape[1], k, hcap) == "spill") == case.endswith("_spill")
    name = "launches_int8" if scale is not None else "launches"
    before = getattr(TK.rescore_topk, name)
    v, ids = TK.rescore_topk(u, items, blk, k, item_scale=scale, **bans)
    torch.cuda.synchronize()
    assert getattr(TK.rescore_topk, name) == before + 1
    hold_pass2(v, ids, u, items, scale, blk, k, bans)


def test_rescore_topk_takes_a_misaligned_table_on_the_scalar_body(cuda):
    u, items, scale, blk, bans = _pass2_case(cuda, 128, 20_000, 64, 50, hcap=20,
                                             exclude_pad=True)
    buf = items.new_empty(items.numel() + 1)
    buf[1:] = items.view(-1)
    odd = buf[1:].view(items.shape)             # 2 bytes past an aligned address
    assert odd.data_ptr() % 16 and _body(odd, blk.shape[1], 50, 20) == "scalar"
    v, ids = TK.rescore_topk(u, odd, blk, 50, **bans)
    hold_pass2(v, ids, u, items, scale, blk, 50, bans)


@pytest.mark.parametrize("idt,D,kp,k,hcap,N,aligned,body", [
    (1, 64, 301, 100, 200, 50_000, 1, "vector"),      # the serving shape
    (2, 64, 301, 100, 200, 50_000, 1, "vector"),      # catalog_int8
    (1, 65, 301, 100, 200, 50_000, 1, "scalar"),      # the item-bias column
    (2, 65, 301, 100, 200, 50_000, 1, "scalar"),
    (0, 64, 301, 100, 200, 50_000, 1, "vector"),
    (1, 64, 301, 100, 200, 50_000, 0, "scalar"),      # a misaligned view
    (1, 64, 303, 301, 0, 250_000, 1, "vector"),       # a shard, invalid_from
    (1, 1024, 10, 10, 0, 50_000, 1, "vector"),        # 128 words a row
    (1, 1032, 10, 10, 0, 50_000, 1, "scalar"),
    (1, 64, 3301, 100, 3200, 1_000_000, 1, "spill"),  # a long history
    (1, 64, 3500, 3500, 0, 1_000_000, 1, "spill"),    # a large k
    (1, 64, 10, 161, 0, 50_000, 1, "refused"),        # k past kp 16
    (1, 0, 10, 10, 0, 50_000, 1, "refused"),
    (3, 64, 10, 10, 0, 50_000, 1, "refused"),         # no such item dtype
    (1, 64, 10, 10, 0, 2**31 - 17, 1, "vector"),      # the largest catalog
    (1, 64, 10, 10, 0, 2**31 - 16, 1, "refused")])    # ids past 32 bits
def test_rescore_body_of_each_path(cuda, idt, D, kp, k, hcap, N, aligned, body):
    """csrc/rescore_topk.cu's own rule: every path that reaches pass 2 takes
    a body, and a working set past shared memory spills, with a workspace."""
    lib = _build.library("rescore_topk")
    rule, ws = lib.unirec_rescore_topk_body, lib.unirec_rescore_topk_workspace
    rule.argtypes, ws.argtypes, ws.restype = [ctypes.c_int] * 7, [ctypes.c_int] * 5, \
        ctypes.c_longlong
    assert BODIES[rule(idt, D, kp, k, hcap, N, aligned)] == body
    if body in ("scalar", "vector", "spill"):
        assert (ws(4096, D, kp, k, hcap) > 0) == (body == "spill")


def test_rescore_topk_counts_launches_and_reports_refusals(cuda):
    """One launch a call on its counter, on every body; an error of the C
    entry is raised, not skipped; a catalog past 32-bit ids raises with the
    kernel's capacity."""
    u, items, scale, blk, bans = _pass2_case(cuda, 64, 20_000, 65, 50, hcap=10,
                                             exclude_pad=True)
    before = TK.rescore_topk.launches
    TK.rescore_topk(u, items, blk, 50, **bans)
    TK.rescore_topk(u, items, blk, 50, **bans)
    assert TK.rescore_topk.launches == before + 2
    launch, _ = TK._rescore_lib()
    v = torch.empty(64, 50, device=cuda)
    i = torch.empty(64, 50, dtype=torch.int64, device=cuda)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = launch(7, 1, p(u), p(items), None, p(blk), None, None, None, p(v), p(i),
                 64, 20_000, 65, blk.shape[1], 50, 0, 0, 20_000, None, 0,
                 _build.stream_handle(cuda))                # no such user dtype
    with pytest.raises(RuntimeError, match="rescore_topk launch"):
        _build.check(err, "rescore_topk launch")
    huge = torch.empty(2**31 - 16, 1, dtype=torch.bfloat16, device=cuda)   # 4 GB
    with pytest.raises(ValueError, match="capacity"):
        TK.rescore_topk(torch.ones(2, 1, dtype=torch.bfloat16, device=cuda), huge,
                        torch.zeros(2, 7, dtype=torch.int64, device=cuda), 5)
    del huge
    assert TK.rescore_topk.launches == before + 2


@pytest.mark.parametrize("away", ["item_emb", "blk", "hist_items", "hist_len", "keep_ids",
                                  "item_scale"])
def test_rescore_topk_refuses_host_tensors(cuda, away):
    """Every tensor argument must sit on the users' card: a host pointer
    would fault in the kernel, so the wrapper refuses it first."""
    u, items, scale, blk, bans = _pass2_case(cuda, 16, 20_000, 64, 10, idt=torch.int8,
                                             hcap=8, keep=True, exclude_pad=True)
    args = dict(item_emb=items, blk=blk, item_scale=scale, **bans)
    args[away] = args[away].cpu()
    with pytest.raises(ValueError, match=f"{away} not on the users' device"):
        TK.rescore_topk(u, args.pop("item_emb"), args.pop("blk"), 10, **args)


@pytest.mark.parametrize("hcap", [8, 3200])   # the working set in shared memory; spilled
def test_rescore_topk_takes_tied_candidates_in_candidate_order(cuda, hcap):
    """Every item the same row, so every score of a user ties: the kernel
    takes the first k unbanned candidates in pass 1's chunk order, values
    equal and ids in that order, the same on every call."""
    B, N, D, k = 64, 100_000, 64, 100
    g = torch.Generator(device=cuda).manual_seed(23)
    u = torch.randn(B, D, generator=g, device=cuda).to(torch.bfloat16)
    items = torch.randn(1, D, generator=g, device=cuda).expand(N, D).to(torch.bfloat16)
    kp = k + 1 + hcap
    blk = torch.stack([torch.randperm(N // 16, generator=g, device=cuda)[:kp]
                       for _ in range(B)])
    hist = torch.randint(0, N, (B, hcap), generator=g, device=cuda)
    hlen = torch.randint(0, hcap + 1, (B,), generator=g, device=cuda)
    bans = dict(hist_items=hist, hist_len=hlen, exclude_pad_item=True)
    assert _body(items.contiguous(), kp, k, hcap) == ("spill" if hcap > 1000 else "vector")
    v, ids = TK.rescore_topk(u, items, blk, k, **bans)
    for _ in range(2):
        v2, ids2 = TK.rescore_topk(u, items, blk, k, **bans)
        assert torch.equal(ids, ids2) and torch.equal(v, v2)
    iid = (blk[..., None] * 16 + torch.arange(16, device=cuda)).reshape(B, -1)
    for r in range(B):
        banned = torch.isin(iid[r], hist[r, :hlen[r]]) | (iid[r] == 0)
        assert torch.equal(ids[r], iid[r][~banned][:k])
        assert bool((v[r] == v[r, 0]).all())


def test_serving_pass2_launches_the_kernel_and_no_plain_pass(cuda, monkeypatch):
    """fused_catalog_topk at a serving-like shape (bf16 users, history,
    padding item): one rescore launch a call, no plain pass 2 on the card,
    and the ids equal the dense top-k apart from ties."""
    g = torch.Generator(device=cuda).manual_seed(13)
    u = torch.randn(512, 64, generator=g, device=cuda).to(torch.bfloat16)
    items = (torch.randn(50_000, 64, generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    hist = torch.randint(1, 50_000, (512, 200), generator=g, device=cuda)
    hlen = torch.randint(10, 201, (512,), generator=g, device=cuda)

    def plain(*a, **kw):
        raise AssertionError("the plain pass 2 ran on CUDA tensors")

    monkeypatch.setattr(TK, "_rescore_topk_plain", plain)
    before = TK.rescore_topk.launches
    v, ids = TK.fused_catalog_topk(u, items, 100, hist_items=hist, hist_len=hlen,
                                   exclude_pad_item=True)
    assert TK.rescore_topk.launches == before + 1
    dense = u.float() @ items.float().T
    valid = torch.arange(200, device=cuda)[None] < hlen[:, None]
    dense = dense.scatter(1, torch.where(valid, hist, 0), float("-inf"))
    ref_v, ref_ids = torch.topk(dense, 100)
    tol = 1e-5 * float(ref_v.abs().max())
    assert float((v - ref_v).abs().max()) <= tol
    same = (ids.sort(1).values == ref_ids.sort(1).values).all(1)
    kth = ref_v[:, -1:]
    near = ((dense - kth).abs() <= tol).sum(1) > 1      # a tie at the k-th
    assert bool((same | near).all())


def test_shared_memory_gate_matches_the_kernels(cuda):
    layer = _build.library("layer_fwd").unirec_layer_fwd_smem_bytes
    lastq = _build.library("lastq_fwd").unirec_lastq_fwd_smem_bytes
    layer.argtypes = [ctypes.c_int] * 3
    lastq.argtypes = [ctypes.c_int] * 4
    for Lp, D, F, nh in ((56, 64, 128, 2), (16, 32, 64, 2), (136, 64, 256, 4)):
        assert layer(Lp, D, F) == LY._layer_smem_bytes(Lp, D, F)
        assert lastq(Lp, D, F, nh) == LY._lastq_smem_bytes(Lp, D, F, nh)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, madd, params = layer_case(cuda, torch.float16)
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
    within ln_tol (card_cases.py): bf16 LayerNorm outputs, 3e-2 or two bf16
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
    tol = ln_tol(ref)
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


def _rel_err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


def _drop(p=0.1, seed=1234):
    return LY.drop_params(p, p, True, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_forward_kernels_match_plain(cuda, dtype):
    x, madd, params = layer_case(cuda, dtype, B=16, seed=4)
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    flat = LY._layer_weights(params, dtype)
    y = LY._layer_fwd_cuda(xp, mp, flat, 2, "swish", 1e-10, True, _drop())
    ref = LY._layer_fwd_plain(xp, mp, flat, 2, "swish", 1e-10, True, _drop())
    assert float((y.float() - ref.float()).abs().max()) <= LN_TOL[dtype_name(dtype)]
    assert float((y.float() - LY._layer_fwd_plain(xp, mp, flat, 2, "swish", 1e-10, True)
                  .float()).abs().max()) > 10 * LN_TOL[dtype_name(dtype)]    # dropout really ran
    fq = LY._lastq_weights(params, dtype)
    yq = LY._lastq_fwd_cuda(xp, mp, fq, 9, 2, "swish", 1e-10, _drop())
    rq = LY._lastq_fwd_plain(xp, mp, fq, 9, 2, "swish", 1e-10, _drop())
    assert float((yq.float() - rq.float()).abs().max()) <= LN_TOL[dtype_name(dtype)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal,act", [(True, "swish"), (False, "gelu"), (True, "relu")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_bwd_matches_plain(cuda, dtype, causal, act, p):
    x, madd, params = layer_case(cuda, dtype, B=40, seed=5)
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    flat = LY._layer_weights(params, dtype)
    dy = torch.randn(xp.shape, device=cuda).to(dtype)
    args = (2, act, 1e-10, causal, _drop(p))
    before = LY.layer_bwd.launches
    dx, grads = LY.layer_bwd(xp, mp, flat, dy, *args)
    assert LY.layer_bwd.launches == before + 1
    rdx, rgrads = LY._layer_bwd_plain(xp, mp, flat, dy, *args)
    assert _rel_err(dx, rdx) <= BWD_TOL[dtype_name(dtype)]
    for g, r, w in zip(grads, rgrads, flat):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel_err(g, r) <= BWD_TOL[dtype_name(dtype)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lastq_bwd_matches_plain(cuda, dtype, p):
    x, madd, params = layer_case(cuda, dtype, B=40, seed=6)
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    flat = LY._lastq_weights(params, dtype)
    dy = torch.randn(xp.shape[0], xp.shape[2], device=cuda).to(dtype)
    args = (9, 2, "swish", 1e-10, _drop(p))
    before = LY.lastq_bwd.launches
    dx, grads = LY.lastq_bwd(xp, mp, flat, dy, *args)
    assert LY.lastq_bwd.launches == before + 1
    rdx, rgrads = LY._lastq_bwd_plain(xp, mp, flat, dy, *args)
    assert _rel_err(dx, rdx) <= BWD_TOL[dtype_name(dtype)]
    for g, r in zip(grads, rgrads):
        assert _rel_err(g, r) <= BWD_TOL[dtype_name(dtype)]


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
        x, madd, params = layer_case(cuda, torch.float32, D=D, F=F)
        assert lb.unirec_layer_bwd_slab_floats(D, F) == sum(
            t.numel() for t in LY._layer_weights(params, torch.float32))
        assert qb.unirec_lastq_bwd_slab_floats(D, F) == sum(
            t.numel() for t in LY._lastq_weights(params, torch.float32))


def _layer_bwd_path_case(dev, B, seed, causal=True, act="swish", p=0.1, dtype=torch.bfloat16):
    """The training path's layer (L=50 -> Lp=56, D=64, 2 heads, F=128) on B
    examples, with dy on every real row, as the layer backward is called."""
    xp, mp, params = path_layer_case(dev, dtype, B, seed)
    flat = LY._layer_weights(params, dtype)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.zeros_like(xp)
    dy[:, :50] = torch.randn(B, 50, 64, generator=g, device=dev).to(dtype)
    return xp, mp, flat, dy, (2, act, 1e-10, causal, _drop(p))


def _hold_layer_bwd(got, ref, D=64):
    """Every output within BWD_TOL of its own largest value; the key bias's
    gradient, zero in exact arithmetic, against the query bias's scale."""
    (dx, grads), (rdx, rgrads) = got, ref
    assert _rel_err(dx, rdx) <= BWD_TOL["bfloat16"]
    for gr, r in zip(grads, rgrads):
        assert _rel_err(gr, r) <= BWD_TOL["bfloat16"]
    dbk, rdbq = grads[1][D:2 * D].float(), rgrads[1][:D].float()
    assert float(dbk.abs().max()) <= BWD_TOL["bfloat16"] * float(rdbq.abs().max())


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
    assert _rel_err(dx, rdx) > 4 * BWD_TOL["bfloat16"]


def test_layer_bwd_f32_keeps_the_cuda_core_body(cuda):
    xp, mp, flat, dy, args = _layer_bwd_path_case(cuda, 9, 23, dtype=torch.float32)
    assert LY._layer_bwd_body(torch.float32, 56, 64, 128, 2) == "cuda"
    before = LY.layer_bwd.launches, LY.layer_bwd.launches_mma
    dx, grads = LY.layer_bwd(xp, mp, flat, dy, *args)
    assert (LY.layer_bwd.launches, LY.layer_bwd.launches_mma) == (before[0] + 1, before[1])
    rdx, rgrads = LY._layer_bwd_plain(xp, mp, flat, dy, *args)
    for a, r in zip((dx, *grads), (rdx, *rgrads)):
        assert _rel_err(a, r) <= BWD_TOL["float32"]


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
    x, madd, params = layer_case(cuda, torch.bfloat16, B=17, L=Lp - 3, D=D, F=F, seed=24)
    xp, mp, _ = LY._pad_L(x, madd, Lp - 3)
    flat = LY._layer_weights(params, torch.bfloat16)
    dy = torch.randn(xp.shape, device=cuda).to(torch.bfloat16)
    args = (nh, "gelu", 1e-10, True, _drop(0.1))
    before = LY.layer_bwd.launches_mma
    dx, grads = LY._layer_bwd_cuda(xp, mp, flat, dy, *args)
    assert LY.layer_bwd.launches_mma == before + 1
    rdx, rgrads = LY._layer_bwd_plain(xp, mp, flat, dy, *args)
    for a, b in zip((dx, *grads), (rdx, *rgrads)):
        assert _rel_err(a, b) <= BWD_TOL["bfloat16"]


# ------------------------------------ rows 1 and 4 on the tensor cores
def _layer_fwd_path_case(dev, B, seed, causal=True, act="swish", p=0.1, dtype=torch.bfloat16):
    """The paths' whole layer (L=50 -> Lp=56, D=64, 2 heads, F=128) on B
    examples, as fused_transformer_layer calls its forward."""
    xp, mp, params = path_layer_case(dev, dtype, B, seed)
    return xp, mp, LY._layer_weights(params, dtype), (2, act, 1e-10, causal, _drop(p))


@pytest.mark.parametrize("B", [33, 256])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("act", ["swish", "gelu"])
def test_layer_fwd_tensor_core_body_matches_plain(cuda, act, causal, p, B):
    """Row 1's bf16 tensor-core forward at the paths' widths (B=33: the last
    block's second group idle; B=256: the serving batch), both activations
    of the paths, both masks, dropout 0 and 0.1."""
    xp, mp, flat, args = _layer_fwd_path_case(cuda, B, 30, causal, act, p)
    assert LY._layer_fwd_body(torch.bfloat16, 56, 64, 128, 2) == "mma"
    before = LY.fused_transformer_layer.launches, LY.fused_transformer_layer.launches_mma
    y = LY._layer_fwd_cuda(xp, mp, flat, *args)
    assert (LY.fused_transformer_layer.launches,
            LY.fused_transformer_layer.launches_mma) == (before[0] + 1, before[1] + 1)
    ref = LY._layer_fwd_plain(xp, mp, flat, *args)
    assert torch.isfinite(y).all()
    assert float((y.float() - ref.float()).abs().max()) <= ln_tol(ref)


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
    assert float((y.float() - ref.float()).abs().max()) <= ln_tol(ref)


# B=256: the serving batch, every other activation and mask (swish and
# causal there: chip_smoke.py's f32 row 1 line)
@pytest.mark.parametrize("B,act,causal", [(9, "swish", True)] + [
    (256, act, causal) for act in LY.SUPPORTED_ACTS for causal in (True, False)
    if (act, causal) != ("swish", True)])
def test_layer_fwd_f32_keeps_the_cuda_core_body(cuda, B, act, causal):
    xp, mp, flat, args = _layer_fwd_path_case(cuda, B, 32, causal, act, dtype=torch.float32)
    assert LY._layer_fwd_body(torch.float32, 56, 64, 128, 2) == "cuda"
    before = LY.fused_transformer_layer.launches, LY.fused_transformer_layer.launches_mma
    y = LY._layer_fwd_cuda(xp, mp, flat, *args)
    assert (LY.fused_transformer_layer.launches,
            LY.fused_transformer_layer.launches_mma) == (before[0] + 1, before[1])
    ref = LY._layer_fwd_plain(xp, mp, flat, *args)
    assert float((y - ref).abs().max()) <= LN_TOL["float32"]


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
    x, madd, params = layer_case(cuda, torch.bfloat16, B=17, L=Lp - 3, D=D, F=F, seed=33)
    xp, mp, _ = LY._pad_L(x, madd, Lp - 3)
    flat = LY._layer_weights(params, torch.bfloat16)
    args = (nh, "gelu", 1e-10, True, _drop(0.1))
    before = LY.fused_transformer_layer.launches_mma
    y = LY._layer_fwd_cuda(xp, mp, flat, *args)
    assert LY.fused_transformer_layer.launches_mma == before + 1
    ref = LY._layer_fwd_plain(xp, mp, flat, *args)
    assert float((y.float() - ref.float()).abs().max()) <= ln_tol(ref)


def _lastq_bwd_path_case(dev, B, seed, act="swish", p=0.1, qi=49, dtype=torch.bfloat16):
    """The paths' last-query layer (L=50 -> Lp=56, D=64, 2 heads, F=128) on
    B examples, query row qi, as its backward is called."""
    xp, mp, params = path_layer_case(dev, dtype, B, seed)
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
    assert _rel_err(dx, rdx) <= BWD_TOL["bfloat16"]
    for i, (gr, r) in enumerate(zip(grads, rgrads)):
        if i == 3:
            err = float((gr.float() - r.float()).abs().max())
            assert err <= BWD_TOL["bfloat16"] * float(rgrads[1].float().abs().max())
        else:
            assert _rel_err(gr, r) <= BWD_TOL["bfloat16"]


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
    assert _rel_err(dx, rdx) > 4 * BWD_TOL["bfloat16"]


def test_lastq_bwd_f32_keeps_the_cuda_core_body(cuda):
    xp, mp, flat, dy, args = _lastq_bwd_path_case(cuda, 9, 43, dtype=torch.float32)
    assert LY._lastq_bwd_body(torch.float32, 56, 64, 128, 2) == "cuda"
    before = LY.lastq_bwd.launches, LY.lastq_bwd.launches_mma
    dx, grads = LY.lastq_bwd(xp, mp, flat, dy, *args)
    assert (LY.lastq_bwd.launches, LY.lastq_bwd.launches_mma) == (before[0] + 1, before[1])
    rdx, rgrads = LY._lastq_bwd_plain(xp, mp, flat, dy, *args)
    for a, r in zip((dx, *grads), (rdx, *rgrads)):
        assert _rel_err(a, r) <= BWD_TOL["float32"]


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
    x, madd, params = layer_case(cuda, torch.bfloat16, B=17, L=Lp - 3, D=D, F=F, seed=44)
    xp, mp, _ = LY._pad_L(x, madd, Lp - 3)
    flat = LY._lastq_weights(params, torch.bfloat16)
    dy = torch.randn(17, D, device=cuda).to(torch.bfloat16)
    args = (Lp - 4, nh, "gelu", 1e-10, _drop(0.1))
    before = LY.lastq_bwd.launches_mma
    dx, grads = LY._lastq_bwd_cuda(xp, mp, flat, dy, *args)
    assert LY.lastq_bwd.launches_mma == before + 1
    rdx, rgrads = LY._lastq_bwd_plain(xp, mp, flat, dy, *args)
    for a, b in zip((dx, *grads), (rdx, *rgrads)):
        assert _rel_err(a, b) <= BWD_TOL["bfloat16"]


# ------------------------------------ row 3 on the tensor cores
def _lastq_fwd_path_case(dev, B, seed, act="swish", p=0.1, qi=49, dtype=torch.bfloat16):
    """The paths' last-query layer (L=50 -> Lp=56, D=64, 2 heads, F=128) on
    B examples, query row qi, as fused_last_query_layer calls its forward."""
    xp, mp, params = path_layer_case(dev, dtype, B, seed)
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
    assert float((y.float() - ref.float()).abs().max()) <= ln_tol(ref)


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
    assert float((y.float() - ref.float()).abs().max()) <= ln_tol(ref)


def test_lastq_fwd_tensor_core_masks_are_the_backwards(cuda):
    """Through autograd with dropout 0.1 (train mode, a seed), the tensor-core
    forward and the tensor-core backward, which replays its masks from the
    seed, against the plain forward and backward: the output and every
    gradient agree, and another seed's plain output does not."""
    from unittest import mock
    x, madd, params = layer_case(cuda, torch.bfloat16, B=35, L=50, D=64, F=128, seed=62)
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
    assert float((y.float() - ry.float()).abs().max()) <= ln_tol(ry)
    assert float((y.float() - other.float()).abs().max()) > 4 * ln_tol(ry)
    for i, (g, r) in enumerate(zip(grads, rgrads)):
        if i == 4:   # the key bias: zero in exact arithmetic, held to the query bias's scale
            err = float((g.float() - r.float()).abs().max())
            assert err <= BWD_TOL["bfloat16"] * float(rgrads[2].float().abs().max())
        else:
            assert _rel_err(g, r) <= BWD_TOL["bfloat16"]


def test_lastq_fwd_f32_keeps_the_cuda_core_body(cuda):
    xp, mp, flat, args = _lastq_fwd_path_case(cuda, 9, 64, dtype=torch.float32)
    assert LY._lastq_fwd_body(torch.float32, 56, 64, 128, 2) == "cuda"
    before = LY.fused_last_query_layer.launches, LY.fused_last_query_layer.launches_mma
    y = LY._lastq_fwd_cuda(xp, mp, flat, *args)
    assert (LY.fused_last_query_layer.launches,
            LY.fused_last_query_layer.launches_mma) == (before[0] + 1, before[1])
    ref = LY._lastq_fwd_plain(xp, mp, flat, *args)
    assert float((y - ref).abs().max()) <= LN_TOL["float32"]


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
    x, madd, params = layer_case(cuda, torch.bfloat16, B=17, L=Lp - 3, D=D, F=F, seed=65)
    xp, mp, _ = LY._pad_L(x, madd, Lp - 3)
    flat = LY._lastq_weights(params, torch.bfloat16)
    args = (Lp - 4, nh, "gelu", 1e-10, _drop(0.1))
    before = LY.fused_last_query_layer.launches_mma
    y = LY._lastq_fwd_cuda(xp, mp, flat, *args)
    assert LY.fused_last_query_layer.launches_mma == before + 1
    ref = LY._lastq_fwd_plain(xp, mp, flat, *args)
    assert float((y.float() - ref.float()).abs().max()) <= ln_tol(ref)


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


def _member_case(dev, B, C, K, seed=9):
    """Histories left-padded with 0 before 0..C ids of 1..99, candidates in
    -2..99, a third of them from the history (its padding among them)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(0, C + 1, (B,), generator=g, device=dev)
    rows = torch.randint(1, 100, (B, C), generator=g, device=dev, dtype=torch.int32)
    rows = torch.where(torch.arange(C, device=dev)[None] >= C - lens[:, None], rows, 0)
    cand = torch.randint(-2, 100, (B, K), generator=g, device=dev, dtype=torch.int32)
    pick = torch.randint(0, C, (B, K), generator=g, device=dev)
    return rows, torch.where(torch.arange(K, device=dev)[None] % 3 == 0,
                             rows.gather(1, pick), cand)


@pytest.mark.parametrize("C", [13, 200, 1000])   # 1000: four passes of 256 ids
@pytest.mark.parametrize("B", [1, 1001, 32768])
def test_member_warp_body_matches_plain(cuda, B, C):
    from unirec_tpu_torch.ops import member as MB
    rows, cand = _member_case(cuda, B, C, 36)
    assert MB._member_body(C, 36) == "warp"
    before = (MB.member_mask.launches, MB.member_mask.launches_warp)
    out = MB.member_mask(rows, cand)
    assert (MB.member_mask.launches, MB.member_mask.launches_warp) == (before[0] + 1,
                                                                      before[1] + 1)
    assert torch.equal(out, MB._member_plain(rows, cand))


@pytest.mark.parametrize("C,K", [(200, 1), (200, 33), (200, 64), (31, 64), (200, 65), (13, 100)])
def test_member_bodies_take_every_candidate_count(cuda, C, K):
    """The warp body at K up to 64 (one or two candidates a lane), the block
    body above."""
    from unirec_tpu_torch.ops import member as MB
    rows, cand = _member_case(cuda, 517, C, K, seed=10)
    before = MB.member_mask.launches_warp
    out = MB.member_mask(rows, cand)
    assert MB.member_mask.launches_warp == before + (K <= 64)
    assert torch.equal(out, MB._member_plain(rows, cand))


@pytest.mark.parametrize("C,K", [(200, 36), (13, 36), (7264, 64), (20000, 1), (200, 0),
                                 (200, 65), (13, 400)])
def test_member_body_selector(cuda, C, K):
    """csrc/member.cu's rule against ops/member.py's copy."""
    from unirec_tpu_torch.ops import member as MB
    takes = _build.library("member").unirec_member_warp_takes
    takes.argtypes = [ctypes.c_int] * 2
    assert bool(takes(C, K)) == (MB._member_body(C, K) == "warp")


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
    before = (MB.member_mask.launches, MB.member_mask.launches_warp)
    negs = aug.sample_negatives(torch.Generator(device=cuda).manual_seed(0), rows,
                                torch.ones(1001, 1, dtype=torch.int32, device=cuda))
    assert (MB.member_mask.launches, MB.member_mask.launches_warp) == (before[0] + 1,
                                                                      before[1] + 1)
    hit = (negs[:, :, None] == rows[:, None, :]).any(-1) & (negs > 0)
    assert negs.shape == (1001, 9) and not bool(hit.any())


def test_training_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from unirec_tpu_torch.ops import member as MB
    from unirec_tpu_torch.ops import scatter_accum as SA
    x, madd, params = layer_case(cuda, torch.float16)
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
# Forward and backward against the plain versions on the same CUDA tensors
# (ATT_TOL); with dropout the masks are the same bits.


def _masked_ok(a, b, tol):
    """Examples 1.. within tol; example 0 of ``att_case`` has every key
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
    q, k, v, mask = att_case(cuda, dtype, L=L, mask_heads=mask_heads)
    drop = LY.drop_params(p, 0.0, True, 4321)
    before = AT.fused_attention.launches, AT.fused_attention_bwd.launches
    mma = AT.fused_attention.launches_mma
    out = AT._fwd_cuda(q, k, v, mask, drop)
    assert AT.fused_attention.launches == before[0] + 1
    # bf16 at these lengths: the tensor-core forward
    assert (AT._fwd_body(dtype, L, 32) == "mma") == (dtype == torch.bfloat16)
    assert AT.fused_attention.launches_mma == mma + (dtype == torch.bfloat16)
    assert _rel(out, AT._fwd_plain(q, k, v, mask, drop)) <= ATT_TOL[dtype_name(dtype)]
    do = torch.randn_like(q.float()).to(dtype)
    got = AT.fused_attention_bwd(q, k, v, mask, do, drop)
    assert AT.fused_attention_bwd.launches == before[1] + 1
    for a, b in zip(got, AT._bwd_plain(q, k, v, mask, do, drop)):
        assert a.dtype == dtype and a.shape == q.shape
        assert _rel(a, b) <= ATT_TOL[dtype_name(dtype)]


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
    q, k, v, mask = att_case(cuda, torch.bfloat16, B=3, L=L, hd=hd)
    drop = LY.drop_params(0.1, 0.0, True, 4323)
    do = torch.randn_like(q.float()).to(torch.bfloat16)
    before = AT.fused_attention_bwd.launches, AT.fused_attention_bwd.launches_mma
    got = AT.fused_attention_bwd(q, k, v, mask, do, drop)
    assert AT.fused_attention_bwd.launches == before[0] + 1
    assert AT.fused_attention_bwd.launches_mma == before[1] + (body == "mma")
    for a, b in zip(got, AT._bwd_plain(q, k, v, mask, do, drop)):
        assert _masked_ok(a, b, BWD_TOL["bfloat16"])


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
    q, k, v, mask = att_case(cuda, torch.bfloat16, B=5, H=H, L=L, hd=hd,
                              mask_heads=mask_heads)
    drop = LY.drop_params(0.1, 0.0, True, 4324)
    before = AT.fused_attention.launches, AT.fused_attention.launches_mma
    out = AT._fwd_cuda(q, k, v, mask, drop)
    assert AT.fused_attention.launches == before[0] + 1
    assert AT.fused_attention.launches_mma == before[1] + (body == "mma")
    assert _masked_ok(out, AT._fwd_plain(q, k, v, mask, drop), ATT_TOL["bfloat16"])


@pytest.mark.parametrize("L", [16, 50])
def test_fused_attention_bwd_replays_the_forward_dropout_mask(cuda, L):
    """The tensor-core backward's dropout mask is the forward's (the plain
    keep mask) bit for bit (card_cases.replayed_mask_mismatches)."""
    from unirec_tpu_torch.ops import attention as AT
    before = AT.fused_attention_bwd.launches_mma
    bad, dropped = replayed_mask_mismatches(cuda, 3, L, 64, 0.3)
    assert AT.fused_attention_bwd.launches_mma == before + 1
    assert bad == 0 and 0 < dropped < 3 * 2 * L * L


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
    q, k, v, mask = att_case(cuda, dtype, B=3, L=L)
    drop = LY.drop_params(p, 0.0, True, 4322)
    out = AT._fwd_cuda(q, k, v, mask, drop)
    assert _masked_ok(out, AT._fwd_plain(q, k, v, mask, drop), ATT_TOL[dtype_name(dtype)])
    do = torch.randn_like(q.float()).to(dtype)
    for a, b in zip(AT._bwd_cuda(q, k, v, mask, do, drop),
                    AT._bwd_plain(q, k, v, mask, do, drop)):
        assert a.dtype == dtype and _masked_ok(a, b, ATT_TOL[dtype_name(dtype)])


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
    q, k, v, mask = att_case(cuda, dtype, B=3, L=L, hd=hd)
    assert AT._fwd_body(dtype, L, hd) == ("whole" if (L, hd) == (50, 136) else "tiled")
    drop = LY.drop_params(p, 0.0, True, 4325)
    tol = ATT_TOL[dtype_name(dtype)]
    out = AT._fwd_cuda(q, k, v, mask, drop)
    assert out.dtype == dtype and _masked_ok(out, AT._fwd_plain(q, k, v, mask, drop), tol)
    do = torch.randn_like(q.float()).to(dtype)
    for a, b in zip(AT._bwd_cuda(q, k, v, mask, do, drop),
                    AT._bwd_plain(q, k, v, mask, do, drop)):
        assert a.dtype == dtype and a.shape == q.shape and _masked_ok(a, b, tol)


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
    q, k, v, mask = att_case(cuda, dtype, B=B, L=L, hd=hd)
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
    q, k, v, mask = att_case(cuda, torch.float32, B=2, L=256, hd=136)
    assert AT._flash_body(torch.float32, 136) == AT._flash_body(torch.bfloat16, 136) == "cuda"
    out, lse = AT._flash_fwd_cuda(q, k, v, mask)
    ref, ref_lse = AT._flash_fwd_plain(q, k, v, mask)
    assert _masked_ok(out, ref, 1e-5)
    assert bool(((lse - ref_lse).abs() <= 1e-5 * ref_lse.abs().clamp(min=1.0)).all())
    q, k, v, mask = att_case(cuda, torch.float16, B=2, L=256)
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
    assert _rel(y, FF._fwd_plain(x, w1, b1, w2, b2, act)) <= ATT_TOL[dtype_name(dtype)]
    got = FF.fused_ffn_bwd(x, w1, b1, w2, b2, dy, act)
    assert FF.fused_ffn_bwd.launches == before[1] + 1
    # bf16: the tensor-core backward (T=33: one ragged tile)
    assert FF.fused_ffn_bwd.launches_mma == before[2] + (dtype == torch.bfloat16)
    for a, b in zip(got, FF._bwd_plain(x, w1, b1, w2, b2, dy, act)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= ATT_TOL[dtype_name(dtype)]


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
        assert _rel(a, b) <= ATT_TOL["bfloat16"]


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
            ATT_TOL[dtype_name(dt)] * max(1.0, float(ref.float().abs().max()))


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
    assert _rel(y, FF._fwd_plain(x, w1, b1, w2, b2, "swish")) <= ATT_TOL["bfloat16"]


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
    assert _rel(y, FF._fwd_plain(x, w1, b1, w2, b2, "swish")) <= ATT_TOL[dtype_name(dtype)]
    for a, b in zip(FF._bwd_cuda(x, w1, b1, w2, b2, dy, "swish"),
                    FF._bwd_plain(x, w1, b1, w2, b2, dy, "swish")):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= ATT_TOL[dtype_name(dtype)]


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


# ------------------------------------------------- popularity negatives
def _pop_augmenter(dev, n=5000, U=2048, C=200, seed=11):
    """A device augmenter with popularity negatives (alpha 1) over a Zipf
    catalog, and histories drawn by the same popularity (many members)."""
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter
    from unirec_tpu_torch.data.history import UserHistory
    rng = np.random.default_rng(seed)
    pop = np.floor(1e5 / rng.permutation(np.arange(1, n + 1)) ** 0.9)
    pop[0] = 0
    lens = rng.integers(10, C + 1, U).astype(np.int32)
    items = np.zeros((U, C), np.int32)
    m = np.arange(C)[None] < lens[:, None]
    items[m] = rng.choice(n, int(m.sum()), p=pop / pop.sum())
    cfg = {"n_items": n, "n_sample_neg_train": 9, "neg_oversample_factor": 4,
           "max_seq_len": 50, "dataloader": "SeqRecDataset", "neg_by_pop_alpha": 1.0,
           "history_mask_mode": "autoregressive", "neg_membership_pallas": 1}
    return DeviceAugmenter(cfg, UserHistory(items, lens), item_popularity=pop, device=dev), pop


def test_popularity_draws_on_a_cuda_generator_follow_the_alias_table(cuda):
    """10^7 draws on the card: its alias table is the CPU's, bit for bit,
    and the draws' frequencies are within 0.01 total variation of the
    table's probabilities (about 0.006 is expected from sampling)."""
    from unirec_tpu_torch.data.sampler import AliasTable
    aug, pop = _pop_augmenter(cuda)
    table = AliasTable.of_popularity(pop, 1.0)
    assert torch.equal(aug.state["alias_thresh"].cpu(),
                       torch.as_tensor(table.thresh, dtype=torch.float32))
    assert torch.equal(aug.state["alias_alias"].cpu(), torch.as_tensor(table.alias).int())
    draws = aug._draw(torch.Generator(device=cuda).manual_seed(0), (10_000, 1000))
    assert draws.is_cuda and draws.dtype == torch.int32 and int(draws.min()) >= 1
    freq = torch.bincount(draws.reshape(-1).long(), minlength=len(pop)).double().cpu().numpy()
    p = pop / pop.sum()
    assert 0.5 * np.abs(freq / draws.numel() - p).sum() < 0.01


def test_member_matches_plain_on_popularity_candidates(cuda):
    """Row 8's warp body on the candidates a popularity draw proposes
    against histories drawn by the same popularity, exact; and the
    augmenter's negatives keep the first-survivor rule."""
    from unirec_tpu_torch.ops import member as MB
    aug, _ = _pop_augmenter(cuda)
    uid = torch.arange(2048, device=cuda)
    rows = aug.state["hist_items"][uid]
    cand = aug._draw(torch.Generator(device=cuda).manual_seed(1), (2048, 36))
    before = (MB.member_mask.launches, MB.member_mask.launches_warp)
    out = MB.member_mask(rows, cand)
    assert (MB.member_mask.launches, MB.member_mask.launches_warp) == (before[0] + 1,
                                                                      before[1] + 1)
    ref = MB._member_plain(rows, cand)
    assert torch.equal(out, ref) and 0.01 < float(ref.float().mean()) < 0.9
    pos = rows[:, -1:]
    negs = aug.sample_negatives(torch.Generator(device=cuda).manual_seed(2), rows, pos)
    ok = ~((negs[:, :, None] == rows[:, None, :]).any(-1) | (negs == pos))
    assert bool((ok | (negs == 0)).all())


def test_multi_positive_metrics_on_the_card_match_the_cpu(cuda):
    """ops/metrics.py::multipos_topk_and_metrics on one batch, on the card
    and on the CPU, from the same scores (spaced 1e-3 apart, so the 1e-8
    tie noise of either generator reorders nothing), positives and
    histories."""
    from unirec_tpu_torch.ops import metrics as M
    g = torch.Generator().manual_seed(3)
    B, N = 512, 50_000
    scores = torch.stack([torch.randperm(N, generator=g) for _ in range(B)]).float() * 1e-3
    pos = torch.randint(0, N, (B, 3), generator=g)
    pos[:, 2][::4] = 0                                   # rows with two positives
    hist = torch.randint(1, N, (B, 200), generator=g)
    hlen = torch.randint(0, 201, (B,), generator=g)
    names = ["group_auc", "hit@1", "hit@10", "recall@10", "ndcg@10", "mrr@10", "ndcg@50"]

    def run(dev):
        out = M.multipos_topk_and_metrics(scores.to(dev), pos.to(dev), hist.to(dev),
                                          hlen.to(dev), names, 50,
                                          torch.Generator(device=dev).manual_seed(4))
        return {k: v.cpu() for k, v in out.items()}

    got, ref = run(cuda), run("cpu")
    for k in names:
        torch.testing.assert_close(got[k], ref[k], atol=1e-6, rtol=1e-6, msg=k)


# ------------------------------------- the sequential family, side inputs
def _family_model(name, dev, **over):
    """A small model of the family at f32, dropout 0, its weights drawn on
    the CPU from seed 0, on ``dev``."""
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = config_mod.parse_arguments(dict({
        "model": name, "n_users": 40, "n_items": 300, "embedding_size": 32,
        "max_seq_len": 12, "conv_size": 4, "inner_size": 48, "n_layers": 2,
        "hidden_size": 48 if name == "GRU" else 32, "compute_dtype": "float32",
        "hidden_dropout_prob": 0.0, "dropout_prob": 0.0, "loss_type": "bce",
        "vmem_embedding_grad": 1}, **over), argv=[], device="cpu")
    model = get_model_class(name)(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(dev)


def _family_batch(dev, B=16, L=12, n_items=300, seed=0):
    g = torch.Generator().manual_seed(seed)
    seq = torch.randint(1, n_items, (B, L), generator=g)
    lens = torch.randint(0, L + 1, (B,), generator=g)
    seq = torch.where(torch.arange(L)[None] >= L - lens[:, None], seq, 0)
    item = torch.randint(1, n_items, (B, 5), generator=g)
    label = torch.zeros(B, 5)
    label[:, 0] = 1.0
    return {k: v.to(dev) for k, v in {
        "item_seq": seq, "item_seq_len": lens, "user_id": torch.randint(1, 40, (B,), generator=g),
        "item_id": item, "label": label, "weight": torch.ones(B)}.items()}


@pytest.mark.parametrize("name", FAMILY)
def test_sequential_family_on_the_card_matches_the_cpu(cuda, name):
    """Each new model's forward and backward on the card against the same
    model on the CPU: user embeddings and the loss within 1e-4 abs (f32,
    summation order only), every gradient within 1e-4 of its own largest
    element; the card's backward scatters through row 6."""
    from unirec_tpu_torch.models.modules import DropoutRNG
    from unirec_tpu_torch.ops import scatter_accum as SA
    outs = {}
    for dev in ("cpu", cuda):
        model = _family_model(name, dev)
        batch = _family_batch(dev)
        before = SA.scatter_add_rows.launches
        loss, _ = model(batch, train=True, rng=DropoutRNG(0, dev))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        launched = SA.scatter_add_rows.launches - before
        with torch.no_grad():
            outs[str(dev)] = (model.user_emb(batch).cpu(), loss.detach().cpu(),
                              [g.cpu() for g in grads], launched)
    (u0, l0, g0, n0), (u1, l1, g1, n1) = outs["cpu"], outs[str(cuda)]
    assert n0 == 0 and n1 == (3 if name == "SVDPlusPlus" else 2)
    assert float((u0 - u1).abs().max()) <= 1e-4 and abs(float(l0 - l1)) <= 1e-4
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(a.abs().max()), 1e-6)


@pytest.mark.parametrize("name", ["AvgHist", "SVDPlusPlus"])
def test_scatter_add_at_d256_f32_on_both_tables(cuda, name):
    """Row 6 at run_seq_benchmark.sh's width (d=256, f32) on AvgHist's and
    SVD++'s own tables: each gather of a table (item_dst_embedding for the
    history, item_embedding for the candidates, SVD++'s user_embedding too)
    launches the sorted-tile body once, and each table's gradient matches
    the plain scatter's element by element (1e-5 of its largest, f32
    atomics in another order)."""
    from unirec_tpu_torch.models.modules import DropoutRNG
    from unirec_tpu_torch.ops import scatter_accum as SA
    grads = {}
    for plain in (False, True):
        model = _family_model(name, cuda, embedding_size=256, max_seq_len=50,
                              n_items=5000, asymmetric=True)
        batch = _family_batch(cuda, B=400, L=50, n_items=5000, seed=1)
        tables = {n: p for n, p in model.named_parameters() if n.endswith("embedding.weight")}
        before = (SA.scatter_add_rows.launches, SA.scatter_add_rows.launches_sorted)
        with pytest.MonkeyPatch.context() as mp:
            if plain:
                mp.setattr(SA, "_scatter_cuda", SA._scatter_plain)
            loss, _ = model(batch, train=True, rng=DropoutRNG(0, cuda))
            got = torch.autograd.grad(loss, list(tables.values()))
        launched = (SA.scatter_add_rows.launches - before[0],
                    SA.scatter_add_rows.launches_sorted - before[1])
        grads[plain] = (dict(zip(tables, got)), launched)
    (k, nk), (p, npl) = grads[False], grads[True]
    want = {"AvgHist": 2, "SVDPlusPlus": 3}[name]
    assert nk == (want, want) and npl[0] == 0
    assert {"item_dst_embedding.weight", "item_embedding.weight"} <= set(k)
    for n in k:
        assert k[n].dtype == torch.float32 and float(k[n].abs().max()) > 0
        assert float((k[n] - p[n]).abs().max()) <= 1e-5 * float(p[n].abs().max()), n


def test_member_matches_plain_on_walk_histories(cuda):
    """Row 8's warp body on side_inputs_path's kind of ids: histories of
    10..199 items walking groups of 200 consecutive ids over 50,000 items,
    uniform candidates (9 negatives, 4 proposals each), exact."""
    from unirec_tpu_torch.ops import member as MB
    rng = np.random.default_rng(12)
    B, C, N = 4096, 199, 50_000
    lens = rng.integers(10, C + 1, B)
    start = rng.integers(0, 200, B)[:, None] + np.arange(C)[None]
    group = rng.integers(0, (N - 1) // 200, B)[:, None]
    rows = np.where(np.arange(C)[None] < lens[:, None], 1 + group * 200 + start % 200, 0)
    rows = torch.as_tensor(rows, dtype=torch.int32, device=cuda)
    cand = torch.randint(1, N, (B, 36), device=cuda, dtype=torch.int32)
    cand[:, :4] = rows[:, :4]                          # some members
    before = MB.member_mask.launches_warp
    out = MB.member_mask(rows, cand)
    assert MB.member_mask.launches_warp == before + 1
    assert torch.equal(out, MB._member_plain(rows, cand))
    assert bool(out[:, :4][rows[:, :4] > 0].all())


def test_side_inputs_launch_the_training_kernels(cuda):
    """SASRec at bench widths with features, text and time buckets, the
    fused layers and the scatter gather: one train-mode forward and
    backward on the card launches rows 1-4, and row 6 for the item table,
    the feature table and the projected text rows (the history's and the
    candidates' each) and the time table, and its loss matches the plain
    versions'."""
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.models.modules import DropoutRNG
    from unirec_tpu_torch.ops import scatter_accum as SA
    from unirec_tpu_torch.utils.registry import get_model_class
    rng = np.random.default_rng(0)
    feats = np.stack([rng.integers(1, 64, 500), 64 + rng.integers(1, 16, 500)], 1)
    feats[0] = 0
    cfg = config_mod.parse_arguments({
        "model": "SASRec", "n_users": 10, "n_items": 500, "embedding_size": 64,
        "hidden_size": 64, "n_heads": 2, "inner_size": 128, "max_seq_len": 50,
        "last_query_only": 1, "fused_layer": 1, "fused_lastq": 1, "hidden_act": "swish",
        "compute_dtype": "bfloat16", "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0,
        "use_features": 1, "features_shape": [64, 16], "_item2features": feats,
        "use_text_emb": 1, "text_emb_size": 768,
        "_text_emb": rng.normal(size=(500, 768)).astype(np.float32), "time_seq": 64})
    model = get_model_class("SASRec")(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(cuda)
    B, L = 64, 50
    seq = torch.randint(1, 500, (B, L), device=cuda)
    item = torch.randint(1, 500, (B, 10), device=cuda)
    f = torch.as_tensor(feats, device=cuda)
    batch = {"item_seq": seq, "time_seq": torch.randint(1, 64, (B, L), device=cuda),
             "item_seq_features": f[seq], "item_id": item, "item_features": f[item],
             "label": torch.cat([torch.ones(B, 1), torch.zeros(B, 9)], 1).to(cuda),
             "weight": torch.ones(B, device=cuda)}
    before = (LY.fused_transformer_layer.launches, LY.fused_last_query_layer.launches,
              LY.layer_bwd.launches, LY.lastq_bwd.launches, SA.scatter_add_rows.launches)
    loss, _ = model(batch, train=True, rng=DropoutRNG(0, cuda))
    loss.backward()
    after = (LY.fused_transformer_layer.launches, LY.fused_last_query_layer.launches,
             LY.layer_bwd.launches, LY.lastq_bwd.launches, SA.scatter_add_rows.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 7]
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_layer_fwd", "_lastq_fwd", "_layer_bwd", "_lastq_bwd"):
            mp.setattr(LY, f"{name}_cuda", getattr(LY, f"{name}_plain"))
        mp.setattr(SA, "_scatter_cuda", SA._scatter_plain)
        with torch.no_grad():
            ref, _ = model(batch, train=False)
    assert abs(float(loss.detach()) - float(ref)) <= 2e-3 * abs(float(ref))


# ------------------------------------------------- the CF and ranking models
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_at_bst_width_matches_plain(cuda, dtype, p):
    """Rows 10 and 11 at BST's shape: 4 heads of 16, L = 21 (the history of
    20 and the candidate), the bidirectional key-padding mask [N, 1, 1, L];
    bf16 on the tensor-core bodies (L and hd padded to 16 inside them)."""
    from unirec_tpu_torch.models.modules import causal_attention_mask
    from unirec_tpu_torch.ops import attention as AT
    g = torch.Generator(device=cuda).manual_seed(13)
    N, H, L, hd = 512, 4, 21, 16
    q, k, v = (torch.randn(N, H, L, hd, generator=g, device=cuda).to(dtype) for _ in range(3))
    seq = torch.randint(0, 3, (N, L), generator=g, device=cuda)
    seq[:, -1] = 1                                   # the candidate is always a key
    mask = causal_attention_mask(seq, bidirectional=True)
    assert mask.shape == (N, 1, 1, L) and AT.fused_supported(q, mask)
    drop = LY.drop_params(p, 0.0, True, 77)
    mma = AT.fused_attention.launches_mma, AT.fused_attention_bwd.launches_mma
    out = AT._fwd_cuda(q, k, v, mask, drop)
    assert _rel(out, AT._fwd_plain(q, k, v, mask, drop)) <= ATT_TOL[dtype_name(dtype)]
    do = torch.randn_like(q.float()).to(dtype)
    got = AT.fused_attention_bwd(q, k, v, mask, do, drop)
    for a, b in zip(got, AT._bwd_plain(q, k, v, mask, do, drop)):
        assert _rel(a, b) <= ATT_TOL[dtype_name(dtype)]
    bf16 = int(dtype == torch.bfloat16)
    assert (AT.fused_attention.launches_mma, AT.fused_attention_bwd.launches_mma) == \
        (mma[0] + bf16, mma[1] + bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_at_bst_width_matches_plain(cuda, dtype):
    """Rows 12 and 13 at BST's shape: d = 64, inner 128, swish, 21 rows an
    example."""
    from unirec_tpu_torch.ops import ffn as FF
    g = torch.Generator(device=cuda).manual_seed(14)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=cuda) * std).to(dtype)  # noqa: E731
    T = 512 * 21
    x, w1, b1, w2, b2, dy = (rn(T, 64), rn(64, 128, std=0.2), rn(128, std=0.1),
                             rn(128, 64, std=0.2), rn(64, std=0.1), rn(T, 64))
    assert _rel(FF._fwd_cuda(x, w1, b1, w2, b2, "swish"),
                FF._fwd_plain(x, w1, b1, w2, b2, "swish")) <= ATT_TOL[dtype_name(dtype)]
    for a, b in zip(FF.fused_ffn_bwd(x, w1, b1, w2, b2, dy, "swish"),
                    FF._bwd_plain(x, w1, b1, w2, b2, dy, "swish")):
        assert _rel(a, b) <= ATT_TOL[dtype_name(dtype)]


CF_RANK_MODELS = {
    "MF": dict(loss_type="bpr", has_user_emb=True),
    "MultiVAE": dict(encoder_dims=[48], decoder_dims=[48], eval_reparameter_sampling_times=0),
    "FM": dict(loss_type="bce", n_feats=300),
    "BST": dict(loss_type="bce", n_layers=2, n_heads=4, inner_size=128, hidden_act="swish",
                use_fused_attention=1, use_fused_ffn=1, max_seq_len=20),
    "AdaRanker-GRU": dict(loss_type="bce", base_model="GRU", train_type="Ada-Ranker"),
    "AdaRanker-SASRec": dict(loss_type="bce", base_model="SASRec", train_type="Ada-Ranker",
                             n_layers=1, n_heads=2, inner_size=128, use_fused_attention=1,
                             use_fused_ffn=1),
}


@pytest.mark.parametrize("name", sorted(CF_RANK_MODELS))
def test_cf_and_rank_models_on_the_card_match_the_cpu(cuda, name):
    """Each model with the same weights and batch on the card (its kernels:
    row 6 under every masked gather, rows 10-13 in BST and the SASRec
    AdaRanker) and on the CPU (the plain versions), f32, dropout 0:
    predict, the loss at train=False and every gradient, each within 1e-4
    of its leaf's largest (a leaf whose exact gradient is zero of its
    partner's: a key bias of its query bias, FiLM's shift under the SASRec
    base's LayerNorm of FiLM's scale); the row 6 launches rise (FM's
    none)."""
    from unirec_tpu_torch import config as torch_config
    from unirec_tpu_torch.ops import scatter_accum as SA
    from unirec_tpu_torch.utils.registry import get_model_class
    model_name = name.split("-")[0]
    args = dict(dict(n_users=200, n_items=500, embedding_size=64, max_seq_len=10,
                     compute_dtype="float32", vmem_embedding_grad=1, hidden_dropout_prob=0.0,
                     attn_dropout_prob=0.0, dropout_prob=0.0, model=model_name),
                **CF_RANK_MODELS[name])
    cfg = torch_config.parse_arguments(args, argv=[], device="cpu")
    rng = np.random.default_rng(0)
    B, G, L = 64, 21, int(cfg["max_seq_len"])
    seq = rng.integers(1, 500, (B, L))
    seq[:8, :L // 2] = 0
    label = np.zeros((B, G), np.float32)
    label[:, 0] = 1.0
    batch = {"user_id": rng.integers(1, 200, B), "item_id": rng.integers(1, 500, (B, G)),
             "label": label, "weight": np.ones(B, np.float32), "item_seq": seq,
             "item_seq_len": (seq != 0).sum(1), "index_list": rng.integers(0, 300, (B, G, 5)),
             "value_list": rng.random((B, G, 5)).astype(np.float32)}
    if model_name == "MultiVAE":
        batch["item_id"] = batch["item_id"][:, 0]
    models, outs = [], []
    for dev in ("cpu", cuda):
        m = get_model_class(model_name)(cfg)
        m.init_weights(torch.Generator().manual_seed(3))
        m.to(dev)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        n0 = SA.scatter_add_rows.launches
        with torch.no_grad():
            pred = m.predict(tb).float().cpu()
        loss, _ = m(tb, train=False)
        params = list(m.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        outs.append((pred, float(loss.detach()), [g.float().cpu() for g in grads],
                     SA.scatter_add_rows.launches - n0))
    (p0, l0, g0, s0), (p1, l1, g1, s1) = outs
    assert s0 == 0 and (s1 == 0 if model_name == "FM" else s1 > 0)
    assert _rel(p1, p0) <= 1e-4
    assert abs(l1 - l0) <= 1e-4 * max(1.0, abs(l0))
    names = [n for n, _ in m.named_parameters()]
    scale = {n: float(g.abs().max()) for n, g in zip(names, g0)}
    for n, a, b in zip(names, g1, g0):
        ref = scale[n.replace("key.bias", "query.bias").replace(
            "film_affine_emb_bias", "film_affine_emb_scale")]
        assert float((a - b).abs().max()) <= 1e-4 * max(ref, 1e-6), n


# ------------------------------------------------------- the solver models
def _solver_graph(U=600, N=300, density=0.05, seed=0):
    import scipy.sparse as ssp
    rng = np.random.default_rng(seed)
    return ssp.csr_matrix((rng.random((U, N)) < density).astype(np.float64))


def _solved_matrix(name, graph, device, **over):
    from unirec_tpu_torch.models import solvers as SV
    model = getattr(SV, name)({"n_users": graph.shape[0], "n_items": graph.shape[1],
                               "epochs": 10, **over}).to(device)
    model.solve(graph)
    return model, (model.user_similarity if name == "UserCF" else model.item_similarity)


@pytest.mark.parametrize("over", [{}, {"solver_device_inverse_max": 64,
                                       "solver_inverse_block": 48}], ids=["lu", "blocked"])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_solvers_on_the_card_match_the_cpu(cuda, name, over):
    """Each solver's matrix on the card against the port's CPU run, by its
    largest entry (f32 both; the iterations of AdmmSLIM and SLIM carry the
    roundings of another summation order); its scores too."""
    graph = _solver_graph()
    model, got = _solved_matrix(name, graph, cuda, **over)
    _, want = _solved_matrix(name, graph, "cpu", **over)
    assert got.device.type == "cuda"
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    assert rel <= SOLVER_TOL[name], rel
    batch = {"user_id": torch.arange(20, device=cuda),
             "item_id": torch.arange(60, device=cuda).reshape(20, 3)}
    assert model.predict(batch).shape == (20, 3)


def test_solvers_run_in_full_f32_under_tf32(cuda):
    """With TF32 on in the caller's process, EASE's Gram, inverse and finish
    still run in f32 (the result equals the TF32-off one to 1e-5 of its
    largest entry), and the caller's setting is back after the solve."""
    graph = _solver_graph(U=2000, N=600, density=0.1)
    _, ref = _solved_matrix("EASE", graph, cuda, solver_device_inverse_max=256,
                            solver_inverse_block=128)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, got = _solved_matrix("EASE", graph, cuda, solver_device_inverse_max=256,
                                solver_inverse_block=128)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


def test_solver_user_rows_on_the_card_are_the_graphs(cuda):
    from unirec_tpu_torch.models import solvers as SV
    graph = _solver_graph()
    rows = SV._DeviceCSR(graph, cuda)
    ids = torch.tensor([0, 5, 5, 599, 17], device=cuda)
    np.testing.assert_array_equal(rows.gather(ids).cpu().numpy(),
                                  graph[ids.cpu().numpy()].toarray())
    np.testing.assert_array_equal(rows.dense(3, 40).cpu().numpy(), graph[3:40].toarray())


# --------------------------------------------------- the unirec::* operators
def _op_case(dev, name, dtype):
    """(operator arguments, the plain version's output(s)) on ``dev``."""
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import ffn as FF
    g = torch.Generator(device=dev).manual_seed(7)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    if name in ("layer_fwd", "lastq_fwd"):
        x, madd, params = layer_case(dev, dtype, seed=3)
        xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
        if name == "layer_fwd":
            flat = LY._layer_weights(params, dtype)
            act = LY.SUPPORTED_ACTS.index("swish")
            return ((xp, mp, list(flat), 2, act, True, 1e-10, *LY.NO_DROP),
                    LY._layer_fwd_plain(xp, mp, flat, 2, "swish", 1e-10, True))
        flat = LY._lastq_weights(params, dtype)
        act = LY.SUPPORTED_ACTS.index("gelu")
        return ((xp, mp, list(flat), 8, 2, act, 1e-10, *LY.NO_DROP),
                LY._lastq_fwd_plain(xp, mp, flat, 8, 2, "gelu", 1e-10))
    if name == "ffn_fwd":
        x, w1, w2 = rn(300, 64).to(dtype), (rn(64, 128) * 0.1).to(dtype), \
            (rn(128, 64) * 0.1).to(dtype)
        b1, b2 = (rn(128) * 0.1).to(dtype), (rn(64) * 0.1).to(dtype)
        return ((x, w1, b1, w2, b2, FF.ACTS.index("swish")),
                FF._fwd_plain(x, w1, b1, w2, b2, "swish"))
    L = 256 if name == "flash_fwd" else 40
    q, k, v = (rn(4, 2, L, 32).to(dtype) for _ in range(3))
    mask = torch.where(rn(4, 1, L, L) > 1.5, -1e4, 0.0)
    if name == "flash_fwd":
        return (q, k, v, mask), AT._flash_fwd_plain(q, k, v, mask)
    return (q, k, v, mask, 0, 0, 1.0), AT._fwd_plain(q, k, v, mask)


OP_COUNTERS = {"layer_fwd": ("fused_transformer_layer", LY), "lastq_fwd":
               ("fused_last_query_layer", LY), "attention_fwd": ("fused_attention", None),
               "flash_fwd": ("flash_attention", None), "ffn_fwd": ("fused_ffn", None)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(OP_COUNTERS))
def test_unirec_operator_cuda_launches_its_kernel(cuda, name, dtype):
    """Each operator's CUDA implementation is its kernel's launch (the
    wrapper's counter rises by one) and agrees with the plain version."""
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import ffn as FF
    counter = getattr({"fused_attention": AT, "flash_attention": AT, "fused_ffn": FF}.get(
        OP_COUNTERS[name][0], LY), OP_COUNTERS[name][0])
    args, ref = _op_case(cuda, name, dtype)
    before = counter.launches
    got = getattr(torch.ops.unirec, name)(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    outs, refs = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for o, r in zip(outs, refs):
        tol = LN_TOL[dtype_name(dtype)] if o.dtype == dtype else 1e-3   # flash's lse is f32
        assert o.shape == r.shape and o.dtype == r.dtype
        assert float((o.float() - r.float()).abs().max()) <= tol * max(1.0, float(
            r.float().abs().max()) if name == "ffn_fwd" else 1.0)


def _port_checkpoint(path, **over):
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint
    from unirec_tpu_torch.utils.flax_bridge import to_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = config_mod.parse_arguments(dict(dict(
        model="SASRec", n_users=500, n_items=1000, max_seq_len=50, embedding_size=64,
        hidden_size=64, inner_size=128, n_heads=2, n_layers=2, dataloader="SeqRecDataset",
        hidden_act="swish", compute_dtype="bfloat16", last_query_only=1, fused_layer=1,
        fused_lastq=1), **over), argv=[], device="cuda")
    model = get_model_class("SASRec")(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    save_checkpoint(str(path), {"config": cfg, "params": to_flax_params(model)})
    return str(path)


def _serving_ids(B, L=50, n_items=1000, seed=5):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, n_items, size=(B, L)).astype(np.int32)
    seq[0, :30] = 0
    return (np.arange(1, B + 1, dtype=np.int32), seq, (seq != 0).sum(1).astype(np.int32))


def test_exported_fused_program_on_the_card(cuda, tmp_path):
    """A fused_layer/fused_lastq checkpoint's user_emb.pt2 on the card: rows
    1 and 3 launch on their tensor-core bodies, and the output agrees with
    the live model and with the plain versions (two bf16 ulps)."""
    from unittest import mock

    from unirec_tpu_torch.serving.export import ServeFunction, ServingModel, export_model
    from unirec_tpu_torch.utils.checkpoint import load_model_freely
    ckpt = _port_checkpoint(tmp_path / "ck.pkl")
    man = export_model(ckpt, str(tmp_path / "art"), atol=2.0 ** -4, device="cuda")
    assert man["functions"]["user_emb"]["custom_ops"] == ["unirec::lastq_fwd",
                                                         "unirec::layer_fwd"]
    serve = ServingModel(str(tmp_path / "art"))
    ids = _serving_ids(64)
    n0 = (LY.fused_transformer_layer.launches_mma, LY.fused_last_query_layer.launches_mma)
    got = torch.as_tensor(serve.user_emb(*ids))
    assert (LY.fused_transformer_layer.launches_mma, LY.fused_last_query_layer.launches_mma) \
        == (n0[0] + 1, n0[1] + 1)
    model, _ = load_model_freely(ckpt, "cuda")
    t = [torch.as_tensor(a, device=cuda) for a in ids]
    with torch.no_grad():
        live = ServeFunction(model, "user_emb")(*t).float().cpu()
        with mock.patch.object(LY, "_layer_fwd_cuda", LY._layer_fwd_plain), \
                mock.patch.object(LY, "_lastq_fwd_cuda", LY._lastq_fwd_plain):
            plain = ServeFunction(model, "user_emb")(*t).float().cpu()
    tol = ln_tol(plain)
    assert float((got - live).abs().max()) <= tol
    assert float((got - plain).abs().max()) <= tol


def test_cpp_client_serves_rows_1_and_3_on_the_card(cuda, tmp_path):
    """The C++ client (built against the installed libtorch with CUDA) on an
    AOTInductor package of the fused checkpoint's user_emb at batch 16:
    its shims launch rows 1 and 3 (tensor-core bodies) once a call each, and
    its output equals the .pt2 program's."""
    from unirec_tpu_torch.serving.cpp import build as CB
    from unirec_tpu_torch.serving.export import ServingModel, export_model
    ckpt = _port_checkpoint(tmp_path / "ck.pkl")
    export_model(ckpt, str(tmp_path / "art"), aoti=["user_emb"], aoti_batch=16,
                 atol=2.0 ** -4, device="cuda")
    build = CB.build_client()
    assert build["cuda"]
    ids = _serving_ids(16)
    res = CB.run_client(build["binary"], tmp_path / "art" / "user_emb.aoti.pt2", ids,
                        libs=CB.kernel_libs(), repeat=2)
    assert res["device"] == "cuda" and res["calls"] == 3
    for op in ("unirec::layer_fwd", "unirec::lastq_fwd"):
        assert res["launches"][op] == 3 and res["launches_mma"][op] == 3
    ref = ServingModel(str(tmp_path / "art")).user_emb(*ids)
    assert float(np.abs(res["outputs"][0] - ref).max()) <= ln_tol(torch.as_tensor(ref))


# the entry configuration (rows 10 and 12) and the long one (rows 9 and 12)
CLIENT_PACKAGES = {
    "entry": (dict(last_query_only=1, fused_layer=0, fused_lastq=0, use_fused_attention=1,
                   use_fused_ffn=1), 50, ("unirec::attention_fwd", "unirec::ffn_fwd")),
    "long": (dict(max_seq_len=256, fused_layer=0, fused_lastq=0, use_fused_attention=0,
                  use_pallas=1, use_fused_ffn=1, attn_dropout_prob=0.0), 256,
             ("unirec::flash_fwd", "unirec::ffn_fwd")),
}


@pytest.mark.parametrize("which", sorted(CLIENT_PACKAGES))
def test_cpp_client_serves_the_entry_and_long_packages(cuda, tmp_path, which):
    """The C++ client on a ``score`` AOTInductor package at batch 16 of the
    entry checkpoint (fused attention and FFN) and of the long one (flash
    attention at L=256 and the fused FFN): its shims launch each of the
    package's rows once a layer a call, on the tensor-core bodies the Python
    launchers pick, and its output equals the .pt2 program's (two bf16
    ulps of the largest score, or 0.03)."""
    from unirec_tpu_torch.serving.cpp import build as CB
    from unirec_tpu_torch.serving.export import ServingModel, export_model
    over, L, ops = CLIENT_PACKAGES[which]
    ckpt = _port_checkpoint(tmp_path / "ck.pkl", **over)
    man = export_model(ckpt, str(tmp_path / "art"), aoti=["score"], aoti_batch=16,
                       atol=2.0 ** -4, device="cuda")
    assert man["functions"]["score"]["aoti"]["custom_ops"] == sorted(ops)
    build = CB.build_client()
    users, seq, lens = _serving_ids(16, L=L)
    cands = np.random.default_rng(7).integers(1, 1000, (16, 32)).astype(np.int32)
    ids = (users, seq, lens, cands)
    res = CB.run_client(build["binary"], tmp_path / "art" / "score.aoti.pt2", ids,
                        libs=CB.kernel_libs(), repeat=2)
    assert res["device"] == "cuda" and res["calls"] == 3
    # the last-query layer runs plain attention; the FFN runs in both layers
    per_call = {"unirec::attention_fwd": 1, "unirec::flash_fwd": 1, "unirec::ffn_fwd": 2}
    for op in ops:
        assert res["launches"][op] == 3 * per_call[op], (op, res["launches"])
        assert res["launches_mma"][op] == res["launches"][op], (op, res["launches_mma"])
    ref = ServingModel(str(tmp_path / "art")).score(*ids)
    assert float(np.abs(res["outputs"][0] - ref).max()) <= ln_tol(torch.as_tensor(ref))


def test_flash_body_rule_is_the_library_rule(cuda):
    """ops/attention.py::_flash_body against csrc/flash_attention.cu's
    unirec_flash_fwd_mma_takes, which the C++ client's shim reads."""
    from unirec_tpu_torch.ops import attention as AT
    fn = _build.library("flash_attention").unirec_flash_fwd_mma_takes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for hd in (8, 32, 64, 128, 136, 256):
            assert bool(fn(code, hd)) == (AT._flash_body(dtype, hd) == "mma"), (dtype, hd)


@pytest.mark.parametrize("variant", ["scan", "sorted", "expand", "cast"])
def test_embedding_gradient_variant_on_the_card_matches_the_cpu(cuda, variant):
    """ops/embedding.py's gathers on CUDA tensors (plain torch ops, as XLA in
    the JAX package): the rows and the table gradient of 1.6M ids (bench.py's
    item_seq: a fifth padding, whose rows the model's mask zeroes) into a
    50,000 x 64 table, bf16 compute, against the same function on the CPU:
    the rows exactly, the gradient within 1e-5 of its largest entry (f32
    sums in another order) or, for the bf16 sums of ``expand`` (about 7
    rows a slot, each addition rounded to bf16, in another order on the
    card), eight bf16 ulps of it."""
    from unirec_tpu_torch.ops import embedding as E
    fns = {"scan": lambda t, i: E.gather_scan(t, i, torch.bfloat16),
           "sorted": lambda t, i: E.gather_sorted(t, i),
           "expand": lambda t, i: E.gather_expand(t.to(torch.bfloat16), i, 4),
           "cast": lambda t, i: E.gather_cast(t, i, torch.bfloat16)}
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 50_000, (32768, 50))
    ids[:, :10] = 0
    table = rng.normal(size=(50_000, 64)).astype(np.float32)
    g = rng.normal(size=ids.shape + (64,)).astype(np.float32) * (ids != 0)[..., None]
    out = {}
    for dev in ("cpu", cuda):
        t = torch.from_numpy(table).to(dev).requires_grad_(True)
        rows = fns[variant](t, torch.from_numpy(ids.astype(np.int32)).to(dev))
        rows.backward(torch.from_numpy(g).to(dev, rows.dtype))
        out[str(dev)] = (rows.detach().float().cpu(), t.grad.float().cpu())
    (rc, gc), (rg, gg) = out["cpu"], out["cuda"]
    assert torch.equal(rc, rg)
    tol = (2.0 ** -5 if variant == "expand" else 1e-5) * float(gc.abs().max())
    err = float((gg - gc).abs().max())
    assert err <= tol, (err, tol)


def test_morec_gram_on_the_card_matches_the_cpu(cuda):
    """MoRec's loss vector and the Gram of its 4 per-objective gradients
    (4 backward passes) for MF on the card against the CPU, 1e-4 of the
    largest entry; row 6 launches once for each table in each backward."""
    from types import SimpleNamespace

    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.facility.morec import integration as TI
    from unirec_tpu_torch.ops import scatter_accum as SA
    from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = config_mod.parse_arguments(dict(model="MF", n_users=300, n_items=500,
                                          embedding_size=64, has_user_emb=1, loss_type="bpr",
                                          compute_dtype="float32"), argv=[], device="cuda")
    rng = np.random.default_rng(3)
    batch = {"user_id": rng.integers(1, 300, 256).astype(np.int32),
             "item_id": rng.integers(1, 500, (256, 10)).astype(np.int32),
             "label": np.tile(np.eye(1, 10, dtype=np.float32), (256, 1)),
             "weight": np.ones(256, np.float32)}
    out = {}
    cpu_model = get_model_class("MF")(cfg)
    cpu_model.init_weights(torch.Generator().manual_seed(1))
    for dev in ("cpu", "cuda"):
        model = get_model_class("MF")(cfg)
        load_flax_params(model, to_flax_params(cpu_model))
        model.to(dev)
        tr = SimpleNamespace(model=model, device=torch.device(dev))
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        before = SA.scatter_add_rows.launches
        vec = TI.loss_vector(tr, b, 0, 4)
        G = TI.gram(TI.objective_grads(list(model.parameters()), vec))
        torch.cuda.synchronize()
        out[dev] = (vec.detach().cpu(), G.cpu(), SA.scatter_add_rows.launches - before)
    (vc, gc, _), (vg, gg, launched) = out["cpu"], out["cuda"]
    assert float((vg - vc).abs().max()) <= 1e-4 * float(vc.abs().max())
    assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max())
    assert launched == 4 * 2


# ------------------------------------------------------------- distribution
@pytest.mark.parametrize("which", ["layer", "lastq"])
def test_dropout_is_keyed_by_the_global_example(cuda, which):
    """A data-parallel rank's rows [16, 32) launched with b0 = 16 draw the
    masks rows 16-31 draw in the whole batch's launch (rows 1-4, bf16 on
    the tensor cores, dropout 0.1), forward and backward, bit for bit; the
    plain version, keyed alike, agrees within _ln_tol."""
    x, madd, params = layer_case(cuda, torch.bfloat16, B=32, L=50, D=64, F=128, seed=7)
    xp, mp, _ = LY._pad_L(x, madd, x.shape[1])
    drop = _drop(0.1, 4242)
    part = drop._replace(b0=16)
    g = torch.Generator(device=cuda).manual_seed(8)
    dy_full = torch.randn(xp.shape if which == "layer" else (32, 64), generator=g,
                          device=cuda).to(torch.bfloat16)
    if which == "layer":
        flat = LY._layer_weights(params, torch.bfloat16)
        args = (2, "swish", 1e-10, True)
        fwd, bwd, plain = LY._layer_fwd_cuda, LY._layer_bwd_cuda, LY._layer_fwd_plain
    else:
        flat = LY._lastq_weights(params, torch.bfloat16)
        args = (49, 2, "swish", 1e-10)
        fwd, bwd, plain = LY._lastq_fwd_cuda, LY._lastq_bwd_cuda, LY._lastq_fwd_plain
    whole = fwd(xp, mp, flat, *args, drop)
    rows = fwd(xp[16:].contiguous(), mp[16:].contiguous(), flat, *args, part)
    assert torch.equal(rows, whole[16:])
    ref = plain(xp[16:].contiguous(), mp[16:].contiguous(), flat, *args, part)
    assert float((rows.float() - ref.float()).abs().max()) <= ln_tol(ref)
    other = fwd(xp[16:].contiguous(), mp[16:].contiguous(), flat, *args, drop)
    assert not torch.equal(other, whole[16:])      # b0 = 0 draws rows 0-15's masks
    dx_whole = bwd(xp, mp, flat, dy_full, *args, drop)[0]
    dx_rows = bwd(xp[16:].contiguous(), mp[16:].contiguous(), flat,
                  dy_full[16:].contiguous(), *args, part)[0]
    assert torch.equal(dx_rows, dx_whole[16:])


@pytest.mark.parametrize("dtype,L", [(torch.bfloat16, 50), (torch.float32, 50),
                                     (torch.float32, 300)])
def test_fused_attention_dropout_is_keyed_by_the_global_example(cuda, dtype, L):
    """Rows 10 and 11 (the tensor-core, whole and tiled bodies): a rank's
    examples [3, 6) launched with b0 = 3 draw the masks they draw in the
    whole batch's launch, forward and backward, bit for bit; b0 = 0 draws
    examples 0-2's."""
    from unirec_tpu_torch.ops import attention as AT
    q, k, v, mask = att_case(cuda, dtype, B=6, L=L, seed=5)
    drop = LY.drop_params(0.2, 0.0, True, 4343)
    part = drop._replace(b0=3)
    do = torch.randn_like(q.float()).to(dtype)
    rows = lambda t: t[3:].contiguous()  # noqa: E731
    whole = AT._fwd_cuda(q, k, v, mask, drop)
    got = AT._fwd_cuda(rows(q), rows(k), rows(v), rows(mask), part)
    assert torch.equal(got, whole[3:])
    assert not torch.equal(AT._fwd_cuda(rows(q), rows(k), rows(v), rows(mask), drop),
                           whole[3:])
    for a, b in zip(AT._bwd_cuda(rows(q), rows(k), rows(v), rows(mask), rows(do), part),
                    AT._bwd_cuda(q, k, v, mask, do, drop)):
        assert torch.equal(a, b[3:])


def test_sharded_topk_launches_blockmax_per_shard_and_matches_plain(cuda):
    """4 logical shards of a 50,002-item bf16 catalog (2 padded rows in the
    last): one blockmax launch a shard on the tensor-core body, the same
    ids as through the plain version and as the unsharded fused top-k."""
    from unittest import mock
    g = torch.Generator(device=cuda).manual_seed(5)
    u = torch.randn(256, 64, generator=g, device=cuda).to(torch.bfloat16)
    items = (torch.randn(50_002, 64, generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    table, _ = TK.place_item_table(items, 4)
    before = TK.catalog_blockmax.launches_mma
    v, ids = TK.sharded_catalog_topk(u, table, 100, n_real=50_002, n_shards=4)
    assert TK.catalog_blockmax.launches_mma == before + 4
    with mock.patch.object(TK, "_blockmax_cuda", TK._blockmax_plain):
        pv, pids = TK.sharded_catalog_topk(u, table, 100, n_real=50_002, n_shards=4)
    assert torch.equal(ids.sort(1).values, pids.sort(1).values)
    whole = TK.fused_catalog_topk(u, items, 100)[1]
    assert torch.equal(ids.sort(1).values, whole.sort(1).values)
    assert int(ids.max()) < 50_002


def test_world_size_one_train_step_matches_plain(cuda, tmp_path):
    """A train step in an NCCL group of one at mesh_data=1 (the
    distributed branch: the all-reduce of gradients and loss, global
    denominators, the row offset) launches rows 1-4, 6 and 8, and its loss
    and updated weights agree with the same step through the plain
    versions (BWD_TOL, bf16)."""
    import datetime
    import socket
    from unittest import mock

    import torch.distributed as dist

    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter
    from unirec_tpu_torch.data.history import UserHistory
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.ops import member as MB, scatter_accum as SA
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.utils.registry import get_model_class
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("cuda:nccl,cpu:gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        rng = np.random.default_rng(0)
        lens = rng.integers(5, 40, 500).astype(np.int32)
        hist = np.zeros((500, 40), np.int32)
        m = np.arange(40)[None] < lens[:, None]
        hist[m] = rng.integers(1, 2000, int(m.sum()))
        cfg = config_mod.parse_arguments(dict(
            model="SASRec", n_users=500, n_items=2000, max_seq_len=50, embedding_size=64,
            hidden_size=64, inner_size=128, n_layers=2, n_heads=2, loss_type="bce",
            n_sample_neg_train=9, dataloader="SeqRecDataset",
            history_mask_mode="autoregressive", compute_dtype="bfloat16",
            last_query_only=1, fused_layer=1, fused_lastq=1, vmem_embedding_grad=1,
            neg_membership_pallas=1, hidden_dropout_prob=0.1, attn_dropout_prob=0.1,
            mesh_data=1, output_path=str(tmp_path)), argv=[], device="cuda")
        raw = to_device({"user_id": rng.integers(1, 500, 512).astype(np.int32),
                         "item_id": rng.integers(1, 2000, 512).astype(np.int32),
                         "weight": np.ones(512, np.float32)}, cuda)
        out = {}
        for kind in ("kernels", "plain"):
            tr = Trainer(cfg, get_model_class("SASRec")(cfg), device="cuda")
            assert tr.mesh.distributed and tr.mesh.n_data == 1
            tr.set_device_augmenter(DeviceAugmenter(cfg, UserHistory(hist, lens),
                                                    device="cuda"))
            tr.init_params()
            counts = (LY.layer_bwd.launches, LY.lastq_bwd.launches,
                      SA.scatter_add_rows.launches, MB.member_mask.launches)
            patches = [mock.patch.object(LY, f"_{n}_cuda", getattr(LY, f"_{n}_plain"))
                       for n in ("layer_fwd", "lastq_fwd", "layer_bwd", "lastq_bwd")] + [
                mock.patch.object(SA, "_scatter_cuda", SA._scatter_plain),
                mock.patch.object(MB, "_member_cuda", MB._member_plain)] \
                if kind == "plain" else []
            for p in patches:
                p.start()
            try:
                loss = float(tr.train_step(raw))
            finally:
                for p in patches:
                    p.stop()
            launched = [a - b for a, b in zip((LY.layer_bwd.launches, LY.lastq_bwd.launches,
                                               SA.scatter_add_rows.launches,
                                               MB.member_mask.launches), counts)]
            out[kind] = (loss, [p.detach().float().clone() for p in tr.params], launched)
        (lk, pk, nk), (lp, pp, npl) = out["kernels"], out["plain"]
        assert all(n > 0 for n in nk) and not any(npl)
        assert abs(lk - lp) <= BWD_TOL["bfloat16"] * abs(lp)
        for a, b in zip(pk, pp):
            assert _rel_err(a, b) <= BWD_TOL["bfloat16"]
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- HSTU's attention
def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("L", [24, 200, 256, 512])
@pytest.mark.parametrize("dqk,dv", [(25, 25), (32, 32), (64, 64), (32, 16)])
def test_hstu_attention_matches_plain(cuda, L, dqk, dv):
    """The tensor-core kernels against the plain versions on the same bf16
    tensors: the output and dq, dk, dv within 2e-2 of each one's largest
    plain value (bf16 operands rounded where the plain versions round them,
    sums in another order, so a rounding may flip), the table's f32
    gradient within 1e-4; padding rows come out zero."""
    from unirec_tpu_torch.ops import hstu_attention as HA
    q, k, v, rab, keys, go = hstu_case(cuda, 6 if L <= 256 else 3, L, 2, dqk, dv)
    before = (HA.hstu_attention.launches_mma, HA.hstu_attention_bwd.launches_mma)
    out = HA.hstu_attention_fwd(q, k, v, rab, keys)
    dq, dk, dvv, drab = HA.hstu_attention_bwd(q, k, v, rab, keys, go)
    assert (HA.hstu_attention.launches_mma, HA.hstu_attention_bwd.launches_mma) == \
        (before[0] + 1, before[1] + 1)
    want = HA._fwd_plain(q, k, v, rab, keys)
    wq, wk, wv, wrab = HA._bwd_plain(q, k, v, rab, keys, go)
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    for got, exp in ((out, want), (dq, wq), (dk, wk), (dvv, wv)):
        assert torch.isfinite(got.float()).all() and _rel(got, exp) <= 2e-2
    assert _rel(drab, wrab) <= 1e-4
    assert not out[0].any() and not dq[0].any() and not dk[0].any() and not dvv[0].any()


def test_hstu_attention_autograd_and_determinism(cuda):
    """Through the autograd.Function: gradients equal the direct backward
    call's bit for bit, twice (sums in a fixed order, no atomics)."""
    from unirec_tpu_torch.ops import hstu_attention as HA
    q, k, v, rab, keys, go = hstu_case(cuda, 16, 200, 2, 25, 25, seed=1)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, rab)]
    for _ in range(2):
        out = HA.hstu_attention(*leaves, keys)
        got = torch.autograd.grad(out, leaves, go)
        want = HA.hstu_attention_bwd(q, k, v, rab, keys, go)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_hstu_attention_stores_no_pair_tensor(cuda):
    """At B = 2,048, L = 200, two heads of 25 the [B, H, L, L] f32 scores
    would take 655 MB; the forward allocates its output and the backward
    its three gradients and the per-block partial tables, nothing more."""
    from unirec_tpu_torch.ops import hstu_attention as HA
    B, L, H, hd = 2048, 200, 2, 25
    q, k, v, rab, keys, go = hstu_case(cuda, B, L, H, hd, hd, seed=2)
    HA.hstu_attention_bwd(q, k, v, rab, keys, go)       # built, and the workspace sized
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = HA.hstu_attention_fwd(q, k, v, rab, keys)
    grads = HA.hstu_attention_bwd(q, k, v, rab, keys, go)
    torch.cuda.synchronize()
    io = B * L * H * hd * 2
    assert torch.cuda.max_memory_allocated() - base <= 4 * io + (16 << 20)
    del out, grads


def test_hstu_attention_refuses_what_the_kernels_do_not_take(cuda):
    """On the card f32 operands, L past 512 and head widths past 64 raise a
    ValueError, forward and backward, before anything is launched; nothing
    falls back to the plain version."""
    from unirec_tpu_torch.ops import hstu_attention as HA
    before = (HA.hstu_attention.launches_plain, HA.hstu_attention_bwd.launches_plain)
    q, k, v, rab, keys, go = hstu_case(cuda, 2, 24, 2, 25, 25)
    with pytest.raises(ValueError, match="bf16"):
        HA.hstu_attention_fwd(q.float(), k.float(), v.float(), rab, keys)
    with pytest.raises(ValueError, match="bf16"):
        HA.hstu_attention_bwd(q.float(), k.float(), v.float(), rab, keys, go)
    for L, hd in ((520, 16), (24, 65)):
        q, k, v, rab, keys, go = hstu_case(cuda, 1, L, 1, hd, hd)
        with pytest.raises(ValueError, match="capacity"):
            HA.hstu_attention_fwd(q, k, v, rab, keys)
        with pytest.raises(ValueError, match="capacity"):
            HA.hstu_attention_bwd(q, k, v, rab, keys, go)
    assert (HA.hstu_attention.launches_plain, HA.hstu_attention_bwd.launches_plain) == before


def test_hstu_model_on_the_card_launches_the_kernels_and_refuses_f32(cuda):
    """A training step of a small HSTU in bf16 on the card runs every layer's
    attention on the tensor-core kernels (none on the plain version), and
    its loss agrees with the same model's in f32 on the CPU within bf16's
    rounding; in f32 on the card the model raises (the kernels take bf16
    alone, and nothing falls back)."""
    from unirec_tpu_torch import config
    from unirec_tpu_torch.models.modules import DropoutRNG
    from unirec_tpu_torch.ops import hstu_attention as HA
    from unirec_tpu_torch.utils.registry import get_model_class
    base = dict(model="HSTU", n_users=100, n_items=500, max_seq_len=200, embedding_size=50,
                hidden_size=50, n_layers=3, n_heads=2, loss_type="softmax",
                n_sample_neg_train=16, distance_type="cosine", tau=0.05, hidden_dropout_prob=0.0)
    g = torch.Generator(device=cuda).manual_seed(3)
    lens = torch.randint(0, 201, (64,), generator=g, device=cuda)
    seq = torch.randint(1, 500, (64, 200), generator=g, device=cuda) \
        * (torch.arange(200, device=cuda)[None] >= 200 - lens[:, None])
    label = torch.zeros(64, 17, device=cuda)
    label[:, 0] = 1
    batch = {"item_seq": seq, "item_id": torch.randint(1, 500, (64, 17), generator=g,
                                                       device=cuda), "label": label}

    def model_on(device, dtype):
        cfg = config.parse_arguments(dict(base, compute_dtype=dtype), argv=[], device=device)
        model = get_model_class("HSTU")(cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        return model.to(device)

    model = model_on("cuda", "bfloat16")
    before = (HA.hstu_attention.launches_mma, HA.hstu_attention.launches_plain,
              HA.hstu_attention_bwd.launches_mma, HA.hstu_attention_bwd.launches_plain)
    loss, _ = model(batch, train=True, rng=DropoutRNG(0, cuda))
    loss.backward()
    after = (HA.hstu_attention.launches_mma, HA.hstu_attention.launches_plain,
             HA.hstu_attention_bwd.launches_mma, HA.hstu_attention_bwd.launches_plain)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 0, 3, 0)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    cpu = model_on("cpu", "float32")
    want, _ = cpu({n: t.cpu() for n, t in batch.items()}, train=True,
                  rng=DropoutRNG(0, "cpu"))
    assert abs(float(loss) - float(want)) <= 5e-2 * abs(float(want))
    with pytest.raises(ValueError, match="bf16"):
        model_on("cuda", "float32")(batch, train=True, rng=DropoutRNG(0, cuda))


# ------------------------------------------------------- Adam (csrc/adam.cu)
def _clone_state(params, state):
    return [p.clone() for p in params], {k: [t.clone() for t in v] if isinstance(v, list)
                                         else v.clone() for k, v in state.items()}


def _bits(ts):
    return [t.view(torch.int32).clone() for t in ts]


ADAM_CASES = [("adam", 0.0, -1.0), ("adam", 0.01, 0.5), ("adamw", 0.01, -1.0),
              ("sparse_adam", 0.01, 0.05)]


@pytest.mark.parametrize("kind,wd,clip", ADAM_CASES)
def test_adam_kernel_matches_the_plain_path_at_the_sasrec_d64_leaves(cuda, kind, wd, clip):
    """Three updates of the 36 leaves of sasrec_d64_l50 through the kernel
    and through the plain path on the card, from one state: every leaf's
    params, mu and nu within 2 f32 ulps of the plain ones, each leaf on its
    own (the small ones, biases and LayerNorm scales, among them), and the
    same count; one launch an update."""
    from unirec_tpu_torch.core import optim
    from unirec_tpu_torch.ops import adam as A
    shapes = cell_leaf_shapes("sasrec_d64_l50")
    assert len(shapes) == 36 and len(shapes) <= A.max_leaves()
    opt = optim.build_optimizer({"optimizer": kind, "learning_rate": 1e-3,
                                 "weight_decay": wd, "grad_clip_value": clip})
    kp, ks = adam_state(opt, cuda, shapes, seed=5)
    pp, ps = _clone_state(kp, ks)
    g = torch.Generator(device=cuda).manual_seed(6)
    before = A.adam_step.launches_fused
    for step in range(3):
        grads = [torch.randn(*s, generator=g, device=cuda) * 1e-3 for s in shapes]
        loss = torch.tensor(0.5, device=cuda)
        opt.step_(grads, ks, kp, loss)
        pp, ps = guarded_update(opt, grads, ps, pp, loss)
    torch.cuda.synchronize()
    assert A.adam_step.launches_fused == before + 3
    assert int(ks["count"]) == int(ps["count"]) == 7
    worst = {}
    for i, s in enumerate(shapes):
        for what, a, b in (("p", kp[i], pp[i]), ("mu", ks["mu"][i], ps["mu"][i]),
                           ("nu", ks["nu"][i], ps["nu"][i])):
            worst[(i, s, what)] = f32_ulps(a, b)
    bad = {k: v for k, v in worst.items() if not v <= 2.0}
    assert not bad, bad


def test_adam_kernel_writes_nothing_when_the_loss_is_not_finite(cuda):
    """A NaN or infinite loss leaves params, mu, nu and count bit-equal; the
    next finite update moves them (the ticket is whole again)."""
    from unirec_tpu_torch.core import optim
    opt = optim.build_optimizer({"optimizer": "adam", "learning_rate": 1e-3})
    shapes = cell_leaf_shapes("sasrec_d64_l50")
    params, state = adam_state(opt, cuda, shapes, seed=7)
    grads = [torch.randn(*s, device=cuda) for s in shapes]
    for bad in (float("nan"), float("inf"), float("-inf")):
        old = _bits(params), _bits(state["mu"]), _bits(state["nu"]), int(state["count"])
        opt.step_(grads, state, params, torch.tensor(bad, device=cuda))
        torch.cuda.synchronize()
        for a, b in zip((_bits(params), _bits(state["mu"]), _bits(state["nu"])), old[:3]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert int(state["count"]) == old[3]
    opt.step_(grads, state, params, torch.tensor(0.5, device=cuda))
    assert int(state["count"]) == 5
    old_p = _bits(params)
    opt.step_(grads, state, params, torch.tensor(0.5, device=cuda))
    assert int(state["count"]) == 6
    assert all(not torch.equal(a, b) for a, b in zip(_bits(params), old_p))


def test_adam_kernel_takes_more_leaves_than_a_table_and_ragged_unaligned_leaves(cuda):
    """More than two tables of leaves (three launches), sizes that are not
    a multiple of 4 or of a chunk, an empty leaf, and leaves and gradients
    that start 4 bytes past a 16-byte boundary: the plain path's values
    within 2 ulps, count bumped once an update."""
    from unirec_tpu_torch.core import optim
    from unirec_tpu_torch.ops import adam as A
    n = 2 * A.max_leaves() + 5
    shapes = [(4097,), (3,), (1,), (33, 7), (0,), (4096 * 3 + 2,)] + [(64,)] * (n - 6)
    opt = optim.build_optimizer({"optimizer": "adam", "learning_rate": 1e-3})
    kp, ks = adam_state(opt, cuda, shapes, seed=8)
    buf = torch.zeros(kp[0].numel() + 1, device=cuda)        # leaf 0 on a 4-byte offset
    buf[1:].copy_(kp[0])
    kp[0] = buf[1:]
    assert kp[0].data_ptr() % 16 == 4
    pp, ps = _clone_state(kp, ks)
    g = torch.Generator(device=cuda).manual_seed(9)
    before = A.adam_step.launches_fused
    for step in range(2):
        grads = [torch.randn(*s, generator=g, device=cuda) * 1e-3 for s in shapes]
        gbuf = torch.empty(grads[3].numel() + 1, device=cuda)
        gbuf[1:].copy_(grads[3].reshape(-1))
        kgrads = list(grads)
        kgrads[3] = gbuf[1:].view(shapes[3])                # an unaligned gradient
        loss = torch.tensor(1.0, device=cuda)
        opt.step_(kgrads, ks, kp, loss)
        pp, ps = guarded_update(opt, grads, ps, pp, loss)
    torch.cuda.synchronize()
    assert A.adam_step.launches_fused == before + 2 * 3
    assert int(ks["count"]) == int(ps["count"]) == 6
    for i in range(n):
        for a, b in ((kp[i], pp[i]), (ks["mu"][i], ps["mu"][i]), (ks["nu"][i], ps["nu"][i])):
            assert f32_ulps(a, b) <= 2.0, (i, shapes[i])


def _card_trainer(tmp_path, cuda):
    """A SASRec trainer at the d=64 cell's widths on a small catalog, with
    its device pipeline, and a raw device batch."""
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter
    from unirec_tpu_torch.data.history import UserHistory
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.utils.registry import get_model_class
    rng = np.random.default_rng(0)
    lens = rng.integers(5, 40, 500).astype(np.int32)
    hist = np.zeros((500, 40), np.int32)
    m = np.arange(40)[None] < lens[:, None]
    hist[m] = rng.integers(1, 2000, int(m.sum()))
    cfg = config_mod.parse_arguments(dict(
        model="SASRec", n_users=500, n_items=2000, max_seq_len=50, embedding_size=64,
        hidden_size=64, inner_size=128, n_layers=2, n_heads=2, loss_type="bce",
        n_sample_neg_train=9, dataloader="SeqRecDataset",
        history_mask_mode="autoregressive", compute_dtype="bfloat16",
        last_query_only=1, fused_layer=1, fused_lastq=1, vmem_embedding_grad=1,
        neg_membership_pallas=1, hidden_dropout_prob=0.1, attn_dropout_prob=0.1,
        output_path=str(tmp_path)), argv=[], device="cuda")
    tr = Trainer(cfg, get_model_class("SASRec")(cfg), device="cuda")
    tr.set_device_augmenter(DeviceAugmenter(cfg, UserHistory(hist, lens), device="cuda"))
    tr.init_params()
    raw = to_device({"user_id": rng.integers(1, 500, 512).astype(np.int32),
                     "item_id": rng.integers(1, 2000, 512).astype(np.int32),
                     "weight": np.ones(512, np.float32)}, cuda)
    return tr, raw


def test_a_train_step_makes_no_host_sync(cuda, tmp_path):
    """Trainer.train_step on a device batch under
    torch.cuda.set_sync_debug_mode("error"), after two warm-up steps: no
    synchronising call anywhere in the step, the update included."""
    tr, raw = _card_trainer(tmp_path, cuda)
    for _ in range(2):
        tr.train_step(raw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [tr.train_step(raw) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(x)) for x in losses)
    assert int(tr.opt_state["count"]) == 5


def test_the_adam_counters_count_one_fused_update_a_step(cuda, tmp_path):
    """tracing.counters(): adam_fused one a step, adam_plain none on the
    card, adam_leaves 36 a step while a profiler runs and none otherwise."""
    from torch.profiler import ProfilerActivity, profile

    from unirec_tpu_torch.utils import tracing
    tr, raw = _card_trainer(tmp_path, cuda)
    tr.train_step(raw)
    before = tracing.counters()
    for _ in range(3):
        tr.train_step(raw)
    mid = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            tr.train_step(raw)
        torch.cuda.synchronize()
    after = tracing.counters()
    assert mid["adam_fused"] - before["adam_fused"] == 3
    assert after["adam_fused"] - mid["adam_fused"] == 2
    assert after["adam_plain"] == before["adam_plain"]
    assert mid["adam_leaves"] == before["adam_leaves"]
    assert after["adam_leaves"] - mid["adam_leaves"] == 2 * len(tr.params) == 72
