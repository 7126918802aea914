"""unirec_tpu_torch/ops/topk.py against the JAX package.

The port's catalog_blockmax runs its plain PyTorch version on CPU tensors;
it is held against the JAX Pallas kernel in interpret mode (rtol 1e-5, f32
reassociation). The top-k ids must EQUAL JAX's: the data are random f32
factors, so no two scores tie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirec_tpu.ops.topk as jax_topk
from unirec_tpu_torch.ops import topk as torch_topk

B, D = 8, 16


def _factors(N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32))


@pytest.mark.parametrize("quantized", [False, True])
def test_catalog_blockmax_matches_jax_kernel(quantized):
    u, items = _factors(512)
    scale = None
    if quantized:
        q, s = jax_topk.quantize_catalog(jnp.asarray(items))
        items, scale = np.asarray(q), np.asarray(s)
    ref = jax_topk.catalog_blockmax(
        jnp.asarray(u), jnp.asarray(items), 16, 128, interpret=True,
        item_scale_padded=None if scale is None else jnp.asarray(scale))
    got = torch_topk.catalog_blockmax(
        torch.from_numpy(u), torch.from_numpy(items),
        item_scale=None if scale is None else torch.from_numpy(scale))
    assert got.shape == (B, 512 // 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_catalog_blockmax_ragged_chunk_takes_real_items_only():
    u, items = _factors(50)          # 4 chunks, the last holds 2 items
    got = torch_topk.catalog_blockmax(torch.from_numpy(u), torch.from_numpy(items))
    scores = u @ items.T
    assert got.shape == (B, 4)
    np.testing.assert_allclose(got[:, 3].numpy(), scores[:, 48:].max(1), rtol=1e-6)


@pytest.mark.parametrize("D", [64, 65])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_catalog_blockmax_matches_jax_with_a_negative_ragged_chunk(kind, D):
    """The serving catalogs (bf16 or int8 items, D=64, or 65 with the item
    bias column) with a ragged last chunk whose every score is negative: the
    chunk's max is over its real items (a zero padding row would win with
    0). Held within 1e-3 of the largest block max against the interpret-mode
    JAX kernel, whose catalog is padded with copies of the last item (which
    leave every chunk's max unchanged)."""
    rng = np.random.default_rng(D)
    Bu, N = 5, 16 * 20 + 5
    u = torch.from_numpy(np.abs(rng.normal(size=(Bu, D))).astype(np.float32)).to(torch.bfloat16)
    items = rng.normal(size=(N, D)).astype(np.float32) * 0.05
    items[-5:] = -np.abs(items[-5:])             # the last chunk scores < 0 for every user
    it = torch.from_numpy(items).to(torch.bfloat16)
    scale = None
    if kind == "int8":
        it, scale = torch_topk.quantize_catalog(it)
    pad = 384 - N
    it_np = it.float().numpy() if kind == "bf16" else it.numpy()
    it_pad = np.concatenate([it_np, np.repeat(it_np[-1:], pad, 0)])
    j_items = jnp.asarray(it_pad, jnp.bfloat16) if kind == "bf16" else jnp.asarray(it_pad)
    j_scale = None if scale is None else jnp.asarray(
        np.concatenate([scale.numpy(), np.repeat(scale.numpy()[-1:], pad)]))
    ref = np.asarray(jax_topk.catalog_blockmax(
        jnp.asarray(u.float().numpy(), jnp.bfloat16), j_items, 16, 64, interpret=True,
        item_scale_padded=j_scale))[:, :-(-N // 16)]
    got = torch_topk.catalog_blockmax(u, it, item_scale=scale).numpy()
    assert got.shape == (Bu, 21) and (ref[:, -1] < 0).all() and (got[:, -1] < 0).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("udt,idt,D,body", [
    (torch.bfloat16, torch.bfloat16, 64, "mma"),   # serving, bf16 catalog
    (torch.bfloat16, torch.int8, 64, "mma"),       # serving, int8 catalog
    (torch.bfloat16, torch.bfloat16, 65, "mma"),   # with the item bias column
    (torch.bfloat16, torch.int8, 1, "mma"),
    (torch.bfloat16, torch.bfloat16, 128, "mma"),
    (torch.bfloat16, torch.bfloat16, 129, "cuda"),
    (torch.bfloat16, torch.bfloat16, 0, "cuda"),
    (torch.float32, torch.bfloat16, 64, "cuda"),
    (torch.float32, torch.int8, 64, "cuda"),
    (torch.bfloat16, torch.float32, 64, "cuda"),
    (torch.float16, torch.float16, 64, "cuda"),
])
def test_blockmax_body_rule(udt, idt, D, body):
    """ops/topk.py's copy of csrc/blockmax.cu's rule at its boundaries
    (tests/test_torch_gpu.py holds the two together on the card)."""
    assert torch_topk._blockmax_body(udt, idt, D) == body


def test_quantize_catalog_bit_equal():
    _, items = _factors(300, seed=3)
    items[7] = 0.0                   # an all-zero row keeps scale 1
    q_ref, s_ref = jax_topk.quantize_catalog(jnp.asarray(items))
    q, s = torch_topk.quantize_catalog(torch.from_numpy(items))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def _history(N, cap=20, seed=1):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, N, size=(B, cap)).astype(np.int32)
    hlen = rng.integers(0, cap + 1, size=B).astype(np.int32)
    return hist, hlen


@pytest.mark.parametrize("N", [2048, 2000])       # 2000: ragged last chunk
@pytest.mark.parametrize("case", ["plain", "history", "int8"])
def test_fused_catalog_topk_ids_equal_jax(case, N):
    """Two-pass path: kp < nb_real and N > 4*k*16 at k=10."""
    k = 10
    u, items = _factors(N, seed=N)
    kw_np = {}
    if case == "history":
        hist, hlen = _history(N)
        u_top = np.argsort(-(u @ items.T), axis=1)
        hist[:, 0] = u_top[:, 0]                   # ban each user's best item
        keep = u_top[:, 1].astype(np.int32)
        hist[:, 1] = keep                          # ... but exempt the second
        hlen = np.maximum(hlen, 2)
        kw_np = dict(hist_items=hist, hist_len=hlen, keep_ids=keep,
                     exclude_pad_item=True)
    elif case == "int8":
        q, s = jax_topk.quantize_catalog(jnp.asarray(items))
        items = np.asarray(q)
        kw_np = dict(item_scale=np.asarray(s))
    to_jax = {k_: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k_, v in kw_np.items()}
    to_torch = {k_: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                for k_, v in kw_np.items()}
    v_ref, ids_ref = jax_topk.fused_catalog_topk(
        jnp.asarray(u), jnp.asarray(items), k, interpret=True, **to_jax)
    v, ids = torch_topk.fused_catalog_topk(torch.from_numpy(u),
                                           torch.from_numpy(items), k, **to_torch)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-6)
    if case == "history":
        got = ids.numpy()
        assert not (got == hist[:, :1]).any(axis=1).any()
        assert (got == keep[:, None]).any(axis=1).all()


def test_fused_catalog_topk_dense_fallback_equals_jax():
    """Small N takes the dense scoring path in both packages."""
    u, items = _factors(300, seed=5)
    hist, hlen = _history(300, cap=12)
    v_ref, ids_ref = jax_topk.fused_catalog_topk(
        jnp.asarray(u), jnp.asarray(items), 10, hist_items=jnp.asarray(hist),
        hist_len=jnp.asarray(hlen), exclude_pad_item=True, interpret=True)
    _, ids = torch_topk.fused_catalog_topk(
        torch.from_numpy(u), torch.from_numpy(items), 10,
        hist_items=torch.from_numpy(hist), hist_len=torch.from_numpy(hlen),
        exclude_pad_item=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))


def test_blockmax_counters_stay_on_cpu():
    before = (torch_topk.catalog_blockmax.launches,
              torch_topk.catalog_blockmax.launches_int8)
    u, items = _factors(2048)
    torch_topk.fused_catalog_topk(torch.from_numpy(u), torch.from_numpy(items), 10)
    assert (torch_topk.catalog_blockmax.launches,
            torch_topk.catalog_blockmax.launches_int8) == before


def test_catalog_blockmax_refuses_other_chunks():
    u, items = _factors(64)
    with pytest.raises(ValueError):
        torch_topk.catalog_blockmax(torch.from_numpy(u), torch.from_numpy(items),
                                    chunk=32)


# each case's features: history (with keep_ids exempting a banned id, and
# the padding item banned), id 0 leading but banned, a shard's invalid tail,
# a ragged last chunk, int8 items
_PASS2_FEATURES = {
    "history_keep": {"history", "keep"}, "exclude_pad": {"pad_lead"},
    "invalid_from": {"invalid"}, "ragged": {"ragged"}, "int8": {"int8"},
    "history": {"history"}, "history_invalid_from": {"history", "invalid"},
    "ragged_history_keep": {"ragged", "history", "keep"},
    "ragged_int8": {"ragged", "int8"}, "int8_history_keep": {"int8", "history", "keep"},
    "invalid_from_exclude_pad": {"invalid", "pad_lead"},
}


@pytest.mark.parametrize("case", list(_PASS2_FEATURES))
def test_rescore_topk_plain_equals_jax(case):
    """Pass 2's plain version, on pass 1's chunks at fused_catalog_topk's
    kp, equals the JAX package's fused_catalog_topk: ids exactly, values
    within f32 reassociation."""
    f = _PASS2_FEATURES[case]
    k, N = 10, 2000 if "ragged" in f else 2048
    u, items = _factors(N, seed=17 + len(case))
    kw = {}
    if "pad_lead" in f:
        items[0] = 10 * np.abs(u).mean(0) * np.sign(u.sum(0))   # id 0 would lead
        kw["exclude_pad_item"] = True
    dense = u @ items.T
    if "int8" in f:
        q, s = jax_topk.quantize_catalog(jnp.asarray(items))
        items = np.asarray(q)
        kw["item_scale"] = np.asarray(s)
        dense = (u @ items.astype(np.float32).T) * kw["item_scale"][None, :]
    if "history" in f:
        hist, hlen = _history(N)
        u_top = np.argsort(-dense, axis=1)
        hist[:, 0], hist[:, 1] = u_top[:, 0], u_top[:, 1]
        hlen = np.maximum(hlen, 2)
        kw.update(hist_items=hist, hist_len=hlen)
        if "keep" in f:
            kw.update(keep_ids=u_top[:, 1].astype(np.int32), exclude_pad_item=True)
    if "invalid" in f:
        kw.update(invalid_from=N - 40, max_invalid=40)
    jkw = {a: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for a, v in kw.items()}
    if "invalid" in f:
        jkw["invalid_from"] = jnp.asarray(N - 40)
    v_ref, ids_ref = jax_topk.fused_catalog_topk(jnp.asarray(u), jnp.asarray(items), k,
                                                 interpret=True, **jkw)
    tkw = {a: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for a, v in kw.items()}
    hcap = kw["hist_items"].shape[1] if "hist_items" in kw else 0
    icap = (-(-40 // 16) + 1) if "invalid" in f else 0
    kp = k + (16 if N % 16 else 0) + int(kw.get("exclude_pad_item", False)) + hcap + icap
    ut, it = torch.from_numpy(u), torch.from_numpy(items)
    scale = tkw.pop("item_scale", None)
    tkw.pop("max_invalid", None)
    _, blk = torch_topk.fast_topk(torch_topk.catalog_blockmax(ut, it, item_scale=scale), kp)
    v, ids = torch_topk._rescore_topk_plain(ut, it, blk, k, item_scale=scale, **tkw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-6)
    got = ids.numpy()
    if "history" in f:
        assert not (got == hist[:, :1]).any()
        if "keep" in f:
            assert (got == u_top[:, 1:2]).any(1).all()
        else:
            assert not (got == hist[:, 1:2]).any()
    if "pad_lead" in f or "keep" in f:
        assert not (got == 0).any()
    if "invalid" in f:
        assert (got < N - 40).all()


@pytest.mark.parametrize("case", ["f32", "bf16_items", "bf16_users", "int8", "bans"])
def test_rescore_topk_runs_the_plain_version_on_the_cpu(case):
    """On CPU tensors pass 2 is the plain version and no launch counter moves."""
    u, items = _factors(2048, seed=9)
    ut, it = torch.from_numpy(u), torch.from_numpy(items)
    kw = {}
    if case == "bf16_items":
        it = it.to(torch.bfloat16)
    elif case == "bf16_users":
        ut = ut.to(torch.bfloat16)
    elif case == "int8":
        it, kw["item_scale"] = torch_topk.quantize_catalog(it)
    _, blk = torch_topk.fast_topk(torch_topk.catalog_blockmax(
        ut, it, item_scale=kw.get("item_scale")), 40)
    if case == "bans":
        hist, hlen = _history(2048)
        kw = dict(hist_items=torch.from_numpy(hist), hist_len=torch.from_numpy(hlen),
                  keep_ids=torch.from_numpy(hist[:, 0]), exclude_pad_item=True,
                  invalid_from=2000)
    before = (torch_topk.rescore_topk.launches, torch_topk.rescore_topk.launches_int8)
    v, ids = torch_topk.rescore_topk(ut, it, blk, 10, **kw)
    pv, pids = torch_topk._rescore_topk_plain(ut, it, blk, 10, **kw)
    assert torch.equal(ids, pids) and torch.equal(v, pv)
    assert v.dtype == torch.float32 and ids.dtype == torch.int64
    assert (torch_topk.rescore_topk.launches,
            torch_topk.rescore_topk.launches_int8) == before


def test_rescore_topk_refuses_a_device_without_a_kernel():
    u = torch.zeros(2, 16, device="meta")
    with pytest.raises(ValueError, match="no rescore_topk kernel"):
        torch_topk.rescore_topk(u, torch.zeros(64, 16, device="meta"),
                                torch.zeros(2, 2, dtype=torch.int64, device="meta"), 4)


def _pass2_args(away=None):
    """A CPU call's arguments, ``away`` of them moved to another device."""
    args = dict(user_emb=torch.zeros(4, 16), item_emb=torch.zeros(640, 16, dtype=torch.int8),
                blk=torch.zeros(4, 3, dtype=torch.int64), k=5,
                hist_items=torch.ones(4, 6, dtype=torch.int64),
                hist_len=torch.full((4,), 6), keep_ids=torch.ones(4, dtype=torch.int64),
                item_scale=torch.ones(640))
    if away:
        args[away] = args[away].to("meta")
    return args


@pytest.mark.parametrize("away", ["item_emb", "blk", "hist_items", "hist_len", "keep_ids",
                                  "item_scale"])
def test_rescore_cuda_refuses_a_tensor_off_the_users_device(away):
    """The kernel's wrapper names every tensor that is not on the users'
    device before anything is launched (a host pointer would fault on the
    card)."""
    args = _pass2_args(away)
    with pytest.raises(ValueError, match=f"{away} not on the users' device"):
        torch_topk._rescore_cuda(args.pop("user_emb"), args.pop("item_emb"),
                                 args.pop("blk"), args.pop("k"), **args)


@pytest.mark.parametrize("bad", ["k_past_candidates", "k_zero", "no_hist_len", "keep_ids",
                                 "item_scale", "blk_users"])
def test_rescore_cuda_refuses_mismatched_shapes(bad):
    """Shapes the kernel would read past are refused before the launch."""
    args = _pass2_args()
    if bad == "k_past_candidates":
        args["k"] = 3 * 16 + 1
    elif bad == "k_zero":
        args["k"] = 0
    elif bad == "no_hist_len":
        args["hist_len"] = None
    elif bad == "keep_ids":
        args["keep_ids"] = torch.ones(3, dtype=torch.int64)
    elif bad == "item_scale":
        args["item_scale"] = torch.ones(639)
    else:
        args["blk"] = torch.zeros(5, 3, dtype=torch.int64)
    with pytest.raises(ValueError):
        torch_topk._rescore_cuda(args.pop("user_emb"), args.pop("item_emb"),
                                 args.pop("blk"), args.pop("k"), **args)
