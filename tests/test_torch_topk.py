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
