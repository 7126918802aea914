"""Shared NN blocks: scorers and the post-LN transformer encoder.

Counterpart of unirec_tpu/models/modules.py (eval mode; dropout arrives with
the training slice). Submodules carry the flax modules' names
(``multi_head_attention.query``, ``feed_forward.dense_1``, ``layer_0``), so
utils/flax_bridge.py maps parameters by path. As in the JAX package,
parameters stay f32 and ``dtype`` (None or torch.bfloat16) is the compute
dtype: inputs and weights are cast to it at each dense layer, and
LayerNorm statistics run in f32.

Kernel dispatch follows the JAX package's flags. ``fused_layer`` and
``fused_lastq`` call ops/layer.py, whose wrappers launch the Hopper kernels
on CUDA tensors and their plain versions on CPU tensors. The flags whose
Pallas kernels are not ported yet (``use_fused_attention``,
``use_fused_ffn``, and ``use_pallas`` at L >= 256) raise on CUDA, naming
their ROADMAP item; on the CPU they run the plain math, as the JAX
package's CPU path does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unirec_tpu_torch.ops import layer as layer_ops

ACT2FN = {
    "gelu": F.gelu,  # erf form, as jax.nn.gelu(approximate=False)
    "relu": torch.relu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leakyrelu": F.leaky_relu,
}

MASK_VALUE = -10000.0
MIN_FLASH_SEQ_LEN = 256   # unirec_tpu/ops/attention.py:119
MAX_FUSED_SEQ_LEN = 512   # unirec_tpu/ops/attention.py:179


def _not_ported(flag: str, item: str):
    return NotImplementedError(
        f"{flag} selects a Pallas kernel that has no Hopper port yet "
        f"(ROADMAP.md {item}); unset it to run the plain path")


def inner_product_scores(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dim-dispatching dot scorer (modules.py:45-67): [B,D]x[B,D]->[B];
    [B,D]x[M,D]->[B,M]; [B,G,D]x[B,D]->[B,G]; [B,D]x[B,G,D]->[B,G]."""
    if x.dim() == y.dim():
        if x.shape == y.shape:
            return (x * y).sum(-1)
        return x @ y.T
    if x.dim() > y.dim():
        return torch.einsum("bgd,bd->bg", x, y)
    return torch.einsum("bd,bgd->bg", x, y)


def dense(mod: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=...) on a torch Linear: x and the parameters in
    the compute dtype (f32 when it is None)."""
    dt = dtype or torch.promote_types(x.dtype, mod.weight.dtype)
    return F.linear(x.to(dt), mod.weight.to(dt), mod.bias.to(dt))


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax nn.LayerNorm(dtype=...): f32 statistics, output in the compute
    dtype (f32 when it is None)."""
    dt = dtype or torch.promote_types(x.dtype, mod.weight.dtype)
    y = F.layer_norm(x.float(), mod.normalized_shape, mod.weight.float(),
                     mod.bias.float(), mod.eps)
    return y.to(dt)


def causal_attention_mask(item_seq: torch.Tensor,
                          bidirectional: bool = False) -> torch.Tensor:
    """Additive mask [B,1,L,L]: -10000 where attention is forbidden
    (sasrec.py:40-57): padding keys (id 0), plus the causal triangle unless
    bidirectional."""
    B, L = item_seq.shape
    mask = (item_seq > 0).float()[:, None, None, :]
    if not bidirectional:
        mask = mask * torch.tril(torch.ones(L, L, device=item_seq.device))[None, None]
    return (1.0 - mask) * MASK_VALUE


class MultiHeadAttention(nn.Module):
    """Post-LN self-attention (modules.py:247-316), eval mode."""

    def __init__(self, n_heads: int, hidden_size: int, layer_norm_eps: float,
                 dtype=None, use_flash: bool = False, use_fused: bool = False,
                 last_query: bool = False):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        self.use_flash, self.use_fused = use_flash, use_fused
        self.last_query = last_query
        for name in ("query", "key", "value", "dense"):
            self.add_module(name, nn.Linear(hidden_size, hidden_size))
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        B, L, H = t.shape
        return t.reshape(B, L, self.n_heads, H // self.n_heads).transpose(1, 2)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        if self.last_query:
            return self._last_query_attention(x, attn_mask)
        B, L, H = x.shape
        hd = H // self.n_heads
        if x.is_cuda and self.use_fused and L <= MAX_FUSED_SEQ_LEN:
            raise _not_ported("use_fused_attention", "Queue 2 item 7")
        if x.is_cuda and self.use_flash and L >= MIN_FLASH_SEQ_LEN \
                and L % 8 == 0 and hd % 8 == 0:
            raise _not_ported("use_pallas", "Queue 2 item 6")
        q = self._split(dense(self.query, x, self.dtype))
        k = self._split(dense(self.key, x, self.dtype))
        v = self._split(dense(self.value, x, self.dtype))
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
        probs = torch.softmax(scores + attn_mask.to(scores.dtype), dim=-1)
        ctx = (probs @ v).transpose(1, 2).reshape(B, L, H)
        out = dense(self.dense, ctx, self.dtype)
        return layer_norm(self.LayerNorm, out + x, self.dtype)

    def _last_query_attention(self, x, attn_mask):
        """Single-query attention: q from x[:, -1:], k/v over all rows."""
        B, L, H = x.shape
        hd = H // self.n_heads
        xq = x[:, L - 1:, :]
        q = self._split(dense(self.query, xq, self.dtype))
        k = self._split(dense(self.key, x, self.dtype))
        v = self._split(dense(self.value, x, self.dtype))
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
        # final query row of the additive mask (negative index: a
        # bidirectional mask has a size-1 query dim)
        mask_row = attn_mask[..., -1:, :]
        probs = torch.softmax(scores + mask_row.to(scores.dtype), dim=-1)
        ctx = (probs @ v).transpose(1, 2).reshape(B, 1, H)
        out = dense(self.dense, ctx, self.dtype)
        return layer_norm(self.LayerNorm, out + xq, self.dtype)


class FeedForward(nn.Module):
    """Pointwise FFN with residual post-LN (modules.py:319-355)."""

    def __init__(self, hidden_size: int, inner_size: int, hidden_act: str,
                 layer_norm_eps: float, dtype=None, fused: bool = False):
        super().__init__()
        self.hidden_act, self.dtype, self.fused = hidden_act, dtype, fused
        self.dense_1 = nn.Linear(hidden_size, inner_size)
        self.dense_2 = nn.Linear(inner_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and self.fused:
            raise _not_ported("use_fused_ffn", "Queue 2 item 8")
        h = dense(self.dense_1, x, self.dtype)
        h = dense(self.dense_2, ACT2FN[self.hidden_act](h), self.dtype)
        return layer_norm(self.LayerNorm, h + x, self.dtype)


class TransformerLayer(nn.Module):
    def __init__(self, n_heads: int, hidden_size: int, inner_size: int,
                 hidden_act: str, layer_norm_eps: float, dtype=None,
                 use_flash: bool = False, use_fused: bool = False,
                 last_query: bool = False, head_stacked: bool = False,
                 fused_ffn: bool = False, fused_layer: bool = False,
                 fused_causal: bool = True, fused_lastq: bool = False):
        super().__init__()
        self.n_heads, self.inner_size = n_heads, inner_size
        self.hidden_act, self.layer_norm_eps = hidden_act, layer_norm_eps
        self.last_query, self.head_stacked = last_query, head_stacked
        self.fused_layer, self.fused_causal = fused_layer, fused_causal
        self.fused_lastq = fused_lastq
        special = last_query or head_stacked
        self.multi_head_attention = MultiHeadAttention(
            n_heads, hidden_size, layer_norm_eps, dtype,
            use_flash and not special, use_fused and not special, last_query)
        self.feed_forward = FeedForward(hidden_size, inner_size, hidden_act,
                                        layer_norm_eps, dtype, fused_ffn)

    def kernel_params(self):
        """The JAX package's fused-layer parameter tuple, flax layout
        (kernels [in, out]): ((wq,bq),(wk,bk),(wv,bv),(wo,bo),(g1,c1),
        (w1,b1),(w2,b2),(g2,c2))."""
        a, f = self.multi_head_attention, self.feed_forward
        lin = lambda m: (m.weight.T, m.bias)  # noqa: E731
        return (lin(a.query), lin(a.key), lin(a.value), lin(a.dense),
                (a.LayerNorm.weight, a.LayerNorm.bias), lin(f.dense_1),
                lin(f.dense_2), (f.LayerNorm.weight, f.LayerNorm.bias))

    def kernel_kwargs(self):
        return dict(n_heads=self.n_heads, inner_size=self.inner_size,
                    hidden_act=self.hidden_act,
                    layer_norm_eps=float(self.layer_norm_eps))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        gate = layer_ops.fused_layer_supported(x, self.hidden_act,
                                               self.n_heads, self.inner_size)
        # row L-1 of the additive mask is exactly the key-padding row (the
        # causal triangle allows every key there)
        if self.fused_lastq and self.last_query and not self.head_stacked \
                and gate:
            madd = attn_mask[:, 0, -1, :].float()
            y = layer_ops.fused_last_query_layer(
                x, madd, self.kernel_params(), **self.kernel_kwargs())
            return y[:, None, :]
        if self.fused_layer and not (self.last_query or self.head_stacked) \
                and gate:
            madd = attn_mask[:, 0, -1, :].float()
            return layer_ops.fused_transformer_layer(
                x, madd, self.kernel_params(), causal=self.fused_causal,
                **self.kernel_kwargs())
        return self.feed_forward(self.multi_head_attention(x, attn_mask))


class TransformerEncoder(nn.Module):
    """Stack of post-LN layers (modules.py:659-767); ``last_query_only``
    runs the final layer for the last position only (output [B, 1, H])."""

    def __init__(self, n_layers: int = 2, n_heads: int = 2,
                 hidden_size: int = 64, inner_size: int = 256,
                 hidden_act: str = "gelu", layer_norm_eps: float = 1e-12,
                 dtype=None, use_flash: bool = False, use_fused: bool = False,
                 remat: bool = False, head_stacked: bool = False,
                 last_query_only: bool = False, fused_ffn: bool = False,
                 fused_layer: bool = False, fused_causal: bool = True,
                 fused_lastq: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.hidden_act, self.n_heads, self.inner_size = hidden_act, n_heads, inner_size
        self.fused_causal = fused_causal
        # the padded fused chain: every layer a kernel (modules.py:711-750)
        self.chain = (fused_layer and fused_lastq and last_query_only
                      and not (remat or head_stacked or fused_ffn))
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TransformerLayer(
                n_heads, hidden_size, inner_size, hidden_act, layer_norm_eps,
                dtype, use_flash, use_fused,
                last_query_only and i == n_layers - 1, head_stacked,
                fused_ffn, fused_layer, fused_causal, fused_lastq))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        if self.chain and layer_ops.fused_layer_supported(
                x, self.hidden_act, self.n_heads, self.inner_size):
            # pad the sequence to the kernels' multiple of 8 ONCE and keep it
            # padded between layers; fake rows are banned as keys by the
            # -1e30 madd tail and the final layer reads only real row L-1
            B, L, D = x.shape
            madd = attn_mask[:, 0, -1, :].float()
            xp, mp, _ = layer_ops._pad_L(x, madd, L)
            *body, last = self.layers()
            for layer in body:
                xp = layer_ops.fused_transformer_layer(
                    xp, mp, layer.kernel_params(), causal=self.fused_causal,
                    **layer.kernel_kwargs())
            y = layer_ops.fused_last_query_layer(
                xp, mp, last.kernel_params(), q_index=L - 1,
                **last.kernel_kwargs())
            return y[:, None, :]
        for layer in self.layers():
            x = layer(x, attn_mask)
        return x
