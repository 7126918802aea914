"""Shared NN blocks: scorers and the post-LN transformer encoder.

Counterpart of unirec_tpu/models/modules.py, in eval and train mode.
Submodules carry the flax modules' names
(``multi_head_attention.query``, ``feed_forward.dense_1``, ``layer_0``), so
utils/flax_bridge.py maps parameters by path. As in the JAX package,
parameters stay f32 and ``dtype`` (None or torch.bfloat16) is the compute
dtype: inputs and weights are cast to it at each dense layer, and
LayerNorm statistics run in f32.

Dropout takes its randomness from a ``DropoutRNG`` (the JAX package's
'dropout' rng stream): the plain sites draw their masks from its device
generator (``dropout_bits=8`` draws one byte per element, as Dropout8), and
each fused-kernel call takes a host-int seed from it, from which the kernel
draws its own Philox masks (ops/layer.py).

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


class DropoutRNG:
    """The dropout randomness of one training step. ``generator`` lives on
    the activations' device and draws the plain sites' masks; ``seed()``
    draws a host int for each fused-kernel call from a CPU generator, so
    handing a seed to a kernel never waits on the device."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=torch.device(device)).manual_seed(seed)
        self._host = torch.Generator().manual_seed(seed)

    def seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self._host))


def _need_rng(rng):
    if rng is None:
        raise ValueError("train-mode dropout needs a DropoutRNG (the JAX "
                         "package's rngs={'dropout': ...})")
    return rng


def apply_dropout(x: torch.Tensor, rate: float, train: bool,
                  rng: "DropoutRNG | None", bits8: bool = False) -> torch.Tensor:
    """Inline dropout (modules.py:79-122). ``bits8``: Dropout8, one random
    byte per element, the threshold quantized to round(rate*256)/256 and
    the kept values scaled by the realized 1/keep_p; else flax Dropout,
    keep with probability 1-rate."""
    if not train or rate <= 0.0:
        return x
    gen = _need_rng(rng).generator
    if bits8:
        thr = int(round(rate * 256.0))
        if thr <= 0:
            return x
        if thr >= 256:
            return torch.zeros_like(x)
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, generator=gen,
                             device=x.device)
        return torch.where(bits >= thr, x * (1.0 / (1.0 - thr / 256.0)),
                           torch.zeros_like(x))
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def cosine_scores(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Reference CosineScorer (modules.py:141-147): ip / max(|x|^2 |y|^2, eps)."""
    deno = inner_product_scores((x * x).sum(-1, keepdim=True),
                                (y * y).sum(-1, keepdim=True))
    return inner_product_scores(x, y) / torch.clamp(deno, min=eps)


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
    """Post-LN self-attention (modules.py:181-351)."""

    def __init__(self, n_heads: int, hidden_size: int, layer_norm_eps: float,
                 dtype=None, use_flash: bool = False, use_fused: bool = False,
                 last_query: bool = False, hidden_dropout_prob: float = 0.0,
                 attn_dropout_prob: float = 0.0, bits8: bool = False):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        self.p_hidden, self.p_attn, self.bits8 = (float(hidden_dropout_prob),
                                                  float(attn_dropout_prob), bits8)
        self.use_flash, self.use_fused = use_flash, use_fused
        self.last_query = last_query
        for name in ("query", "key", "value", "dense"):
            self.add_module(name, nn.Linear(hidden_size, hidden_size))
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        B, L, H = t.shape
        return t.reshape(B, L, self.n_heads, H // self.n_heads).transpose(1, 2)

    def _drop(self, t, rate, train, rng):
        return apply_dropout(t, rate, train, rng, self.bits8)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        if self.last_query:
            return self._last_query_attention(x, attn_mask, train, rng)
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
        probs = self._drop(probs, self.p_attn, train, rng)
        ctx = (probs @ v).transpose(1, 2).reshape(B, L, H)
        out = self._drop(dense(self.dense, ctx, self.dtype), self.p_hidden, train, rng)
        return layer_norm(self.LayerNorm, out + x, self.dtype)

    def _last_query_attention(self, x, attn_mask, train=False, rng=None):
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
        probs = self._drop(probs, self.p_attn, train, rng)
        ctx = (probs @ v).transpose(1, 2).reshape(B, 1, H)
        out = self._drop(dense(self.dense, ctx, self.dtype), self.p_hidden, train, rng)
        return layer_norm(self.LayerNorm, out + xq, self.dtype)


class FeedForward(nn.Module):
    """Pointwise FFN with residual post-LN (modules.py:319-355)."""

    def __init__(self, hidden_size: int, inner_size: int, hidden_act: str,
                 layer_norm_eps: float, dtype=None, fused: bool = False,
                 hidden_dropout_prob: float = 0.0, bits8: bool = False):
        super().__init__()
        self.hidden_act, self.dtype, self.fused = hidden_act, dtype, fused
        self.p_hidden, self.bits8 = float(hidden_dropout_prob), bits8
        self.dense_1 = nn.Linear(hidden_size, inner_size)
        self.dense_2 = nn.Linear(inner_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        if x.is_cuda and self.fused:
            raise _not_ported("use_fused_ffn", "Queue 2 item 8")
        h = dense(self.dense_1, x, self.dtype)
        h = dense(self.dense_2, ACT2FN[self.hidden_act](h), self.dtype)
        h = apply_dropout(h, self.p_hidden, train, rng, self.bits8)
        return layer_norm(self.LayerNorm, h + x, self.dtype)


class TransformerLayer(nn.Module):
    def __init__(self, n_heads: int, hidden_size: int, inner_size: int,
                 hidden_act: str, layer_norm_eps: float, dtype=None,
                 use_flash: bool = False, use_fused: bool = False,
                 last_query: bool = False, head_stacked: bool = False,
                 fused_ffn: bool = False, fused_layer: bool = False,
                 fused_causal: bool = True, fused_lastq: bool = False,
                 hidden_dropout_prob: float = 0.0, attn_dropout_prob: float = 0.0,
                 bits8: bool = False):
        super().__init__()
        self.n_heads, self.inner_size = n_heads, inner_size
        self.p_hidden, self.p_attn = float(hidden_dropout_prob), float(attn_dropout_prob)
        self.hidden_act, self.layer_norm_eps = hidden_act, layer_norm_eps
        self.last_query, self.head_stacked = last_query, head_stacked
        self.fused_layer, self.fused_causal = fused_layer, fused_causal
        self.fused_lastq = fused_lastq
        special = last_query or head_stacked
        self.multi_head_attention = MultiHeadAttention(
            n_heads, hidden_size, layer_norm_eps, dtype,
            use_flash and not special, use_fused and not special, last_query,
            hidden_dropout_prob, attn_dropout_prob, bits8)
        self.feed_forward = FeedForward(hidden_size, inner_size, hidden_act,
                                        layer_norm_eps, dtype, fused_ffn,
                                        hidden_dropout_prob, bits8)

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

    def drop_kwargs(self, train: bool, rng: DropoutRNG | None):
        """Dropout arguments of one fused-kernel call: the rates, and a
        fresh seed from ``rng`` when dropout is on (one draw per layer, as
        the JAX layers each call make_rng)."""
        on = train and (self.p_attn > 0.0 or self.p_hidden > 0.0)
        return dict(p_attn=self.p_attn, p_hidden=self.p_hidden, train=train,
                    seed=_need_rng(rng).seed() if on else None)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        gate = layer_ops.fused_layer_supported(x, self.hidden_act,
                                               self.n_heads, self.inner_size)
        # row L-1 of the additive mask is exactly the key-padding row (the
        # causal triangle allows every key there)
        if self.fused_lastq and self.last_query and not self.head_stacked \
                and gate:
            madd = attn_mask[:, 0, -1, :].float()
            y = layer_ops.fused_last_query_layer(
                x, madd, self.kernel_params(), **self.kernel_kwargs(),
                **self.drop_kwargs(train, rng))
            return y[:, None, :]
        if self.fused_layer and not (self.last_query or self.head_stacked) \
                and gate:
            madd = attn_mask[:, 0, -1, :].float()
            return layer_ops.fused_transformer_layer(
                x, madd, self.kernel_params(), causal=self.fused_causal,
                **self.kernel_kwargs(), **self.drop_kwargs(train, rng))
        h = self.multi_head_attention(x, attn_mask, train, rng)
        return self.feed_forward(h, train, rng)


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
                 fused_lastq: bool = False, hidden_dropout_prob: float = 0.0,
                 attn_dropout_prob: float = 0.0, bits8: bool = False):
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
                fused_ffn, fused_layer, fused_causal, fused_lastq,
                hidden_dropout_prob, attn_dropout_prob, bits8))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        if self.chain and layer_ops.fused_layer_supported(
                x, self.hidden_act, self.n_heads, self.inner_size):
            # pad the sequence to the kernels' multiple of 8 ONCE and keep it
            # padded between layers; fake rows are banned as keys by the
            # -1e30 madd tail and the final layer reads only real row L-1;
            # one dropout seed per layer
            B, L, D = x.shape
            madd = attn_mask[:, 0, -1, :].float()
            xp, mp, _ = layer_ops._pad_L(x, madd, L)
            *body, last = self.layers()
            for layer in body:
                xp = layer_ops.fused_transformer_layer(
                    xp, mp, layer.kernel_params(), causal=self.fused_causal,
                    **layer.kernel_kwargs(), **layer.drop_kwargs(train, rng))
            y = layer_ops.fused_last_query_layer(
                xp, mp, last.kernel_params(), q_index=L - 1,
                **last.kernel_kwargs(), **last.drop_kwargs(train, rng))
            return y[:, None, :]
        for layer in self.layers():
            x = layer(x, attn_mask, train, rng)
        return x
