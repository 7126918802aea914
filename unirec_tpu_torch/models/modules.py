"""Shared NN blocks: scorers, the post-LN transformer encoder and the
other sequential models' blocks.

Counterpart of unirec_tpu/models/modules.py, in eval and train mode, plus
the blocks unirec_tpu/models/sequential.py defines for its models: the
MLP scorer, attention pooling (AttHist), flax's GRU cell and its scan
(GRU, AdaRanker), ConvFormer's FFN and its depthwise and spectral token
mixers, and AdaRanker's set encoder, parameter memory and patched linear
layer. These
are XLA in the JAX package, not Pallas, so they are plain torch ops here;
each computes in the dtype flax's ``dtype=None`` promotion gives (f32
against the f32 parameters) and draws its JAX initializers in
``jax_init``.
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

The JAX package's opt-in variants: ``qkv_packed`` (one ``qkv`` dense of
width 3H in each attention path, which turns the fused layer kernels off)
and ``remat_attention`` (each layer checkpointed, its recompute replaying
the forward's dropout draws). The four ranking modules the JAX package
exports but no model uses (``Dice``, ``SequenceAttLayer``,
``ModulateHidden``, ``MMoEUnit``) follow. HSTU's layers, which the JAX
package does not have, close the file (``HSTUEncoder``, ``HSTULayer``,
``RelativePositionBias``): their attention is ops/hstu_attention.py.

Kernel dispatch follows the JAX package's flags and gates. ``fused_layer``
and ``fused_lastq`` call ops/layer.py and ``use_fused_ffn`` ops/ffn.py (the
six activations of its kernel). In a layer that is neither last-query nor
head-stacked, attention tries, in the JAX module's order,
``use_fused_attention`` (ops/attention.py's fused kernels, when
``fused_supported``), then ``use_pallas`` (flash attention, when
``flash_supported``: L >= 256, L and the head width multiples of 8, and no
attention dropout in train mode), then the plain math. Each wrapper
launches its Hopper kernel on CUDA tensors and its plain version on CPU
tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unirec_tpu_torch.core.mesh import RowSlice, rand_rows, randint_rows, randn_rows
from unirec_tpu_torch.ops import attention as attn_ops
from unirec_tpu_torch.ops import ffn as ffn_ops
from unirec_tpu_torch.ops import hstu_attention as hstu_ops
from unirec_tpu_torch.ops import layer as layer_ops
from unirec_tpu_torch.utils import tracing

ACT2FN = {
    "gelu": F.gelu,  # erf form, as jax.nn.gelu(approximate=False)
    "relu": torch.relu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leakyrelu": F.leaky_relu,
}

MASK_VALUE = -10000.0


class DropoutRNG:
    """The dropout randomness of one training step. ``generator`` lives on
    the activations' device; ``rows`` draws the plain sites' masks and
    noise from it; ``seed()`` draws a host int for each fused-kernel call
    from a CPU generator, so handing a seed to a kernel never waits on the
    device.

    ``rows`` (lo, n, total): the batch is rows [lo, lo + n) of a global
    batch of ``total`` (a data-parallel rank's share). Plain draws are then
    taken at the global shape and sliced (core/mesh.py::RowSlice), and the
    fused kernels key their masks by global example (``row_offset``), so a
    rank's examples draw what they draw in a one-process run."""

    def __init__(self, seed: int, device, rows=None):
        self.generator = torch.Generator(device=torch.device(device)).manual_seed(seed)
        self._host = torch.Generator().manual_seed(seed)
        self.rows = RowSlice(self.generator, *rows) if rows is not None else self.generator

    def row_offset(self, n: int) -> int:
        """The global index of the first of a kernel call's ``n`` examples:
        m * lo when they are the batch's rows with m entries each (BST's
        candidates), 0 outside a data-parallel step."""
        r = self.rows
        if not isinstance(r, RowSlice) or r.n == 0 or n % r.n:
            return 0
        return n // r.n * r.lo

    def seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self._host))

    def get_state(self):
        """Both generators' states: ``set_state`` of them replays every
        draw made since (a rematerialized layer's recompute)."""
        return self.generator.get_state(), self._host.get_state()

    def set_state(self, state) -> None:
        self.generator.set_state(state[0])
        self._host.set_state(state[1])


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
    gen = _need_rng(rng).rows
    if bits8:
        thr = int(round(rate * 256.0))
        if thr <= 0:
            return x
        if thr >= 256:
            return torch.zeros_like(x)
        bits = randint_rows(gen, 0, 256, x.shape, x.device, torch.uint8)
        return torch.where(bits >= thr, x * (1.0 / (1.0 - thr / 256.0)),
                           torch.zeros_like(x))
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = rand_rows(gen, x.shape, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def cosine_scores(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Reference CosineScorer (modules.py:141-147): ip / max(|x|^2 |y|^2, eps)."""
    deno = inner_product_scores((x * x).sum(-1, keepdim=True),
                                (y * y).sum(-1, keepdim=True))
    return inner_product_scores(x, y) / torch.clamp(deno, min=eps)


def inner_product_scores(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dim-dispatching dot scorer (modules.py:45-67): [B,D]x[B,D]->[B];
    [B,D]x[M,D]->[B,M]; [B,G,D]x[B,D]->[B,G]; [B,D]x[B,G,D]->[B,G]; in
    the promoted dtype (an f32 user against bf16 items scores in f32)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    x, y = x.to(dt), y.to(dt)
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
    """Post-LN self-attention (modules.py:181-351). ``qkv_packed``: one
    ``qkv`` dense of width 3H in place of ``query``, ``key`` and ``value``,
    its output split in three (modules.py:246-250); the last-query path
    projects every row through it and keeps row L-1 of the queries, as the
    JAX module does (:321-327)."""

    def __init__(self, n_heads: int, hidden_size: int, layer_norm_eps: float,
                 dtype=None, use_flash: bool = False, use_fused: bool = False,
                 last_query: bool = False, hidden_dropout_prob: float = 0.0,
                 attn_dropout_prob: float = 0.0, bits8: bool = False,
                 qkv_packed: bool = False):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        self.p_hidden, self.p_attn, self.bits8 = (float(hidden_dropout_prob),
                                                  float(attn_dropout_prob), bits8)
        self.use_flash, self.use_fused = use_flash, use_fused
        self.last_query, self.qkv_packed = last_query, qkv_packed
        if qkv_packed:
            self.qkv = nn.Linear(hidden_size, 3 * hidden_size)
            names = ("dense",)
        else:
            names = ("query", "key", "value", "dense")
        for name in names:
            self.add_module(name, nn.Linear(hidden_size, hidden_size))
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def _project(self, x: torch.Tensor, q_rows: slice = slice(None)):
        """The query, key and value projections of ``x`` [B, L, H], the
        queries of rows ``q_rows`` only, in the compute dtype."""
        if self.qkv_packed:
            qp, kp, vp = dense(self.qkv, x, self.dtype).chunk(3, dim=-1)
            return qp[:, q_rows], kp, vp
        return (dense(self.query, x[:, q_rows], self.dtype), dense(self.key, x, self.dtype),
                dense(self.value, x, self.dtype))

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
        drop_on = train and self.p_attn > 0.0
        q, k, v = (self._split(t) for t in self._project(x))
        if self.use_fused and attn_ops.fused_supported(q, attn_mask):
            # modules.py:276-286: the kernels, with in-kernel dropout
            ctx = attn_ops.short_attention(q, k, v, attn_mask, self.p_attn,
                                           _need_rng(rng) if drop_on else None, train)
        elif self.use_flash and attn_ops.flash_supported(q, attn_mask) and not drop_on:
            # modules.py:287-289: flash attention (no dropout inside it)
            ctx = attn_ops.causal_attention(q, k, v, attn_mask)
        else:
            scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
            probs = torch.softmax(scores + attn_mask.to(scores.dtype), dim=-1)
            ctx = self._drop(probs, self.p_attn, train, rng) @ v
        ctx = ctx.transpose(1, 2).reshape(B, L, H)
        out = self._drop(dense(self.dense, ctx, self.dtype), self.p_hidden, train, rng)
        return layer_norm(self.LayerNorm, out + x, self.dtype)

    def _last_query_attention(self, x, attn_mask, train=False, rng=None):
        """Single-query attention: q from x[:, -1:], k/v over all rows."""
        B, L, H = x.shape
        hd = H // self.n_heads
        xq = x[:, L - 1:, :]
        q, k, v = (self._split(t) for t in self._project(x, slice(L - 1, None)))
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
        if self.fused and self.hidden_act in ffn_ops.ACTS:
            # modules.py:525-538: the weights cast to the compute dtype (f32
            # when it is None), flax layout [in, out]
            d1, d2 = self.dense_1, self.dense_2
            dt = self.dtype or torch.promote_types(x.dtype, d1.weight.dtype)
            y = ffn_ops.fused_ffn(x.reshape(-1, x.shape[-1]).to(dt), d1.weight.t().to(dt),
                                  d1.bias.to(dt), d2.weight.t().to(dt), d2.bias.to(dt),
                                  self.hidden_act)
            h = y.reshape(*x.shape[:-1], y.shape[-1])
        else:
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
                 bits8: bool = False, qkv_packed: bool = False):
        super().__init__()
        self.n_heads, self.inner_size = n_heads, inner_size
        self.p_hidden, self.p_attn = float(hidden_dropout_prob), float(attn_dropout_prob)
        self.hidden_act, self.layer_norm_eps = hidden_act, layer_norm_eps
        self.last_query, self.head_stacked = last_query, head_stacked
        self.fused_layer, self.fused_causal = fused_layer, fused_causal
        self.fused_lastq, self.qkv_packed = fused_lastq, qkv_packed
        special = last_query or head_stacked
        self.multi_head_attention = MultiHeadAttention(
            n_heads, hidden_size, layer_norm_eps, dtype,
            use_flash and not special, use_fused and not special, last_query,
            hidden_dropout_prob, attn_dropout_prob, bits8, qkv_packed)
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

    def drop_kwargs(self, train: bool, rng: DropoutRNG | None, n: int):
        """Dropout arguments of one fused-kernel call on ``n`` examples: the
        rates, and when dropout is on a fresh seed from ``rng`` (one draw
        per layer, as the JAX layers each call make_rng) and the first
        example's global index."""
        on = train and (self.p_attn > 0.0 or self.p_hidden > 0.0)
        return dict(p_attn=self.p_attn, p_hidden=self.p_hidden, train=train,
                    seed=_need_rng(rng).seed() if on else None,
                    row_offset=rng.row_offset(n) if on else 0)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        # the layer kernels take the unpacked weights (modules.py:620, :634)
        gate = not self.qkv_packed and layer_ops.fused_layer_supported(
            x, self.hidden_act, self.n_heads, self.inner_size)
        # row L-1 of the additive mask is exactly the key-padding row (the
        # causal triangle allows every key there)
        if self.fused_lastq and self.last_query and not self.head_stacked \
                and gate:
            madd = attn_mask[:, 0, -1, :].float()
            y = layer_ops.fused_last_query_layer(
                x, madd, self.kernel_params(), **self.kernel_kwargs(),
                **self.drop_kwargs(train, rng, x.shape[0]))
            return y[:, None, :]
        if self.fused_layer and not (self.last_query or self.head_stacked) \
                and gate:
            madd = attn_mask[:, 0, -1, :].float()
            return layer_ops.fused_transformer_layer(
                x, madd, self.kernel_params(), causal=self.fused_causal,
                **self.kernel_kwargs(), **self.drop_kwargs(train, rng, x.shape[0]))
        h = self.multi_head_attention(x, attn_mask, train, rng)
        return self.feed_forward(h, train, rng)


class TransformerEncoder(nn.Module):
    """Stack of post-LN layers (modules.py:659-767); ``last_query_only``
    runs the final layer for the last position only (output [B, 1, H]).
    ``remat``: each layer's activations are recomputed in the backward
    (the JAX package's ``nn.remat``, modules.py:752-754) through
    ``torch.utils.checkpoint``; the recompute replays the forward's dropout
    (``_rematerialized``). As in JAX, ``remat`` and ``qkv_packed`` turn the
    padded fused chain off (:712); each layer still takes its own fused
    kernels where its gates allow."""

    def __init__(self, n_layers: int = 2, n_heads: int = 2,
                 hidden_size: int = 64, inner_size: int = 256,
                 hidden_act: str = "gelu", layer_norm_eps: float = 1e-12,
                 dtype=None, use_flash: bool = False, use_fused: bool = False,
                 remat: bool = False, head_stacked: bool = False,
                 last_query_only: bool = False, fused_ffn: bool = False,
                 fused_layer: bool = False, fused_causal: bool = True,
                 fused_lastq: bool = False, hidden_dropout_prob: float = 0.0,
                 attn_dropout_prob: float = 0.0, bits8: bool = False,
                 qkv_packed: bool = False):
        super().__init__()
        self.n_layers, self.remat = n_layers, remat
        self.hidden_act, self.n_heads, self.inner_size = hidden_act, n_heads, inner_size
        self.fused_causal = fused_causal
        # the padded fused chain: every layer a kernel (modules.py:711-750)
        self.chain = (fused_layer and fused_lastq and last_query_only
                      and not (remat or head_stacked or qkv_packed or fused_ffn))
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TransformerLayer(
                n_heads, hidden_size, inner_size, hidden_act, layer_norm_eps,
                dtype, use_flash, use_fused,
                last_query_only and i == n_layers - 1, head_stacked,
                fused_ffn, fused_layer, fused_causal, fused_lastq,
                hidden_dropout_prob, attn_dropout_prob, bits8, qkv_packed))

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
                    **layer.kernel_kwargs(), **layer.drop_kwargs(train, rng, B))
            y = layer_ops.fused_last_query_layer(
                xp, mp, last.kernel_params(), q_index=L - 1,
                **last.kernel_kwargs(), **last.drop_kwargs(train, rng, B))
            return y[:, None, :]
        remat = self.remat and train and torch.is_grad_enabled()
        for layer in self.layers():
            x = _rematerialized(layer, x, attn_mask, train, rng) if remat \
                else layer(x, attn_mask, train, rng)
        return x


def _rematerialized(layer, x, attn_mask, train, rng):
    """``layer(x, ...)`` whose activations the backward recomputes
    (``torch.utils.checkpoint``, non-reentrant). ``rng``'s generators are
    stateful, so the recompute would draw other dropout masks and kernel
    seeds: it first puts them back to their state at the layer's start,
    which replays the forward's draws, and afterwards to where the backward
    found them."""
    from torch.utils.checkpoint import checkpoint
    start = rng.get_state() if rng is not None else None
    calls = []

    def run(h):
        if calls and rng is not None:       # the backward's recompute
            now = rng.get_state()
            rng.set_state(start)
            try:
                return layer(h, attn_mask, train, rng)
            finally:
                rng.set_state(now)
        calls.append(1)
        return layer(h, attn_mask, train, rng)

    return checkpoint(run, x, use_reentrant=False)


# ------------------------------------------------- scorers and poolers
def _broadcast_pair(x: torch.Tensor, y: torch.Tensor):
    """MLPScorer's three broadcast rules (modules.py:163-169): [B,D] x [M,D]
    -> both [B,M,D]; [B,G,D] x [B,D] and [B,D] x [B,G,D] -> both [B,G,D]."""
    if x.dim() == y.dim():
        if x.shape != y.shape:
            x = x[:, None, :].expand(x.shape[0], y.shape[0], x.shape[-1])
            y = y[None, :, :].expand(x.shape)
    elif x.dim() > y.dim():
        y = y[..., None, :].expand(x.shape)
    else:
        x = x[..., None, :].expand(y.shape)
    return x, y


class MLPScorer(nn.Module):
    """2-layer MLP over [user, item] (modules.py:150-177): dropout, dense,
    ``act_f``, dense to one score. flax's compact names ``Dense_0`` and
    ``Dense_1``; the denses compute in the promoted dtype (f32 for bf16
    inputs), as flax's dtype=None does."""

    def __init__(self, embed_dim: int, hidden_dim: int, dropout_prob: float = 0.0,
                 act_f: str = "tanh"):
        super().__init__()
        self.p, self.act = float(dropout_prob), ACT2FN[act_f]
        self.Dense_0 = nn.Linear(2 * embed_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        x, y = _broadcast_pair(x, y)
        dt = torch.promote_types(x.dtype, y.dtype)
        h = apply_dropout(torch.cat([x.to(dt), y.to(dt)], dim=-1), self.p, train, rng)
        h = dense(self.Dense_1, self.act(dense(self.Dense_0, h, None)), None)
        return h[..., 0]


class AttentionMergeLayer(nn.Module):
    """Learned attention pooling over the sequence (modules.py:985-1000):
    a dense layer, a softmax over every position (padding included, no
    mask, as in JAX) of its product with the vector ``h``, the weighted sum
    of the dense outputs, dropout. ``h`` is drawn from normal(1.0)."""

    def __init__(self, input_size: int, dropout: float = 0.0):
        super().__init__()
        self.p = float(dropout)
        self.dense = nn.Linear(input_size, input_size)
        self.h = nn.Parameter(torch.empty(input_size, 1))

    def jax_init(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.h, 0.0, 1.0, generator=generator)

    def forward(self, seq_emb: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        h = dense(self.dense, seq_emb, None)
        scores = torch.softmax((h @ self.h.to(h.dtype))[..., 0], dim=-1)
        return apply_dropout(torch.einsum("bl,bld->bd", scores, h), self.p, train, rng)


# ------------------------------------------------------------------ GRU
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init on a torch [out, in] weight: a normal
    truncated at two standard deviations, of variance 1 / fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class GRUCell(nn.Module):
    """flax's GRUCell (linen/recurrent.py) with its six named denses: the
    input ones ``ir``, ``iz``, ``in`` with biases, the recurrent ``hr``,
    ``hz`` without and ``hn`` with one; sigmoid gates, tanh candidate,
    h' = (1 - z) n + z h."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_features, features))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, nn.Linear(features, features, bias=bias))

    def jax_init(self, generator: torch.Generator) -> None:
        """flax's defaults, which the JAX GRU keeps (sequential.py:116):
        lecun-normal input kernels, orthogonal recurrent kernels, zero
        biases."""
        for name in ("ir", "iz", "in"):
            lecun_normal_(getattr(self, name).weight, generator)
            getattr(self, name).bias.zero_()
        for name in ("hr", "hz", "hn"):
            nn.init.orthogonal_(getattr(self, name).weight, generator=generator)
        self.hn.bias.zero_()


class RNN(nn.Module):
    """flax nn.RNN over a GRUCell from a zero f32 carry: the input products
    of all L steps in one matmul, then one recurrent matmul a step. The
    cell computes in the promoted dtype (f32 for bf16 inputs), as flax's
    dtype=None does. Returns every step's hidden state [B, L, H]."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.cell = GRUCell(in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cell
        gi = [getattr(c, n) for n in ("ir", "iz", "in")]
        dt = torch.promote_types(x.dtype, c.ir.weight.dtype)
        w_i = torch.cat([g.weight for g in gi]).to(dt)
        b_i = torch.cat([g.bias for g in gi]).to(dt)
        w_h = torch.cat([c.hr.weight, c.hz.weight, c.hn.weight]).to(dt)
        b_hn = c.hn.bias.to(dt)
        # one [B, 3H] slab a step: a slice of the whole [B, L, 3H] product
        # would make each step's backward fill a tensor of that size
        steps = F.linear(x.to(dt), w_i, b_i).unbind(1)
        H = c.features
        h = torch.zeros(x.shape[0], H, dtype=dt, device=x.device)
        out = []
        for xt in steps:
            xr, xz, xn = xt.split(H, dim=-1)
            hr, hz, hn = (h @ w_h.T).split(H, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * (hn + b_hn))
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out, dim=1)


# ------------------------------------------------------- ConvFormer blocks
class ConvFFN(nn.Module):
    """ConvFormer's FFN (sequential.py:201-219): Dense_0 -> act -> Dense_1
    -> dropout -> LayerNorm_0(h + x), flax's compact names, in the promoted
    dtype."""

    def __init__(self, hidden_size: int, inner_size: int, hidden_act: str,
                 hidden_dropout_prob: float, layer_norm_eps: float):
        super().__init__()
        self.act, self.p = ACT2FN[hidden_act], float(hidden_dropout_prob)
        self.Dense_0 = nn.Linear(hidden_size, inner_size)
        self.Dense_1 = nn.Linear(inner_size, hidden_size)
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        h = dense(self.Dense_1, self.act(dense(self.Dense_0, x, None)), None)
        h = apply_dropout(h, self.p, train, rng)
        return layer_norm(self.LayerNorm_0, h + x, None)


class DepthwiseConvLayer(nn.Module):
    """Depthwise Conv1d token mixer (sequential.py:222-252): the sequence
    left-padded by conv_size - 1 rows (``circular``: its last rows;
    ``reflect``: its last rows reversed; ``constant``: zeros), a valid
    depthwise convolution with ``conv_kernel`` [K, H] plus ``conv_bias``,
    dropout, LayerNorm_0(h + x). Window indices past the padded sequence
    clamp to its last row, as the JAX gather does. Both parameters are
    drawn from normal(init_ratio)."""

    def __init__(self, conv_size: int, padding_mode: str, hidden_dropout_prob: float,
                 hidden_size: int, layer_norm_eps: float, init_ratio: float):
        super().__init__()
        self.K, self.mode = int(conv_size), padding_mode
        self.p, self.init_ratio = float(hidden_dropout_prob), float(init_ratio)
        self.conv_kernel = nn.Parameter(torch.empty(self.K, hidden_size))
        self.conv_bias = nn.Parameter(torch.empty(hidden_size))
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def jax_init(self, generator: torch.Generator) -> None:
        for w in (self.conv_kernel, self.conv_bias):
            nn.init.normal_(w, 0.0, self.init_ratio, generator=generator)

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.K - 1
        if not pad:
            return x
        if self.mode == "circular":
            return torch.cat([x[:, -pad:], x], dim=1)
        if self.mode == "reflect":
            return torch.cat([x.flip(1)[:, :pad], x], dim=1)
        return F.pad(x, (0, 0, pad, 0))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        L = x.shape[1]
        dt = torch.promote_types(x.dtype, self.conv_kernel.dtype)
        xp = self._padded(x).to(dt)
        kernel = self.conv_kernel.to(dt)
        h = self.conv_bias.to(dt).expand(x.shape[0], L, -1)
        pos = torch.arange(L, device=x.device)
        for k in range(self.K):
            h = h + xp.index_select(1, (pos + k).clamp(max=xp.shape[1] - 1)) * kernel[k]
        h = apply_dropout(h, self.p, train, rng)
        return layer_norm(self.LayerNorm_0, h + x, None)


class SpectralConvLayer(nn.Module):
    """FASTConvFormer's mixer (sequential.py:255-282): the filter
    ``conv_weight`` [1, K, H], zero-padded to max_seq_len rows and cut to
    the sequence's L, multiplied with the sequence in the rfft domain
    (norm="ortho" both ways), irfft back to L rows in x's dtype, dropout,
    LayerNorm_0(h + x). The transforms run in f32 (torch's CUDA rfft takes
    no bf16). ``conv_weight`` is drawn from normal(0.02)."""

    def __init__(self, conv_size: int, hidden_dropout_prob: float, hidden_size: int,
                 layer_norm_eps: float, max_seq_len: int):
        super().__init__()
        self.K, self.max_seq_len = int(conv_size), int(max_seq_len)
        self.p = float(hidden_dropout_prob)
        self.conv_weight = nn.Parameter(torch.empty(1, self.K, hidden_size))
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def jax_init(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.conv_weight, 0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        L = x.shape[1]
        w = F.pad(self.conv_weight.float(), (0, 0, 0, self.max_seq_len - self.K))[:, :L]
        xf = torch.fft.rfft(x.float(), dim=1, norm="ortho")
        wf = torch.fft.rfft(w, dim=1, norm="ortho")
        h = torch.fft.irfft(xf * wf, n=L, dim=1, norm="ortho").to(x.dtype)
        h = apply_dropout(h, self.p, train, rng)
        return layer_norm(self.LayerNorm_0, h + x, None)


# ------------------------------------------------------- AdaRanker blocks
def torch_linear_(w: torch.Tensor, generator: torch.Generator, fan_in: int) -> None:
    """U(+-1/sqrt(fan_in)): torch.nn.Linear's default draw, the JAX
    package's ``torch_linear_kernel_init`` (variance_scaling(1/3, fan_in,
    uniform)) and ``torch_linear_bias_init``."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    nn.init.uniform_(w, -bound, bound, generator=generator)


def torch_linear_kernel_(lin: nn.Linear, generator: torch.Generator) -> None:
    """A Linear's kernel from ``torch_linear_kernel_init``, its bias zero."""
    torch_linear_(lin.weight, generator, lin.in_features)
    if lin.bias is not None:
        lin.bias.zero_()


class NeuProcessEncoder(nn.Module):
    """Neural-process set encoder (modules.py:842-885): ``input_hidden``,
    dropout, relu, ``input_out``, the mean over the set, relu of
    ``z_to_hidden``, then ``hidden_to_mu`` and ``hidden_to_logsigma``; in
    training z = mu + eps exp(log_sigma / 2), eps from the step's dropout
    generator, else z = mu. Kernels from torch's Linear draw, zero biases,
    the log-sigma bias -8 unless ``reference_init`` (then torch's draw)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 dropout_prob: float, reference_init: bool = False):
        super().__init__()
        self.p, self.reference_init = float(dropout_prob), reference_init
        self.input_hidden = nn.Linear(input_size, hidden_size)
        self.input_out = nn.Linear(hidden_size, output_size)
        self.z_to_hidden = nn.Linear(output_size, hidden_size)
        self.hidden_to_mu = nn.Linear(hidden_size, output_size)
        self.hidden_to_logsigma = nn.Linear(hidden_size, output_size)

    def jax_init(self, generator: torch.Generator) -> None:
        for lin in (self.input_hidden, self.input_out, self.z_to_hidden, self.hidden_to_mu,
                    self.hidden_to_logsigma):
            torch_linear_kernel_(lin, generator)
        if self.reference_init:
            torch_linear_(self.hidden_to_logsigma.bias, generator,
                          self.hidden_to_logsigma.in_features)
        else:
            self.hidden_to_logsigma.bias.fill_(-8.0)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        h = apply_dropout(dense(self.input_hidden, x, None), self.p, train, rng)
        h = dense(self.input_out, torch.relu(h), None)
        h2 = torch.relu(dense(self.z_to_hidden, h.mean(-2), None))
        mu = dense(self.hidden_to_mu, h2, None)
        if not train:
            return mu
        log_sigma = dense(self.hidden_to_logsigma, h2, None)
        eps = randn_rows(_need_rng(rng).rows, mu.shape, mu.device)
        return mu + eps * torch.exp(0.5 * log_sigma)


class MemoryUnit(nn.Module):
    """Parameter memory (modules.py:888-918): ``clusters_k`` parameter
    blocks ``array`` [K, in * out] mixed by softmax(z index^T); returns
    [B, out, in] patches. ``init_center``: 'one' (1 + normal(0.05), the
    weight patches), 'zero' (normal(0.05), the bias patches) or 'xavier'
    (glorot-uniform, the reference's); ``index`` is glorot-uniform."""

    def __init__(self, input_size: int, output_size: int, emb_size: int,
                 clusters_k: int = 10, init_center: str = "one"):
        super().__init__()
        self.input_size, self.output_size, self.init_center = input_size, output_size, init_center
        self.array = nn.Parameter(torch.empty(clusters_k, input_size * output_size))
        self.index = nn.Parameter(torch.empty(clusters_k, emb_size))

    def jax_init(self, generator: torch.Generator) -> None:
        # flax's glorot_uniform on [K, n]: fan_in K, fan_out n
        if self.init_center == "one":
            nn.init.normal_(self.array, 1.0, 0.05, generator=generator)
        elif self.init_center == "zero":
            nn.init.normal_(self.array, 0.0, 0.05, generator=generator)
        else:
            _glorot_uniform_(self.array, generator)
        _glorot_uniform_(self.index, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        att = torch.softmax(z @ self.index.T, dim=-1)
        return (att @ self.array).reshape(-1, self.output_size, self.input_size)


def _glorot_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's glorot_uniform on a 2-D [fan_in, fan_out] parameter."""
    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    nn.init.uniform_(w, -bound, bound, generator=generator)


class AdaLinear(nn.Module):
    """Linear layer under per-request patches (modules.py:921-945):
    ``weight`` [in, out] (the flax layout), ``bias`` [out]; with patches
    the weight is mem_w^T * weight a request and the bias bias + mem_b."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def jax_init(self, generator: torch.Generator) -> None:
        torch_linear_(self.weight, generator, self.weight.shape[0])
        torch_linear_(self.bias, generator, self.weight.shape[0])

    def forward(self, x: torch.Tensor, mem_w: torch.Tensor | None = None,
                mem_b: torch.Tensor | None = None) -> torch.Tensor:
        if mem_w is None:
            return x @ self.weight + self.bias
        w_new = mem_w.transpose(1, 2) * self.weight[None]          # [B, in, out]
        out = torch.einsum("b...i,bio->b...o", x, w_new)
        b_new = self.bias[None]
        if mem_b is not None:
            b_new = b_new + mem_b[..., 0]                          # [B, out]
        return out + b_new[:, None, :] if out.dim() == 3 else out + b_new


# ------------------------------------------- ranking blocks no model uses
# The JAX package exports these four and tests them (tests/test_kernels.py:
# 157-200), but no registered model of either package calls them. They
# carry the flax names, so the bridge maps their parameters.
class Dice(nn.Module):
    """Dice activation (modules.py:783-795): f(s) = p s + (1 - p) alpha s
    with p = sigmoid(s) and ``alpha`` a zero-initialized parameter [D]."""

    def __init__(self, emb_size: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(emb_size))

    def jax_init(self, generator: torch.Generator) -> None:
        self.alpha.zero_()

    def forward(self, score: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(score)
        return self.alpha * (1.0 - p) * score + p * score


class SequenceAttLayer(nn.Module):
    """DIN-style target attention over the history (modules.py:798-823):
    queries [B, T, H] through ``dense_1``, keys [B, L, H] through
    ``dense_2`` (no biases), their products set to 0.0 at the left-padding
    keys (l < L - keys_length, the reference's mask value) before a softmax
    of the products over sqrt(H); returns the weighted sum of the raw keys."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.dense_1 = nn.Linear(input_size, output_size, bias=False)
        self.dense_2 = nn.Linear(input_size, output_size, bias=False)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                keys_length: torch.Tensor) -> torch.Tensor:
        H, L = queries.shape[-1], keys.shape[1]
        att = torch.einsum("bth,blh->btl", F.linear(queries, self.dense_1.weight),
                           F.linear(keys, self.dense_2.weight))
        invalid = torch.arange(L, device=keys.device)[None, :] < (L - keys_length[:, None])
        att = torch.where(invalid[:, None, :], 0.0, att)
        att = torch.softmax(att / math.sqrt(float(H)), dim=-1)
        return torch.einsum("btl,blh->bth", att, keys)


class ModulateHidden(nn.Module):
    """A per-request square weight generated from z, applied to the hidden
    state (modules.py:948-961): ``gen_para_layer`` maps z to [in, in]."""

    def __init__(self, input_size: int, emb_size: int):
        super().__init__()
        self.input_size = input_size
        self.gen_para_layer = nn.Linear(emb_size, input_size * input_size)

    def jax_init(self, generator: torch.Generator) -> None:
        torch_linear_kernel_(self.gen_para_layer, generator)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        n = self.input_size
        w = self.gen_para_layer(z).reshape(-1, n, n)
        return torch.einsum("b...i,boi->b...o", x, w)


class MMoEUnit(nn.Module):
    """Mixture-of-experts parameter generator (modules.py:964-982): a
    softmax gate (``gate_net``, no bias) over ``expert_num`` parameter
    blocks ``weight`` [expert_num, out * in], keyed on z (its first row when
    z is [B, n, D]); returns [B, out, in]."""

    def __init__(self, input_size: int, output_size: int, emb_size: int,
                 expert_num: int = 10):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.weight = nn.Parameter(torch.empty(expert_num, output_size * input_size))
        self.gate_net = nn.Linear(emb_size, expert_num, bias=False)

    def jax_init(self, generator: torch.Generator) -> None:
        torch_linear_(self.weight, generator, self.weight.shape[0])
        torch_linear_kernel_(self.gate_net, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        if z.dim() == 3:
            z = z[:, 0]
        att = torch.softmax(self.gate_net(z), dim=-1)
        return (att @ self.weight).reshape(-1, self.output_size, self.input_size)


# ------------------------------------------------------------------ HSTU
def plain_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without affine parameters over the last axis, in f32, as
    element-wise ops and two row means. torch's layer_norm kernels take
    their one-block-a-row path where the width is not a multiple of their
    vector (HSTU's 50): 8.8 ms a call at [1.64M, 50] on an H100, against
    1.8 ms for these passes (PERF.md §4)."""
    x = x.float()
    xc = x - x.mean(-1, keepdim=True)
    return xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)


class RelativePositionBias(nn.Module):
    """HSTU's relative-position bias: one learned value for each offset j - i
    of a key from its query, in (-max_len, max_len), shared by the heads (the
    position part of RelativeBucketedTimeAndPositionBasedBias in the public
    code; its timestamp part is not modelled). ``weight`` [2 max_len - 1],
    drawn from N(0, 0.02) as there."""

    def __init__(self, max_len: int):
        super().__init__()
        self.max_len = int(max_len)
        self.weight = nn.Parameter(torch.zeros(2 * self.max_len - 1))

    def jax_init(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)

    def table(self, L: int) -> torch.Tensor:
        """The [2L - 1] entries of offsets -(L - 1) .. L - 1."""
        c = self.max_len - 1
        return self.weight[c - (L - 1):c + L]


class HSTULayer(nn.Module):
    """One HSTU layer (Zhai et al., ICML 2024; the public code's
    SequentialTransductionUnitJagged), for x [B, L, d]:

        U, V, Q, K = split(SiLU(LN(x) W_uvqk))     (W_uvqk without a bias)
        A_h = SiLU(Q_h K_h^T + rab) / L             (causal, padding keys out)
        y = x + W_o(Dropout(U * LN(concat_h A_h V_h))) + b_o

    The norms have no affine parameters and run in f32, as does the table;
    the products, SiLU and the gate in the compute dtype. The attention is
    ops/hstu_attention.py: its kernels on the card (bf16; past their capacity
    they raise), its plain versions on the CPU. Dropout draws its mask from
    the step's ``DropoutRNG``."""

    def __init__(self, hidden_size: int, n_heads: int, dqk: int, dv: int, max_len: int,
                 dropout_prob: float, layer_norm_eps: float, dtype=None):
        super().__init__()
        self.n_heads, self.dqk, self.dv = int(n_heads), int(dqk), int(dv)
        self.p, self.eps, self.dtype = float(dropout_prob), float(layer_norm_eps), dtype
        self.uvqk = nn.Linear(hidden_size, self.n_heads * (2 * self.dv + 2 * self.dqk),
                              bias=False)
        self.o = nn.Linear(self.n_heads * self.dv, hidden_size)
        self.rab = RelativePositionBias(max_len)

    def forward(self, x: torch.Tensor, keys: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        dt = self.dtype or x.dtype
        H, dqk, dv = self.n_heads, self.dqk, self.dv
        with tracing.span("hstu.uvqk"):
            xh = plain_norm(x, self.eps).to(dt)
            uvqk = F.silu(F.linear(xh, self.uvqk.weight.to(dt)))
            u, v, q, k = torch.split(uvqk, [H * dv, H * dv, H * dqk, H * dqk], dim=-1)
        with tracing.span("hstu.attention"):
            q, k, v = q.unflatten(-1, (H, dqk)), k.unflatten(-1, (H, dqk)), \
                v.unflatten(-1, (H, dv))
            o = hstu_ops.hstu_attention(q, k, v, self.rab.table(x.shape[1]), keys).flatten(-2)
        with tracing.span("hstu.output"):
            on = plain_norm(o, self.eps).to(dt)
            h = apply_dropout(u * on, self.p, train, rng)
            return x + F.linear(h, self.o.weight.to(dt), self.o.bias.to(dt))


class HSTUEncoder(nn.Module):
    """``n_layers`` HSTU layers (``layer_{i}``) under the span
    ``hstu.encoder``; ``keys`` [B, L] is False at padding."""

    def __init__(self, n_layers: int, **layer):
        super().__init__()
        self.n_layers = int(n_layers)
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", HSTULayer(**layer))

    def forward(self, x: torch.Tensor, keys: torch.Tensor, train: bool = False,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        with tracing.span("hstu.encoder"):
            for i in range(self.n_layers):
                x = getattr(self, f"layer_{i}")(x, keys, train, rng)
        return x
