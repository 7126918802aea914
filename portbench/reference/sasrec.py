"""Plain PyTorch reference of SASRec training and full-catalog top-k serving.

This file is the yardstick that decides ``correct``. It imports nothing of
the program under test (``unirec_tpu_torch``) and nothing of JAX: every
quantity the program derives from the benchmark's inputs (the history
windows, the negatives, the alias table, the dropout masks, the tower, the
loss, the gradients, Adam's update, the catalog scores) is worked out again
here, in float32 with TF32 off (or float64 in the CPU tests), as plain
tensor operations with autograd.

Semantics (UniRec's SASRec with the BCE loss, as the port documents them):

* history window: the user's packed history row, targets handled by the
  ``history_mask_mode`` rule (``unorder``: occurrences of the target zeroed;
  ``autoregressive``: the row cut before a uniformly chosen occurrence of
  the target), the last ``max_seq_len`` items right-aligned, 0 padding;
* negatives: ``n_neg * oversample`` proposals, uniform over [1, n_items) or
  from a Walker alias table of popularity ** alpha; a proposal equal to the
  positive or in the user's history is rejected, the first survivor of
  each group of ``oversample`` kept, 0 if none survives;
* tower: item rows (id 0 gives zeros) plus position rows, LayerNorm,
  dropout, post-LN transformer layers under the -1e4 causal and key-padding
  mask (the last layer for the last position only with
  ``last_query_only``), the last position's state;
* loss: BCE over clamped sigmoid probabilities, mean over the 1 + n_neg
  columns, weighted mean over rows; Adam (b1 0.9, b2 0.999, eps 1e-8).

Randomness. The program draws its negatives, its plain dropout masks and
the seeds of its fused kernels from torch generators keyed by
(seed, step); the fused kernels key their masks by Philox4x32-10 of
(kernel seed, site, example, element). Those rules are part of what the
configuration states, so the reference draws the same numbers from the
same generators and recomputes the Philox bits itself: a step here sees the
batch and the masks that the program's step saw, and the comparison
measures arithmetic, not sampling noise.

``Precision`` lowers the reference to a control: ``fp8`` rounds every
matrix product's operands (and the gathered rows) to float8 e4m3 with a
per-tensor scale, the step below the configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

MASK_VALUE = -1e4
BCE_EPS = 1e-8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
U32 = 0xFFFFFFFF
FP8_MAX = 448.0


# ----------------------------------------------------------------- precision
class Precision:
    """``q(x)``: x as the reference computes it. ``f32``: unchanged;
    ``fp8``: rounded to float8 e4m3 under a per-tensor scale, the gradient
    passed straight through."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        with torch.no_grad():
            amax = x.detach().abs().amax().clamp(min=1e-30)
            scale = FP8_MAX / amax
            r = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
        return x + (r - x).detach()


F32 = Precision("f32")


def _full_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ Philox
def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of 32-bit m and c, from
    16-bit halves so that no int64 product overflows."""
    ml, mh = m & 0xFFFF, m >> 16
    cl, ch = c & 0xFFFF, c >> 16
    mid = mh * cl + ml * ch
    low = ml * cl + ((mid & 0xFFFF) << 16)
    hi = (mh * ch + (mid >> 16) + (low >> 32)) & U32
    return hi, low & U32


def philox_word0(seed: int, site: int, b: torch.Tensor, elem: torch.Tensor) -> torch.Tensor:
    """Word 0 of Philox4x32-10 with counter (elem, b, 0, 0) and key
    (seed, site); int64 tensors that broadcast."""
    c0, c1 = torch.broadcast_tensors(elem.to(torch.int64), b.to(torch.int64))
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = int(seed) & U32, int(site) & U32
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + 0x9E3779B9) & U32, (k1 + 0xBB67AE85) & U32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def philox_keep(seed: int, p: float, site: int, B: int, elems: torch.Tensor,
                device, chunk: int = 1 << 24) -> torch.Tensor:
    """[B, *elems.shape] bool: example b's element e is kept iff its Philox
    word is >= round(p * 2^32). Computed in row blocks of at most ``chunk``
    elements."""
    thresh = min(max(int(round(p * 2.0 ** 32)), 0), U32)
    elems = elems.to(device=device, dtype=torch.int64)
    out = torch.empty((B, *elems.shape), dtype=torch.bool, device=device)
    rows = max(1, chunk // max(elems.numel(), 1))
    for lo in range(0, B, rows):
        hi = min(B, lo + rows)
        b = torch.arange(lo, hi, device=device).view(-1, *([1] * elems.dim()))
        out[lo:hi] = philox_word0(seed, site, b, elems[None]) >= thresh
    return out


# ----------------------------------------------------------------- config
class Sizes:
    """The sizes and switches of one SASRec configuration (a port config
    dict, as the configuration file holds it)."""

    def __init__(self, cfg: Dict):
        g = cfg.get
        self.n_items = int(cfg["n_items"])
        self.L = int(cfg["max_seq_len"])
        self.D = int(g("hidden_size") or g("embedding_size"))
        self.nh = int(g("n_heads", 2))
        self.F = int(g("inner_size", 256))
        self.n_layers = int(g("n_layers", 2))
        self.eps = float(g("layer_norm_eps", 1e-12))
        self.act = g("hidden_act", "gelu")
        self.p_hidden = float(g("hidden_dropout_prob", 0.5))
        self.p_attn = float(g("attn_dropout_prob", 0.5))
        self.bits8 = int(g("dropout_bits", 32)) == 8
        self.n_neg = int(g("n_sample_neg_train", 0) or 0)
        self.oversample = max(int(g("neg_oversample_factor", 4)), 1)
        self.mask_mode = g("history_mask_mode", "unorder")
        self.seq_last = bool(g("seq_last", 0))
        self.alpha = float(g("neg_by_pop_alpha", 0) or 0)
        self.lr = float(g("learning_rate", 1e-3))
        self.last_query = bool(g("last_query_only", 0))
        # which dropout sites the program's kernels key by Philox: the whole
        # tower as one chain of layer kernels, or the attention kernel's
        # probabilities in the full-length layers
        self.chain = bool(g("fused_layer", 0)) and bool(g("fused_lastq", 0)) \
            and self.last_query and not g("use_fused_ffn", 0)
        self.fused_attention = bool(g("use_fused_attention", 0))
        self.Lp = -(-self.L // 8) * 8
        if g("fused_layer", 0) and not self.chain:
            raise ValueError("reference models the layer kernels only as the whole chain")
        for key in ("remat_attention", "qkv_packed", "attn_head_stacked", "has_user_emb",
                    "use_features", "use_text_emb", "time_seq", "has_item_bias"):
            if g(key, 0):
                raise ValueError(f"reference does not model {key}")
        if g("distance_type", "dot") != "dot" or g("loss_type", "bce") != "bce":
            raise ValueError("reference models dot scores under the BCE loss")
        if float(g("tau", 1.0)) != 1.0 or float(g("score_clip_value", -1) or -1) > 0:
            raise ValueError("reference models tau 1 and no score clip")
        if g("optimizer", "adam") != "adam" or float(g("weight_decay", 0) or 0) \
                or float(g("grad_clip_value", -1) or -1) > 0:
            raise ValueError("reference models plain Adam")


def step_seeds(seed: int, step: int):
    """(negatives seed, dropout seed) of training step ``step`` (0-based):
    the program's per-step randomness is this function of (seed, step)."""
    a, b = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return int(a), int(b)


# ---------------------------------------------------------------- dropout
class Dropout:
    """The dropout randomness of one training step: ``plain`` sites draw
    from a torch generator on the device, each fused-kernel call takes a
    seed from a host generator (both seeded with the step's dropout seed)."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed)
        self.device = torch.device(device)

    def kernel_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.host)) & U32

    def plain(self, x: torch.Tensor, p: float, bits8: bool) -> torch.Tensor:
        if p <= 0.0:
            return x
        if bits8:
            thr = int(round(p * 256.0))
            if thr <= 0:
                return x
            bits = torch.randint(0, 256, x.shape, generator=self.gen, device=self.device,
                                 dtype=torch.uint8)
            return torch.where(bits >= thr, x * (1.0 / (1.0 - thr / 256.0)),
                               torch.zeros_like(x))
        keep = torch.rand(x.shape, generator=self.gen, device=self.device) < 1.0 - p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _philox_drop(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    return torch.where(keep, x * (1.0 / (1.0 - p)), torch.zeros_like(x))


# ---------------------------------------------------------------- the tower
def _layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _act(name: str, u: torch.Tensor) -> torch.Tensor:
    if name == "swish":
        return u * torch.sigmoid(u)
    if name == "relu":
        return torch.relu(u)
    if name == "gelu":
        return 0.5 * u * (1.0 + torch.erf(u / math.sqrt(2.0)))
    if name == "tanh":
        return torch.tanh(u)
    if name == "sigmoid":
        return torch.sigmoid(u)
    raise ValueError(f"activation {name}")


def _linear(W, name, x, q: Precision):
    return q(x) @ q(W[name + ".weight"]).transpose(0, 1) + W[name + ".bias"]


def _layer(W, s: Sizes, i: int, x, add, last: bool, drop: Optional[Dropout], q: Precision):
    """One post-LN layer; ``last``: the last position's query only."""
    pre = f"trm_encoder.layer_{i}."
    B, L, D = x.shape
    nh, hd = s.nh, D // s.nh
    xq = x[:, L - 1:] if last else x
    Lq = xq.shape[1]
    a = pre + "multi_head_attention."
    qh = _linear(W, a + "query", xq, q).view(B, Lq, nh, hd).transpose(1, 2)
    kh = _linear(W, a + "key", x, q).view(B, L, nh, hd).transpose(1, 2)
    vh = _linear(W, a + "value", x, q).view(B, L, nh, hd).transpose(1, 2)
    mask = (add[:, L - 1:] if last else add)[:, None]           # [B, 1, Lq, L]
    probs = torch.softmax(q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(hd) + mask, dim=-1)
    # a layer kernel takes one seed whenever it drops anything; the
    # attention kernel of a full-length layer one when it drops probabilities
    kseed = None
    if drop is not None and ((s.chain and (s.p_attn > 0 or s.p_hidden > 0))
                             or (s.fused_attention and not s.chain and not last
                                 and s.p_attn > 0)):
        kseed = drop.kernel_seed()
    hidden_by_kernel = drop is not None and s.chain
    if drop is not None and s.p_attn > 0:
        if kseed is not None:
            # the kernels' probability sites: head h, element i * row + j
            # (the chain pads rows to Lp; the last-query kernel keys j alone)
            if last:
                elems = torch.arange(L)[None, :]
            else:
                row = s.Lp if s.chain else L
                elems = torch.arange(L)[:, None] * row + torch.arange(L)[None, :]
            keep = torch.stack([philox_keep(kseed, s.p_attn, h, B, elems, x.device)
                                for h in range(nh)], dim=1)
            probs = _philox_drop(probs, keep, s.p_attn)
        else:
            probs = drop.plain(probs, s.p_attn, s.bits8)
    ctx = (q(probs) @ q(vh)).transpose(1, 2).reshape(B, Lq, D)
    o = _linear(W, a + "dense", ctx, q)
    hidden_elems = torch.arange(Lq * D).view(Lq, D) if not last else torch.arange(D)[None]

    def hidden_drop(t, site):
        if drop is None or s.p_hidden <= 0:
            return t
        if hidden_by_kernel:
            return _philox_drop(t, philox_keep(kseed, s.p_hidden, site, B, hidden_elems,
                                               x.device), s.p_hidden)
        return drop.plain(t, s.p_hidden, s.bits8)

    x1 = _layer_norm(hidden_drop(o, nh) + xq, W[a + "LayerNorm.weight"],
                     W[a + "LayerNorm.bias"], s.eps)
    f = pre + "feed_forward."
    h2 = _linear(W, f + "dense_2", _act(s.act, _linear(W, f + "dense_1", x1, q)), q)
    return _layer_norm(hidden_drop(h2, nh + 1) + x1, W[f + "LayerNorm.weight"],
                       W[f + "LayerNorm.bias"], s.eps)


def user_embedding(W, s: Sizes, item_seq: torch.Tensor, drop: Optional[Dropout] = None,
                   q: Precision = F32) -> torch.Tensor:
    """The tower's output [B, D] for left-padded windows ``item_seq``."""
    B, L = item_seq.shape
    seq = item_seq.long()
    x = q(W["item_embedding.weight"])[seq] * (seq != 0)[..., None]
    x = x + q(W["position_embedding.weight"][:L])[None]
    x = _layer_norm(x, W["LayerNorm.weight"], W["LayerNorm.bias"], s.eps)
    if drop is not None:
        x = drop.plain(x, s.p_hidden, s.bits8)
    keys = seq > 0
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=seq.device))
    add = torch.where(keys[:, None, :] & tri[None], 0.0, MASK_VALUE).to(x.dtype)
    for i in range(s.n_layers):
        x = _layer(W, s, i, x, add, s.last_query and i == s.n_layers - 1, drop, q)
    return x[:, -1]


# ------------------------------------------------------------- the pipeline
class AliasTable:
    """Walker's alias table of ``weights`` (float64 construction, the small
    and large stacks popped from their ends); thresholds kept as float32."""

    def __init__(self, weights: np.ndarray):
        w = np.asarray(weights, dtype=np.float64)
        n = len(w)
        prob = w * n / w.sum()
        alias = np.zeros(n, dtype=np.int64)
        thresh = np.ones(n, dtype=np.float64)
        small = [i for i in range(n) if prob[i] < 1.0]
        large = [i for i in range(n) if prob[i] >= 1.0]
        while small and large:
            sm, lg = small.pop(), large.pop()
            thresh[sm] = prob[sm]
            alias[sm] = lg
            prob[lg] -= 1.0 - prob[sm]
            (small if prob[lg] < 1.0 else large).append(lg)
        self.thresh = thresh.astype(np.float32)
        self.alias = alias.astype(np.int32)


def make_alias(popularity: np.ndarray, alpha: float) -> AliasTable:
    w = np.power(np.asarray(popularity, dtype=np.float64), alpha)
    w[0] = 0.0
    return AliasTable(w)


def train_batch(s: Sizes, user_id: torch.Tensor, item_id: torch.Tensor,
                hist_items: torch.Tensor, hist_lens: torch.Tensor, aug_seed: int,
                alias: Optional[AliasTable] = None) -> Dict[str, torch.Tensor]:
    """The training batch of raw (user, item) rows: candidates [B, 1 + n_neg]
    (the positive first), labels, the history window and its length."""
    dev = hist_items.device
    gen = torch.Generator(device=dev).manual_seed(aug_seed)
    uid = user_id.long().to(dev)
    rows = hist_items[uid].long()
    lens = hist_lens[uid].long()
    pos = item_id.long().to(dev)[:, None]
    B, C = rows.shape
    K = s.n_neg * s.oversample
    if alias is None:
        cand = torch.randint(1, s.n_items, (B, K), generator=gen, device=dev,
                             dtype=torch.int32).long()
    else:
        th = torch.as_tensor(alias.thresh, device=dev)
        al = torch.as_tensor(alias.alias, device=dev).long()
        idx = torch.randint(0, th.shape[0], (B, K), generator=gen, device=dev)
        frac = torch.rand((B, K), generator=gen, device=dev)
        cand = torch.where(frac < th[idx], idx, al[idx])
    in_hist = torch.zeros((B, K), dtype=torch.bool, device=dev)
    for j in range(C):                               # a column at a time: [B, K] temporaries
        in_hist |= (cand == rows[:, j:j + 1]) & (rows[:, j:j + 1] > 0)
    ok = ~((cand == pos) | in_hist)
    ok = ok.view(B, s.n_neg, s.oversample)
    cand = cand.view(B, s.n_neg, s.oversample)
    first = ok.to(torch.int8).argmax(-1, keepdim=True)
    negs = torch.where(ok.any(-1), cand.gather(-1, first)[..., 0], 0)
    cands = torch.cat([pos, negs], 1)
    # the history window
    is_tgt = (rows == pos) & (rows > 0)
    L = s.L
    if s.mask_mode == "unorder":
        rows = torch.where(is_tgt, 0, rows)
        n = lens
    else:
        valid = is_tgt & (torch.arange(C, device=dev)[None, :] < lens[:, None])
        counts = valid.sum(-1)
        if s.seq_last:
            rev = C - 1 - valid.flip(-1).to(torch.int8).argmax(-1)
            n = torch.where(counts > 0, rev, lens)
        else:
            hi = counts.clamp(min=1)
            u = torch.rand((B,), generator=gen, device=dev)
            r = torch.minimum((u * hi).long(), hi - 1)
            sel = (valid.long().cumsum(-1) > r[:, None]) & valid
            n = torch.where(counts > 0, sel.to(torch.int8).argmax(-1), lens)
    grid = n[:, None] - L + torch.arange(L, device=dev)[None, :]
    seq = rows.gather(1, grid.clamp(0, C - 1)) * (grid >= 0)
    label = torch.zeros(cands.shape, dtype=torch.float32, device=dev)
    label[:, 0] = 1.0
    return {"item_id": cands, "label": label, "item_seq": seq,
            "item_seq_len": torch.clamp(n, max=L)}


def bce(scores: torch.Tensor, label: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    p = torch.sigmoid(scores).clamp(BCE_EPS, 1.0 - BCE_EPS)
    comp = torch.where(1.0 - p > 0, 1.0 - p, torch.sigmoid(-scores).clamp(min=BCE_EPS))
    per_row = -(label * torch.log(p) + (1.0 - label) * torch.log(comp)).mean(-1)
    w = weight.to(per_row.dtype)
    return (per_row * w).sum() / w.sum().clamp(min=1.0)


def loss_of(W, s: Sizes, batch, weight, drop: Optional[Dropout], q: Precision):
    u = user_embedding(W, s, batch["item_seq"], drop, q)
    ids = batch["item_id"].long()
    items = q(W["item_embedding.weight"])[ids] * (ids != 0)[..., None]
    scores = (q(u)[:, None, :] * q(items)).sum(-1)
    return bce(scores, batch["label"].to(u.dtype), weight)


def train(W0: Dict[str, torch.Tensor], cfg: Dict, raw: Sequence[Dict[str, np.ndarray]],
          hist_items: torch.Tensor, hist_lens: torch.Tensor, seed: int,
          popularity: Optional[np.ndarray] = None, q: Precision = F32,
          dtype=torch.float32) -> Dict:
    """``len(raw)`` training steps from the weights W0 (name -> tensor).
    Returns each step's loss, each leaf's first gradient and its change over
    all the steps (norms, by name), and each step's batch."""
    _full_f32()
    s = Sizes(cfg)
    dev = hist_items.device
    alias = make_alias(popularity, s.alpha) if (s.alpha > 0 and popularity is not None) \
        else None
    P = {k: v.detach().to(device=dev, dtype=dtype).clone().requires_grad_(True)
         for k, v in W0.items()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, batches, grad_norm = [], [], None
    for step, rb in enumerate(raw):
        aug_seed, drop_seed = step_seeds(seed, step)
        batch = train_batch(s, torch.as_tensor(rb["user_id"]), torch.as_tensor(rb["item_id"]),
                            hist_items, hist_lens, aug_seed, alias)
        batches.append({k: batch[k] for k in ("item_id", "item_seq", "item_seq_len")})
        weight = torch.as_tensor(rb["weight"], device=dev)
        loss = loss_of(P, s, batch, weight, Dropout(drop_seed, dev), q)
        grads = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            t = step + 1
            for (k, p), g in zip(P.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * g
                nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * g * g
                mhat = mu[k] / (1 - ADAM_B1 ** t)
                vhat = nu[k] / (1 - ADAM_B2 ** t)
                p -= s.lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
            if grad_norm is None:
                grad_norm = {k: float((torch.zeros_like(p) if g is None else g).norm())
                             for (k, p), g in zip(P.items(), grads)}
        del grads, loss
    change = {k: float((P[k].detach() - W0[k].to(dev, dtype)).norm()) for k in P}
    return {"losses": losses, "grad_norm": grad_norm, "change_norm": change,
            "batches": batches}


# ---------------------------------------------------------------- serving
def windows(hist_items: torch.Tensor, hist_lens: torch.Tensor, users: torch.Tensor, L: int):
    """The serving windows: the last L items of each user's history,
    right-aligned, 0 padding."""
    rows = hist_items[users.long()].long()
    n = hist_lens[users.long()].long()
    C = rows.shape[1]
    grid = n[:, None] - L + torch.arange(L, device=rows.device)[None, :]
    return rows.gather(1, grid.clamp(0, C - 1)) * (grid >= 0)


def catalog_scores(W, cfg: Dict, users: torch.Tensor, hist_items: torch.Tensor,
                   hist_lens: torch.Tensor, q: Precision = F32,
                   dtype=torch.float32) -> torch.Tensor:
    """[B, n_items] scores of every item for ``users``, the users' history
    items and the padding item at -inf."""
    _full_f32()
    s = Sizes(cfg)
    Wd = {k: v.to(dtype) for k, v in W.items()}
    with torch.no_grad():
        u = user_embedding(Wd, s, windows(hist_items, hist_lens, users, s.L), None, q)
        table = Wd["item_embedding.weight"].clone()
        table[0] = 0.0
        scores = q(u) @ q(table).transpose(0, 1)
        rows = hist_items[users.long()].long()
        live = torch.arange(rows.shape[1], device=rows.device)[None, :] \
            < hist_lens[users.long()].long()[:, None]
        scores.scatter_(1, torch.where(live, rows, 0), float("-inf"))
        scores[:, 0] = float("-inf")
    return scores


def topk_ids(scores: torch.Tensor, k: int) -> torch.Tensor:
    return scores.topk(k, dim=1).indices
