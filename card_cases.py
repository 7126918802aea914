"""What the two card suites share: ``tests/test_torch_gpu.py`` (each kernel
against its plain version, ``pytest -m gpu``) and ``chip_smoke.py`` (kernel
times and bounds, the path runs) take their tolerances, case builders and
holders from here, so each decision is written once.

Tolerances are keyed by dtype name (``dtype_name``). The module imports
neither JAX nor, when imported, torch: ``chip_smoke.py`` imports it, and
is imported on machines without a card; the builders import torch inside.
"""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Outputs of the whole layer and the last-query layer (rows 1, 3), absolute:
# they are LayerNorm outputs, O(1). f32 differs by summation order only;
# bf16 rounds where the plain versions round, but a rounding that flips at
# one point moves later roundings.
LN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Backward and gradient checks, relative to each output's largest reference
# value. f32: summation order (the kernels sum weight gradients per block,
# then across blocks). bf16: the kernels round to bf16 where the plain
# versions do, but sum in another f32 order, so a rounding can flip and
# later roundings carry it.
BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# Attention and FFN outputs (rows 10-13), relative to the largest output:
# f32 summation order only; bf16 two bf16 ulps (the two round at the same
# points, a sum's order can flip one rounding).
ATT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
# The solvers' matrices on the card against the port's CPU run, each
# matrix's largest difference over its largest entry: f32 on both sides,
# summed in another order (the Gram products and the inverse); the
# iterations of AdmmSLIM and SLIM carry the roundings.
SOLVERS = ("EASE", "AdmmSLIM", "SLIM", "SAR", "UserCF")
SOLVER_TOL = {"EASE": 1e-4, "SAR": 1e-4, "UserCF": 1e-4, "AdmmSLIM": 1e-3, "SLIM": 1e-3,
              "SLIM_active_set": 1e-3, "EASE_lu_vs_blocked": 1e-4}
# the sequential family beside SASRec (models/sequential.py)
FAMILY = ("GRU", "AvgHist", "AttHist", "SVDPlusPlus", "ConvFormer", "FASTConvFormer")


def dtype_name(dtype) -> str:
    """"float32" for torch.float32: the key of the tolerance tables."""
    return str(dtype).replace("torch.", "")


def ln_tol(ref) -> float:
    """bf16 LayerNorm outputs: LN_TOL, or two bf16 ulps of the largest
    output where that is more (an output in [4, 8) has ulp 2^-5 > 3e-2),
    since one rounding that flips moves an output by one ulp."""
    return max(LN_TOL["bfloat16"], 2.0 ** -6 * float(ref.float().abs().max()))


def f32_ulps(a, b) -> float:
    """The largest |a - b| over the elements, in f32 ulps of b."""
    import torch
    m = b.abs()
    spacing = torch.nextafter(m, torch.full_like(m, float("inf"))) - m
    return float(((a - b).abs() / spacing).max()) if a.numel() else 0.0


def layer_case(dev, dtype, B=8, L=10, D=32, F=64, seed=0):
    """Inputs of rows 1-4: x [B, L, D], the additive key mask (random
    padding, the last two keys real, example 0 fully padded) and the layer's
    weights at a trained model's scale."""
    import torch
    from unirec_tpu_torch.ops import layer as LY
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


def path_layer_case(dev, dtype, B, seed):
    """layer_case at the paths' widths (L=50 padded to 56, d=64, 2 heads,
    inner 128) on B examples, padded as the wrappers pad: (xp, mp, params)."""
    from unirec_tpu_torch.ops import layer as LY
    x, madd, params = layer_case(dev, dtype, B=B, L=50, D=64, F=128, seed=seed)
    xp, mp, _ = LY._pad_L(x, madd, 50)
    return xp, mp, params


def att_case(dev, dtype, B=6, H=2, L=10, hd=32, mask_heads=1, seed=0):
    """q, k, v [B, H, L, hd] at unit scale and the model's additive causal
    mask [B, mask_heads, L, L] (random padding, the last two keys real;
    example 0 has every key masked)."""
    import torch
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


def hstu_case(dev, B, L, H, dqk, dv, seed=0):
    """q, k [B, L, H, dqk], v [B, L, H, dv] split out of one bf16 projection
    as the model splits them (strided; heads on 2-byte boundaries at odd
    widths), the table, keys with left padding and one row of padding only,
    and an output gradient."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    uvqk = torch.nn.functional.silu(torch.randn(B, L, H * (2 * dv + 2 * dqk), generator=g,
                                                device=dev)).to(torch.bfloat16)
    _, v, q, k = uvqk.split([H * dv, H * dv, H * dqk, H * dqk], dim=-1)
    q, k, v = q.unflatten(-1, (H, dqk)), k.unflatten(-1, (H, dqk)), v.unflatten(-1, (H, dv))
    rab = torch.randn(2 * L - 1, generator=g, device=dev) * 0.5
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    lens[0], lens[-1] = 0, L
    keys = torch.arange(L, device=dev)[None, :] >= (L - lens)[:, None]
    go = torch.randn(B, L, H, dv, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, rab, keys, go


def cell_leaf_shapes(name):
    """The leaf shapes of a benchmark configuration's model
    (portbench/configs/<name>.json), built on the CPU."""
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.utils.registry import get_model_class
    conf = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["config"]
    cfg = config_mod.parse_arguments(dict(conf), argv=[], device="cpu")
    return [tuple(p.shape) for p in get_model_class(cfg["model"])(cfg).parameters()]


def adam_state(opt, dev, shapes, seed, count=4):
    """Leaves at the init scale and a state some steps old: moments drawn,
    count ``count``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda s, std: torch.randn(*s, generator=g, device=dev) * std  # noqa: E731
    params = [rn(s, 0.02) for s in shapes]
    state = opt.init(params)
    state["mu"] = [rn(s, 1e-3) for s in shapes]
    state["nu"] = [rn(s, 1e-3) ** 2 for s in shapes]
    state["count"].fill_(count)
    return params, state


def guarded_update(opt, grads, state, params, loss):
    """The plain path of an optimizer step: ``Optimizer.update``, then the
    NaN guard's select of ``p + u`` and of each new state tensor; (params,
    state) anew, the inputs untouched."""
    import torch
    finite = torch.isfinite(loss)
    u, new = opt.update(grads, state, params)

    def keep(n, o):
        return torch.where(finite, n, o)

    return ([keep(p + d, p) for p, d in zip(params, u)],
            {k: [keep(n, o) for n, o in zip(v, state[k])] if isinstance(v, list)
             else keep(v, state[k]) for k, v in new.items()})


def hold_pass2(v, ids, u, items, scale, blk, k, bans):
    """Pass 2's (values, ids) against the plain version's on the same
    inputs: values descending and equal within f32 rounding (the kernel sums
    a row's products in another order: 1e-5 of the largest score), every id
    scored as its value says and not banned, and the id sets equal apart
    from ties at the k-th value (an id in one set only scores within the
    rounding of the k-th). Raises AssertionError with the readings; returns
    them."""
    import torch
    from unirec_tpu_torch.ops import topk as TK
    pv, pids = TK._rescore_topk_plain(u, items, blk, k, item_scale=scale, **bans)
    tol = 1e-5 * float(pv.abs().max())
    N = items.shape[0]
    shaped = v.shape == ids.shape == (u.shape[0], k) and ids.dtype == torch.int64
    in_range = shaped and int(ids.min()) >= 0 and int(ids.max()) < N
    own = (u.float()[:, None, :] * items[ids.clamp(0, N - 1)].float()).sum(-1)
    if scale is not None:
        own = own * scale[ids.clamp(0, N - 1)]
    differ = (ids.sort(1).values != pids.sort(1).values).any(1)
    off_ties = [(r, i) for r in differ.nonzero()[:, 0].tolist()
                for i in set(ids[r].tolist()) ^ set(pids[r].tolist())
                if abs(float((v[r, (ids[r] == i).nonzero()[0, 0]] if (ids[r] == i).any()
                              else pv[r, (pids[r] == i).nonzero()[0, 0]]) - pv[r, -1])) > tol]
    got = {"tol": tol, "shape_ok": shaped, "ids_in_range": in_range,
           "descending": bool((v[:, 1:] <= v[:, :-1]).all()),
           "finite": bool(torch.isfinite(v).all()), "max_abs_err": float((v - pv).abs().max()),
           "own_score_err": float((own - v).abs().max()),
           "banned_selected": not bool(torch.isfinite(
               TK._ban_candidates(own, ids, N, **bans)).all()),
           "rows_differing": int(differ.sum()), "differ_off_ties": off_ties[:5]}
    if not (in_range and got["descending"] and got["finite"] and got["max_abs_err"] <= tol
            and got["own_score_err"] <= tol and not got["banned_selected"] and not off_ties):
        raise AssertionError(f"pass 2 disagrees with its plain version: {got}")
    return got


def replayed_mask_mismatches(dev, B, L, hd, p, seed=97):
    """(mismatches, dropped): the fused attention backward's dropout mask
    against the forward's keying (the plain keep mask), bit for bit. q = k
    = 0 and no mask make every probability 1/L, and dO with one-hot rows
    (dO[i, i - c0] = 1 for i in a chunk [c0, c0 + hd)) makes dV[j, i - c0]
    = z[i, j] = rnd(keep[i, j] / L / (1 - p)) exactly, so dV shows every
    kept element; one backward call a chunk."""
    import torch
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import layer as LY
    H = 2
    z = torch.zeros(B, H, L, hd, device=dev, dtype=torch.bfloat16)
    drop = LY.drop_params(p, 0.0, True, seed)
    m = torch.zeros(B, 1, L, L, device=dev)
    keep = AT._keep(drop, B, H, L, dev)
    want = torch.where(keep, torch.full_like(keep, 1.0 / L, dtype=torch.float32)
                       * drop.inv_attn, 0.0).to(torch.bfloat16)
    bad = 0
    for c0 in range(0, L, hd):
        n = min(hd, L - c0)
        do = torch.zeros_like(z)
        do[:, :, c0 + torch.arange(n), torch.arange(n)] = 1.0
        dv = AT._bwd_cuda(z, z, z, m, do, drop)[2]
        bad += int((dv[..., :n].transpose(-1, -2) != want[:, :, c0:c0 + n]).sum())
    return bad, int((want == 0).sum())
