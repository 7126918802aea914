"""Batch top-k recommendation.

Counterpart of unirec_tpu/main/reco_topk.py (reference
unirec/main/reco_topk.py:22-187). Per batch of users the device scores the
catalog, masks each user's history (keeping the ``last_item`` target
competitive) and selects the top k; only the [B, topk] ids come back.

Score paths, as in the JAX package:
  - dense: ``user_emb @ item_emb.T`` + biases, history masked, ``torch.topk``;
  - fused (``use_fused_topk``, default on for CUDA and N >= 16384):
    ops/topk.py::fused_catalog_topk, whose catalog pass is the blockmax
    kernel; the item bias folds into an extra factor column;
  - fused int8 (``catalog_int8=1``): the same over a per-row int8 catalog;
  - ``item_file``: per-(user, item) score lines with a held-out label.
The catalog's item side takes the model's constants (the feature table and
the text rows the checkpoint carries); the user side reads the history
windows alone, as the JAX package's does. While a profiler runs, a request
opens the spans of utils/tracing.py: ``serve.request`` over
``serve.catalog``, then per batch ``serve.windows``,
``serve.history_gather``, ``serve.to_device``, ``serve.tower`` (the
sharded and fused paths) and ``serve.topk``, then ``serve.fetch``.
``topk_recall_target`` in (0, 1) asks the JAX package for
``lax.approx_max_k``, a TPU PartialReduce op that XLA lowers to exact top-k
everywhere else; the port honours the target with exact selection (the
fused path's blockmax kernel at its catalog sizes, ``torch.topk`` below
them), whose recall is 1.0, and keeps the JAX rule that ``last_item`` > 0
forces exact selection with a warning (ROADMAP.md, deliberate differences).

Row-sharded serving (reco_topk.py:146-217): on a mesh with ``mesh_model``
> 1 (``torchrun --nproc_per_node N``) the catalog (bf16, or int8 with its
scales sharded alike) is placed row-sharded over the ``model`` ranks and
each batch runs ops/topk.py's ``masked_sharded_topk``; the user embeddings
are computed on every rank (replicated over ``model``), and rank 0 alone
writes the CSV. ``n_shards`` runs the same path over that many logical
shards of one table in one process. As in the JAX package it serves
``last_item`` <= 0 without an approximate target.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from unirec_tpu_torch import config as config_mod
from unirec_tpu_torch.core.distributed import (initialize_distributed, is_main_process,
                                               rank_device)
from unirec_tpu_torch.core.mesh import create_mesh
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.main.infer_embedding import iter_infer_batches
from unirec_tpu_torch.ops import topk as topk_ops
from unirec_tpu_torch.utils import to_device, tracing
from unirec_tpu_torch.utils.checkpoint import load_model_freely
from unirec_tpu_torch.utils.logger import setup_logger


@torch.no_grad()
def get_topk_recommendations(config, model, user_ids: np.ndarray,
                             history: UserHistory, topk: int, mesh=None,
                             n_shards: Optional[int] = None):
    """[n_users, topk] recommended item ids, or the score lines in
    ``item_file`` mode. Runs on the model's device; row-sharded on a
    ``mesh`` with n_model > 1, or over ``n_shards`` logical shards."""
    with tracing.span("serve.request"):
        return _topk_request(config, model, user_ids, history, topk, mesh, n_shards)


def _topk_request(config, model, user_ids, history, topk, mesh, n_shards):
    dev = model.device
    last_item = int(config.get("last_item", 0))
    tau = float(config.get("tau", 1.0))
    recall_target = float(config.get("topk_recall_target", 0) or 0)
    approx = 0.0 < recall_target < 1.0
    if approx:
        # exact selection meets any recall target (module docstring)
        if last_item > 0:
            logging.getLogger("unirec_tpu_torch").warning(
                "topk_recall_target ignored under last_item>0 (evaluation "
                "requires exact selection)")
        else:
            logging.getLogger("unirec_tpu_torch").info(
                "topk_recall_target %g: exact selection (recall 1.0)", recall_target)
    item_file = config.get("item_file") or ""
    distributed = mesh is not None and mesh.distributed and mesh.n_model > 1
    sharded = (distributed or int(n_shards or 1) > 1) and not item_file \
        and last_item <= 0 and not approx
    with tracing.span("serve.catalog"):
        item_emb = model.all_item_emb()
        _, item_bias = model.bias_terms()
        if sharded:
            shards = mesh.n_model if distributed else int(n_shards)
            rank = mesh.rank("model") if distributed else None
            n_items_real = item_emb.shape[0]
            table, scale = item_emb, None
            if int(config.get("catalog_int8", 0) or 0):
                table, scale = topk_ops.quantize_catalog(table)   # per shard, half the bytes
                scale = topk_ops.place_item_table(scale, shards, rank)[0]
            table = topk_ops.place_item_table(table, shards, rank)[0]
            bias = None if item_bias is None else \
                topk_ops.place_item_table(item_bias.float(), shards, rank)[0]
        fused_flag = config.get("use_fused_topk")
        if fused_flag is None:  # default: on for CUDA serving-scale catalogs
            fused_flag = dev.type == "cuda" and item_emb.shape[0] >= 16384
        fused = not item_file and last_item <= 0 and bool(int(fused_flag)) and not sharded
        item_scale = None
        if fused:
            item_aug = item_emb
            if item_bias is not None:
                item_aug = torch.cat([item_emb, item_bias[:, None].to(item_emb.dtype)], 1)
            if int(config.get("catalog_int8", 0) or 0):
                item_aug, item_scale = topk_ops.quantize_catalog(item_aug)

    user2items = {}
    if item_file:
        with open(item_file) as f:
            for line in f:
                u, items = line.strip().split("\t")
                user2items[int(u)] = [int(t) for t in items.split(",")]

    pending, reals, metas = [], [], []
    batches = iter_infer_batches(config, user_ids, history, model.is_seqrec)
    while True:
        with tracing.span("serve.windows"):
            batch = next(batches, None)
        if batch is None:
            break
        n_real = batch.pop("n_real")
        with tracing.span("serve.history_gather"):
            hist_items, hist_len = history.gather(batch["user_id"])
            if last_item > 0:
                target = hist_items[np.arange(len(hist_len)),
                                    np.maximum(hist_len - last_item, 0)]
            else:
                target = np.zeros(len(hist_len), np.int32)
        reals.append(n_real)
        metas.append((batch["user_id"][:n_real], target))
        with tracing.span("serve.to_device"):
            tb = to_device(batch, dev, torch.int64)
            h = to_device({"items": hist_items, "len": hist_len,
                           "target": target}, dev, torch.int64)
        if item_file:
            pending.append(topk_ops.full_catalog_scores(model, tb, item_emb, tau))
            continue
        if sharded or fused:
            with tracing.span("serve.tower"):
                user_emb = model.user_emb(tb)
        with tracing.span("serve.topk"):
            if sharded:
                # the per-user bias and tau shift/scale whole rows and cannot
                # change the ranking; the item bias goes to each shard
                _, ids = topk_ops.masked_sharded_topk(
                    user_emb, table, h["items"], h["len"], topk,
                    mesh if distributed else None, n_real=n_items_real, n_shards=shards,
                    item_bias=bias, item_scale=scale)
                pending.append(ids)
            elif fused:
                # the per-user bias and tau shift/scale whole rows and cannot
                # change the ranking; the item bias is the extra factor column
                if item_bias is not None:
                    user_emb = torch.cat([user_emb, torch.ones_like(user_emb[:, :1])], 1)
                _, ids = topk_ops.fused_catalog_topk(
                    user_emb, item_aug, topk, hist_items=h["items"],
                    hist_len=h["len"], exclude_pad_item=True, item_scale=item_scale)
                pending.append(ids)
            else:
                pending.append(_dense_topk(model, tb, item_emb, h, tau, topk,
                                           last_item > 0))
    with tracing.span("serve.fetch"):
        fetched = [x.float().cpu().numpy()[:n] if item_file else x.cpu().numpy()[:n]
                   for x, n in zip(pending, reals)]

    if item_file:
        lines = []
        for scores, (uids, target) in zip(fetched, metas):
            for i, u in enumerate(uids):
                for it in user2items.get(int(u), []):
                    label = "1" if it == int(target[i]) else "0"
                    s = scores[i][it] if it > 0 else 0.0
                    lines.append(f"{int(u)}\t{it}\t{s}\t{label}\n")
        return lines
    return np.concatenate(fetched, axis=0)


def _dense_topk(model, tb, item_emb, h, tau: float, topk: int,
                keep_target: bool) -> torch.Tensor:
    """Full scores, history and the padding item masked to -inf, the
    held-out target's score restored when ``keep_target``; top-k ids."""
    scores = topk_ops.full_catalog_scores(model, tb, item_emb, tau)
    rows = torch.arange(scores.shape[0], device=scores.device)
    target_score = scores[rows, h["target"]]
    cap = h["items"].shape[1]
    valid = torch.arange(cap, device=scores.device)[None, :] < h["len"][:, None]
    hcols = torch.where(valid, h["items"], 0)
    masked = scores.scatter(1, hcols, float("-inf"))
    masked[:, 0] = float("-inf")
    if keep_target:
        masked[rows, h["target"]] = target_score
    return topk_ops.fast_topk(masked, topk)[1]


def do_topk_reco(config: Dict, device: Optional[str] = None):
    config = dict(config)
    device = device or config.pop("device", None)
    initialize_distributed(config, device)
    dev = rank_device(device)
    out_path = config.get("output_path", "topk_reco.csv")
    logger = setup_logger(config.get("exp_name", "reco_topk"),
                          os.path.dirname(os.path.abspath(out_path)))
    model, ckpt_cfg = load_model_freely(config["model_file"], dev)
    config = {**ckpt_cfg, **config}
    mesh = create_mesh(config, device=dev)

    dpath = config["dataset_path"]
    user_ids = np.loadtxt(os.path.join(dpath, config["dataset_name"]),
                          dtype=np.int64).reshape(-1)
    logger.info("#. users for recommendations: %d", len(user_ids))
    fname = config.get("user_history_filename", "user_history")
    fmt = config.get("user_history_file_format", config.get("train_file_format"))
    history = UserHistory.load(os.path.join(dpath, fname),
                               int(config["n_users"]), fmt)
    res = get_topk_recommendations(config, model, user_ids, history,
                                   int(config.get("topk", 100)), mesh=mesh)
    if not is_main_process():       # one writer on a shared filesystem
        return res
    if config.get("item_file"):
        with open(out_path, "w") as f:
            f.writelines(res)
        logger.info("saved per-item scores to %s", out_path)
    else:
        np.savetxt(out_path, res, delimiter=",", fmt="%i")
        logger.info("saved top-%s recommendations to %s",
                    config.get("topk", 100), out_path)
    return res


if __name__ == "__main__":
    do_topk_reco(config_mod.parse_cmd_arguments(sys.argv[1:]))
