"""Evaluators (counterpart of unirec_tpu/facility/evaluation/evaluators.py).

  - one_vs_k: grouped scores from ``model.predict`` (the positive in column
    0, sampled negatives after it), tie noise, rank within the row.
  - one_vs_all (one positive): user embeddings times the whole item table
    (``ops/topk.py::full_catalog_scores``, a ``torch.matmul``), history
    masking, tie noise and the rank of the positive, on the device; only
    per-row metric vectors come back, fetched once after the sweep.
  - one_vs_all with several positives per row (T5/T6 tables): the same
    sweep through ``ops/metrics.py::multipos_topk_and_metrics`` (the @k
    metrics and group_auc).
  - session_aware: ``model.predict`` scores on the device, fetched once
    after the sweep; grouped by session (or user) and reduced per session
    on the host, a numpy copy of the JAX package's ``evaluate_with_scores``.

Tie noise draws from a ``torch.Generator`` on the device seeded as the JAX
evaluators seed their keys (seed + 101 for one_vs_k, seed + 202 for
one_vs_all, seed + 303 for its multi-positive form), fresh for every
evaluation, so an evaluation of the same weights repeats exactly; the
session protocol draws its noise from numpy at seed + 404, as JAX does.
Metrics are weighted means over the real rows (``weight`` > 0) and match
onepos.py, multipos.py and sessionwise.py. ``predict_scores`` serves the
infer task under every protocol: ``model.predict`` of every batch, the real
rows kept, fetched once after the sweep.

The MoRec metric family (evaluators.py:135-345, :421-530) reads the item
meta (``_item_meta_morec``: price ``weight``, ``fair_group``,
``align_group``) and the alignment distribution that main.run loads. Under
one_vs_all: ``rhit@k``/``rrecall@k`` (the positive's price when it ranks in
the top k), ``rndcg@k`` (its price times the ndcg), ``pop-kl@k`` (KL of the
alignment distribution to the align-group frequency of the top-k lists,
which the device sweep returns beside the ranks) and ``least-misery``
(``min-<metric>``: the smallest mean over the positives' fair groups of each
per-row metric); the host reduction is numpy, as in the JAX package. Under
one_vs_k they are skipped, as there. Under session_aware: the
price-weighted ``rhit@k`` (the largest price among hit positives),
``rrecall@k`` (their price mass) and ``rndcg[@k]`` (sessionwise.py:39-83).

On a mesh (a process group up, evaluators.py:47-99) every rank holds the
same host batch and scores its rows of it (``_to_device``: padded to a
multiple of ``n_data``, the rank's slice); the tie noise is drawn at the
global batch's shape and sliced, and the per-row results are gathered over
``data`` before the host reduction, so every rank returns the one-process
metrics. The per-batch ``reparam_seed`` counts the same on every rank.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from unirec_tpu_torch.constants import DataFormat, EvalProtocol
from unirec_tpu_torch.core.mesh import MeshContext
from unirec_tpu_torch.ops import metrics as M
from unirec_tpu_torch.ops.topk import full_catalog_scores
from unirec_tpu_torch.utils import to_device

_MOREC_PREFIXES = ("rhit", "rndcg", "rrecall", "pop-kl")


class _EvaluatorBase:
    def __init__(self, config: Dict[str, Any], model, device=None,
                 mesh: Optional[MeshContext] = None):
        self.config = config
        self.model = model
        self.device = torch.device(device) if device is not None else model.device
        self.mesh = mesh if mesh is not None else MeshContext()
        self.metric_names = M.parse_metrics(config.get("metrics", "['group_auc']"))
        self.seed = int(config.get("seed", 2022))
        self.item_meta = config.get("_item_meta_morec")
        self.align_dist = config.get("_alignment_dist")
        self._batches = 0

    def _to_device(self, batch) -> Dict[str, Any]:
        """This rank's rows of the (padded) batch on the device, with
        ``reparam_seed``: a host int that counts this evaluator's batches
        (evaluators.py:54-61), from which MultiVAE seeds its evaluation
        noise, fresh each batch; and ``reparam_rows`` (lo, n, total), the
        rows' place in the global batch, at whose shape it draws."""
        self._batches += 1
        batch = self.mesh.pad_batch(batch)
        total = len(batch["weight"])
        lo, hi = self.mesh.row_range(total)
        return dict(to_device(self.mesh.shard_batch(batch), self.device),
                    reparam_seed=self._batches, reparam_rows=(lo, hi - lo, total))

    def _host(self, batch) -> Dict[str, Any]:
        """The host batch as every rank holds it: padded to a multiple of
        n_data rows, the rows ``_gather`` returns."""
        return self.mesh.pad_batch(batch)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of a per-row result, in batch order."""
        return self.mesh.all_gather_rows(t, "data")

    @torch.no_grad()
    def predict_scores(self, batcher) -> np.ndarray:
        """Raw scores of the real rows (evaluators.py:110-119), in f32: [rows]
        without negatives, [rows, 1 + negatives] with them."""
        pending, keeps = [], []
        for batch in batcher:
            pending.append(self._gather(self.model.predict(self._to_device(batch))))
            keeps.append(np.asarray(self._host(batch)["weight"]) > 0)
        return np.concatenate([s.float().cpu().numpy()[k] for s, k in zip(pending, keeps)])


class OnePositiveEvaluator(_EvaluatorBase):
    """One positive per row: one-vs-k (grouped scores) and one-vs-all (full
    catalog)."""

    def __init__(self, config: Dict[str, Any], model, device=None,
                 mesh: Optional[MeshContext] = None):
        super().__init__(config, model, device, mesh)
        # bare (no-@k) r-metrics are session-wise only (sessionwise.py:
        # 171-173): dropped here, as in the JAX package
        session_only = [m for m in self.metric_names
                        if "@" not in m and m in ("rhit", "rndcg", "rrecall")]
        self.morec_names = [m for m in self.metric_names
                            if (m.split("@")[0] in _MOREC_PREFIXES or m == "least-misery")
                            and m not in session_only]
        # 'auc' is one global ROC-AUC over every (score, label) pair of the
        # one-vs-k sweep (onepos.py:136-137)
        self.base_names = [m for m in self.metric_names if m != "auc"
                           and m not in self.morec_names and m not in session_only]
        pop_ks = [int(m.split("@")[1]) for m in self.morec_names if m.startswith("pop-kl@")]
        self._popkl_k = max(pop_ks) if pop_ks else 0

    def _generator(self, offset: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed + offset)

    @staticmethod
    def merge(rows: Dict[str, List[np.ndarray]], weights: List[np.ndarray]) -> Dict[str, float]:
        """Weighted means over the real rows."""
        w = np.concatenate(weights)
        return {k: float(np.sum(np.concatenate(v) * w) / max(np.sum(w), 1.0))
                for k, v in rows.items()}

    @torch.no_grad()
    def evaluate(self, batcher) -> Dict[str, float]:
        rows: Dict[str, List[np.ndarray]] = {m: [] for m in self.base_names}
        weights, pending, auc_labels = [], [], []
        want_auc = "auc" in self.metric_names
        gen = self._generator(101)
        group = int(self.config.get("group_size", -1) or -1)
        for batch in batcher:
            batch = self._host(batch)
            w = np.asarray(batch["weight"])
            jb = self._to_device(batch)
            scores = self.model.predict(jb)
            if scores.dim() == 1:
                scores = scores.reshape(-1, group) if group > 0 \
                    else scores.reshape(len(jb["weight"]), -1)
            per = scores.shape[0] // len(jb["weight"])   # score rows a batch row
            noisy = M.add_tie_noise(scores, self.mesh.row_slice(gen, scores.shape[0],
                                                                len(w) * per))
            vals = {m: self._gather(v) for m, v in M.onepos_metrics(
                M.onepos_rank_from_group(noisy), scores.shape[1], self.base_names).items()}
            scores = self._gather(scores)
            need_auc = want_auc and "label" in batch
            pending.append((vals, scores if need_auc else None, w))
            if need_auc:
                auc_labels.append(np.asarray(batch["label"]).reshape(len(w), -1)[w > 0])
            # per-group rows after the reshape share their row's weight
            weights.append(np.repeat(w, scores.shape[0] // len(w)))
        auc_scores = []
        for vals, sc, w in pending:
            for m in self.base_names:
                rows[m].append(vals[m].cpu().numpy())
            if sc is not None:
                auc_scores.append(sc.float().cpu().numpy().reshape(len(w), -1)[w > 0])
        out = self.merge(rows, weights)
        if auc_scores:
            out["auc"] = M.roc_auc(np.concatenate([a.reshape(-1) for a in auc_labels]),
                                   np.concatenate([a.reshape(-1) for a in auc_scores]))
        return out

    def evaluate_full(self, batcher, history) -> Dict[str, float]:
        n_items = int(self.config["n_items"])

        def metrics(scores, pos, hist_items, hist_len, gen):
            if pos.dim() == 2:
                pos = pos[:, 0]
            rank, topk = M.onepos_rank_and_topk(scores, pos, hist_items, hist_len, gen,
                                                self._popkl_k)
            vals = M.onepos_metrics(rank, n_items, self.base_names)
            if self.morec_names:
                vals.update(_rank=rank, _pos=pos, **({} if topk is None else {"_topk": topk}))
            return vals

        fetched, weights = self._sweep(batcher, history, 202, metrics)
        rows = {m: [vals[m] for vals in fetched] for m in self.base_names}
        if not self.morec_names:
            return self.merge(rows, weights)
        return self._morec_metrics(rows, fetched, weights)

    def _morec_metrics(self, rows, fetched, weights) -> Dict[str, float]:
        """The base metrics' means and the MoRec family's, from the sweep's
        ranks, top-k lists and positives (the JAX package's host reduction,
        evaluators.py:300-355)."""
        meta = self.item_meta
        per_row = self.base_names + [m for m in self.morec_names
                                     if not m.startswith("pop-kl") and m != "least-misery"]
        popkl = {m: None for m in self.morec_names if m.startswith("pop-kl")}
        group_ids = []
        for m in per_row[len(self.base_names):]:
            rows[m] = []
        for w, vals in zip(weights, fetched):
            rank, pos, keep = vals["_rank"], vals["_pos"], w > 0
            prices = meta["weight"][pos] if meta is not None and "weight" in meta \
                else np.ones_like(pos, np.float64)
            for m in self.morec_names:
                name = m.split("@")[0]
                if name in ("rhit", "rrecall"):
                    rows[m].append((rank < int(m.split("@")[1])).astype(np.float64) * prices)
                elif name == "rndcg":
                    k = int(m.split("@")[1])
                    rows[m].append((rank < k) / np.log2(rank + 2.0) * prices)
                elif name == "pop-kl":
                    i2g = meta["align_group"]
                    ids = vals["_topk"][keep][:, :int(m.split("@")[1])].reshape(-1)
                    counts = np.bincount(i2g[ids], minlength=int(i2g.max()) + 1)
                    popkl[m] = counts.astype(np.float64) if popkl[m] is None \
                        else popkl[m] + counts
            if "least-misery" in self.morec_names and meta is not None:
                group_ids.append(meta["fair_group"][pos])
        out = self.merge(rows, weights)
        # pop-kl@k: KL(alignment_dist || top-k group frequency) (onepos.py:53-68)
        for m, counts in popkl.items():
            freq = counts[1:] / max(counts[1:].sum(), 1e-10)
            tgt = np.asarray(self.align_dist, np.float64)
            out[m] = float(np.sum((tgt + 1e-10) * (np.log(tgt + 1e-10) - np.log(freq + 1e-10))))
        # least-misery: the smallest fair-group mean of each per-row metric
        # (onepos.py:206-217)
        if group_ids:
            gid = np.concatenate(group_ids)
            w = np.concatenate(weights) > 0
            for m in per_row:
                v = np.concatenate(rows[m])
                vv, gg = v[w[: len(v)]], gid[w[: len(gid)]]
                mins = [vv[gg == g].mean() for g in np.unique(gg) if g > 0 and (gg == g).any()]
                if mins:
                    out[f"min-{m}"] = float(min(mins))
        return out

    @torch.no_grad()
    def _sweep(self, batcher, history, seed_offset: int, metrics):
        """Score each batch against the whole catalog and reduce it to
        per-row results with ``metrics(scores, pos, hist_items, hist_len,
        gen)``, all on the device; the per-batch results are fetched once,
        after the sweep. Returns ([{name: numpy array}], [weights])."""
        item_emb = self.model.all_item_emb()
        tau = float(self.config.get("tau", 1.0))
        gen = self._generator(seed_offset)
        weights, pending = [], []
        for batch in batcher:
            batch = self._host(batch)
            jb = self._to_device(batch)
            local = self.mesh.shard_batch(batch)
            hist_items, hist_len = history.gather(np.asarray(local["user_id"]))
            h = to_device({"items": hist_items, "len": hist_len}, self.device)
            scores = full_catalog_scores(self.model, jb, item_emb, tau)
            vals = metrics(scores, jb["item_id"], h["items"], h["len"],
                           self.mesh.row_slice(gen, scores.shape[0], len(batch["weight"])))
            pending.append({k: self._gather(v) for k, v in vals.items()})
            weights.append(np.asarray(batch["weight"]))
        return [{k: v.cpu().numpy() for k, v in vals.items()} for vals in pending], weights

    def _full_sweep(self, batcher, history, seed_offset: int, names,
                    metrics) -> Dict[str, float]:
        """``_sweep``'s weighted means of ``names``."""
        fetched, weights = self._sweep(batcher, history, seed_offset, metrics)
        return self.merge({m: [vals[m] for vals in fetched] for m in names}, weights)


class MultiPositiveEvaluator(OnePositiveEvaluator):
    """One-vs-all with several positives per user (T5/T6 rows): the @k
    metrics and the per-row group_auc (multipos.py:184-191)."""

    def __init__(self, config, model, device=None, mesh=None):
        super().__init__(config, model, device, mesh)
        self.base_names = [m for m in self.metric_names if "@" in m or m == "group_auc"]
        ks = [int(m.split("@")[1]) for m in self.metric_names if "@" in m]
        self.max_k = max(ks) if ks else 10

    def evaluate_full(self, batcher, history) -> Dict[str, float]:
        def metrics(scores, pos, hist_items, hist_len, gen):
            return M.multipos_topk_and_metrics(scores, pos, hist_items, hist_len,
                                               self.base_names, self.max_k, gen)

        return self._full_sweep(batcher, history, 303, self.base_names, metrics)


class SessionWiseEvaluator(_EvaluatorBase):
    """Session-grouped metrics (sessionwise.py): scores from
    ``model.predict`` on the device, fetched once after the sweep, then
    grouped by ``session_id`` (``user_id`` when the table has none) and
    reduced per session on the host. Sessions that are all positive or all
    negative are dropped (sessionwise.py:104-115). The price-weighted
    rhit/rrecall/rndcg take each row's price from the MoRec item meta's
    ``weight`` by item id (evaluator_abc.py:145-169), 1 without it."""

    PRICE_PREFIXES = ("rndcg", "rhit", "rrecall")

    def __init__(self, config, model, device=None, mesh=None):
        super().__init__(config, model, device, mesh)
        self._need_prices = any(m.split("@")[0] in self.PRICE_PREFIXES
                                for m in self.metric_names)

    @torch.no_grad()
    def evaluate(self, batcher) -> Dict[str, float]:
        pending, labels, sessions, item_ids = [], [], [], []
        for batch in batcher:
            batch = self._host(batch)
            w = np.asarray(batch["weight"])
            pending.append((w, self._gather(self.model.predict(self._to_device(batch)))))
            labels.append(np.asarray(batch["label"]).reshape(-1))
            sessions.append(np.asarray(batch["session_id"] if "session_id" in batch
                                       else batch["user_id"]).reshape(-1))
            if self._need_prices:
                item_ids.append(np.asarray(batch["item_id"]).reshape(-1))
        scores = []
        for i, (w, s_dev) in enumerate(pending):
            s = s_dev.float().cpu().numpy().reshape(-1)
            keep = np.repeat(w > 0, s.shape[0] // len(w))
            scores.append(s[keep])
            labels[i], sessions[i] = labels[i][keep], sessions[i][keep]
            if self._need_prices:
                item_ids[i] = item_ids[i][keep]
        prices = None
        if self._need_prices:
            ids = np.concatenate(item_ids)
            meta = self.item_meta
            prices = (meta["weight"][ids] if meta is not None and "weight" in meta
                      else np.ones(len(ids), np.float64))
        return self.evaluate_with_scores(np.concatenate(scores), np.concatenate(labels),
                                         np.concatenate(sessions), prices=prices)

    def evaluate_with_scores(self, scores: np.ndarray, labels: np.ndarray,
                             session_ids: np.ndarray,
                             prices: Optional[np.ndarray] = None) -> Dict[str, float]:
        """Per-session metrics averaged over the sessions (the JAX package's
        ``evaluate_with_scores``, numpy, the same noise from the same seed)."""
        rng = np.random.default_rng(self.seed + 404)
        scores = scores + rng.uniform(-1e-8, 1e-8, size=scores.shape)
        order = np.argsort(session_ids, kind="stable")
        s, l, g = scores[order], labels[order], session_ids[order]
        p = prices[order] if prices is not None else None
        bounds = np.flatnonzero(np.r_[True, g[1:] != g[:-1], True])
        res: Dict[str, List[float]] = {m: [] for m in self.metric_names}

        def rndcg(k, ranks, ndcg_w, rank_prices):
            # sessionwise.py:44-50: each hit positive's discount times its
            # price, over the largest discounts paired with the largest prices
            n = min(k, len(ranks))
            hit = ranks < k
            num = (ndcg_w[ranks[hit]] * rank_prices[hit]).sum()
            den = (ndcg_w[:n] * np.sort(rank_prices)[::-1][:n]).sum() + 1e-8
            return num / den

        for a, b in zip(bounds[:-1], bounds[1:]):
            gs, gl = s[a:b], l[a:b]
            n_pos = gl.sum()
            if n_pos <= 0 or n_pos == len(gl):
                continue
            ranks_full = np.empty(len(gs), dtype=np.int64)
            ranks_full[np.argsort(-gs, kind="stable")] = np.arange(len(gs))
            pos_ranks = ranks_full[gl > 0]
            rank_order = np.argsort(pos_ranks)
            ranks = pos_ranks[rank_order]
            # the positives' prices in rank order (sessionwise.py:160-162)
            rank_prices = p[a:b][gl > 0][rank_order] if p is not None else None
            n = len(gs)
            ndcg_w = 1.0 / np.log2(np.arange(2, n + 2))
            mrr_w = 1.0 / np.arange(1, n + 1)
            for m in self.metric_names:
                if m == "group_auc":
                    res[m].append(M.roc_auc(gl, gs))
                elif m == "ndcg":
                    res[m].append(ndcg_w[ranks].sum() / ndcg_w[: len(ranks)].sum())
                elif m == "rndcg":      # k = inf (sessionwise.py:172)
                    res[m].append(rndcg(np.inf, ranks, ndcg_w, rank_prices))
                elif m == "mrr":
                    res[m].append(mrr_w[ranks].sum() / len(ranks))
                elif "@" in m:
                    name, k = m.split("@")
                    k = int(k)
                    if name == "ndcg":
                        res[m].append(ndcg_w[ranks[ranks < k]].sum()
                                      / ndcg_w[:min(k, len(ranks))].sum())
                    elif name == "rndcg":
                        res[m].append(rndcg(k, ranks, ndcg_w, rank_prices))
                    elif name == "hit":
                        res[m].append(1.0 if ranks[0] < k else 0.0)
                    elif name == "rhit":        # the largest hit price (sessionwise.py:63-65)
                        res[m].append(float(((ranks < k) * rank_prices).max()))
                    elif name == "recall":
                        res[m].append((ranks < k).sum() / len(ranks))
                    elif name == "rrecall":     # the hit price mass (sessionwise.py:81-83)
                        res[m].append(float(((ranks < k) * rank_prices).sum()))
                    elif name == "mrr":
                        res[m].append(mrr_w[ranks[ranks < k]].sum() / min(k, len(ranks)))
        return {m: float(np.mean(v)) if v else 0.0 for m, v in res.items()}


def build_evaluator(config: Dict[str, Any], model, protocol: str,
                    data_format=None, device=None, mesh: Optional[MeshContext] = None):
    """Protocol x format dispatch (trainer.py:100-131)."""
    if protocol == EvalProtocol.SESSION_AWARE.value:
        return SessionWiseEvaluator(config, model, device, mesh)
    if protocol == EvalProtocol.ONE_VS_ALL.value and data_format in (
            DataFormat.T5.value, DataFormat.T6.value):
        return MultiPositiveEvaluator(config, model, device, mesh)
    if protocol in (EvalProtocol.ONE_VS_ALL.value, EvalProtocol.ONE_VS_K.value,
                    EvalProtocol.LABEL_AWARE.value):
        return OnePositiveEvaluator(config, model, device, mesh)
    raise ValueError(f"protocol/format mismatch: {protocol} / {data_format}")
