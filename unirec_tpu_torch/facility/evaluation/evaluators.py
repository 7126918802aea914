"""Evaluators of the one-positive protocols (counterpart of
unirec_tpu/facility/evaluation/evaluators.py).

  - one_vs_k: grouped scores from ``model.predict`` (the positive in column
    0, sampled negatives after it), tie noise, rank within the row.
  - one_vs_all (one positive): user embeddings times the whole item table
    (``ops/topk.py::full_catalog_scores``, a ``torch.matmul``), history
    masking, tie noise and the rank of the positive, on the device; only
    per-row metric vectors come back, fetched once after the sweep.

Tie noise draws from a ``torch.Generator`` on the device seeded as the JAX
evaluators seed their keys (seed + 101 for one_vs_k, seed + 202 for
one_vs_all), fresh for every evaluation, so an evaluation of the same
weights repeats exactly. Metrics are weighted means over the real rows
(``weight`` > 0) and match onepos.py. ``predict_scores`` serves the infer
task under either protocol: ``model.predict`` of every batch, the real
rows kept, fetched once after the sweep. Not ported yet, and raising
NotImplementedError naming their ROADMAP item: one_vs_all with several
positives per row (T5/T6 tables; its metrics are ported in
ops/metrics.py::multipos_topk_and_metrics) and the session-wise protocol
(Queue 1 item 5), and the MoRec metric family (Queue 1 item 11).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from unirec_tpu_torch.constants import DataFormat, EvalProtocol
from unirec_tpu_torch.ops import metrics as M
from unirec_tpu_torch.ops.topk import full_catalog_scores
from unirec_tpu_torch.utils import to_device

_MOREC_PREFIXES = ("rhit", "rndcg", "rrecall", "pop-kl", "least-misery")


class OnePositiveEvaluator:
    """One positive per row: one-vs-k (grouped scores) and one-vs-all (full
    catalog)."""

    def __init__(self, config: Dict[str, Any], model, device=None):
        self.config = config
        self.model = model
        self.device = torch.device(device) if device is not None else model.device
        self.metric_names = M.parse_metrics(config.get("metrics", "['group_auc']"))
        self.seed = int(config.get("seed", 2022))
        morec = [m for m in self.metric_names if m.split("@")[0] in _MOREC_PREFIXES]
        if morec:
            raise NotImplementedError(f"the MoRec metrics {morec} are not ported yet "
                                      "(ROADMAP.md Queue 1 item 11)")
        # 'auc' is one global ROC-AUC over every (score, label) pair of the
        # one-vs-k sweep (onepos.py:136-137)
        self.base_names = [m for m in self.metric_names if m != "auc"]

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
            w = np.asarray(batch["weight"])
            scores = self.model.predict(to_device(batch, self.device))
            if scores.dim() == 1:
                scores = scores.reshape(-1, group) if group > 0 else scores.reshape(len(w), -1)
            noisy = M.add_tie_noise(scores, gen)
            vals = M.onepos_metrics(M.onepos_rank_from_group(noisy), scores.shape[1],
                                    self.base_names)
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

    @torch.no_grad()
    def predict_scores(self, batcher) -> np.ndarray:
        """Raw scores of the real rows (evaluators.py:110-119), in f32: [rows]
        without negatives, [rows, 1 + negatives] with them."""
        pending, keeps = [], []
        for batch in batcher:
            pending.append(self.model.predict(to_device(batch, self.device)))
            keeps.append(np.asarray(batch["weight"]) > 0)
        return np.concatenate([s.float().cpu().numpy()[k] for s, k in zip(pending, keeps)])

    def evaluate_full(self, batcher, history) -> Dict[str, float]:
        n_items = int(self.config["n_items"])

        def metrics(scores, pos, hist_items, hist_len, gen):
            if pos.dim() == 2:
                pos = pos[:, 0]
            rank = M.onepos_rank_full_catalog(scores, pos, hist_items, hist_len, gen)
            return M.onepos_metrics(rank, n_items, self.base_names)

        return self._full_sweep(batcher, history, 202, self.base_names, metrics)

    @torch.no_grad()
    def _full_sweep(self, batcher, history, seed_offset: int, names,
                    metrics) -> Dict[str, float]:
        """Score each batch against the whole catalog and reduce it to
        per-row metrics with ``metrics(scores, pos, hist_items, hist_len,
        gen)``, all on the device; the per-batch results are fetched once,
        after the sweep."""
        item_emb = self.model.all_item_emb()
        tau = float(self.config.get("tau", 1.0))
        gen = self._generator(seed_offset)
        weights, pending = [], []
        for batch in batcher:
            jb = to_device(batch, self.device)
            hist_items, hist_len = history.gather(np.asarray(batch["user_id"]))
            h = to_device({"items": hist_items, "len": hist_len}, self.device)
            scores = full_catalog_scores(self.model, jb, item_emb, tau)
            pending.append(metrics(scores, jb["item_id"], h["items"], h["len"], gen))
            weights.append(np.asarray(batch["weight"]))
        rows = {m: [vals[m].cpu().numpy() for vals in pending] for m in names}
        return self.merge(rows, weights)


class MultiPositiveEvaluator:
    """One-vs-all with several positives per user (T5/T6 rows)."""

    def __init__(self, config, model, device=None):
        raise NotImplementedError("one_vs_all with several positives per row (T5/T6 "
                                  "tables) is not ported yet (ROADMAP.md Queue 1 item 5)")


def build_evaluator(config: Dict[str, Any], model, protocol: str,
                    data_format=None, device=None):
    """Protocol x format dispatch (trainer.py:100-131)."""
    if protocol == EvalProtocol.SESSION_AWARE.value:
        raise NotImplementedError("the session_aware protocol is not ported yet "
                                  "(ROADMAP.md Queue 1 item 5)")
    if protocol == EvalProtocol.ONE_VS_ALL.value and data_format in (
            DataFormat.T5.value, DataFormat.T6.value):
        return MultiPositiveEvaluator(config, model, device)
    if protocol in (EvalProtocol.ONE_VS_ALL.value, EvalProtocol.ONE_VS_K.value,
                    EvalProtocol.LABEL_AWARE.value):
        return OnePositiveEvaluator(config, model, device)
    raise ValueError(f"protocol/format mismatch: {protocol} / {data_format}")
