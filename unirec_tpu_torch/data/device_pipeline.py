"""Device-side batch augmentation (counterpart of
unirec_tpu/data/device_pipeline.py).

The host feeds raw id columns; negative sampling with user-history
rejection and the left-padded history windows run as torch ops on tensors
resident on the device. Semantics are the JAX package's: oversampled
negatives, uniform over [1, n_items) or, with ``neg_by_pop_alpha`` > 0 and
the item popularity, drawn from the Walker alias table of popularity **
alpha kept on the device (f32 thresholds, int32 aliases; :89-105),
rejected when in the user's history or equal to a positive, the first
valid proposal kept and 0 when every proposal fails (:141-160); the
unorder / autoregressive truncation rules, ``seq_last`` and an explicit
per-row ``max_len`` (:162-216); the item-feature table kept on the device
and gathered at the candidates and at the history window
(``item_features``, ``item_seq_features``), and the T6 time rows windowed
with the items (``time_seq``) (:61, 164, 244, 278-288). With ``aerec`` the
rows are AERec training rows: the user's history table row (the training
split's deduplicated items), cut at ``aerec_max_hist``, as ``item_seq``.

Randomness comes from an explicit ``torch.Generator`` on the state's device
(the JAX package's ``key``), drawn at the global batch's shape when a
data-parallel rank augments its rows (core/mesh.py::RowSlice); the two frameworks draw different numbers from
one seed, so tests hold sampled batches to their invariants and the
deterministic parts (windowing, membership) to exact equality.

Membership runs through ops/member.py (the TPU's ``_member_kernel``, a
CUDA kernel here) under ``neg_membership_pallas=1``, else as the broadcast
compare. The JAX package's ``neg_membership_binary_search`` chooses only
how the same mask is computed on the TPU; the port does not read it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from unirec_tpu_torch.core.mesh import RowSlice, rand_rows, randint_rows
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.data.sampler import AliasTable
from unirec_tpu_torch.ops import member as member_ops
from unirec_tpu_torch.utils import tracing


class DeviceAugmenter:
    """Holds the device-resident history and exposes ``augment(raw, gen)``."""

    def __init__(self, config: Dict[str, Any], history: UserHistory,
                 item_popularity: Optional[np.ndarray] = None,
                 features: Optional[np.ndarray] = None, aerec: bool = False,
                 device=None):
        c = config
        self.aerec = bool(aerec)
        self.aerec_cap = int(c.get("aerec_max_hist", 0) or 0)
        self.device = torch.device(device or "cuda")
        self.n_items = int(c["n_items"])
        self.n_neg = int(c.get("n_sample_neg_train", 0) or 0)
        if c.get("loss_type") == "fullsoftmax":  # catalog is the negative set
            self.n_neg = 0
        self.oversample = max(int(c.get("neg_oversample_factor", 4)), 1)
        self.max_seq_len = int(c.get("max_seq_len", 10))
        self.mask_mode = c.get("history_mask_mode", "unorder")
        self.seq_last = bool(c.get("seq_last", 0))
        self.is_sequential = c.get("dataloader") in ("SeqRecDataset",)
        self.use_pallas_membership = bool(int(c.get("neg_membership_pallas", 0) or 0))
        self.with_time = bool(int(c.get("time_seq", 0) or 0)) and history.times is not None
        self.use_features = features is not None
        self.state: Dict[str, torch.Tensor] = {
            "hist_items": torch.as_tensor(history.items, dtype=torch.int32,
                                          device=self.device),
            "hist_lens": torch.as_tensor(history.lengths, dtype=torch.int32,
                                         device=self.device),
        }
        if self.with_time:
            self.state["hist_times"] = torch.as_tensor(history.times, dtype=torch.int32,
                                                       device=self.device)
        if self.use_features:
            self.state["features"] = torch.as_tensor(np.asarray(features, np.int32),
                                                     device=self.device)
        alpha = float(c.get("neg_by_pop_alpha", 0) or 0)
        self.use_alias = item_popularity is not None and alpha > 0
        if self.use_alias:
            table = AliasTable.of_popularity(item_popularity, alpha)
            self.state["alias_thresh"] = torch.as_tensor(table.thresh, dtype=torch.float32,
                                                         device=self.device)
            self.state["alias_alias"] = torch.as_tensor(table.alias, dtype=torch.int32,
                                                        device=self.device)

    # ------------------------------------------------------------------
    def _draw(self, gen, shape) -> torch.Tensor:
        """Negative proposals; ``gen`` a generator or a RowSlice."""
        if not self.use_alias:
            return randint_rows(gen, 1, self.n_items, shape, self.device, torch.int32)
        thresh, alias = self.state["alias_thresh"], self.state["alias_alias"]
        idx = randint_rows(gen, 0, thresh.shape[0], shape, self.device)
        frac = rand_rows(gen, shape, self.device)
        return torch.where(frac < thresh[idx], idx.to(torch.int32), alias[idx])

    def _membership(self, rows, cand) -> torch.Tensor:
        """cand[b, k] > 0 and in rows[b, :] -- [B, K] bool."""
        if self.use_pallas_membership and member_ops.member_supported(rows.shape[1]):
            return member_ops.member_mask(rows, cand)
        return member_ops._member_plain(rows, cand)

    def sample_negatives(self, gen, rows, pos2d) -> torch.Tensor:
        """[B, n_neg] negatives: oversample, reject in-history / equal to a
        positive, keep the first valid proposal, 0 when all fail."""
        B = pos2d.shape[0]
        K = self.n_neg * self.oversample
        cand = self._draw(gen, (B, K))
        bad = (cand[:, :, None] == pos2d[:, None, :]).any(-1)
        bad |= self._membership(rows, cand)
        ok = (~bad).view(B, self.n_neg, self.oversample)
        cand = cand.view(B, self.n_neg, self.oversample)
        first = ok.to(torch.int8).argmax(-1, keepdim=True)
        chosen = cand.gather(-1, first)[..., 0]
        return torch.where(ok.any(-1), chosen, torch.zeros_like(chosen))

    def history_window(self, gen, rows, lens, tgt2d, trows=None, explicit_max_len=None):
        """(item_seq [B, L], item_seq_len [B], time_seq [B, L] or None) with
        the host pipeline's unorder / autoregressive semantics; tgt2d: [B,
        P] positive items; ``trows``: the rows' time buckets, windowed alike."""
        B, C = rows.shape
        L = self.max_seq_len
        lens = lens.long()
        is_tgt = (rows[:, :, None] == tgt2d[:, None, :]).any(-1) & (rows > 0)
        if explicit_max_len is not None and self.mask_mode != "unorder":
            n = torch.minimum(explicit_max_len.long(), lens)
        elif self.mask_mode == "unorder":
            rows = torch.where(is_tgt, torch.zeros_like(rows), rows)
            if trows is not None:
                trows = torch.where(is_tgt, torch.zeros_like(trows), trows)
            n = lens
        else:  # autoregressive
            pos = torch.arange(C, device=rows.device)
            valid_pos = is_tgt & (pos[None, :] < lens[:, None])
            counts = valid_pos.sum(-1)
            if self.seq_last:
                rev = C - 1 - valid_pos.flip(-1).to(torch.int8).argmax(-1)
                n = torch.where(counts > 0, rev, lens)
            else:
                hi = counts.clamp(min=1)
                u = rand_rows(gen, (B,), rows.device)
                r = torch.minimum((u * hi).long(), hi - 1)
                sel = (valid_pos.long().cumsum(-1) > r[:, None]) & valid_pos
                n = torch.where(counts > 0, sel.to(torch.int8).argmax(-1), lens)
        grid = n[:, None] - L + torch.arange(L, device=rows.device)[None, :]
        valid = grid >= 0
        gi = grid.clamp(0, C - 1)
        seq = rows.gather(1, gi) * valid
        tseq = None if trows is None else (trows.gather(1, gi) * valid).to(torch.int32)
        return seq.to(torch.int32), torch.clamp(n, max=L).to(torch.int32), tseq

    # ------------------------------------------------------------------
    def with_state(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """The raw batch with the device tables attached (the JAX package's
        jit-operand convention; here only a reference travels)."""
        out = dict(raw)
        out["_aug"] = self.state
        return out

    def augment(self, raw: Dict[str, Any], gen: torch.Generator,
                rows=None) -> Dict[str, torch.Tensor]:
        """raw: {user_id [B], item_id [B] or [B, P], weight [B], label?,
        max_len? [B]} as device tensors -> the full train batch. ``rows``
        (lo, hi): augment only rows [lo, hi) of the (global) raw batch, a
        data-parallel rank's, with every random draw taken at the global
        batch's shape and sliced, so they are the rows a one-process run
        makes; membership (row 8) runs on these rows alone."""
        with tracing.span("train.augment"):
            return self._augment(raw, gen, rows)

    def _augment(self, raw, gen, rows):
        raw = dict(raw)
        state = raw.pop("_aug", self.state)
        if rows is not None:
            lo, hi = rows
            gen = RowSlice(gen, lo, hi - lo, len(raw["user_id"]))
            raw = {k: v[lo:hi] if torch.is_tensor(v) and v.dim() else v
                   for k, v in raw.items()}
        uid = raw["user_id"].long()
        rows = state["hist_items"][uid]
        lens = state["hist_lens"][uid]
        batch = {"user_id": raw["user_id"], "weight": raw["weight"]}
        if self.aerec:
            # AERec rows (:237-256): the user's own deduplicated history is
            # the input and the reconstruction target
            cap = self.aerec_cap or rows.shape[1]
            batch["item_seq"] = rows[:, :cap]
            batch["item_seq_len"] = torch.clamp(lens, max=cap)
            if self.use_features:
                batch["item_seq_features"] = state["features"][batch["item_seq"].long()]
            return batch
        pos = raw["item_id"].to(torch.int32)
        pos2d = pos if pos.dim() == 2 else pos[:, None]
        in_label = raw.get("label")
        if self.n_neg > 0:
            negs = self.sample_negatives(gen, rows, pos2d)
            item_id = torch.cat([pos2d, negs], dim=1)
            label = torch.zeros(item_id.shape, dtype=torch.float32, device=item_id.device)
            P = pos2d.shape[1]
            if in_label is None:
                label[:, :P] = 1.0
            elif in_label.dim() == 1:
                label[:, 0] = in_label.float()
            else:
                label[:, :P] = in_label.float()
        else:
            item_id = pos
            if in_label is not None:
                label = in_label.float()
            elif pos.dim() == 2:
                label = torch.zeros(pos.shape, dtype=torch.float32, device=pos.device)
                label[:, 0] = 1.0
            else:
                label = torch.ones(pos.shape, dtype=torch.float32, device=pos.device)
        batch["item_id"] = item_id
        batch["label"] = label
        if self.use_features:
            batch["item_features"] = state["features"][item_id.long()]
        if self.is_sequential:
            trows = state["hist_times"][uid] if self.with_time else None
            seq, seq_len, tseq = self.history_window(gen, rows, lens, pos2d, trows=trows,
                                                     explicit_max_len=raw.get("max_len"))
            batch["item_seq"] = seq
            batch["item_seq_len"] = seq_len
            if tseq is not None:
                batch["time_seq"] = tseq
            if self.use_features:
                batch["item_seq_features"] = state["features"][seq.long()]
        return batch


class RawIdBatcher:
    """Host loop for the device pipeline (copy of the JAX package's): shuffle
    and slice the raw id columns; ``extra`` columns ride along."""

    def __init__(self, user_id: np.ndarray, item_id: np.ndarray,
                 batch_size: int, seed: int = 2022, shuffle: bool = True,
                 extra: Optional[Dict[str, np.ndarray]] = None):
        self.user_id = np.asarray(user_id).astype(np.int32)
        self.item_id = np.asarray(item_id).astype(np.int32)
        self.extra = {k: np.asarray(v) for k, v in (extra or {}).items()}
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = shuffle
        self._epoch = 0

    def __len__(self):
        return (len(self.user_id) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        """Fast-forward the shuffle rng (auto_resume)."""
        self._epoch = int(epoch)

    def __iter__(self):
        rng = np.random.default_rng([self.seed, self._epoch])
        self._epoch += 1
        n, b = len(self.user_id), self.batch_size
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, b):
            idx = order[start:start + b]
            pad = b - len(idx)
            weight = np.ones(b, np.float32)
            if pad:
                weight[len(idx):] = 0.0
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            out = {"user_id": self.user_id[idx], "item_id": self.item_id[idx],
                   "weight": weight}
            for k, v in self.extra.items():
                out[k] = v[idx]
            yield out
