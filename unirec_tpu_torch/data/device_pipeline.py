"""Device-side batch augmentation (counterpart of
unirec_tpu/data/device_pipeline.py).

The host feeds raw id columns; negative sampling with user-history
rejection and the left-padded history windows run as torch ops on tensors
resident on the device. Semantics are the JAX package's: oversampled
uniform negatives, rejected when in the user's history or equal to a
positive, the first valid proposal kept and 0 when every proposal fails
(:141-160); the unorder / autoregressive truncation rules, ``seq_last`` and
an explicit per-row ``max_len`` (:162-216).

Randomness comes from an explicit ``torch.Generator`` on the state's device
(the JAX package's ``key``); the two frameworks draw different numbers from
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

from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.ops import member as member_ops


class DeviceAugmenter:
    """Holds the device-resident history and exposes ``augment(raw, gen)``."""

    def __init__(self, config: Dict[str, Any], history: UserHistory,
                 item_popularity: Optional[np.ndarray] = None,
                 features: Optional[np.ndarray] = None, aerec: bool = False,
                 device=None):
        c = config
        if float(c.get("neg_by_pop_alpha", 0) or 0) > 0 and item_popularity is not None:
            raise NotImplementedError("popularity (alias-table) negatives are not "
                                      "ported yet (ROADMAP.md Queue 1 item 3)")
        if aerec:
            raise NotImplementedError("AERec training rows are not ported yet "
                                      "(ROADMAP.md Queue 1 item 7)")
        if features is not None:
            raise NotImplementedError("categorical item features are not ported "
                                      "yet (ROADMAP.md Queue 1)")
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
        self.state: Dict[str, torch.Tensor] = {
            "hist_items": torch.as_tensor(history.items, dtype=torch.int32,
                                          device=self.device),
            "hist_lens": torch.as_tensor(history.lengths, dtype=torch.int32,
                                         device=self.device),
        }

    # ------------------------------------------------------------------
    def _draw(self, gen: torch.Generator, shape) -> torch.Tensor:
        return torch.randint(1, self.n_items, shape, generator=gen,
                             device=self.device, dtype=torch.int32)

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

    def history_window(self, gen, rows, lens, tgt2d, explicit_max_len=None):
        """(item_seq [B, L], item_seq_len [B]) with the host pipeline's
        unorder / autoregressive semantics; tgt2d: [B, P] positive items."""
        B, C = rows.shape
        L = self.max_seq_len
        lens = lens.long()
        is_tgt = (rows[:, :, None] == tgt2d[:, None, :]).any(-1) & (rows > 0)
        if explicit_max_len is not None and self.mask_mode != "unorder":
            n = torch.minimum(explicit_max_len.long(), lens)
        elif self.mask_mode == "unorder":
            rows = torch.where(is_tgt, torch.zeros_like(rows), rows)
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
                u = torch.rand(B, generator=gen, device=rows.device)
                r = torch.minimum((u * hi).long(), hi - 1)
                sel = (valid_pos.long().cumsum(-1) > r[:, None]) & valid_pos
                n = torch.where(counts > 0, sel.to(torch.int8).argmax(-1), lens)
        grid = n[:, None] - L + torch.arange(L, device=rows.device)[None, :]
        valid = grid >= 0
        seq = rows.gather(1, grid.clamp(0, C - 1)) * valid
        return seq.to(torch.int32), torch.clamp(n, max=L).to(torch.int32)

    # ------------------------------------------------------------------
    def with_state(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """The raw batch with the device tables attached (the JAX package's
        jit-operand convention; here only a reference travels)."""
        out = dict(raw)
        out["_aug"] = self.state
        return out

    def augment(self, raw: Dict[str, Any], gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """raw: {user_id [B], item_id [B] or [B, P], weight [B], label?,
        max_len? [B]} as device tensors -> the full train batch."""
        raw = dict(raw)
        state = raw.pop("_aug", self.state)
        uid = raw["user_id"].long()
        rows = state["hist_items"][uid]
        lens = state["hist_lens"][uid]
        batch = {"user_id": raw["user_id"], "weight": raw["weight"]}
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
        if self.is_sequential:
            seq, seq_len = self.history_window(gen, rows, lens, pos2d,
                                               explicit_max_len=raw.get("max_len"))
            batch["item_seq"] = seq
            batch["item_seq_len"] = seq_len
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
