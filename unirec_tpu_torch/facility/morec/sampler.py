"""MoRec adaptive data sampler.

The port's copy of unirec_tpu/facility/morec/sampler.py over the port's
host ``Batcher`` (data/pipeline.py), with the same numpy generator draws, so
the block composition from a seed equals the JAX package's. The design
(reference facility/morec/morec_data_sampler.py:77-459): every epoch,
per-objective group sampling weights are updated by signed SGD from
validation signals (worst-group loss for fairness, top-k group frequency
against the target distribution for alignment), then each batch is
composed of one block per objective (group-quota sampling) plus one
uniformly random block, the accuracy block, placed last (trainer.py:331-338
convention). The signals are gathered between epochs (``refresh_weights``)
by the sweeps of facility/morec/integration.py on the device; MoRec batches
are host batches (negatives drawn by the host sampler), as in the JAX
package.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from unirec_tpu_torch.data.pipeline import Batcher


def normalize(x: np.ndarray) -> np.ndarray:
    return x / (x.sum() + 1e-10)


def group_items_by_attr(item2info: np.ndarray, ngroup: int,
                        zero_as_group: bool = False):
    """Split items into ngroup buckets by descending attribute value
    (morec_data_sampler.py:163-206). Group ids start at 1; 0 is padding.
    Returns (item2group, group2info[ngroup+1] mean attr per group)."""
    n = len(item2info)
    if zero_as_group:
        zero_idx = np.flatnonzero(item2info == 0.0)
        ngroup_eff = ngroup - 1
    else:
        zero_idx = np.array([], dtype=int)
        ngroup_eff = ngroup
    order = np.argsort(-item2info, kind="stable")
    order = order[~np.isin(order, zero_idx)]
    buckets = np.array_split(order, ngroup_eff)
    item2group = np.zeros(n, dtype=np.int64)
    for gid, bucket in enumerate(buckets, start=1):
        item2group[bucket] = gid
    if zero_as_group:
        item2group[zero_idx] = ngroup
    item2group[0] = 0  # padding item
    group2info = np.zeros(ngroup + 1)
    for gid in range(1, ngroup + 1):
        mask = item2group == gid
        if mask.any():
            group2info[gid] = item2info[mask].mean()
    return item2group, group2info


def group_rows(gcol: np.ndarray, ngroup: int) -> List[np.ndarray]:
    """[no rows, the rows of group 1, ..., of group ngroup - 1], each
    ascending: ``np.flatnonzero(gcol == g)`` of every g (the JAX sampler's
    lists) from one stable sort, so that revenue's one group an item costs
    no pass over the rows per group."""
    order = np.argsort(gcol, kind="stable")
    bounds = np.searchsorted(gcol[order], np.arange(ngroup + 1))
    return [np.array([], dtype=np.int64)] + [order[bounds[g]:bounds[g + 1]].astype(np.int64)
                                              for g in range(1, ngroup)]


class MoRecBatcher(Batcher):
    def __init__(self, dataset, config: Dict[str, Any], history=None,
                 sampler=None, features=None,
                 item_meta: Optional[Dict[str, np.ndarray]] = None,
                 align_dist: Optional[np.ndarray] = None,
                 valid_batcher: Optional[Batcher] = None,
                 topk: int = 100):
        super().__init__(dataset, config, history=history, sampler=sampler,
                         batch_size=config.get("batch_size"), shuffle=True,
                         seed=int(config.get("seed", 2022)) + 31,
                         features=features)
        self.objectives = list(config.get("morec_objectives",
                                          ["fairness", "alignment", "revenue"]))
        self.alpha = float(config.get("morec_alpha", 0.1))
        self.topk = topk
        self.valid_batcher = valid_batcher
        self.align_dist = align_dist
        self.fairness_metric = config.get("morec_fairness_metric", "loss")
        self.trainer = None  # set via set_trainer

        n_items = int(config["n_items"])
        ngroup_cfg = config.get("morec_ngroup", [10, 10, -1])
        if not isinstance(ngroup_cfg, (list, tuple)):
            ngroup_cfg = [ngroup_cfg] * len(self.objectives)

        self.item2group: Dict[str, np.ndarray] = {}
        self.ngroup: Dict[str, int] = {}
        self.group2weights: Dict[str, np.ndarray] = {}
        for obj, ng in zip(self.objectives, ngroup_cfg):
            if obj in ("fairness", "alignment"):
                col = "fair_group" if obj == "fairness" else "align_group"
                i2g = np.asarray(item_meta[col], np.int64)
                self.item2group[obj] = i2g
                self.ngroup[obj] = int(i2g.max()) + 1
            elif obj == "revenue":
                weight = np.asarray(item_meta["weight"], np.float64)
                if ng and int(ng) > 0:
                    i2g, g2info = group_items_by_attr(weight, int(ng))
                else:  # every item its own group (morec_data_sampler.py:140-143)
                    i2g = np.arange(n_items)
                    g2info = weight.copy()
                self.item2group[obj] = i2g
                self.ngroup[obj] = int(i2g.max()) + 1
                self.group2weights[obj] = normalize(g2info)
            else:
                raise ValueError(f"unsupported MoRec objective: {obj}")

        # per-objective: data row indices per group (train + valid)
        item_col = self._item_column(dataset)
        self.group2dataindex: Dict[str, List[np.ndarray]] = {}
        for obj in self.objectives:
            ng = self.ngroup[obj]
            idx = group_rows(self.item2group[obj][item_col], ng)
            self.group2dataindex[obj] = idx
            if obj not in self.group2weights:
                ratio = np.array([len(ix) / max(len(item_col), 1) for ix in idx])
                self.group2weights[obj] = ratio

        if valid_batcher is not None:
            vcol = self._item_column(valid_batcher.ds)
            self.group2dataindex_val = {
                obj: group_rows(self.item2group[obj][vcol], self.ngroup[obj])
                for obj in self.objectives}

    @staticmethod
    def _item_column(dataset) -> np.ndarray:
        item = dataset.cols["item_id"]
        return (item[:, 0] if item.ndim == 2 else item).astype(np.int64)

    def set_trainer(self, trainer):
        self.trainer = trainer

    @property
    def n_blocks(self) -> int:
        return len(self.objectives) + 1

    def __len__(self) -> int:
        n, b = len(self.ds), self.batch_size
        return (n + b - 1) // b

    # ------------------------------------------------------------- signals
    def refresh_weights(self):
        """Per-epoch signed-SGD update of group sampling weights
        (morec_data_sampler.py:363-392)."""
        from unirec_tpu_torch.facility.morec import integration as I
        if self.trainer is None or self.trainer.params is None or \
                self.valid_batcher is None:
            return
        topk_items, target_items = I.gather_topk(
            self.trainer, self.valid_batcher, self.topk)

        signals: Dict[str, Optional[np.ndarray]] = {}
        if "fairness" in self.objectives:
            if self.fairness_metric == "hit":
                signals["fairness"] = self._fair_signal_hit(topk_items,
                                                            target_items)
            else:
                signals["fairness"] = self._fair_signal_loss()
        if "revenue" in self.objectives:
            signals["revenue"] = np.zeros(self.ngroup["revenue"])
        if "alignment" in self.objectives:
            signals["alignment"] = self._alignment_signal(topk_items)

        for obj in self.objectives:
            sig = signals.get(obj)
            if sig is None:
                continue
            w = self.group2weights[obj]
            desc = np.flatnonzero(sig < 0)
            asc = np.flatnonzero(sig > 0)
            if len(desc) and len(asc):
                w[desc] -= self.alpha
                w[asc] += self.alpha
                w[w <= 0] = 0.0
            elif len(desc):
                w[desc] -= np.minimum(self.alpha, w[desc])
            elif len(asc):
                w[asc] += self.alpha
            # rank 0's weights on every data rank: the ranks compose the
            # same global batches
            self.group2weights[obj] = I._rank0(self.trainer, normalize(w))

    def _fair_signal_hit(self, topk_items, target_items) -> np.ndarray:
        i2g = self.item2group["fairness"]
        ng = self.ngroup["fairness"]
        hit = (topk_items[:, :10] == target_items[:, None]).any(-1)
        gid = i2g[target_items]
        group2hit = np.zeros(ng)
        for g in range(1, ng):
            mask = gid == g
            if mask.any():
                group2hit[g] = hit[mask].mean()
        group2hit[0] = 1.0
        signal = np.zeros(ng)
        signal[int(np.argmin(group2hit))] = 1
        return signal

    def _fair_signal_loss(self) -> np.ndarray:
        """Worst-group training loss on the validation set
        (morec_data_sampler.py:230-253): the per-row losses over the whole
        valid sweep are grouped by the positive item's fair group — one
        device sweep instead of the reference's per-group dataloaders."""
        from unirec_tpu_torch.facility.morec import integration as I
        per_row_loss, items = I.gather_per_row_loss(self.trainer,
                                                    self.valid_batcher)
        i2g = self.item2group["fairness"]
        gid = i2g[items]
        ng = self.ngroup["fairness"]
        loss = np.full(ng, -np.inf)
        for g in range(1, ng):
            mask = gid == g
            if mask.any():
                loss[g] = per_row_loss[mask].mean()
        signal = np.zeros(ng)
        signal[int(np.argmax(loss))] = 1
        return signal

    def _alignment_signal(self, topk_items) -> np.ndarray:
        i2g = self.item2group["alignment"]
        ng = self.ngroup["alignment"]
        gid, counts = np.unique(topk_items.reshape(-1), return_counts=True)
        gid = i2g[gid]
        group2counts = np.zeros(ng)
        for g in range(ng):
            mask = gid == g
            if mask.any():
                group2counts[g] = counts[mask].sum()
        group2pop = group2counts / (group2counts.sum() + 1e-10)
        target = np.concatenate([[0.0], self.align_dist]) \
            if self.align_dist is not None and len(self.align_dist) == ng - 1 \
            else np.zeros(ng)
        signal = np.zeros(ng)
        div = group2pop - target
        signal[div > 0] = -1
        signal[div < 0] = 1
        return signal

    # ------------------------------------------------------------ batching
    def __iter__(self):
        self.refresh_weights()
        rng = self._next_rng()
        n_batches = len(self)
        B = self.batch_size
        n_train = len(self.ds)
        cols = []
        for obj in self.objectives:
            w = self.group2weights[obj]
            quota = np.floor(w * B).astype(int)
            quota[-1] = B - quota[:-1].sum()
            blocks = []
            for g in range(1, self.ngroup[obj]):
                pool = self.group2dataindex[obj][g]
                if len(pool) == 0:
                    pool = np.arange(n_train)
                blocks.append(rng.choice(pool, size=(n_batches, quota[g]),
                                         replace=True))
            col = np.concatenate(blocks, axis=1)
            col = rng.permutation(col.reshape(-1)).reshape(n_batches, B)
            cols.append(col)
        # random (accuracy) block, last — cycled permutation without replacement
        perm = rng.permutation(n_train)
        reps = int(np.ceil(n_batches * B / n_train))
        rand = np.concatenate([perm] * reps)[: n_batches * B].reshape(n_batches, B)
        cols.append(rand)

        index_matrix = np.concatenate(cols, axis=1)  # [n_batches, n_blocks*B]
        for row in index_matrix:
            yield self._assemble(row, np.ones(len(row), np.float32), rng)
