"""MoRec multi-objective training.

Counterpart of unirec_tpu/facility/morec (the reference's
unirec/facility/morec): item-meta loading (facility/morec/__init__.py:8-99),
the objective controllers (controllers.py, min_norm.py: numpy on the host),
the adaptive batch sampler (sampler.py) and the trainer's objective-control
step with the signal sweeps (integration.py: torch on the device).
``build_morec`` wires the sampler and the controller into a Trainer.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from unirec_tpu_torch.facility.morec.controllers import (EPOSolver, MGDASolver,
                                                   ParetoMTLSolver,
                                                   PIController, PIXController,
                                                   StaticWeightSolver,
                                                   build_controller)
from unirec_tpu_torch.facility.morec.sampler import MoRecBatcher


def load_morec_meta_data(n_items: int, filepath: str,
                         objectives: List[str]) -> Dict[str, np.ndarray]:
    """Load the item meta csv → dense arrays indexed by item id
    (reference facility/morec/__init__.py:8-61): pads item 0 with
    weight=0 / group=0, shifts group ids up by one when the file uses
    0-based groups for real items."""
    import pandas as pd
    df = pd.read_csv(filepath, sep=",")
    assert "item_id" in df.columns, "`item_id` column is required"
    err = "`{col}` column is required by the {obj} objective"
    if "revenue" in objectives:
        assert "weight" in df.columns, err.format(col="weight", obj="revenue")
    if "fairness" in objectives:
        assert "fair_group" in df.columns, err.format(col="fair_group", obj="fairness")
    if "alignment" in objectives:
        assert "align_group" in df.columns, err.format(col="align_group", obj="alignment")

    items = df["item_id"].to_numpy(np.int64)
    if len(np.unique(items)) < n_items:
        if len(np.unique(items)) == n_items - 1 and 0 not in items:
            pad = {c: [0] for c in df.columns}
            pad["item_id"] = [0]
            if "weight" in df.columns:
                pad["weight"] = [0.0]
            df = pd.concat([pd.DataFrame(pad), df], ignore_index=True)
        else:
            raise ValueError(f"{n_items} items in dataset but only "
                             f"{len(np.unique(items))} have meta information")

    for col in ("align_group", "fair_group"):
        if col in df.columns and df[col].min() == 0:
            zero_items = df.loc[df[col] == 0, "item_id"].unique()
            if len(zero_items) > 1 or (len(zero_items) == 1 and zero_items[0] != 0):
                df.loc[df["item_id"] != 0, col] += 1

    df = df.set_index("item_id").sort_index()
    out: Dict[str, np.ndarray] = {}
    idx = np.arange(n_items)
    for col in df.columns:
        dtype = np.float64 if col == "weight" else np.int64
        arr = np.zeros(n_items, dtype)
        arr[df.index.to_numpy()] = df[col].to_numpy(dtype)
        out[col] = arr[idx]
    return out


def load_alignment_distribution(item_meta: Dict[str, np.ndarray],
                                item_popularity: Optional[np.ndarray],
                                align_dist_filepath: Optional[str] = None
                                ) -> Optional[np.ndarray]:
    """Target group distribution for the alignment objective
    (reference facility/morec/__init__.py:64-99): loaded from csv or derived
    from training-set popularity per align group."""
    if "align_group" not in item_meta:
        return None
    if align_dist_filepath is None and item_popularity is None:
        # no distribution source (pop-kl/alignment not in play) — skip
        return None
    i2g = item_meta["align_group"]
    max_gid = int(i2g.max())
    probs = np.zeros(max_gid)
    if align_dist_filepath:
        import pandas as pd
        df = pd.read_csv(align_dist_filepath, sep=",")
        assert {"group_id", "proportion"} <= set(df.columns)
        probs[df["group_id"].to_numpy(np.int64)] = df["proportion"].to_numpy()
    else:
        for gid in range(1, max_gid + 1):
            probs[gid - 1] = item_popularity[i2g == gid].sum()
    return probs / (probs.sum() + 1e-10)


def build_morec(trainer, config, train_ds, valid_batcher, history,
                item_popularity, features, item_sampler=None) -> MoRecBatcher:
    """Wire the MoRec sampler + controller into a Trainer
    (reference main.py:168-190, 347-364). Returns the train batcher, whose
    host batches the trainer takes without a device augmenter."""
    objectives = list(config.get("morec_objectives",
                                 ["fairness", "alignment", "revenue"]))
    item_meta = config.get("_item_meta_morec")
    align_dist = config.get("_alignment_dist")
    if item_meta is None:
        meta_file = os.path.join(config["dataset_path"],
                                 config.get("item_meta_morec_filename",
                                            "item_meta_morec.csv"))
        item_meta = load_morec_meta_data(int(config["n_items"]), meta_file,
                                         objectives)
        align_file = config.get("align_dist_filename")
        align_dist = load_alignment_distribution(
            item_meta, item_popularity,
            os.path.join(config["dataset_path"], align_file)
            if align_file else None)
        config["_item_meta_morec"] = item_meta
        config["_alignment_dist"] = align_dist

    # every objective block must stay whole when the mesh splits the batch
    # over data: batch_size rounded up to a multiple of n_data, so that
    # pad_batch appends no padding row (it would land inside the last
    # block), as the JAX package rounds it
    n_data = getattr(getattr(trainer, "mesh", None), "n_data", 1)
    B = int(config.get("batch_size", 256))
    if B % n_data:
        config = dict(config)
        config["batch_size"] = B + (n_data - B % n_data)
    batcher = MoRecBatcher(train_ds, config, history=history,
                           sampler=item_sampler, features=features,
                           item_meta=item_meta, align_dist=align_dist,
                           valid_batcher=valid_batcher)
    batcher.set_trainer(trainer)
    trainer._morec_sampler = batcher
    trainer.add_objective_controller(build_controller(config, len(objectives)))
    return batcher


__all__ = [
    "load_morec_meta_data", "load_alignment_distribution", "build_morec",
    "MoRecBatcher", "PIController", "PIXController", "StaticWeightSolver",
    "MGDASolver", "ParetoMTLSolver", "EPOSolver", "build_controller",
]
