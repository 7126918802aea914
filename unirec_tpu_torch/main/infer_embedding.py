"""Batch user/item embedding inference.

Counterpart of unirec_tpu/main/infer_embedding.py: load a checkpoint
(model rebuilt from its embedded config), encode every requested id in
fixed-shape batches on the device, and write ``id\\tv1,v2,...`` lines.
Batches are queued without a host round-trip and copied back once. With
``use_features`` the item -> feature table of ``features_filepath`` rides
along: the history windows' features on the user side, the items' on the
item side (unirec_tpu/main/infer_embedding.py:54-58, 132-137); text rows
come from the checkpoint's constants.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from unirec_tpu_torch import config as config_mod
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.models.base import features_shape
from unirec_tpu_torch.utils import file_io, to_device
from unirec_tpu_torch.utils.checkpoint import load_model_freely
from unirec_tpu_torch.utils.logger import setup_logger


def _pad_to(arr: np.ndarray, size: int) -> np.ndarray:
    if len(arr) == size:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], size - len(arr), axis=0)])


def iter_infer_batches(config, ids: np.ndarray, history: Optional[UserHistory],
                       is_seqrec: bool, features: Optional[np.ndarray] = None,
                       node_type: str = "user"):
    """Fixed-shape id batches (the last one padded by repeating its final
    id) with left-padded history windows for sequential models
    (inferdataset.py:9-67) and, given ``features``, their feature rows.
    Each batch also carries ``n_real``."""
    bs = int(config.get("test_batch_size") or config.get("batch_size", 512))
    L = int(config.get("max_seq_len", 10))
    last_item = int(config.get("last_item", 0))
    for start in range(0, len(ids), bs):
        chunk = ids[start:start + bs]
        batch: Dict[str, np.ndarray] = {"n_real": len(chunk)}
        chunk = _pad_to(chunk, bs)
        if node_type == "user":
            batch["user_id"] = chunk.astype(np.int32)
            if is_seqrec and history is not None:
                seq, seq_len = history.window(chunk, L, drop_last=last_item)
                batch["item_seq"] = seq
                batch["item_seq_len"] = seq_len
                if features is not None:
                    batch["item_seq_features"] = features[seq]
        else:
            batch["item_id"] = chunk.astype(np.int32)
            if features is not None:
                batch["item_features"] = features[chunk]
        yield batch


@torch.no_grad()
def infer_embedding(config, model, ids: np.ndarray,
                    history: Optional[UserHistory], is_seqrec: bool,
                    features: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    node_type = config.get("node_type", "user")
    key = "user_id" if node_type == "user" else "item_id"
    pending, reals, out_ids = [], [], []
    for batch in iter_infer_batches(config, ids, history, is_seqrec, features, node_type):
        n_real = batch.pop("n_real")
        tb = to_device(batch, model.device, torch.int64)
        emb = model.user_emb(tb) if node_type == "user" \
            else model.item_emb(tb["item_id"], tb.get("item_features"))
        pending.append(emb)
        reals.append(n_real)
        out_ids.append(batch[key][:n_real])
    out = [e.float().cpu().numpy()[:n] for e, n in zip(pending, reals)]
    return np.concatenate(out_ids), np.vstack(out)


def run(args: Optional[Dict] = None, device: Optional[str] = None
        ) -> Tuple[np.ndarray, np.ndarray]:
    config = dict(args or {})
    config.setdefault("exp_name", "infer_embedding")
    out_file = config.get("output_emb_file", "infer_emb.tsv")
    logger = setup_logger(config["exp_name"],
                          os.path.dirname(os.path.abspath(out_file)))
    device = device or config.pop("device", None)
    model, ckpt_cfg = load_model_freely(config["model_file"], device)
    config = {**ckpt_cfg, **config}

    node_type = config.get("node_type", "user")
    dpath = config["dataset_path"]
    if config.get("id_file_name"):
        ids = np.loadtxt(os.path.join(dpath, config["id_file_name"]),
                         dtype=np.int64).reshape(-1)
    else:
        n = config["n_users"] if node_type == "user" else config["n_items"]
        ids = np.arange(int(n), dtype=np.int64)
    logger.info("#. %ss for inference: %d", node_type, len(ids))

    history = None
    is_seqrec = model.is_seqrec and node_type == "user"
    if node_type == "user":
        fname = config.get("user_history_filename", "user_history")
        fmt = config.get("user_history_file_format",
                         config.get("train_file_format"))
        history = UserHistory.load(os.path.join(dpath, fname),
                                   int(config["n_users"]), fmt)

    features = None
    if config.get("use_features") and config.get("features_filepath"):
        features = file_io.load_features(config["features_filepath"], int(config["n_items"]),
                                         len(features_shape(config)))
    ids, emb = infer_embedding(config, model, ids, history, is_seqrec, features)
    logger.info("saving inferred embeddings to %s", out_file)
    with open(out_file, "w") as f:
        for i, e in zip(ids, emb):
            f.write(f"{int(i)}\t" + ",".join(str(float(x)) for x in e) + "\n")
    return ids, emb


if __name__ == "__main__":
    run(config_mod.parse_cmd_arguments(sys.argv[1:]))
