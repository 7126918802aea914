"""AdaRanker dataset builder and item2vec pretraining (counterpart of
unirec_tpu/data/ranker_prep.py; reference examples/preprocess/
specific_datasets/ranker.py:384-613).

- ``distribution_mixer_sample`` and ``build_adaranker_dataset`` are numpy
  copies of the JAX package's: the same files from the same seed (T4
  grouped splits of 1 positive and ``n_neg_k`` mixed-distribution
  negatives, one group per category of the positive, as pandas pkl and
  the reference's text layout, the histories, and data.info).
- ``pretrain_item2vec``: skip-gram with negative sampling over the
  histories' co-occurrences (the role of the reference's gensim Word2Vec),
  a torch SGD loop on the given device with its own ``torch.Generator``;
  writes ``item_emb_<d>.txt`` for ``item_emb_path``/``use_pre_item_emb``.
  Its draws are not the JAX package's; it learns the same co-occurrence.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------------- neg sampling
def distribution_mixer_sample(rng: np.random.Generator, pos_cate: int,
                              target: int, n_cates: int,
                              cate2items_pop: Dict[int, np.ndarray],
                              cate2items_uni: Dict[int, np.ndarray],
                              n_neg: int, exclude: Sequence[int]) -> List[int]:
    """One request's mixed-distribution negatives (ranker.py:384-411)."""
    cates = [pos_cate] + list(rng.choice(np.arange(1, n_cates + 1),
                                         size=rng.integers(0, 3),
                                         replace=True))
    counts = rng.multinomial(n_neg, np.ones(len(cates)) / len(cates))
    use_uniform = rng.integers(0, 100) < 50  # one coin per request (ref :394)
    banned = set(int(x) for x in exclude)
    banned.add(int(target))
    out: List[int] = []
    for cate, cnt in zip(cates, counts):
        if cnt == 0:
            continue
        pool = (cate2items_uni if use_uniform else cate2items_pop).get(
            int(cate))
        if pool is None or len(pool) == 0:
            continue
        # oversample + reject (replaces the reference's 100-retry loop)
        cand = rng.choice(pool, size=max(4 * cnt, 16), replace=True)
        picked = []
        for c in cand:
            c = int(c)
            if c not in banned and c not in picked:
                picked.append(c)
                if len(picked) == cnt:
                    break
        if len(picked) < cnt:  # fall back to the deduped complement
            rest = [int(x) for x in np.unique(pool)
                    if int(x) not in banned and int(x) not in picked]
            rng.shuffle(rest)
            picked += rest[: cnt - len(picked)]
        out += picked
        banned.update(picked)  # no duplicates across category draws
    return out


# ------------------------------------------------------------ dataset build
def build_adaranker_dataset(infile: str, item2cate_file: str, outdir: str,
                            n_neg_k: int = 5, seed: int = 2022,
                            last_train_window: int = 10) -> Dict[str, int]:
    """'user item item ...' lines + item->categories json → T4 grouped
    splits with distribution-mixer negatives (ranker.py:454-556)."""
    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)
    item2cate_raw = json.load(open(item2cate_file))

    users: List[int] = []
    hists: List[List[int]] = []
    with open(infile) as f:
        for line in f:
            w = line.split()
            if len(w) < 4:  # needs >= 3 items after dedup (ref :480)
                continue
            items = list(dict.fromkeys(int(x) for x in w[1:]))
            if len(items) < 3:
                continue
            users.append(int(w[0]))
            hists.append(items)

    all_items = sorted({i for h in hists for i in h})
    item2tid = {it: t for t, it in enumerate(all_items, start=1)}
    item2cate = {item2tid[i]: [int(c) for c in item2cate_raw.get(str(i), [0])]
                 for i in all_items}
    user2uid = {u: k for k, u in enumerate(sorted(set(users)), start=1)}

    cate2items_pop: Dict[int, list] = {}
    for h in hists:
        for i in h:
            for c in item2cate[item2tid[i]]:
                cate2items_pop.setdefault(c, []).append(item2tid[i])
    cate2items_pop = {c: np.asarray(v) for c, v in cate2items_pop.items()}
    cate2items_uni = {c: np.unique(v) for c, v in cate2items_pop.items()}
    n_cates = max(cate2items_pop) if cate2items_pop else 1

    rows = {"train": [], "valid": [], "test": []}
    hist_rows = []
    for u, h in zip(users, hists):
        uid = user2uid[u]
        tids = [item2tid[i] for i in h]
        hist_rows.append((uid, np.asarray(tids, np.int64)))
        st = max(len(tids) - 2 - last_train_window, 0)

        def emit(split, pos, hist_prefix):
            for cate in item2cate[pos]:
                negs = distribution_mixer_sample(
                    rng, cate, pos, n_cates, cate2items_pop, cate2items_uni,
                    n_neg_k, hist_prefix)
                negs = (negs + [0] * n_neg_k)[:n_neg_k]
                rows[split].append((uid,
                                    np.asarray([pos] + negs, np.int64),
                                    np.asarray([1.0] + [0.0] * n_neg_k,
                                               np.float32)))

        for j, pos in enumerate(tids[:-2]):
            if j >= st:
                emit("train", pos, tids[:j])
        emit("valid", tids[-2], tids[:-2])
        emit("test", tids[-1], tids[:-1])

    import pandas as pd
    for split, data in rows.items():
        df = pd.DataFrame(data, columns=["user_id", "item_id_list",
                                         "label_list"])
        df.to_pickle(os.path.join(outdir, f"{split}.pkl"))
        with open(os.path.join(outdir, f"{split}.txt"), "w") as f:
            for uid, items, labels in data:
                f.write(f"{uid} {','.join(map(str, items))} "
                        f"{','.join(str(int(x)) for x in labels)}\n")
    pd.DataFrame(hist_rows, columns=["user_id", "item_seq"]).to_pickle(
        os.path.join(outdir, "user_history.pkl"))
    with open(os.path.join(outdir, "user_history.txt"), "w") as f:
        for uid, tids in hist_rows:
            f.write(f"{uid} {','.join(map(str, tids))}\n")

    info = {"n_users": len(user2uid) + 1, "n_items": len(item2tid) + 1,
            "n_cates": n_cates,
            "train_file_format": "user-item_group-label_group",
            "valid_file_format": "user-item_group-label_group",
            "test_file_format": "user-item_group-label_group",
            "user_history_file_format": "user-item_seq"}
    with open(os.path.join(outdir, "data.info"), "w") as f:
        json.dump(info, f)
    return info


# ------------------------------------------------------------- item2vec
def pretrain_item2vec(histories: Sequence[np.ndarray], n_items: int,
                      dim: int = 64, window: int = 10, n_neg: int = 5,
                      epochs: int = 3, lr: float = 0.025,
                      batch_size: int = 4096, seed: int = 0,
                      out_path: Optional[str] = None, device=None) -> np.ndarray:
    """Skip-gram with negative sampling on item co-occurrence within
    ``window`` positions (ranker_prep.py:166-226): W_in from normal(0.1),
    W_out from normal(0.01) (a zero W_out would stall W_in's first steps),
    plain SGD at ``lr`` over shuffled whole batches of (center, context)
    pairs with ``n_neg`` uniform negatives from [1, n_items). Returns W_in
    [n_items, dim] (row 0, the padding item, zero) and writes it to
    ``out_path`` when given (id \\t comma-separated floats)."""
    from unirec_tpu_torch.utils import resolve_device
    dev = resolve_device(device)
    centers, contexts = _pairs(histories, window)
    if len(centers) == 0:
        table = np.zeros((n_items, dim), np.float32)
        if out_path:
            _write_emb(out_path, table)
        return table
    centers_t = torch.as_tensor(centers, device=dev)
    contexts_t = torch.as_tensor(contexts, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    w_in = (0.1 * torch.randn(n_items, dim, generator=gen, device=dev)).requires_grad_(True)
    w_out = (0.01 * torch.randn(n_items, dim, generator=gen, device=dev)).requires_grad_(True)
    n = len(centers)
    for _ in range(epochs):
        order = torch.randperm(n, generator=gen, device=dev)
        for s in range(0, n - batch_size + 1, batch_size):
            idx = order[s:s + batch_size]
            neg = torch.randint(1, n_items, (batch_size, n_neg), generator=gen, device=dev)
            vc = w_in[centers_t[idx]]                                  # [B, D]
            pos = (vc * w_out[contexts_t[idx]]).sum(-1)
            neg_s = torch.einsum("bd,bkd->bk", vc, w_out[neg])
            loss = -(F.logsigmoid(pos).mean() + F.logsigmoid(-neg_s).sum(-1).mean())
            g_in, g_out = torch.autograd.grad(loss, (w_in, w_out))
            with torch.no_grad():
                w_in -= lr * g_in
                w_out -= lr * g_out
    table = w_in.detach().cpu().numpy().copy()
    table[0] = 0.0
    if out_path:
        _write_emb(out_path, table)
    return table


def _pairs(histories: Sequence[np.ndarray], window: int):
    """Every (center, context) pair of non-padding items at most ``window``
    positions apart in one history: the JAX package's loop's pairs, built
    an offset at a time over the padded histories (another order)."""
    lens = [len(h) for h in histories]
    mat = np.zeros((len(histories), max(lens, default=0)), np.int64)
    for r, h in enumerate(histories):
        mat[r, :len(h)] = h
    centers, contexts = [], []
    for d in range(1, min(window, mat.shape[1] - 1) + 1):
        a, b = mat[:, :-d].ravel(), mat[:, d:].ravel()
        ok = (a > 0) & (b > 0)
        centers += [a[ok], b[ok]]
        contexts += [b[ok], a[ok]]
    if not centers:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(centers), np.concatenate(contexts)


def _write_emb(path: str, table: np.ndarray):
    with open(path, "w") as f:
        for i in range(1, table.shape[0]):
            f.write(f"{i}\t" + ",".join(f"{x:.6f}" for x in table[i]) + "\n")
