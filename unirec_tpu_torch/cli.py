"""Command-line entry point of the port.

    python -m unirec_tpu_torch.cli train --model SASRec --dataset_path ... [flags]
    python -m unirec_tpu_torch.cli test --model_file ckpt.pkl --dataset_path ...
    python -m unirec_tpu_torch.cli infer --model_file ckpt.pkl --dataset_path ...
    python -m unirec_tpu_torch.cli reco-topk --model_file ckpt.pkl --dataset_path ... --topk 100
    python -m unirec_tpu_torch.cli infer-embedding --model_file ckpt.pkl --node_type user ...
    python -m unirec_tpu_torch.cli prepare-adaranker --infile raw.txt --item2cate_file cates.json \
        --out_dir data/ [--n_neg_k 19 --pretrain_item_emb 1 --embedding_size 64]

Counterpart of unirec_tpu/cli.py for the ported commands. Every
``--key value`` flag flows into the config dict; ``--device cpu`` runs on
the CPU (the default is the CUDA card). Checkpoints written by the JAX
package load directly.
"""
from __future__ import annotations

import sys

from unirec_tpu_torch import config as config_mod

COMMANDS = ("train", "test", "infer", "infer-embedding", "reco-topk", "prepare-adaranker")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        raise SystemExit(f"unknown command '{cmd}'. Available: {COMMANDS}")
    args = config_mod.parse_cmd_arguments(rest)
    if cmd in ("train", "test", "infer"):
        from unirec_tpu_torch.main import main as main_mod
        result = main_mod.run(dict(args, task=cmd))
        if result is not None:
            print(result)
        return 0
    if cmd == "prepare-adaranker":
        return _prepare_adaranker(args)
    if cmd == "infer-embedding":
        from unirec_tpu_torch.main import infer_embedding
        infer_embedding.run(args)
        return 0
    from unirec_tpu_torch.main import reco_topk
    reco_topk.do_topk_reco(args)
    return 0


def _prepare_adaranker(kw) -> int:
    """The AdaRanker data build and item2vec pretrain (unirec_tpu/cli.py:
    71-88): 'user item item ...' lines and an item -> categories JSON into
    T4 splits under ``out_dir``; with ``pretrain_item_emb`` also
    ``item_emb_<embedding_size>.txt`` from the histories, on ``device``
    (the card unless given)."""
    import pandas as pd

    from unirec_tpu_torch.data.ranker_prep import build_adaranker_dataset, pretrain_item2vec
    out = kw.pop("out_dir")
    info = build_adaranker_dataset(kw.pop("infile"), kw.pop("item2cate_file"), out,
                                   n_neg_k=int(kw.pop("n_neg_k", 5)))
    if int(kw.pop("pretrain_item_emb", 0)):
        dim = int(kw.pop("embedding_size", 64))
        hist = pd.read_pickle(f"{out}/user_history.pkl")
        pretrain_item2vec(list(hist["item_seq"]), info["n_items"], dim=dim,
                          out_path=f"{out}/item_emb_{dim}.txt", device=kw.get("device"))
    print(info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
