"""Command-line entry point of the port.

    python -m unirec_tpu_torch.cli train --model SASRec --dataset_path ... [flags]
    python -m unirec_tpu_torch.cli test --model_file ckpt.pkl --dataset_path ...
    python -m unirec_tpu_torch.cli infer --model_file ckpt.pkl --dataset_path ...
    python -m unirec_tpu_torch.cli reco-topk --model_file ckpt.pkl --dataset_path ... --topk 100
    python -m unirec_tpu_torch.cli infer-embedding --model_file ckpt.pkl --node_type user ...
    python -m unirec_tpu_torch.cli prepare-adaranker --infile raw.txt --item2cate_file cates.json \
        --out_dir data/ [--n_neg_k 19 --pretrain_item_emb 1 --embedding_size 64]
    python -m unirec_tpu_torch.cli prepare-data --raw_file log.tsv --out_dir data/ [--time_col ts]
    python -m unirec_tpu_torch.cli download-data --dataset ml-100k --out_dir splits/ [--cache dir]
    python -m unirec_tpu_torch.cli convert-splits --split_dir splits/ --out_dir data/
    python -m unirec_tpu_torch.cli convert-adjacency --split_dir gowalla/ --out_dir data/
    python -m unirec_tpu_torch.cli sweep --sweep_file sweep.yaml --n_trials 20 [train flags]
    python -m unirec_tpu_torch.cli export --model_file ckpt.pkl --out_dir art/ \
        [--batch_size 0 --n_candidates 32 --aoti user_emb,score --aoti_batch 256]

Counterpart of unirec_tpu/cli.py, every command of it. Every ``--key value`` flag flows into the config dict or the
command's keyword arguments; ``--device cpu`` runs on the CPU (the default
is the CUDA card). Checkpoints written by the JAX package load directly.
``download-data`` fetches the dataset into ``cache`` (default
``~/.unirec/dataset``) unless its archive is there already, and needs the
network only then.
"""
from __future__ import annotations

import sys

from unirec_tpu_torch import config as config_mod

COMMANDS = ("train", "test", "infer", "infer-embedding", "reco-topk", "prepare-data",
            "download-data", "convert-splits", "convert-adjacency", "prepare-adaranker",
            "sweep", "export")


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
    if cmd == "prepare-data":
        from unirec_tpu_torch.data.prepare import prepare_data
        print(prepare_data(args.pop("raw_file"), args.pop("out_dir"), **args))
        return 0
    if cmd == "download-data":
        return _download_data(args)
    if cmd == "convert-splits":
        from unirec_tpu_torch.data.prepare import convert_splits
        print(convert_splits(args.pop("split_dir"), args.pop("out_dir"), **args))
        return 0
    if cmd == "convert-adjacency":
        # the CF benchmark splits ("user item item ..." lines of yelp2018,
        # gowalla, amazon-book): run_prepare_data-CF_8_1_1.sh's role
        from unirec_tpu_torch.data.prepare import convert_adjacency
        print(convert_adjacency(args.pop("split_dir"), args.pop("out_dir"), **args))
        return 0
    if cmd == "sweep":
        from unirec_tpu_torch.facility.sweep import run_sweep
        best, _ = run_sweep(args.pop("sweep_file"), args, n_trials=int(args.pop("n_trials", 20)))
        print("best trial:", best)
        return 0
    if cmd == "export":
        # torch.export programs, and AOTInductor packages for the C++ client
        from unirec_tpu_torch.serving.export import export_model
        print(export_model(args.pop("model_file"), args.pop("out_dir"), **args))
        return 0
    if cmd == "infer-embedding":
        from unirec_tpu_torch.main import infer_embedding
        infer_embedding.run(args)
        return 0
    from unirec_tpu_torch.main import reco_topk
    reco_topk.do_topk_reco(args)
    return 0


def _download_data(kw) -> int:
    """The reference's download_split_*.py (unirec_tpu/cli.py:54-70):
    ml-100k, ml-10m or amazon-<category> into split files under
    ``out_dir``."""
    from unirec_tpu_torch.data import downloaders as DL
    name = kw.pop("dataset", "ml-100k")
    out = kw.pop("out_dir")
    if name == "ml-100k":
        info = DL.prepare_ml100k(out, **kw)
    elif name == "ml-10m":
        info = DL.prepare_ml10m(out, **kw)
    elif name.startswith("amazon-"):
        info = DL.prepare_amazon(name.split("-", 1)[1], out, **kw)
    else:
        raise SystemExit(f"unknown dataset '{name}' (ml-100k, ml-10m, amazon-<category>)")
    print(info)
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
