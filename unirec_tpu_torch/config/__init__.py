"""Layered configuration, with the defaults held as Python data.

Counterpart of unirec_tpu/config/__init__.py. The merge order is the same
(lowest to highest priority):

    BASE_DEFAULTS -> MODEL_DEFAULTS[<model>] -> dataset metadata
    -> optional --config_file -> command-line args -> caller-provided dict

The defaults are copies of the keys this package reads from
unirec_tpu/config/base.yaml and config/model/*.yaml (tests/test_torch_config.py
holds them equal), so the card path needs no YAML parser; the models of
``PORT_ONLY_MODELS`` have no YAML there. Values keep the
YAML loader's types: ``layer_norm_eps`` is the string ``'1e-10'`` there, and
callers coerce with ``float()``/``int()`` at the point of use, exactly as
checkpoint configs require.

Dataset metadata comes from ``<dataset_path>/data.info`` (JSON) or a sidecar
``<dataset_path>/<dataset>.yaml``; YAML files are parsed only when one is
named, with PyYAML imported at that point.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
from typing import Any, Dict, Iterable, Optional

# keys of unirec_tpu/config/base.yaml that the ported slices read
BASE_DEFAULTS: Dict[str, Any] = {
    "seed": 2022,
    "init_method": "normal",
    "init_std": 0.02,
    "init_mean": 0.0,
    "time_seq": 0,
    "has_user_emb": False,
    "has_user_bias": False,
    "has_item_bias": False,
    "use_features": False,
    "use_text_emb": False,
    "text_emb_size": 768,
    "use_position_emb": True,
    "embedding_size": 32,
    "inner_size": 128,
    "dropout_prob": 0.0,
    "batch_size": 400,
    "loss_type": "bce",
    "distance_type": "dot",
    "test_batch_size": 100,
    "model": "MF",
    "max_seq_len": 10,
    "tau": 1.0,
    "mesh_model": 1,
    "compute_dtype": "float32",
    "reproducible": 0,
    "qkv_packed": 0,
    "attn_head_stacked": 0,
    "fused_layer": 0,
    "fused_lastq": 0,
    "use_fused_ffn": 0,
    "use_pallas": True,
    # training (facility/trainer.py, core/optim.py, data/device_pipeline.py)
    "epochs": 200,
    "learning_rate": 0.001,
    "optimizer": "adam",
    "weight_decay": 0.0,
    "grad_clip_value": -1,
    "scheduler": "reduce",
    "scheduler_factor": 0.1,
    "auto_resume": 0,
    "enable_morec": 0,
    # MoRec (facility/morec): objectives, controller, sampler, PI gains
    "morec_objectives": ["fairness", "alignment", "revenue"],
    "morec_objective_controller": "PID",   # PID, Static, Pareto (MGDA), PIX, ParetoMTL, EPO
    "morec_ngroup": [10, 10, -1],
    "morec_alpha": 0.1,
    "morec_lambda": 0.2,
    "morec_expect_loss": 0.2,
    "morec_beta_min": 0.6,
    "morec_beta_max": 1.3,
    "morec_K_p": 0.01,
    "morec_K_i": 0.001,
    "morec_objective_weights": "[0.3,0.3,0.4]",
    "mesh_data": -1,
    "dataloader": "BaseDataset",
    "history_mask_mode": "unorder",
    "seq_last": False,
    "group_size": -1,
    "ccl_w": 150,
    "ccl_m": 0.4,
    "score_clip_value": -1,
    "neg_by_pop_alpha": 0,
    "neg_oversample_factor": 4,
    "neg_membership_pallas": 0,
    "neg_membership_binary_search": 0,
    "dropout_bits": 32,
    "shard_embeddings": False,
    "vmem_embedding_grad": 1,
    "embedding_grad_f32": 0,
    "scan_embedding_grad": 0,
    "expand_embedding_grad": 0,
    # main.run, validation and evaluation (main/main.py, facility/)
    "state": "INFO",
    "verbose": 2,
    "load_pretrained_model": False,
    "early_stop": 5,
    "shuffle_train": False,
    "metrics": "['group_auc', 'hit@1;3;5', 'ndcg@1;3;5', 'ndcg', 'mrr', 'mrr@1;3;5']",
    "key_metric": "group_auc",
    "test_protocol": "one_vs_k",
    "valid_protocol": "one_vs_k",
    "pad_incomplete_batch": True,
    "user_history_capacity": -1,
    "use_pre_item_emb": 0,
    "checkpoint_backend": "pickle",
    # observability (facility/trainer.py)
    "use_tensorboard": False,
    "use_wandb": False,
}

# config/model/<Model>.yaml of every model this package registers
MODEL_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "SASRec": {
        "n_layers": 2,
        "n_heads": 16,
        "inner_size": 512,
        "hidden_dropout_prob": 0.5,
        "attn_dropout_prob": 0.5,
        "hidden_act": "swish",
        "layer_norm_eps": "1e-10",
    },
    "GRU": {"embedding_size": 64, "max_seq_len": 10, "hidden_size": 768},
    "AvgHist": {"embedding_size": 64, "asymmetric": True, "user_sequence_alpha": 0.5,
                "max_seq_len": 10},
    "AttHist": {"embedding_size": 64, "max_seq_len": 10},
    "SVDPlusPlus": {"embedding_size": 64, "user_sequence_alpha": 0.5, "max_seq_len": 10,
                    "has_user_emb": True},
    "ConvFormer": {
        "n_layers": 2,
        "conv_size": 10,
        "inner_size": 256,
        "hidden_dropout_prob": 0.5,
        "padding_mode": "circular",
        "hidden_act": "gelu",
        "layer_norm_eps": "1e-9",
        "seq_decay": -0.3,
        "seq_merge": False,
        "init_ratio": 0.005,
    },
    "FASTConvFormer": {
        "n_layers": 2,
        "conv_size": 10,
        "inner_size": 256,
        "hidden_dropout_prob": 0.5,
        "padding_mode": "constant",
        "hidden_act": "gelu",
        "layer_norm_eps": "1e-9",
        "seq_decay": -0.3,
        "seq_merge": False,
        "init_ratio": 0.005,
    },
    # HSTU-large (generative-recommenders' ml-1m
    # hstu-sampled-softmax-n128-large-final.gin); the port's own model, with
    # no YAML in the JAX package (PORT_ONLY_MODELS)
    "HSTU": {
        "n_layers": 8,
        "n_heads": 2,
        "embedding_size": 50,
        "hidden_size": 50,
        "max_seq_len": 200,
        "hidden_dropout_prob": 0.2,
        "layer_norm_eps": 1e-6,
        "distance_type": "cosine",
        "tau": 0.05,
    },
    "MF": {"embedding_size": 64, "has_user_emb": True},
    "MultiVAE": {
        "embedding_size": 400,
        "encoder_dims": [200],
        "decoder_dims": [200],
        "anneal_cap": 0.2,
        "total_anneal_steps": 2000000,
        "has_user_emb": False,
        "eval_reparameter_sampling_times": 5,
    },
    "EASE": {"l2_coef": 200, "has_user_bias": 0, "has_item_bias": 0},
    "SLIM": {"l1_coef": 0.004, "l2_coef": 0.098, "epochs": 100},
    "AdmmSLIM": {"l1_coef": 3.0, "l2_coef": 400.0, "item_spec_reg": 0.5,
                 "admm_penalty": 4000.0, "epochs": 100},
    "SAR": {"edge_norm": "sqrt_degree"},
    "UserCF": {"edge_norm": "sqrt_degree"},
    "FM": {"linear_mode": "gather"},
    "BST": {
        "n_layers": 2,
        "n_heads": 16,
        "inner_size": 512,
        "hidden_dropout_prob": 0.5,
        "attn_dropout_prob": 0.5,
        "hidden_act": "swish",
        "layer_norm_eps": "1e-10",
        "seq_decay": -0.3,
    },
    "AdaRanker": {
        "train_type": "Ada-Ranker",
        "base_model": "GRU",
        "n_layers": 2,
        "n_heads": 2,
        "inner_size": 256,
        "hidden_dropout_prob": 0.5,
        "attn_dropout_prob": 0.5,
        "hidden_act": "gelu",
        "layer_norm_eps": "1e-12",
        "ada_reference_init": 0,
    },
}


# models of the port that the JAX package does not have (no config/model YAML)
PORT_ONLY_MODELS = ("HSTU",)


def _load_yaml(path: str) -> Dict[str, Any]:
    import yaml  # only when a YAML file is named

    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def _coerce(value: str) -> Any:
    """Best-effort typed parse of a CLI string value."""
    if not isinstance(value, str):
        return value
    low = value.strip()
    if low.lower() in ("true", "false"):
        return low.lower() == "true"
    try:
        return ast.literal_eval(low)
    except (ValueError, SyntaxError):
        return value


def parse_cmd_arguments(argv: Optional[Iterable[str]] = None) -> Dict[str, Any]:
    """Parse ``--key value`` / ``--key=value`` args into a typed dict
    (unknown keys allowed; a bare ``--flag`` becomes True)."""
    parser = argparse.ArgumentParser(add_help=False)
    _, unknown = parser.parse_known_args(list(argv) if argv is not None else None)
    res: Dict[str, Any] = {}
    key = None
    for tok in unknown:
        if tok.startswith("--"):
            if "=" in tok:
                k, v = tok[2:].split("=", 1)
                res[k] = _coerce(v)
                key = None
            else:
                key = tok[2:]
                res[key] = True
        elif key is not None:
            res[key] = _coerce(tok)
            key = None
    return res


def load_dataset_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Dataset metadata from ``<dataset_path>/<dataset>.yaml`` and
    ``<dataset_path>/data.info`` (later wins)."""
    name = config.get("dataset")
    dpath = config.get("dataset_path")
    res: Dict[str, Any] = {}
    if not dpath:
        return res
    if name and os.path.exists(os.path.join(dpath, f"{name}.yaml")):
        res.update(_load_yaml(os.path.join(dpath, f"{name}.yaml")))
    info = os.path.join(dpath, "data.info")
    if os.path.exists(info):
        with open(info) as f:
            res.update(json.load(f))
    return res


def parse_arguments(args: Optional[Dict[str, Any]] = None,
                    argv: Optional[Iterable[str]] = None,
                    device: str = "cuda") -> Dict[str, Any]:
    """The final merged config dict. ``args`` is the caller's dict (highest
    priority), ``argv`` CLI tokens (next). On ``device='cuda'`` the compute
    dtype defaults to bfloat16 unless any layer above the base defaults sets
    it, the counterpart of the JAX package's TPU default."""
    args = dict(args or {})
    cmd = parse_cmd_arguments(argv if argv is not None else [])

    config = dict(BASE_DEFAULTS)
    explicit: set = set()
    model_name = args.get("model") or cmd.get("model") or config["model"]
    layer = MODEL_DEFAULTS.get(model_name, {})
    config.update(layer)
    explicit.update(layer)
    config["model"] = model_name

    probe = dict(config)
    probe.update(cmd)
    probe.update(args)
    layer = load_dataset_config(probe)
    config.update(layer)
    explicit.update(layer)

    cfg_file = args.get("config_file") or cmd.get("config_file")
    if cfg_file:
        layer = _load_yaml(cfg_file)
        config.update(layer)
        explicit.update(layer)

    config.update(cmd)
    config.update(args)
    explicit.update(cmd)
    explicit.update(args)
    if config.get("reproducible"):
        config["compute_dtype"] = "float32"
    elif str(device).startswith("cuda") and "compute_dtype" not in explicit:
        config["compute_dtype"] = "bfloat16"
    config["cmd_args"] = cmd
    return config
