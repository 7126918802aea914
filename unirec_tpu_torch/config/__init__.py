"""Layered configuration, with the defaults held as Python data.

Counterpart of unirec_tpu/config/__init__.py. The merge order is the same
(lowest to highest priority):

    BASE_DEFAULTS -> MODEL_DEFAULTS[<model>] -> dataset metadata
    -> optional --config_file -> command-line args -> caller-provided dict

The defaults are copies of the keys this package reads from
unirec_tpu/config/base.yaml and config/model/*.yaml (tests/test_torch_config.py
holds them equal), so the card path needs no YAML parser. Values keep the
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
    "use_position_emb": True,
    "embedding_size": 32,
    "inner_size": 128,
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
}


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
