"""The system under test, unirec_tpu_torch, as a run builds it: its merged
configuration, its model with the benchmark's weights, its Trainer with
the device pipeline, and its kernels built into the checkout's ``build/``.

The weights are the benchmark's, not the program's: ``make_weights`` draws
them from the seed on the device (one normal draw for every matrix and
table at the configuration's ``init_std``, LayerNorm scales 1, biases 0,
the padding row of the id tables 0), and the same tensors go to the model
and to the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

PADDED_TABLES = ("item_embedding.weight", "user_embedding.weight")


def port_config(config_file: Dict[str, Any], traffic: Dict[str, Any], seed: int,
                out_dir: str, device: str) -> Dict[str, Any]:
    """The program's merged configuration: the file's ``config``, the
    traffic's ``options`` over it, the run's seed and output folder."""
    from unirec_tpu_torch import config as config_mod
    args = dict(config_file["config"])
    args.update(traffic.get("options", {}))
    args.update(seed=int(seed), output_path=out_dir, exp_name="portbench", epochs=1)
    return config_mod.parse_arguments(args, argv=[], device=device)


def make_weights(shapes: List[Tuple[str, Tuple[int, ...]]], init_std: float, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on ``device`` for the named shapes."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed) ^ 0x5EED)
    normal = [(n, s) for n, s in shapes if n.endswith(".weight") and "LayerNorm" not in n]
    total = sum(int(np.prod(s)) for _, s in normal)
    flat = torch.randn(total, generator=gen, device=device) * float(init_std)
    out, at = {}, 0
    for n, s in normal:
        k = int(np.prod(s))
        out[n] = flat[at:at + k].view(s).clone()
        at += k
    for n, s in shapes:
        if n not in out:
            out[n] = (torch.ones if n.endswith(".weight") else torch.zeros)(
                s, device=device)
        if n in PADDED_TABLES:
            out[n][0].zero_()
    return out


def build_model(cfg: Dict[str, Any], seed: int, device):
    """(model on ``device`` holding the benchmark's weights, the weights)."""
    from unirec_tpu_torch.utils.registry import get_model_class
    model = get_model_class(cfg["model"])(cfg).to(device)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    weights = make_weights(shapes, float(cfg.get("init_std", 0.02)), seed, device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    return model, weights


def build_trainer(cfg: Dict[str, Any], model, device, hist_items: np.ndarray,
                  hist_lens: np.ndarray, popularity: np.ndarray):
    """The port's Trainer over ``model`` with its device pipeline and a
    fresh optimizer state (the model keeps the benchmark's weights)."""
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter
    from unirec_tpu_torch.data.history import UserHistory
    from unirec_tpu_torch.facility.trainer import Trainer
    trainer = Trainer(cfg, model, device=device)
    pop = popularity if float(cfg.get("neg_by_pop_alpha", 0) or 0) > 0 else None
    trainer.set_device_augmenter(DeviceAugmenter(cfg, UserHistory(hist_items, hist_lens),
                                                 item_popularity=pop, device=device))
    trainer.params = list(trainer.model.parameters())
    trainer.opt_state = trainer.tx.init(trainer.params)
    return trainer


def build_kernels() -> Dict[str, float]:
    """Every CUDA source of the port compiled (one nvcc each, at once) into
    the checkout's build/ folder, which later runs find; nvcc seconds."""
    from unirec_tpu_torch.ops import _build
    return {k: v["seconds"] for k, v in _build.build().items()}


def launch_counters() -> Dict[str, int]:
    """The ops wrappers' launch counters (which body each kernel ran)."""
    from unirec_tpu_torch.ops import attention as AT, ffn as FF, layer as LY, \
        member as MB, scatter_accum as SA, topk as TK
    fns = {"layer_fwd": LY.fused_transformer_layer, "layer_bwd": LY.layer_bwd,
           "lastq_fwd": LY.fused_last_query_layer, "lastq_bwd": LY.lastq_bwd,
           "fused_attention": AT.fused_attention, "fused_attention_bwd": AT.fused_attention_bwd,
           "flash_attention": AT.flash_attention, "fused_ffn": FF.fused_ffn,
           "fused_ffn_bwd": FF.fused_ffn_bwd, "scatter_add": SA.scatter_add_rows,
           "member": MB.member_mask, "blockmax": TK.catalog_blockmax}
    out = {}
    for name, fn in fns.items():
        for attr in sorted(vars(fn)):
            if attr.startswith("launches"):
                out[name + attr[len("launches"):]] = int(getattr(fn, attr))
    return out


def reset_launch_counters() -> None:
    from unirec_tpu_torch.ops import attention as AT, ffn as FF, layer as LY, \
        member as MB, scatter_accum as SA, topk as TK
    for fn in (LY.fused_transformer_layer, LY.layer_bwd, LY.fused_last_query_layer,
               LY.lastq_bwd, AT.fused_attention, AT.fused_attention_bwd, AT.flash_attention,
               FF.fused_ffn, FF.fused_ffn_bwd, SA.scatter_add_rows, MB.member_mask,
               TK.catalog_blockmax):
        for attr in list(vars(fn)):
            if attr.startswith("launches"):
                setattr(fn, attr, 0)
