"""Tiny cells for the CPU tests: the harness's drivers run the port's plain
versions on CPU tensors at these sizes."""
import copy
import tempfile
import time

import torch

from harness import cell

TINY_CONFIG = {
    "model": "SASRec", "dataloader": "SeqRecDataset",
    "n_users": 64, "n_items": 97, "max_seq_len": 6,
    "embedding_size": 16, "hidden_size": 16, "inner_size": 32,
    "n_layers": 2, "n_heads": 2, "hidden_act": "swish", "layer_norm_eps": 1e-10,
    "hidden_dropout_prob": 0.1, "attn_dropout_prob": 0.1, "dropout_bits": 8,
    "loss_type": "bce", "n_sample_neg_train": 3, "neg_oversample_factor": 4,
    "history_mask_mode": "autoregressive", "group_size": -1,
    "learning_rate": 0.001, "optimizer": "adam", "init_std": 0.02,
    "compute_dtype": "float32", "last_query_only": 1, "fused_layer": 1, "fused_lastq": 1,
    "vmem_embedding_grad": 1, "neg_membership_pallas": 1, "use_fused_attention": 0,
    "use_fused_ffn": 0, "test_batch_size": 32,
}
FLOPS = {
    "train_example": "3 * ((n_layers - 1) * (2*L*(4*D*D + 2*D*F) + 4*L*L*D) + 2*L*2*D*D + 2*(2*D*D + 2*D*F) + 4*L*D + 2*D*(1 + n_neg))",
    "serve_user": "(n_layers - 1) * (2*L*(4*D*D + 2*D*F) + 4*L*L*D) + 2*L*2*D*D + 2*(2*D*D + 2*D*F) + 4*L*D + 2*n_items*D",
}
TRAIN = {"kind": "train", "batch": 24, "rows_batches": 4,
         "items": {"kind": "zipf", "s": 0.9}, "history_length": [2, 12],
         "history_capacity": 12, "options": {"neg_by_pop_alpha": 1.0},
         "warmup_steps": 1, "trace_steps": 2}
SERVE = {"kind": "serve", "users_per_request": 32, "topk": 5,
         "items": {"kind": "zipf", "s": 0.9}, "history_length": [2, 12],
         "history_capacity": 12, "options": {"test_batch_size": 32, "use_fused_topk": 1},
         "warmup_requests": 1, "trace_requests": 2, "sample_requests": 2}
LOOSE = {"train": {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap_median": 1e-2,
                   "batch_rows_off": 0},
         "serve": {"bad_ids": 0, "topk_gap": 1e-3}}


def context(traffic, config=None, seed=12345, seconds=0.2, trace=False, metrics=(),
            limits=None, hooks=None, tmpdir=None):
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg.update(config or {})
    files = {"cell": {"name": "tiny", "chips": 1}, "config": {"config": cfg, "flops": FLOPS, "reference": "sasrec"},
             "traffic": copy.deepcopy(traffic)}
    return cell.Context(name="tiny", files=files, seed=seed, seconds=seconds, trace=trace,
                        device=torch.device("cpu"),
                        tmpdir=tmpdir or tempfile.mkdtemp(prefix="portbench-test-"),
                        metrics=list(metrics), t_top=time.perf_counter(),
                        limits=limits or LOOSE[traffic["kind"]],
                        hooks=dict(hooks or {}))
