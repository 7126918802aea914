"""Config-driven train/test/infer entry point (counterpart of
unirec_tpu/main/main.py::run).

``run(args)`` merges the config layers, loads the user histories and the
train/valid/test tables, builds the model by registry name and the
Trainer, and runs the task:

  - train: ``Trainer.fit`` on the device pipeline (raw id columns, negative
    sampling and history windows on the device; AERec rows from the
    training split's own histories; T7 libFM rows on shuffled host
    batches), validating before every epoch when a valid table exists;
    then the test table from the best checkpoint. With
    ``load_pretrained_model`` the run starts from ``model_file``'s
    parameters, merged by path and shape (AdaRanker fine-tuned from a Base
    checkpoint). The checkpoint goes to
    ``<output_path>/checkpoint/<exp_name>.pkl``.
  The closed-form models (EASE, AdmmSLIM, SLIM, SAR, UserCF:
    ``optimized_by_sgd`` False) go to ``facility/solver.py::Solver``
    instead (main.py:183-185): solved once on the training split's graph
    (``AERecDataset.get_graph``), validated, saved as
    ``<output_path>/checkpoint/<exp_name>.solver.pkl`` and tested.
  - test: the test table from ``model_file``.
  - infer: the model's scores of the test table's real rows from
    ``model_file`` (one_vs_k unless a test protocol is set), one row per
    line in ``<exp_name>.infer.txt``; returns None.

Train and test write ``<exp_name>.result.tsv`` beside a log in
``<output_path>`` and return the test metrics. With ``use_pre_item_emb``
and ``item_emb_path`` the item table starts from the file's rows. The item
side inputs load here as in the JAX package (main.py:54, 65-74, 176-179):
``use_features`` reads ``features_filepath`` (one row of
len(features_shape) categorical ids an item) for the model's constant and
every batcher, ``use_text_emb`` the frozen rows of ``text_emb_path``
(padding row 0 prepended), and ``time_seq`` > 0 loads the histories with
their time rows. With
``profile=1`` a ``torch.profiler`` trace (CPU and, on the card, CUDA
activities) runs from the parsed config to every return of ``run`` and is
written as ``<output_path>/profile/<exp_name>.pt.trace.json``, torch's
Chrome-trace format where the JAX package writes an xplane; it stops when
``run`` raises too. It runs on the CUDA card unless the caller passes
``device='cpu'`` (or another device), and never falls back to the CPU.

Distribution (main.py:104-131): ``initialize_distributed`` joins the
process group first (the config's ``coordinator_address``,
``num_processes``, ``process_id``, or torchrun's environment; a group the
caller brought up is used as it is), then the logger starts, and the
('data', 'model') mesh of ``mesh_data`` x ``mesh_model`` is built once,
logged and handed to the Trainer or the Solver. Each rank runs on
``cuda:LOCAL_RANK`` unless the caller names the CPU. Every rank returns the
same metrics; rank 0 alone writes the result, infer and log files.
``checkpoint_backend=orbax`` writes the ``.dcp`` directory of
utils/checkpoint.py. So ``torchrun --nproc_per_node N -m
unirec_tpu_torch.cli train --mesh_data N ...`` trains data-parallel.

MoRec (main.py:146-167, 207-216): with ``enable_morec`` or a MoRec metric
(rhit, rndcg, rrecall, pop-kl, least-misery) the item meta
(``item_meta_morec_filename``) and the alignment distribution load into the
config for the sampler and the evaluators; ``enable_morec`` trains on the
MoRec sampler's host batches (facility/morec's ``build_morec``), its
signals swept over the validation split read as training rows.
"""
from __future__ import annotations

import copy
import os
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np
import torch

from unirec_tpu_torch import config as config_mod
from unirec_tpu_torch.constants import EvalProtocol, TaskType
from unirec_tpu_torch.core.distributed import (initialize_distributed, is_main_process,
                                               rank_device)
from unirec_tpu_torch.core.mesh import create_mesh
from unirec_tpu_torch.data import construct_item_popularity
from unirec_tpu_torch.data.datasets import get_dataset_class
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.data.pipeline import (make_eval_batcher, make_host_train_batcher,
                                            make_negative_sampler, make_train_batcher)
from unirec_tpu_torch.facility.solver import Solver
from unirec_tpu_torch.facility.trainer import Trainer
from unirec_tpu_torch.models.base import features_shape
from unirec_tpu_torch.utils import file_io
from unirec_tpu_torch.utils.logger import setup_logger
from unirec_tpu_torch.utils.registry import get_model_class

_TABLE_EXTS = (".ftr", ".pkl", ".tsv", ".csv", ".txt")


def need_user_history(config) -> bool:
    """(reference main.py:206-216; the JAX package's main.py:141-143 adds
    the AERec loader, whose evaluation windows read the histories)"""
    return (int(config.get("n_sample_neg_train", 0) or 0) > 0
            or EvalProtocol.ONE_VS_ALL.value in (config.get("test_protocol"),
                                                 config.get("valid_protocol"))
            or config.get("dataloader") in ("SeqRecDataset", "AERecDataset")
            or _morec_on(config))


_MOREC_METRICS = ("pop-kl", "least-misery", "rhit", "rndcg", "rrecall")


def _morec_on(config) -> bool:
    return int(config.get("enable_morec", 0) or 0) > 0


def load_user_history(config) -> UserHistory:
    return UserHistory.load(
        os.path.join(config["dataset_path"], config.get("user_history_filename", "train")),
        int(config["n_users"]),
        config.get("user_history_file_format", config.get("train_file_format")),
        capacity=int(config.get("user_history_capacity", -1) or -1),
        with_time=bool(config.get("time_seq", 0)))


def load_item_features(config) -> Optional[np.ndarray]:
    """The item -> categorical-feature table of ``features_filepath``
    under ``use_features``, else None."""
    if not config.get("use_features"):
        return None
    return file_io.load_features(config["features_filepath"], int(config["n_items"]),
                                 len(features_shape(config)))


def _task_config(config, task: str) -> Dict[str, Any]:
    c = copy.deepcopy(config)
    c["data_loader_task"] = task
    c["data_format"] = config[f"{task}_file_format"]
    c["eval_protocol"] = config.get(f"{task}_protocol")
    if c["eval_protocol"] == EvalProtocol.ONE_VS_ALL.value:
        c[f"n_sample_neg_{task}"] = -1
    return c


def _exists_any(path, prefix) -> bool:
    return any(os.path.exists(os.path.join(path, prefix + ext)) for ext in _TABLE_EXTS)


def _refuse_unported(config, task: str):
    if task not in (TaskType.TRAIN.value, TaskType.TEST.value, TaskType.INFER.value):
        raise ValueError(f"unknown task: {task}")


def _load_morec_meta(config, item_pop) -> None:
    """The MoRec item meta and alignment distribution into the config
    (``_item_meta_morec``, ``_alignment_dist``), when the meta file exists."""
    from unirec_tpu_torch.facility.morec import (load_alignment_distribution,
                                                 load_morec_meta_data)
    meta_file = os.path.join(config["dataset_path"],
                             config.get("item_meta_morec_filename", "item_meta_morec.csv"))
    if not os.path.exists(meta_file):
        return
    objectives = list(config.get("morec_objectives", ["fairness", "alignment", "revenue"]))
    item_meta = load_morec_meta_data(int(config["n_items"]), meta_file, objectives)
    align_file = config.get("align_dist_filename")
    config["_item_meta_morec"] = item_meta
    config["_alignment_dist"] = load_alignment_distribution(
        item_meta, item_pop,
        os.path.join(config["dataset_path"], align_file) if align_file else None)


def _padded_emb(emb: np.ndarray) -> np.ndarray:
    """Prepend the zero row for padding item 0 (reco_abc.py:193-195)."""
    return np.concatenate([np.zeros((1, emb.shape[1]), emb.dtype), emb], axis=0)


@contextmanager
def _run_trace(config, dev, logger):
    """profile=1: trace the enclosed work with torch.profiler and write its
    Chrome trace under <output_path>/profile (the JAX package's
    jax.profiler trace, main.py:124-128, :300-315); the profiler stops on
    every exit, and the trace is written when the work returned."""
    if not int(config.get("profile", 0) or 0):
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    trace_dir = os.path.join(config["output_path"], "profile")
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    logger.info("torch profiler tracing to %s", trace_dir)
    try:
        yield
    finally:
        prof.stop()
    prof.export_chrome_trace(os.path.join(trace_dir, f"{config['exp_name']}.pt.trace.json"))


def run(args: Dict[str, Any], device: Optional[str] = None) -> Optional[Dict[str, float]]:
    """Run ``args['task']`` (train, test or infer); returns the test
    metrics (None for infer)."""
    args = dict(args)
    device = device or args.pop("device", None)
    config = config_mod.parse_arguments(args, argv=[],
                                        device=torch.device(device or "cuda").type)
    # the rendezvous precedes the logger (rank 0 alone writes its file)
    initialize_distributed(config, device)
    dev = rank_device(device)
    task = config.get("task", TaskType.TRAIN.value)
    # test/infer from a checkpoint: its config defines the model, and the
    # caller's args go on top (reference main.py:304-306, 332-334)
    if config.get("model_file") and (task in (TaskType.TEST.value, TaskType.INFER.value)
                                     or config.get("load_pretrained_model")):
        from unirec_tpu_torch.utils.checkpoint import load_checkpoint
        ckpt_cfg = load_checkpoint(config["model_file"]).get("config")
        if ckpt_cfg:
            config = {**ckpt_cfg, **args, "task": task}
    _refuse_unported(config, task)
    exp_name = config.get("exp_name") or f"{config['model']}-{config.get('dataset', 'data')}"
    config["exp_name"] = exp_name
    out_path = config.get("output_path") or os.path.join(".", "output", exp_name)
    config["output_path"] = out_path
    os.makedirs(out_path, exist_ok=True)
    logger = setup_logger(exp_name, out_path, config.get("state", "INFO"))
    logger.info("task=%s model=%s dataset=%s device=%s", task, config["model"],
                config.get("dataset"), dev)
    mesh = create_mesh(config, device=dev)
    logger.info("mesh: data=%d model=%d (%s)", mesh.n_data, mesh.n_model,
                "distributed" if mesh.distributed else "one process")
    np.random.seed(int(config.get("seed", 2022)))
    with _run_trace(config, dev, logger):
        return _run_task(config, task, dev, logger, mesh)


def _run_task(config, task: str, dev, logger, mesh) -> Optional[Dict[str, float]]:
    exp_name, out_path = config["exp_name"], config["output_path"]
    ds_cls = get_dataset_class(config.get("dataloader", "BaseDataset"))
    dpath = config["dataset_path"]
    history = load_user_history(config) if need_user_history(config) else None
    item_pop = None
    if (float(config.get("neg_by_pop_alpha", 0) or 0) > 0
            or "pop-kl" in str(config.get("metrics", "")) or _morec_on(config)) \
            and history is not None:
        item_pop = construct_item_popularity(history, int(config["n_items"]))
    if _morec_on(config) or any(t in str(config.get("metrics", "")) for t in _MOREC_METRICS):
        _load_morec_meta(config, item_pop)
    features = load_item_features(config)
    if features is not None:
        config["_item2features"] = features
    if config.get("use_text_emb") and config.get("text_emb_path"):
        config["_text_emb"] = _padded_emb(file_io.load_pre_item_emb(config["text_emb_path"]))
    if config.get("use_pre_item_emb") and config.get("item_emb_path"):
        config["_pre_item_emb"] = _padded_emb(file_io.load_pre_item_emb(config["item_emb_path"]))
    model = get_model_class(config["model"])(config)
    sgd = getattr(model, "optimized_by_sgd", True)
    runner = (Trainer if sgd else Solver)(config, model, device=dev, mesh=mesh)
    if history is not None:
        runner.set_user_history(history)

    def eval_batcher(task_name: str, default_protocol: Optional[str] = None):
        tcfg = _task_config(config, task_name)
        ds = ds_cls(tcfg, dpath, config.get(f"data_{task_name}_name", task_name))
        runner.reset_evaluator(tcfg["data_format"], tcfg["eval_protocol"] or default_protocol)
        return make_eval_batcher(ds, tcfg, history, task=task_name,
                                 item_popularity=item_pop, features=features)

    result = None
    if task == TaskType.TRAIN.value:
        tcfg = _task_config(config, "train")
        train_ds = ds_cls(tcfg, dpath, config.get("data_train_name", "train"))
        if sgd and _morec_on(config):
            from unirec_tpu_torch.facility.morec import build_morec
            # the signal sweeps read the valid split as training rows
            # (reference main.py:168-177)
            sig_ds = ds_cls(tcfg, dpath, config.get("data_valid_name", "valid"))
            signal = make_host_train_batcher(sig_ds, tcfg, history, item_pop, features)
            train_data = build_morec(runner, tcfg, train_ds, signal, history, item_pop,
                                     features, item_sampler=make_negative_sampler(
                                         tcfg, history, item_pop))
        elif sgd:
            train_data, augmenter = make_train_batcher(train_ds, tcfg, history, item_pop,
                                                       device=dev, features=features)
            runner.set_device_augmenter(augmenter)
        if sgd:
            fit_kw = dict(load_pretrained_model=bool(config.get("load_pretrained_model")),
                          model_file=config.get("model_file"),
                          verbose=int(config.get("verbose", 1)))
        else:
            train_data, fit_kw = train_ds.get_graph(), {}
        valid = eval_batcher("valid") if _exists_any(
            dpath, config.get("data_valid_name", "valid")) else None
        try:
            runner.fit(train_data, valid, **fit_kw)
        except KeyboardInterrupt:
            # reference main.py:376-377: Ctrl-C still evaluates the test set
            logger.info("Keyboard interrupt: stopping the training and start "
                        "evaluating on the test set.")
        if _exists_any(dpath, config.get("data_test_name", "test")):
            result = runner.evaluate(eval_batcher("test"),
                                     load_best_model=sgd and valid is not None)
    else:
        if config.get("model_file"):
            runner.load_model(config["model_file"])
        if task == TaskType.TEST.value:
            result = runner.evaluate(eval_batcher("test"), load_best_model=False)
        else:
            # reference main.py:293-309: raw scores of the test table
            scores = runner.evaluate(eval_batcher("test", EvalProtocol.ONE_VS_K.value),
                                     load_best_model=False, predict_only=True)
            out_file = os.path.join(out_path, f"{exp_name}.infer.txt")
            if is_main_process():     # one writer on a shared filesystem
                np.savetxt(out_file, scores.reshape(len(scores), -1), fmt="%.6f")
                logger.info("wrote inference scores to %s", out_file)
            return None
    logger.info("test result: %s", result)
    if result is not None and is_main_process():
        with open(os.path.join(out_path, f"{exp_name}.result.tsv"), "w") as f:
            f.write("\t".join(result.keys()) + "\n")
            f.write("\t".join(f"{v:.6f}" for v in result.values()) + "\n")
    return result

