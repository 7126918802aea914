"""Runs the closed-form models (counterpart of
unirec_tpu/facility/solver.py; reference facility/solver.py:10-39): solve
once on the training graph, validate, and save the solved model to
``<output_path>/<checkpoint_dir>/<exp_name>.solver.pkl``, a pickle of
{config, state} that the JAX package reads too. Under a process group
every rank solves the whole model (it is replicated), evaluation splits
its batches over the mesh's ``data`` ranks (solver.py:35) and rank 0
writes the file.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, Optional

import torch

from unirec_tpu_torch.constants import EvalProtocol
from unirec_tpu_torch.core.distributed import barrier, is_main_process
from unirec_tpu_torch.core.mesh import MeshContext, create_mesh
from unirec_tpu_torch.facility.evaluation import build_evaluator
from unirec_tpu_torch.utils import resolve_device
from unirec_tpu_torch.utils.checkpoint import load_checkpoint
from unirec_tpu_torch.utils.logger import setup_logger


class Solver:
    def __init__(self, config: Dict[str, Any], model, device=None,
                 mesh: Optional[MeshContext] = None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else create_mesh(config, device=self.device)
        self.model = model.to(self.device)
        self.exp_name = config.get("exp_name", "unirec_tpu")
        self.logger = setup_logger(self.exp_name, config.get("output_path"))
        self.user_history = None
        self.evaluator = None
        self._eval_protocol = None
        self.best_valid_result = None
        self.saved_model_file = os.path.join(
            config.get("output_path", "."), config.get("checkpoint_dir", "checkpoint"),
            f"{self.exp_name}.solver.pkl")

    def set_user_history(self, history):
        self.user_history = history

    def reset_evaluator(self, data_format=None, eval_protocol=None):
        self.evaluator = build_evaluator(self.config, self.model, eval_protocol,
                                         data_format, self.device, self.mesh)
        self._eval_protocol = eval_protocol

    def fit(self, graph, valid_data=None, save_model: bool = True, **kwargs):
        """Solve on ``graph`` (scipy CSR [n_users, n_items]), then validate
        and save; returns the validation metrics (None without a valid
        table)."""
        t0 = time.perf_counter()
        self.model.solve(graph)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.logger.info("solve() finished in %.2fs", time.perf_counter() - t0)
        result = None
        if valid_data is not None:
            result = self.evaluate(valid_data)
            self.best_valid_result = result
            self.logger.info("valid result: %s", result)
        if save_model:
            self.save_model(self.saved_model_file)
        return result

    def evaluate(self, eval_data, load_best_model: bool = False,
                 model_file: Optional[str] = None, predict_only: bool = False):
        """Metrics of ``eval_data`` under the evaluator's protocol (one
        versus all with the user histories), or with ``predict_only`` the
        real rows' raw scores (the infer task)."""
        if load_best_model:
            self.load_model(model_file or self.saved_model_file)
        if predict_only:
            return self.evaluator.predict_scores(eval_data)
        if self._eval_protocol == EvalProtocol.ONE_VS_ALL.value:
            if self.user_history is None:
                raise ValueError("user_history must be set for one_vs_all evaluation")
            return self.evaluator.evaluate_full(eval_data, self.user_history)
        return self.evaluator.evaluate(eval_data)

    def save_model(self, filename: str):
        if not is_main_process():
            barrier()
            return
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        cfg = {k: v for k, v in self.config.items() if not k.startswith("_")}
        tmp = f"{filename}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"config": cfg, "state": self.model.state_dict()}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, filename)
        self.logger.info("Saved solver model to %s", filename)
        barrier()

    def load_model(self, filename: str):
        self.model.load_state_dict(load_checkpoint(filename)["state"])
        self.logger.info("Loaded solver model from %s", filename)
