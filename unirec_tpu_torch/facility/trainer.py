"""The training loop (counterpart of unirec_tpu/facility/trainer.py).

One train step: the per-step randomness as a function of (seed,
global_step), the JAX package's ``fold_in``; device-side augmentation
(data/device_pipeline.py); forward and backward through the model, whose
fused layers and embedding gathers run the port's CUDA kernels on the
card; the optimizer update (core/optim.py) under the NaN guard, a
``torch.where`` on ``isfinite(loss)`` that keeps the step on the device.
``fit`` runs the epoch loop with the losses kept on the device and fetched
once per epoch, and the ``auto_resume`` rolling ``.last`` checkpoint.
Checkpoints use the JAX package's pickle layout with ``params`` as a flax
tree, so the port's ``reco-topk`` and the JAX package read them.

Not ported yet, and raising NotImplementedError naming their ROADMAP.md
item: validation during ``fit`` (Queue 1 item 5, evaluation), MoRec
(item 11) and a mesh of more than one device (item 12).
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from unirec_tpu_torch.core.optim import (build_optimizer, build_scheduler,
                                         get_learning_rate)
from unirec_tpu_torch.models.modules import DropoutRNG
from unirec_tpu_torch.utils import checkpoint as ckpt_util
from unirec_tpu_torch.utils import resolve_device, to_device
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params
from unirec_tpu_torch.utils.logger import setup_logger


def step_seeds(seed: int, step: int):
    """(augmentation seed, dropout seed) of one global step: a pure
    function of (seed, step), as the JAX trainer's fold_in(base_rng, step)."""
    a, b = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return int(a), int(b)


class Trainer:
    def __init__(self, config: Dict[str, Any], model, device=None):
        if int(config.get("enable_morec", 0) or 0):
            raise NotImplementedError("MoRec training is not ported yet "
                                      "(ROADMAP.md Queue 1 item 11)")
        if int(config.get("mesh_data", -1)) > 1 or int(config.get("mesh_model", 1)) > 1:
            raise NotImplementedError("a mesh of more than one device is not "
                                      "ported yet (ROADMAP.md Queue 1 item 12)")
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.exp_name = config.get("exp_name", "unirec_tpu")
        self.logger = setup_logger(self.exp_name, config.get("output_path"))
        self.epochs = int(config.get("epochs", 0))
        self.saved_model_file = os.path.join(
            config.get("output_path", "."), config.get("checkpoint_dir", "checkpoint"),
            f"{self.exp_name}.pkl")
        self.tx = build_optimizer(config)
        self.scheduler = build_scheduler(config)
        self.seed = int(config.get("seed", 2022))
        self._augmenter = None
        self.params = None
        self.opt_state = None
        self.cur_epoch = 0
        self.cur_step = 1
        self.best_valid_score = None
        self.best_valid_result = None
        self._global_step = 0

    # ------------------------------------------------------------------ setup
    def set_device_augmenter(self, augmenter):
        """Fuse negative sampling and history windowing into the train step;
        the batcher then yields raw id pairs."""
        self._augmenter = augmenter

    def init_params(self, sample_batch=None):
        """Random weights from the config's seed and a fresh optimizer
        state (the sample batch is not needed: torch modules own shapes)."""
        if self.params is not None:
            return
        # drawn on the CPU from a CPU generator: the same weights on any device
        self.model.to("cpu").init_weights(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        self.params = list(self.model.parameters())
        self.opt_state = self.tx.init(self.params)
        n = sum(p.numel() for p in self.params)
        self.logger.info(f"Model initialized: {n} trainable parameters")

    # ------------------------------------------------------------- the step
    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a device batch (raw ids when an augmenter
        is set); returns the loss as a 0-d device tensor, no host sync."""
        aug_seed, drop_seed = step_seeds(self.seed, self._global_step)
        if self._augmenter is not None:
            gen = torch.Generator(device=self.device).manual_seed(aug_seed)
            batch = self._augmenter.augment(batch, gen)
        loss, _ = self.model(batch, train=True, rng=DropoutRNG(drop_seed, self.device))
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        with torch.no_grad():
            # NaN guard (trainer.py:229-237): keep params and state when the
            # loss is not finite
            finite = torch.isfinite(loss)
            updates, new_state = self.tx.update(grads, self.opt_state, self.params)
            for p, u in zip(self.params, updates):
                p.copy_(torch.where(finite, p + u, p))
            self.opt_state = {k: _where(finite, v, self.opt_state[k])
                              for k, v in new_state.items()}
        self._global_step += 1
        return loss.detach()

    # ------------------------------------------------------------------- fit
    def fit(self, train_data, valid_data=None, save_model: bool = True,
            load_pretrained_model: bool = False, model_file: Optional[str] = None,
            verbose: int = 1):
        if valid_data is not None:
            raise NotImplementedError("validation during fit is not ported yet "
                                      "(ROADMAP.md Queue 1 item 5, evaluation)")
        # the JAX trainer peeks one batch to initialize; the peek consumes one
        # shuffle epoch of the batcher, so the port does the same and both
        # see the same data order
        next(iter(train_data))
        self.init_params()
        if load_pretrained_model:
            if model_file is None:
                raise ValueError("`model_file` required with load_pretrained_model")
            self.load_model(model_file)
        auto_resume = bool(int(self.config.get("auto_resume", 0) or 0))
        last_file = self.saved_model_file + ".last" if auto_resume else None
        if auto_resume and os.path.exists(last_file):
            self.resume(last_file)
            if hasattr(train_data, "set_epoch"):
                train_data.set_epoch(self.cur_epoch + 1)
        for epoch_idx in range(self.cur_epoch, self.epochs):
            t0 = time.time()
            losses = [self.train_step(to_device(b, self.device)) for b in train_data]
            # losses stay on the device until the epoch ends: one fetch
            total_loss = float(torch.stack(losses).double().sum()) if losses else 0.0
            self.logger.info("epoch %d training [time: %.2fs, train loss: %.4f]",
                             epoch_idx + 1, time.time() - t0, total_loss)
            if auto_resume:
                self.cur_epoch = epoch_idx + 1
                self.save_model(last_file, epoch_idx + 1, quiet=True)
        self.cur_epoch = self.epochs
        return self.best_valid_result

    # ------------------------------------------------------------ checkpoint
    def save_model(self, filename: str, cur_epoch: int = -1,
                   valid_result: Optional[dict] = None, quiet: bool = False):
        ckpt_util.save_checkpoint(filename, {
            "config": self.config,
            "cur_epoch": cur_epoch,
            "cur_step": self.cur_step,
            "best_valid_score": valid_result,
            "best_score": self.best_valid_score,
            "best_valid_result": self.best_valid_result,
            "global_step": self._global_step,
            "scheduler_state": (self.scheduler.state_dict()
                                if self.scheduler is not None else None),
            "params": to_flax_params(self.model),
            "constants": None,
            "opt_state": ckpt_util.opt_state_to_numpy(self.model, self.opt_state),
        })
        if not quiet:
            self.logger.info("Saved model at epoch %d to %s", cur_epoch, filename)

    def resume(self, filename: str):
        """Restore the full training state: params, optimizer state, epoch
        and patience counters, best score and the step counter the per-step
        randomness is a function of."""
        ckpt = self.load_model(filename, restore_optimizer=True)
        self.cur_epoch = int(ckpt.get("cur_epoch", 0) or 0)
        cs = ckpt.get("cur_step")
        self.cur_step = int(cs) if cs is not None else 1
        self.best_valid_score = ckpt.get("best_score")
        self.best_valid_result = ckpt.get("best_valid_result")
        self._global_step = int(ckpt.get("global_step", 0) or 0)
        if self.scheduler is not None and ckpt.get("scheduler_state"):
            self.scheduler.load_state_dict(ckpt["scheduler_state"])
        self.logger.info("Resumed training state: %d epochs done, global_step=%d, "
                         "lr %g", self.cur_epoch, self._global_step,
                         get_learning_rate(self.opt_state))

    def load_model(self, filename: str, restore_optimizer: bool = False) -> Dict[str, Any]:
        """Load ``params`` (non-strict, as the JAX trainer's merge) and,
        when asked and the file holds the port's optimizer state, that."""
        ckpt = ckpt_util.load_checkpoint(filename)
        self.init_params()
        load_flax_params(self.model, ckpt["params"], strict=False)
        opt = ckpt.get("opt_state")
        if restore_optimizer and isinstance(opt, dict) and "learning_rate" in opt:
            self.opt_state = ckpt_util.opt_state_from_numpy(self.model, opt, self.device)
        self.logger.info("Loaded model from %s (epoch %s)", filename, ckpt.get("cur_epoch"))
        return ckpt


def _where(cond, new, old):
    if isinstance(new, list):
        return [torch.where(cond, n, o) for n, o in zip(new, old)]
    return torch.where(cond, new, old)
