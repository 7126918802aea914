"""The training loop (counterpart of unirec_tpu/facility/trainer.py).

One train step: the per-step randomness as a function of (seed,
global_step), the JAX package's ``fold_in``; device-side augmentation
(data/device_pipeline.py), or a host batch as it comes (T7 rows); with
``total_anneal_steps`` > 0 the batch's MultiVAE KL factor ``kl_anneal``;
forward and backward through the model, whose fused layers and embedding
gathers run the port's CUDA kernels on the card; the optimizer update (core/optim.py) under the NaN guard, a
``torch.where`` on ``isfinite(loss)`` that keeps the step on the device.
``fit`` runs the epoch loop in the reference's order: validate (early
stopping, best checkpoint, LR plateau step), then train, with the losses
kept on the device and fetched once per epoch, and the ``auto_resume``
rolling ``.last`` checkpoint. ``evaluate`` runs the evaluator of the
protocol set by ``reset_evaluator``, from the best checkpoint on request,
or returns the raw scores of the infer task (``predict_only``).
Checkpoints use the JAX package's pickle layout with ``params`` as a flax
tree and the model's frozen item inputs as ``constants``, so the port's
``reco-topk`` and the JAX package read them. With
``freeze`` the parameters ``load_model`` loaded get zero gradients before
the optimizer (trainer.py:380-386); Adam then leaves them exactly as they
are unless ``weight_decay`` adds its term, as it does in the JAX chain.
Observability (reference trainer.py:78-84, 284-290, 356-365):
``use_tensorboard`` writes ``train/loss`` and ``train/epoch_seconds`` at
step epoch + 1 and ``valid/<metric>`` at the epoch index through
``torch.utils.tensorboard`` into ``<output_path>/tensorboard``;
``use_wandb`` logs the same when ``wandb`` imports; either warns and stays
off when its package does not import. While a profiler runs, a step opens
the spans of utils/tracing.py: ``train.step`` over ``train.augment``,
``train.forward``, ``train.backward``, ``train.reduce`` and
``train.update`` (``optim.*``, then ``train.apply``).

MoRec (reference trainer.py:461-538): with an objective controller
(``add_objective_controller``, wired by facility/morec's ``build_morec``)
each step is facility/morec/integration.py's ``morec_train_step`` on the
host batches of the MoRec sampler, ending in the same update.

Distribution (trainer.py:74-176, :380-420): the trainer runs on the
('data', 'model') mesh of core/mesh.py, whose collectives are identities
without a process group, so one process takes the same step. Every rank
holds the same global batch, pads it to a multiple of ``n_data`` and
augments its own rows; every random draw (negatives, history windows,
dropout, MultiVAE's noise) is taken at the global shape and sliced, and the
fused kernels key their dropout by global example. The losses
divide by the global batch's denominators (ops/losses.py), so the ranks'
gradients, summed over ``data`` in one all-reduce with the loss, are the
one-process gradients of the whole batch. Parameters are placed by
``MeshContext.shard_params``: under ``shard_embeddings`` with ``n_model`` >
1 an embedding table keeps this rank's rows (models/base.py's sharded
lookup). Every rank applies the same update; the NaN guard reads the
summed loss, so one rank's non-finite loss skips the step on every rank;
``grad_clip_value`` takes the global norm (a sharded table's squares
summed over ``model``, each replicated parameter counted once).
TensorBoard, W&B, the log file and checkpoint files are written by rank 0
alone. MoRec steps under ``mesh_data`` > 1 take this rank's rows of the
global MoRec batch and sum their shares of the loss vector, and of each
objective's gradient, over ``data`` (facility/morec/integration.py).
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from unirec_tpu_torch.constants import EvalProtocol
from unirec_tpu_torch.core.distributed import is_main_process
from unirec_tpu_torch.core.mesh import MeshContext, create_mesh
from unirec_tpu_torch.core.optim import (build_optimizer, build_scheduler,
                                         get_learning_rate, set_learning_rate)
from unirec_tpu_torch.facility.evaluation import build_evaluator
from unirec_tpu_torch.models.modules import DropoutRNG
from unirec_tpu_torch.ops import losses as L
from unirec_tpu_torch.utils import checkpoint as ckpt_util
from unirec_tpu_torch.utils import resolve_device, to_device, tracing
from unirec_tpu_torch.utils.flax_bridge import load_flax_params, loaded_mask, to_flax_params
from unirec_tpu_torch.utils.logger import setup_logger


def step_seeds(seed: int, step: int):
    """(augmentation seed, dropout seed) of one global step: a pure
    function of (seed, step), as the JAX trainer's fold_in(base_rng, step)."""
    a, b = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return int(a), int(b)


def kl_anneal(step: int, cap: float, total_steps: float) -> float:
    """MultiVAE's KL factor at 0-based global step ``step`` (trainer.py:
    63-70): the reference bumps it by 1/total_anneal_steps after each
    forward up to anneal_cap (multivae.py:25,106-109), so step k uses
    min(cap, k / total)."""
    return min(float(cap), step / float(total_steps))


def early_stopping(value, best, cur_step, max_step=4, bigger=True):
    """The reference's Trainer.early_stopping (trainer.py:188-233), with its
    >/>= asymmetry between the two modes: (best, cur_step, stop, update)."""
    if max_step <= 0:
        return best, cur_step, False, True
    better = best is None or (value > best if bigger else value < best)
    if better:
        return value, 0, False, True
    cur_step += 1
    return best, cur_step, (cur_step > max_step if bigger else cur_step >= max_step), False


class Trainer:
    def __init__(self, config: Dict[str, Any], model, device=None,
                 mesh: Optional[MeshContext] = None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else create_mesh(config, device=self.device)
        self.model = model.to(self.device)
        self.exp_name = config.get("exp_name", "unirec_tpu")
        self.logger = setup_logger(self.exp_name, config.get("output_path"))
        self.epochs = int(config.get("epochs", 0))
        self.early_stop = int(config.get("early_stop", 5))
        self.key_metric = config.get("key_metric", "group_auc")
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
        self.user_history = None
        self.evaluator = None
        self._eval_protocol = None
        self._loaded = None          # per parameter: loaded by load_model
        self.objective_controller = None   # MoRec (facility/morec)
        self._morec_sampler = None
        self._morec_pi_state = None
        # MultiVAE's KL anneal schedule (trainer.py:131-141), fed per step
        # as the batch's ``anneal``; global_step is checkpointed, so the
        # schedule survives a resume
        total = float(config.get("total_anneal_steps", 0) or 0)
        self._anneal_sched = (float(config.get("anneal_cap", 0.2)), total) if total > 0 else None
        self._tb = self._wandb = None
        main = is_main_process()
        if int(config.get("use_tensorboard", 0) or 0) and main:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self.logger.warning("tensorboard unavailable; disabling")
            else:
                self._tb = SummaryWriter(os.path.join(config.get("output_path", "."),
                                                      "tensorboard"))
        if int(config.get("use_wandb", 0) or 0) and main:
            try:
                import wandb
            except ImportError:
                self.logger.warning("wandb unavailable; disabling")
            else:
                self._wandb = wandb
                if wandb.run is None:
                    wandb.init(project=config.get("wandb_project", "unirec_tpu"),
                               name=self.exp_name,
                               config={k: v for k, v in config.items() if not k.startswith("_")})

    # ------------------------------------------------------------------ setup
    def set_user_history(self, history):
        """The packed histories that one-vs-all evaluation masks."""
        self.user_history = history

    def reset_evaluator(self, data_format=None, eval_protocol=None):
        self.evaluator = build_evaluator(self.config, self.model, eval_protocol,
                                         data_format, self.device, self.mesh)
        self._eval_protocol = eval_protocol

    def add_objective_controller(self, controller):
        """MoRec: every step then weighs the per-objective losses through
        ``controller`` (facility/morec/integration.py)."""
        self.objective_controller = controller

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
        # and every rank
        self.model.to("cpu").init_weights(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        if self.config.get("shard_embeddings") and self.mesh.n_model > 1:
            rule = self.mesh.shard_params(self.model,
                                          int(self.config.get("shard_min_rows", 1024)))
            self.logger.info("row-sharded over model: %s",
                             sorted(k for k, v in rule.items() if v))
        self.params = list(self.model.parameters())
        self.opt_state = self.tx.init(self.params)
        n = sum(p.numel() for p in self.params)
        self.logger.info(f"Model initialized: {n} trainable parameters")

    # ------------------------------------------------------------- the step
    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a device batch (raw ids when an augmenter
        is set); returns the loss as a 0-d device tensor, no host sync."""
        with tracing.span("train.step"):
            aug_seed, drop_seed = step_seeds(self.seed, self._global_step)
            if self.objective_controller is not None:
                from unirec_tpu_torch.facility.morec.integration import morec_train_step
                loss = morec_train_step(self, batch, drop_seed)
                self._global_step += 1
                return loss
            n = next(len(v) for v in batch.values() if torch.is_tensor(v) and v.dim())
            lo, hi = self.mesh.row_range(n)
            if self._augmenter is not None:
                gen = torch.Generator(device=self.device).manual_seed(aug_seed)
                batch = self._augmenter.augment(batch, gen, rows=(lo, hi))
            else:
                batch = {k: v[lo:hi] if torch.is_tensor(v) and v.dim() else v
                         for k, v in batch.items()}
            if self._anneal_sched is not None:     # after augment, which rebuilds the keys
                batch = dict(batch, anneal=kl_anneal(self._global_step, *self._anneal_sched))
            with tracing.span("train.forward"), L.global_denominators(
                    lambda x: self.mesh.all_reduce_(x.clone(), "data")):
                loss, _ = self.model(batch, train=True,
                                     rng=DropoutRNG(drop_seed, self.device, (lo, hi - lo, n)))
            with tracing.span("train.backward"):
                grads = torch.autograd.grad(loss, self.params, allow_unused=True)
            loss = self.reduce_and_update(loss, grads)
            self._global_step += 1
            return loss

    def reduce_and_update(self, loss: torch.Tensor, grads) -> torch.Tensor:
        """The update from this rank's loss and gradients (None for a
        parameter the loss does not reach): the global loss and gradients,
        summed over the data ranks in one all-reduce, through
        ``apply_update``. Returns the global loss."""
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        with tracing.span("train.reduce"):
            loss, *grads = self.mesh.all_reduce_flat([loss.detach()] + grads, "data")
        self.apply_update(loss, grads)
        return loss

    def apply_update(self, loss: torch.Tensor, grads):
        """The optimizer update from ``grads`` (None for a parameter the
        loss does not reach), frozen parameters at zero gradient, under the
        NaN guard (trainer.py:229-237): params and state stay when the loss
        is not finite."""
        with tracing.span("train.update"), torch.no_grad():
            grads = [torch.zeros_like(p) if g is None or f else g
                     for g, p, f in zip(grads, self.params, self._frozen)]
            finite = torch.isfinite(loss)
            updates, new_state = self.tx.update(grads, self.opt_state, self.params)
            with tracing.span("train.apply"):
                for p, u in zip(self.params, updates):
                    p.copy_(torch.where(finite, p + u, p))
                self.opt_state = {k: _where(finite, v, self.opt_state[k])
                                  for k, v in new_state.items()}

    @property
    def _frozen(self):
        """Per parameter, whether ``freeze`` holds it: loaded by load_model
        from a pretrained checkpoint (reference trainer.py:380-386)."""
        if not int(self.config.get("freeze", 0) or 0) or self._loaded is None:
            return [False] * len(self.params)
        return self._loaded

    def _log_scalars(self, scalars: Dict[str, float], step: int):
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(dict(scalars), step=step)

    # ------------------------------------------------------------------- fit
    def fit(self, train_data, valid_data=None, save_model: bool = True,
            load_pretrained_model: bool = False, model_file: Optional[str] = None,
            verbose: int = 1):
        # the JAX trainer peeks one batch to initialize; the peek consumes one
        # shuffle epoch of the batcher, so the port does the same and both
        # see the same data order
        next(iter(train_data))
        self.init_params()
        if load_pretrained_model:
            if model_file is None:
                raise ValueError("`model_file` required with load_pretrained_model")
            self.load_model(model_file)
            if int(self.config.get("freeze", 0) or 0):
                self.logger.info("Freezing %d/%d pretrained parameters",
                                 sum(self._frozen), len(self.params))
        auto_resume = bool(int(self.config.get("auto_resume", 0) or 0))
        last_file = self.saved_model_file + ".last" if auto_resume else None
        if auto_resume and ckpt_util.checkpoint_exists(last_file):
            self.resume(last_file)
            if hasattr(train_data, "set_epoch"):
                train_data.set_epoch(self.cur_epoch + 1)
        for epoch_idx in range(self.cur_epoch, self.epochs):
            if valid_data is not None and self._validate(valid_data, epoch_idx,
                                                         save_model, verbose):
                break
            t0 = time.time()
            # every rank holds the whole host batch, padded to a multiple of
            # n_data rows; train_step takes this rank's rows
            losses = [self.train_step(to_device(self.mesh.pad_batch(b), self.device))
                      for b in train_data]
            # losses stay on the device until the epoch ends: one fetch
            total_loss = float(torch.stack(losses).double().sum()) if losses else 0.0
            self.logger.info("epoch %d training [time: %.2fs, train loss: %.4f]",
                             epoch_idx + 1, time.time() - t0, total_loss)
            self._log_scalars({"train/loss": total_loss,
                               "train/epoch_seconds": time.time() - t0}, epoch_idx + 1)
            if auto_resume:
                self.cur_epoch = epoch_idx + 1
                self.save_model(last_file, epoch_idx + 1, quiet=True)
        self.cur_epoch = self.epochs
        return self.best_valid_result

    def _validate(self, valid_data, epoch_idx: int, save_model: bool, verbose: int) -> bool:
        """One validation before epoch ``epoch_idx`` trains (trainer.py:
        311-341): early-stopping bookkeeping, the best checkpoint, the LR
        plateau step. Returns whether training stops."""
        t0 = time.time()
        result = self.evaluate(valid_data, load_best_model=False)
        score = result[self.key_metric]
        self.best_valid_score, self.cur_step, stop, update = early_stopping(
            score, self.best_valid_score, self.cur_step, max_step=self.early_stop)
        self.logger.info("epoch %d evaluating [time: %.2fs, %s: %f]", epoch_idx,
                         time.time() - t0, self.key_metric, score)
        self._log_scalars({f"valid/{k}": v for k, v in result.items()}, epoch_idx)
        if verbose > 1:
            self.logger.info("complete scores on valid set: %s", result)
        if update:
            if save_model:
                self.save_model(self.saved_model_file, epoch_idx, result)
            self.best_valid_result = result
        else:
            self.logger.info("No better score. Patience: %d / %d", self.cur_step,
                             self.early_stop)
        if stop:
            self.logger.info("Finished training, best eval result in epoch %d",
                             epoch_idx - self.cur_step)
            return True
        if self.scheduler is not None and epoch_idx > 0:
            lr = get_learning_rate(self.opt_state)
            new_lr = self.scheduler.step(score, lr)
            if new_lr != lr:
                self.opt_state = set_learning_rate(self.opt_state, new_lr)
                self.logger.info("epoch %d: learning rate -> %g", epoch_idx, new_lr)
        return False

    # -------------------------------------------------------------- evaluate
    def evaluate(self, eval_data, load_best_model: bool = True,
                 model_file: Optional[str] = None, predict_only: bool = False):
        """Metrics of ``eval_data`` under the evaluator's protocol, from the
        best checkpoint when ``load_best_model``; with ``predict_only`` the
        real rows' raw scores instead (the infer task)."""
        if eval_data is None:
            return None
        if load_best_model:
            self.load_model(model_file or self.saved_model_file)
        self.init_params()
        if self.evaluator is None:
            raise ValueError("no evaluator: call reset_evaluator first")
        if predict_only:
            return self.evaluator.predict_scores(eval_data)
        if self._eval_protocol == EvalProtocol.ONE_VS_ALL.value:
            if self.user_history is None:
                raise ValueError("user_history must be set for one_vs_all evaluation")
            return self.evaluator.evaluate_full(eval_data, self.user_history)
        return self.evaluator.evaluate(eval_data)

    # ------------------------------------------------------------ checkpoint
    def save_model(self, filename: str, cur_epoch: int = -1,
                   valid_result: Optional[dict] = None, quiet: bool = False):
        """The checkpoint at ``filename``: the JAX package's pickle, or with
        ``checkpoint_backend=orbax`` the ``<filename>.dcp`` directory
        (utils/checkpoint.py). Every rank calls it (the tables' rows are
        gathered, or each rank writes its own); rank 0 writes the files."""
        state = {
            "config": self.config,
            "cur_epoch": cur_epoch,
            "cur_step": self.cur_step,
            "best_valid_score": valid_result,
            "best_score": self.best_valid_score,
            "best_valid_result": self.best_valid_result,
            "global_step": self._global_step,
            "scheduler_state": (self.scheduler.state_dict()
                                if self.scheduler is not None else None),
            "constants": self.model.constants(),
        }
        if self.config.get("checkpoint_backend", "pickle") == "orbax":
            filename = ckpt_util.save_checkpoint_dcp(filename, state, self.model,
                                                     self.opt_state, self.mesh)
        else:
            ckpt_util.save_checkpoint(filename, dict(
                state, params=to_flax_params(self.model),
                opt_state=ckpt_util.opt_state_to_numpy(self.model, self.opt_state)))
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
        self.model.load_constants(ckpt.get("constants"))
        self._loaded = loaded_mask(self.model, ckpt["params"])
        opt = ckpt.get("opt_state")
        if restore_optimizer and isinstance(opt, dict) and "learning_rate" in opt:
            self.opt_state = ckpt_util.opt_state_from_numpy(self.model, opt, self.device)
        self.logger.info("Loaded model from %s (epoch %s)", filename, ckpt.get("cur_epoch"))
        return ckpt


def _where(cond, new, old):
    if isinstance(new, list):
        return [torch.where(cond, n, o) for n, o in zip(new, old)]
    return torch.where(cond, new, old)
