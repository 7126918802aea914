"""Optimizers and LR schedulers (counterpart of unirec_tpu/core/optim.py).

The JAX package builds an optax chain under ``inject_hyperparams``:
clip_by_global_norm -> torch-style decayed weights (grad += wd * param, for
every optimizer but adamw) -> the core (adam / sgd / adagrad / rmsprop /
adamw = adam then decayed weights) -> scale(-1) -> scale(lr). The same
chain is written here in plain tensor ops, step for step as optax 0.2
computes it, so an update is the same function of (grads, state, params)
and the trainer's NaN guard stays on the device (a ``torch.where`` on
``isfinite(loss)``, no host sync). The trainer calls ``step_``, the
update and the guarded apply in place: for the Adam kinds on CUDA leaves one
hand-written kernel (ops/adam.py, csrc/adam.cu), for every other kind or
device ``update`` and the guarded copies. Parameters and state are lists of tensors in
``model.parameters()`` order; the state is a dict of tensors:

    learning_rate  0-d f32    (the injected hyperparameter)
    count          0-d int32  (adam / adamw)
    mu, nu         lists      (adam / adamw first and second moments)
    sum_of_squares list       (adagrad)
    nu             list       (rmsprop)

While a profiler runs, ``update`` opens ``optim.update`` and, for the Adam
kinds, ``optim.moments``, ``optim.bias_correction`` and ``optim.direction``
(utils/tracing.py); ``step_`` on the card opens ``optim.update`` (the
clip's norm) over ``train.apply`` (the kernel's launches, which write the
guarded update), elsewhere ``update``'s spans, then ``train.apply`` (the
guarded copies). ops/adam.py's ``adam_step`` counts the kernel's launches
(``launches_fused``) and ``step_``'s plain Adam updates (``launches_plain``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from unirec_tpu_torch.core.mesh import all_reduce_
from unirec_tpu_torch.ops import adam as A
from unirec_tpu_torch.utils import tracing

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8      # optax.scale_by_adam defaults
_RMS_DECAY, _RMS_EPS = 0.9, 1e-8            # optax.scale_by_rms defaults
_RSS_EPS = 1e-7                             # optax.scale_by_rss default
_KINDS = ("adam", "sgd", "adagrad", "rmsprop", "adamw", "sparse_adam")


def global_sq_norm(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
    """The squared global norm of ``grads``: each replicated parameter's
    squares once, a row-sharded table's (``row_shard``, core/mesh.py)
    summed over its ``model`` ranks."""
    shards = [(g, p.row_shard) for g, p in zip(grads, params)
              if getattr(p, "row_shard", None) is not None]
    total = sum((g.float() ** 2).sum() for g, p in zip(grads, params)
                if getattr(p, "row_shard", None) is None)
    if shards:
        local = sum((g.float() ** 2).sum() for g, _ in shards).reshape(1)
        total = total + all_reduce_(local, shards[0][1].group)[0]
    return total


class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, new_state)``; apply with ``p + u`` (optax's convention).
    ``step_``: update and apply in place, under the NaN guard."""

    def __init__(self, kind: str, learning_rate: float, weight_decay: float = 0.0,
                 clip: float = -1.0):
        self.kind = kind if kind in _KINDS else "adam"
        self.lr = float(learning_rate)
        self.wd = float(weight_decay or 0.0)
        self.clip = float(clip or -1.0)
        self._tickets = {}           # device -> the kernel's last-block ticket

    @property
    def is_adam(self) -> bool:
        return self.kind in ("adam", "adamw", "sparse_adam")

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        dev = params[0].device
        state: Dict[str, Any] = {"learning_rate": torch.tensor(self.lr, device=dev)}
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        if self.is_adam:
            state.update(count=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=zeros(), nu=zeros())
        elif self.kind == "adagrad":
            state["sum_of_squares"] = zeros()
        elif self.kind == "rmsprop":
            state["nu"] = zeros()
        return state

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        with tracing.span("optim.update"):
            return self._update(list(grads), state, params)

    def _update(self, u, state, params):
        new = dict(state)
        if self.clip > 0:
            g_norm = torch.sqrt(global_sq_norm(u, params))
            trigger = g_norm < self.clip
            u = [torch.where(trigger, g, g / g_norm * self.clip) for g in u]
        if self.wd > 0 and self.kind != "adamw":
            u = torch._foreach_add(u, list(params), alpha=self.wd)
        if self.is_adam:
            with tracing.span("optim.moments"):
                mu = torch._foreach_add(torch._foreach_mul(u, 1.0 - _B1),
                                        torch._foreach_mul(state["mu"], _B1))
                nu = torch._foreach_add(
                    torch._foreach_mul(torch._foreach_mul(u, u), 1.0 - _B2),
                    torch._foreach_mul(state["nu"], _B2))
            with tracing.span("optim.bias_correction"):
                count = state["count"] + 1
                c1 = 1.0 - _B1 ** count.float()
                c2 = 1.0 - _B2 ** count.float()
            with tracing.span("optim.direction"):
                mu_hat = [m / c1 for m in mu]
                nu_hat = [n / c2 for n in nu]
                u = [m / (torch.sqrt(n) + _ADAM_EPS) for m, n in zip(mu_hat, nu_hat)]
            new.update(count=count, mu=list(mu), nu=list(nu))
            if self.kind == "adamw" and self.wd > 0:
                u = torch._foreach_add(u, list(params), alpha=self.wd)
        elif self.kind == "adagrad":
            ss = torch._foreach_add(torch._foreach_mul(u, u), state["sum_of_squares"])
            u = [torch.where(s > 0, torch.rsqrt(s + _RSS_EPS), 0.0) * g
                 for s, g in zip(ss, u)]
            new["sum_of_squares"] = list(ss)
        elif self.kind == "rmsprop":
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(u, u), 1.0 - _RMS_DECAY),
                                    torch._foreach_mul(state["nu"], _RMS_DECAY))
            u = [torch.rsqrt(n + _RMS_EPS) * g for n, g in zip(nu, u)]
            new["nu"] = list(nu)
        lr = state["learning_rate"]
        return [(-g) * lr for g in u], new

    def step_(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
              params: Sequence[torch.Tensor], loss: torch.Tensor) -> None:
        """The update and the trainer's guarded apply in one, in place:
        ``params`` and ``state``'s tensors change unless ``loss`` is not
        finite; ``state`` keeps its dict and tensors. The Adam kinds' CUDA
        leaves go to the kernel, with no host read; every other kind or
        device to ``update`` then ``p + u`` and the new state, copied in
        under ``torch.where`` on ``isfinite(loss)``."""
        params = list(params)
        dev = state["learning_rate"].device
        if not (self.is_adam and dev.type == "cuda"):
            finite = torch.isfinite(loss)
            updates, new = self.update(grads, state, params)
            with tracing.span("train.apply"):
                for p, u in zip(params, updates):
                    torch.where(finite, p + u, p, out=p)
                for k, v in new.items():
                    if k == "learning_rate":    # no step changes it
                        continue
                    olds, news = (state[k], v) if isinstance(v, list) else ([state[k]], [v])
                    for old, t in zip(olds, news):
                        torch.where(finite, t, old, out=old)
            if self.is_adam:
                A.adam_step.launches_plain += 1
            return
        with tracing.span("optim.update"):
            gnorm = torch.sqrt(global_sq_norm(grads, params)) if self.clip > 0 else None
            decay = A.NO_DECAY if self.wd <= 0 else (
                A.DECOUPLED if self.kind == "adamw" else A.L2)
            if dev not in self._tickets:
                self._tickets[dev] = A.new_ticket(dev)
            with tracing.span("train.apply"):
                A.adam_step(params, list(grads), state["mu"], state["nu"], state["count"],
                            state["learning_rate"], loss, b1=_B1, b2=_B2, eps=_ADAM_EPS,
                            wd=self.wd, decay=decay, clip=self.clip, gnorm=gnorm,
                            ticket=self._tickets[dev])


def build_optimizer(config: Dict[str, Any]) -> Optimizer:
    return Optimizer(config.get("optimizer", "adam"),
                     float(config.get("learning_rate", 1e-3)),
                     float(config.get("weight_decay", 0.0) or 0.0),
                     float(config.get("grad_clip_value", -1) or -1))


def set_learning_rate(opt_state: Dict[str, Any], lr: float) -> Dict[str, Any]:
    """Set the injected lr (host-side scheduler step)."""
    opt_state["learning_rate"] = torch.tensor(
        float(lr), device=opt_state["learning_rate"].device)
    return opt_state


def get_learning_rate(opt_state: Dict[str, Any]) -> float:
    return float(opt_state["learning_rate"])


class PlateauScheduler:
    """ReduceLROnPlateau(mode='max', patience=1, threshold=1e-4 rel)."""

    def __init__(self, factor: float, patience: int = 1, threshold: float = 1e-4,
                 min_lr: float = 0.0):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0

    def step(self, metric: float, lr: float) -> float:
        if self.best is None or metric > self.best * (1.0 + self.threshold) or (
                self.best < 0 and metric > self.best * (1.0 - self.threshold)):
            self.best = metric
            self.num_bad = 0
            return lr
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self):
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, s):
        self.best = s.get("best")
        self.num_bad = int(s.get("num_bad", 0) or 0)


class StepScheduler:
    """StepLR(step_size=1): lr *= factor every epoch."""

    def __init__(self, factor: float):
        self.factor = factor

    def step(self, metric: float, lr: float) -> float:
        return lr * self.factor

    def state_dict(self):
        return {}

    def load_state_dict(self, s):
        pass


def build_scheduler(config: Dict[str, Any]):
    kind = config.get("scheduler", "reduce")
    factor = float(config.get("scheduler_factor", 0.1))
    if kind == "step":
        return StepScheduler(factor)
    if kind == "reduce":
        return PlateauScheduler(factor)
    return None
