"""MoRec and the Trainer: the multi-objective train step and the device
sweeps that feed the data sampler's signals.

Counterpart of unirec_tpu/facility/morec/integration.py. A MoRec batch is
``n_blocks`` equal blocks of rows (one per objective, the accuracy block
last); one forward gives the per-row losses, and ``block_losses`` their
weighted mean per block, the loss vector.

- PI(D), and PIX over static inner weights: one forward and one backward.
  beta comes from the PI controller's arithmetic on the device, from the
  accuracy block's loss taken out of the graph (``detach``, JAX's
  ``stop_gradient``); the loss is lam * inner . vec[:-1] + beta * vec[-1].
- Gradient-based controllers (MGDA, ParetoMTL, EPO; PIX over MGDA): the k
  per-objective gradients from k ``torch.autograd.grad(vec[i], ...,
  retain_graph=True)`` passes, as the reference computes them
  (trainer.py:484-496; the JAX package takes one ``jax.jacrev`` over the
  loss vector, which needs vmap rules the port's ctypes-backed autograd
  Functions do not have). Their k x k Gram is formed on the device, leaf by
  leaf, and only it and the loss vector go to the host, to the controller.
  The update's gradient is the weighted sum of those k gradients, the
  gradient of weights . vec: no further backward.
- Static weights: one forward and one backward of weights . vec.

Each step ends in the Trainer's update with its NaN guard and freeze mask.

Under data parallelism (``mesh_data`` > 1) every rank holds the global
batch and takes its rows, which may cross blocks: each row carries its
block's index, and a rank's share of the loss vector is its rows' weighted
loss sums over the global block weights, so the shares sum to the global
vector (the JAX package's one program over the sharded batch,
unirec_tpu/facility/morec/__init__.py:118-127). The controllers read the
summed vector and Gram; their outputs (beta, the weights) are taken from
rank 0, so the ranks stay bit-equal.
``gather_topk`` (exact top-k over the masked catalog) and
``gather_per_row_loss`` sweep the signal batcher between epochs.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from unirec_tpu_torch.constants import NINF_SCORE
from unirec_tpu_torch.models.modules import DropoutRNG
from unirec_tpu_torch.utils import to_device


# ----------------------------------------------------------- train stepping
def block_losses(per_row: torch.Tensor, weight: torch.Tensor, block: torch.Tensor,
                 denominators: torch.Tensor) -> torch.Tensor:
    """Mean per-row loss of each equal-size block (trainer.py:331-336
    tensor_split semantics; the blocks are equal by construction): each
    row's weighted loss summed into its ``block``, over ``denominators``,
    each block's weight summed over the global batch. A data rank's rows
    may cross blocks; the ranks' vectors sum to the global one."""
    num = torch.zeros(denominators.shape[0], dtype=torch.float32, device=per_row.device)
    num.index_add_(0, block, per_row.float() * weight.float())
    return num / torch.clamp(denominators, min=1.0)


def pi_update(state: Dict[str, torch.Tensor], acc_loss: torch.Tensor,
              cfg: Dict[str, torch.Tensor]):
    """The PI controller's step on the device (controllers.PIController.
    control's arithmetic, f32 as in the JAX package); state = {beta,
    integral, t}. Returns (beta, new state)."""
    e = cfg["expect_loss"] - acc_loss
    P = cfg["K_p"] / (1.0 + torch.exp(e))
    in_range = (state["beta"] >= cfg["beta_min"]) & (state["beta"] <= cfg["beta_max"])
    I_new = torch.where(in_range, state["integral"] - cfg["K_i"] * e, state["integral"])
    beta_new = torch.clamp(P + I_new + cfg["beta_min"], cfg["beta_min"], cfg["beta_max"])
    active = state["t"] < cfg["max_iter"]
    new_state = {"beta": torch.where(active, beta_new, state["beta"]),
                 "integral": torch.where(active, I_new, state["integral"]),
                 "t": state["t"] + active.to(state["t"].dtype)}
    return torch.minimum(new_state["beta"], cfg["beta_max"]), new_state


def data_mesh(trainer):
    """The trainer's mesh, or None for one process (a bare namespace)."""
    mesh = getattr(trainer, "mesh", None)
    return mesh if mesh is not None and mesh.distributed else None


def loss_vector(trainer, batch, drop_seed: int, n_blocks: int) -> torch.Tensor:
    """The per-block loss vector of one training forward (autograd on) on
    the global batch ``batch``. Under a data mesh this rank takes its rows
    (core/mesh.py::MeshContext.row_range; dropout drawn at the global
    shape) and returns its share: its rows' weighted loss sums over the
    global block weights, which the ranks' shares sum to
    (``global_vector``)."""
    mesh = data_mesh(trainer)
    n = int(batch["weight"].shape[0])
    lo, hi = (0, n) if mesh is None else mesh.row_range(n)
    rows = {k: v[lo:hi] if torch.is_tensor(v) and v.dim() else v for k, v in batch.items()}
    _, per_row = trainer.model(rows, train=True,
                               rng=DropoutRNG(drop_seed, trainer.device, (lo, hi - lo, n)))
    block = torch.arange(lo, hi, device=per_row.device) // (n // n_blocks)
    den = batch["weight"].float().reshape(n_blocks, -1).sum(-1)
    return block_losses(per_row, rows["weight"], block, den)


def global_vector(trainer, vec: torch.Tensor) -> torch.Tensor:
    """The global loss vector (detached): the ranks' shares summed over
    ``data`` (``vec`` itself in one process)."""
    mesh = data_mesh(trainer)
    vec = vec.detach()
    return vec if mesh is None else mesh.all_reduce_(vec.clone(), "data")


def objective_grads(params: List[torch.Tensor], vec: torch.Tensor,
                    mesh=None) -> List[List[torch.Tensor]]:
    """The gradient of each entry of ``vec``, one backward each (the graph
    kept for the next); a leaf an objective does not reach gets zeros.
    With a data ``mesh`` each objective's gradient is summed over the ranks
    (one all-reduce an objective), so the Gram sees the global ones."""
    rows = []
    for i in range(vec.shape[0]):
        g = torch.autograd.grad(vec[i], params, retain_graph=i + 1 < vec.shape[0],
                                allow_unused=True)
        g = [torch.zeros_like(p) if gi is None else gi for gi, p in zip(g, params)]
        rows.append(g if mesh is None else mesh.all_reduce_flat(g, "data"))
    return rows


def _rank0(trainer, values: np.ndarray) -> np.ndarray:
    """Rank 0's ``values`` on every data rank: the controllers' numbers are
    computed on every rank and taken from one, so the ranks stay bit-equal."""
    mesh = data_mesh(trainer)
    if mesh is None:
        return values
    t = torch.as_tensor(np.ascontiguousarray(values), device=trainer.device)
    return mesh.broadcast_(t, "data").cpu().numpy()


def gram(rows: List[List[torch.Tensor]]) -> torch.Tensor:
    """[k, k] Gram of the k flattened gradients, summed leaf by leaf in f32
    on the device."""
    k = len(rows)
    out = torch.zeros((k, k), dtype=torch.float32, device=rows[0][0].device)
    for leaf in zip(*rows):
        g = torch.stack([t.reshape(-1).float() for t in leaf])
        out += g @ g.T
    return out


def combine(rows: List[List[torch.Tensor]], weights) -> List[torch.Tensor]:
    """sum_i weights[i] * rows[i], leaf by leaf: the gradient of weights . vec."""
    w = [float(x) for x in weights]
    return [sum(wi * t for wi, t in zip(w, leaf)) for leaf in zip(*rows)]


def _pi_state(trainer, controller):
    if getattr(trainer, "_morec_pi_state", None) is None:
        dev = trainer.device
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        trainer._morec_pi_state = {"beta": f32(0.0), "integral": f32(0.0),
                                   "t": torch.tensor(0, dtype=torch.int32, device=dev)}
        trainer._morec_pi_cfg = {
            "expect_loss": f32(controller.expect_loss), "beta_min": f32(controller.beta_min),
            "beta_max": f32(controller.beta_max), "K_p": f32(controller.K_p),
            "K_i": f32(controller.K_i),
            "max_iter": torch.tensor(controller._max_iter, dtype=torch.int32, device=dev)}
    return trainer._morec_pi_state, trainer._morec_pi_cfg


def morec_train_step(trainer, batch, drop_seed: int) -> torch.Tensor:
    """One multi-objective step (trainer._objective_control semantics,
    trainer.py:461-538) on the global device batch; updates the trainer's
    parameters and returns the weighted loss (a 0-d device tensor). Under a
    data mesh (``mesh_data`` > 1) each rank computes its rows' share of the
    loss vector; PI(D) and static weights take one backward of the weighted
    share, summed with the loss in the trainer's one all-reduce
    (``Trainer.reduce_and_update``); a gradient-based controller sums each
    objective's gradient before the Gram. beta and the weights are rank
    0's."""
    controller = trainer.objective_controller
    n_blocks = trainer._morec_sampler.n_blocks
    n_rows = int(batch["weight"].shape[0])
    if n_rows % n_blocks:
        raise ValueError(f"MoRec batch has {n_rows} rows, not divisible into {n_blocks} "
                         "objective blocks (a batch_size that a multiple of mesh_data "
                         "keeps the blocks whole)")
    lam = float(trainer.config.get("morec_lambda", 0.2))
    params = trainer.params
    name = controller.__class__.__name__
    needs_grads = getattr(controller, "needs_grads", False)
    vec = loss_vector(trainer, batch, drop_seed, n_blocks)
    total = global_vector(trainer, vec)

    if name in ("PIXController", "PIController") and not needs_grads:
        # PI beta + static inner weights: one forward and one backward
        state, cfg = _pi_state(trainer, controller)
        if name == "PIXController":
            inner = np.asarray(controller.pareto_solve(None, np.zeros(n_blocks - 1)), np.float32)
        else:
            inner = np.full(n_blocks - 1, 1.0 / (n_blocks - 1), np.float32)
        beta, trainer._morec_pi_state = pi_update(state, total[-1], cfg)
        if data_mesh(trainer) is not None:
            beta = trainer.mesh.broadcast_(beta.reshape(1).clone(), "data")[0]
        inner_t = torch.as_tensor(_rank0(trainer, inner), device=vec.device)
        loss = lam * (inner_t * vec[:-1]).sum() + beta.detach() * vec[-1]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return trainer.reduce_and_update(loss, grads)

    if name.endswith("Solver") and not needs_grads:
        weights = np.asarray(controller.solve(None, np.zeros(n_blocks)), np.float32)
        loss = (torch.as_tensor(_rank0(trainer, weights), device=vec.device) * vec).sum()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return trainer.reduce_and_update(loss, grads)

    rows = objective_grads(params, vec, data_mesh(trainer))
    v = total.cpu().numpy()
    if name.endswith("Solver"):
        G = gram(rows).cpu().numpy()
        weights = np.asarray(controller.solve(G, v), np.float32)
    elif name == "PIXController":      # a gradient-based inner solver (MGDA)
        beta = controller.control(v[-1])
        G = gram(rows[:-1]).cpu().numpy()
        w = np.asarray(controller.pareto_solve(G, v[:-1]), np.float64)
        weights = np.concatenate([lam * w, [beta]]).astype(np.float32)
    else:
        raise ValueError(f"unsupported controller {name}")
    weights = _rank0(trainer, weights)
    loss = (torch.as_tensor(weights, device=vec.device) * total).sum()
    trainer.apply_update(loss, combine(rows, weights))
    return loss


# -------------------------------------------------------- validation sweeps
@torch.no_grad()
def gather_topk(trainer, valid_batcher, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k item ids over the full catalog for every validation row, the
    user's history masked except the row's own positive, and the padding
    item (morec_data_sampler.py:307-327): exact ``torch.topk`` on the
    device, the ids fetched once after the sweep."""
    from unirec_tpu_torch.ops.topk import full_catalog_scores
    model, history, dev = trainer.model, trainer.user_history, trainer.device
    tau = float(trainer.config.get("tau", 1.0))
    item_emb = model.all_item_emb()
    pending = []
    for batch in valid_batcher:
        keep = np.asarray(batch["weight"]) > 0
        pos = batch["item_id"][:, 0] if batch["item_id"].ndim == 2 else batch["item_id"]
        hist_items, hist_len = history.gather(np.asarray(batch["user_id"]))
        h = to_device({"items": hist_items, "len": hist_len, "pos": pos}, dev, torch.int64)
        scores = full_catalog_scores(model, to_device(batch, dev), item_emb, tau)
        cap = h["items"].shape[1]
        valid = torch.arange(cap, device=dev)[None, :] < h["len"][:, None]
        hcols = torch.where(valid & (h["items"] != h["pos"][:, None]), h["items"], 0)
        masked = scores.scatter(1, hcols, NINF_SCORE)
        masked[:, 0] = NINF_SCORE
        pending.append((torch.topk(masked, k).indices, keep, np.asarray(pos)))
    ids = [t.cpu().numpy()[keep] for t, keep, _ in pending]
    return np.concatenate(ids), np.concatenate([p[keep] for _, keep, p in pending])


@torch.no_grad()
def gather_per_row_loss(trainer, valid_batcher) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row training loss over the validation sweep and the rows'
    positive item ids (the fairness objective's worst-group signal), one
    dropout seed a batch from seed + 77."""
    model, dev = trainer.model, trainer.device
    base = int(trainer.config.get("seed", 2022)) + 77
    pending = []
    for i, batch in enumerate(valid_batcher):
        keep = np.asarray(batch["weight"]) > 0
        _, per_row = model(to_device(batch, dev), train=True,
                           rng=DropoutRNG(int(np.random.SeedSequence([base, i]).generate_state(1)[0]),
                                          dev))
        pos = batch["item_id"][:, 0] if batch["item_id"].ndim == 2 else batch["item_id"]
        pending.append((per_row, keep, np.asarray(pos)))
    return (np.concatenate([r.float().cpu().numpy()[k] for r, k, _ in pending]),
            np.concatenate([p[k] for _, k, p in pending]))
