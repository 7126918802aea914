"""Faults planted under the timed path, to show that ``correct`` catches
them (portbench/control.py on the card, the tests on the CPU). Each takes
the driver's run object, breaks the program under it for that run, and
returns a function that mends it."""
from __future__ import annotations

import torch


def frozen_state(run):
    """A training step that leaves the parameters and the optimizer state
    as they were."""
    tr = run.trainer
    tr.apply_update = lambda loss, grads: None
    return lambda: delattr(tr, "apply_update")


def half_batch(run):
    """A training step that leaves out half of the batch's rows and takes
    the mean over the rest."""
    model = run.model
    orig = model.forward

    def forward(batch, train=True, rng=None):
        n = batch["item_id"].shape[0]
        half = {k: v[:n // 2] if torch.is_tensor(v) and v.dim() and v.shape[0] == n else v
                for k, v in batch.items()}
        return orig(half, train=train, rng=rng)

    model.forward = forward
    return lambda: delattr(model, "forward")


def altered_answer(run):
    """Served top-k ids with each row's last id moved to the next item id,
    where the top-k is produced."""
    from unirec_tpu_torch.ops import topk as topk_ops
    orig = topk_ops.fused_catalog_topk

    def fused_catalog_topk(user_emb, item_emb, k, **kw):
        vals, ids = orig(user_emb, item_emb, k, **kw)
        ids = ids.clone()
        ids[:, -1] = ids[:, -1] % (item_emb.shape[0] - 1) + 1
        return vals, ids

    topk_ops.fused_catalog_topk = fused_catalog_topk

    def mend():
        topk_ops.fused_catalog_topk = orig
    return mend


TRAIN_FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch}
SERVE_FAULTS = {"altered_answer": altered_answer}
