"""ops/losses.py against unirec_tpu/ops/losses.py on the same scores (within
1e-6), and core/optim.py against the JAX package's optax chain: the same
gradients give the same updates over 3 steps (within 1e-6)."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unirec_tpu.core import optim as jax_optim
from unirec_tpu.ops import losses as jax_losses
from unirec_tpu_torch.core import optim
from unirec_tpu_torch.ops import losses

TOL = dict(atol=1e-6, rtol=1e-6)


def _scores(seed=0, B=12, G=10):
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(B, G)) * 3).astype(np.float32)
    labels = np.zeros((B, G), np.float32)
    labels[:, 0] = 1.0
    labels[3, 4] = 1.0                           # a row with two positives
    w = np.ones(B, np.float32)
    w[-2:] = 0.0                                 # padded rows
    return s, labels, w


@pytest.mark.parametrize("loss_type", ["bce", "bpr", "ccl", "softmax"])
def test_grouped_losses_match_jax(loss_type):
    s, labels, w = _scores()
    cfg = {"ccl_w": 150, "ccl_m": 0.4}
    loss, per_row = losses.compute_loss(loss_type, torch.from_numpy(s),
                                        torch.from_numpy(labels), torch.from_numpy(w), cfg)
    jl, jrow = jax_losses.compute_loss(loss_type, jnp.asarray(s), jnp.asarray(labels),
                                       jnp.asarray(w), cfg)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    np.testing.assert_allclose(per_row.numpy(), np.asarray(jrow), **TOL)


def test_scalar_bce_and_full_softmax_match_jax():
    s, labels, w = _scores(1)
    l1, r1 = losses.bce_loss(torch.from_numpy(s[:, 0]), torch.from_numpy(labels[:, 0]),
                             torch.from_numpy(w))
    j1, jr1 = jax_losses.bce_loss(jnp.asarray(s[:, 0]), jnp.asarray(labels[:, 0]),
                                  jnp.asarray(w))
    np.testing.assert_allclose(float(l1), float(j1), **TOL)
    np.testing.assert_allclose(r1.numpy(), np.asarray(jr1), **TOL)
    pos = np.arange(12, dtype=np.int32) % 10
    l2, r2 = losses.full_softmax_loss(torch.from_numpy(s), torch.from_numpy(pos),
                                      torch.from_numpy(w))
    j2, jr2 = jax_losses.full_softmax_loss(jnp.asarray(s), jnp.asarray(pos), jnp.asarray(w))
    np.testing.assert_allclose(float(l2), float(j2), **TOL)
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), **TOL)


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        losses.compute_loss("hinge", torch.zeros(2, 3), None, torch.ones(2), {})


@pytest.mark.parametrize("kind,wd,clip", [
    ("adam", 0.0, -1), ("adam", 0.01, -1), ("adam", 0.0, 0.5), ("adam", 0.01, 0.5),
    ("sgd", 0.0, -1), ("adagrad", 0.0, -1), ("rmsprop", 0.0, -1), ("adamw", 0.01, -1),
    ("adamw", 0.01, 0.5)])
def test_updates_match_optax(kind, wd, clip):
    cfg = {"optimizer": kind, "learning_rate": 3e-3, "weight_decay": wd,
           "grad_clip_value": clip}
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (3,), (4, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = jax_optim.build_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    opt = optim.build_optimizer(cfg)
    tp = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(tp)
    for step in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        ju, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, state = opt.update([torch.from_numpy(g) for g in grads], state, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_injected_learning_rate_and_schedulers_match_jax():
    opt = optim.build_optimizer({"optimizer": "sgd", "learning_rate": 0.1})
    state = opt.init([torch.zeros(2)])
    assert optim.get_learning_rate(state) == pytest.approx(0.1)
    state = optim.set_learning_rate(state, 0.01)
    u, _ = opt.update([torch.ones(2)], state, [torch.zeros(2)])
    np.testing.assert_allclose(u[0].numpy(), -0.01, rtol=1e-6)
    for kind in ("reduce", "step"):
        a = optim.build_scheduler({"scheduler": kind, "scheduler_factor": 0.5})
        b = jax_optim.build_scheduler({"scheduler": kind, "scheduler_factor": 0.5})
        lr_a = lr_b = 1.0
        for metric in (0.3, 0.2, 0.2, 0.4, 0.1, 0.1, 0.1):
            lr_a, lr_b = a.step(metric, lr_a), b.step(metric, lr_b)
            assert lr_a == lr_b
        assert a.state_dict() == b.state_dict()
    assert optim.build_scheduler({"scheduler": "none"}) is None
