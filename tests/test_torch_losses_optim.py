"""ops/losses.py against unirec_tpu/ops/losses.py on the same scores (within
1e-6), and core/optim.py against the JAX package's optax chain: the same
gradients give the same updates over 3 steps (within 1e-6). Every kind's
in-place step (``Optimizer.step_``: on CPU leaves the functional update and
the guarded copies, for Adam the kernel's arithmetic) equals the functional
update followed by a guarded apply, bit for bit."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unirec_tpu.core import optim as jax_optim
from card_cases import guarded_update
from unirec_tpu.ops import losses as jax_losses
from unirec_tpu_torch.core import optim
from unirec_tpu_torch.ops import adam as A
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


ADAM_SHAPES = [(5, 3), (3,), (4, 4), (7,)]
FROZEN = 1                  # this leaf's gradient is zero, as the trainer gives a frozen one


@pytest.mark.parametrize("loss2", ["finite", "nan", "inf"])
@pytest.mark.parametrize("kind,wd,clip", [(k, wd, clip) for k in ("adam", "adamw", "sparse_adam",
                                                                  "sgd", "adagrad", "rmsprop")
                                          for wd in (0.0, 0.01) for clip in (-1, 0.5)])
def test_in_place_step_equals_the_functional_update_and_the_guarded_apply(kind, wd, clip, loss2):
    """Three steps from one state: ``step_`` in place against ``update``,
    then ``torch.where(finite, p + u, p)`` and the state select. Params and
    every state tensor of the kind bit-equal after every step, the state
    the same dict and tensors; the second step's loss is ``loss2``, and a
    loss that is not finite leaves everything as it was."""
    cfg = {"optimizer": kind, "learning_rate": 3e-3, "weight_decay": wd,
           "grad_clip_value": clip}
    opt = optim.build_optimizer(cfg)
    rng = np.random.default_rng(11)
    start = [rng.normal(size=s).astype(np.float32) for s in ADAM_SHAPES]
    fp = [torch.from_numpy(p.copy()) for p in start]
    ip = [torch.from_numpy(p.copy()) for p in start]
    fs, ins = opt.init(fp), opt.init(ip)
    losses_ = [torch.tensor(0.7), torch.tensor(float(loss2) if loss2 != "finite" else 0.6),
               torch.tensor(0.5)]
    plain = A.adam_step.launches_plain
    held = dict(ins)
    tensors = {k: list(v) if isinstance(v, list) else [v] for k, v in ins.items()}
    for step, loss in enumerate(losses_):
        grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ADAM_SHAPES]
        grads[FROZEN] = torch.zeros(ADAM_SHAPES[FROZEN])
        before = [p.clone() for p in ip], {k: [t.clone() for t in v] for k, v in tensors.items()}
        fp, fs = guarded_update(opt, grads, fs, fp, loss)
        opt.step_(grads, ins, ip, loss)
        for a, b in zip(ip, fp):
            assert torch.equal(a, b)
        assert set(ins) == set(fs) == set(tensors)
        for k, v in tensors.items():
            assert ins[k] is held[k] and all(a is b for a, b in zip(
                ins[k] if isinstance(ins[k], list) else [ins[k]], v))
            for a, b in zip(v, fs[k] if isinstance(fs[k], list) else [fs[k]]):
                assert torch.equal(a, b) and a.dtype == b.dtype
        if not bool(torch.isfinite(loss)):
            for a, b in zip(ip, before[0]):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            for k, v in tensors.items():
                assert all(torch.equal(a, b) for a, b in zip(v, before[1][k]))
        if wd == 0:
            assert torch.equal(ip[FROZEN], torch.from_numpy(start[FROZEN]))
    if opt.is_adam:
        assert int(ins["count"]) == (3 if loss2 == "finite" else 2)
        assert ins["count"].dtype == torch.int32
        assert A.adam_step.launches_plain == plain + 3      # one for each step_ on the CPU


def test_in_place_step_refuses_what_the_kernel_does_not_take():
    """ops/adam.py checks what the kernel takes before it asks for the card,
    so its refusals show on CPU tensors too; leaves that pass them are then
    refused for the device. ``step_`` on the CPU runs the plain version."""
    opt = optim.build_optimizer({"optimizer": "adam", "learning_rate": 1e-3})
    params = [torch.zeros(4, 3), torch.zeros(5)]
    state = opt.init(params)
    grads = [torch.ones(4, 3), torch.ones(5)]
    loss = torch.tensor(1.0)

    def kernel(p=params, g=grads, **kw):
        A.adam_step(p, g, state["mu"], state["nu"], state["count"], state["learning_rate"],
                    loss, b1=0.9, b2=0.999, eps=1e-8, **kw)

    with pytest.raises(TypeError, match="float32"):
        kernel(g=[grads[0], grads[1].bfloat16()])
    with pytest.raises(ValueError, match="contiguous"):     # written in place
        kernel(p=[torch.zeros(3, 4).t(), params[1]])
    with pytest.raises(ValueError, match="one entry per leaf"):
        kernel(g=grads[:1])
    with pytest.raises(ValueError, match="shape"):
        kernel(g=[torch.ones(3, 4), grads[1]])
    with pytest.raises(ValueError, match="gnorm"):          # the kernel reads clip's norm
        kernel(clip=1.0)
    # a gradient that is not contiguous passes the checks (the wrapper copies it)
    with pytest.raises(ValueError, match="no adam kernel for device cpu"):
        kernel(g=[torch.ones(3, 4).t(), grads[1]])
    assert int(state["count"]) == 0
    opt.step_([torch.ones(3, 4).t(), grads[1]], state, params, loss)
    assert int(state["count"]) == 1 and bool((params[0] < 0).all())
