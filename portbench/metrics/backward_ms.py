"""backward_ms: device milliseconds a step of the operations launched inside
the program's ``train.backward`` span (Trainer.train_step's
torch.autograd.grad: rows 2, 4, 6 and 11; the autograd engine's thread
launches them while the host waits in the span). Moves
train_examples_per_s."""


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = rec.device_s_under("train.backward")
    return None if s is None else 1e3 * s / rec.info["steps"]
