"""forward_ms: device milliseconds a step of the operations launched inside
the program's ``train.forward`` span (Trainer.train_step: the model and its
loss; rows 1 and 3 at d=64, rows 10 and the plain tower at d=256). Moves
train_examples_per_s."""


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = rec.device_s_under("train.forward")
    return None if s is None else 1e3 * s / rec.info["steps"]
