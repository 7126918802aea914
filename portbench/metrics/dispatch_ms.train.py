"""dispatch_ms.train: the host's milliseconds inside Trainer.train_step a
step (its ``train_step`` span, the host clock), over the traced window.
Moves train_examples_per_s."""


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = rec.host_s("train_step")
    return None if s is None else 1e3 * s / rec.info["steps"]
