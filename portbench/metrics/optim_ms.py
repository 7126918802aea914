"""optim_ms: device milliseconds a step of the operations launched inside
Trainer.apply_update (core/optim.py's Adam under the NaN guard). Moves
train_examples_per_s."""


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = rec.device_s_under("apply_update")
    return None if s is None else 1e3 * s / rec.info["steps"]
