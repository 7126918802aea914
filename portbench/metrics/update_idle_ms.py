"""update_idle_ms: milliseconds a step in which the device was idle while
the host was inside the program's ``train.update`` span (Trainer.
apply_update: core/optim.py's Adam and the guarded copies), each idle gap
cut against the span's intervals (harness/idle.py). Moves
train_examples_per_s."""
from harness.idle import idle_s_inside


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = idle_s_inside(rec, ("train.update",))
    return None if s is None else 1e3 * s / rec.info["steps"]
