"""train_mfu: the whole training step's share of the card's bf16 peak, in %.

The configuration file's model FLOPs of one training example
(``flops.train_example``: forward and backward, three times the forward's
products) times the examples of the traced window's steps, over the window
and over 989 TFLOP/s. Moves train_examples_per_s."""
from harness.common import PEAK_FLOPS_BF16


def read(rec):
    info = rec.info
    if info["kind"] != "train" or "train_example" not in info["flops"] or rec.window_s <= 0:
        return None
    work = info["flops"]["train_example"] * info["batch"] * info["steps"]
    return 100.0 * work / rec.window_s / PEAK_FLOPS_BF16
