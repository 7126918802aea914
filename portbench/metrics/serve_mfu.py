"""serve_mfu: the whole request's share of the card's bf16 peak, in %.

The configuration file's FLOPs of one served user (``flops.serve_user``:
the tower's forward and the 2 N D products of scoring the whole catalog)
times the users of the traced window's requests, over the window and over
989 TFLOP/s. Moves serve_users_per_s."""
from harness.common import PEAK_FLOPS_BF16


def read(rec):
    info = rec.info
    if info["kind"] != "serve" or "serve_user" not in info["flops"] or rec.window_s <= 0:
        return None
    work = info["flops"]["serve_user"] * info["batch"] * info["steps"]
    return 100.0 * work / rec.window_s / PEAK_FLOPS_BF16
