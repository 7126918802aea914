"""layer_roofline: the layer kernels' share of their roofline, in %.

Rows 1-4 (ops/layer.py: csrc/layer_fwd.cu, layer_bwd.cu, lastq_fwd.cu,
lastq_bwd.cu, both bodies of each). For each launch in the traced window
the least time the card could take for the work the layer's inputs need
(the real L, not the padded one): the larger of its products at 989 TFLOP/s
(bf16) and its bytes at 3.35 TB/s, each input read once and each output
written once; a backward's products are its forward's recompute plus two
per product. The sum of those bounds over the kernels' summed device time.
Moves train_examples_per_s."""
from harness.common import PEAK_BYTES_PER_S, PEAK_FLOPS_BF16

ROWS = {"layer_fwd_kernel": "layer_fwd", "layer_fwd_mma_kernel": "layer_fwd",
        "layer_bwd_kernel": "layer_bwd", "layer_bwd_mma_kernel": "layer_bwd",
        "lastq_fwd_kernel": "lastq_fwd", "lastq_fwd_mma_kernel": "lastq_fwd",
        "lastq_bwd_kernel": "lastq_bwd", "lastq_bwd_mma_kernel": "lastq_bwd"}
BF16, F32 = 2, 4


def work(row: str, B: int, L: int, D: int, F: int):
    """(products in FLOPs, bytes) of one launch of ``row`` at batch B."""
    w = (4 * D * D + 2 * D * F) * BF16 + (4 * D + F + D) * BF16 + 4 * D * F32   # weights
    dw = (4 * D * D + 2 * D * F + 4 * D + F + D + 4 * D) * F32                   # their grads
    x, madd = B * L * D * BF16, B * L * F32
    full = 2 * B * L * (4 * D * D + 2 * D * F) + 4 * B * L * L * D
    lastq = 2 * B * (L * 2 * D * D + 2 * D * D + 2 * D * F) + 4 * B * L * D
    if row == "layer_fwd":
        return full, x + madd + w + x
    if row == "layer_bwd":
        return 3 * full, 2 * x + madd + w + x + dw
    if row == "lastq_fwd":
        return lastq, x + madd + w + B * D * BF16
    return 3 * lastq, x + B * D * BF16 + madd + w + x + dw


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = rec.info["sizes"]
    bound = seconds = 0.0
    for name, (n, t) in rec.kernels(ROWS).items():
        if not n:
            continue
        ops, nbytes = work(ROWS[name], s["B"], s["L"], s["D"], s["F"])
        bound += n * max(ops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)
        seconds += t
    return None if seconds <= 0 else 100.0 * bound / seconds
