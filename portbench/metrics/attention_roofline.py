"""attention_roofline: the fused attention kernels' share of their
roofline, in %.

Rows 10-11 (ops/attention.py: csrc/attention.cu, every body of the forward
and the backward). For each launch the larger of its products at 989
TFLOP/s (bf16) and its bytes at 3.35 TB/s: the forward's QK^T and PV
(4 B H L^2 hd), q, k, v and the f32 [B, 1, L, L] mask read once, the
output written once; the backward's products are the forward's recompute
plus two per product, q, k, v, the output gradient and the mask read,
dq, dk, dv written. The sum of those bounds over the kernels' summed device
time. Moves train_examples_per_s."""
from harness.common import PEAK_BYTES_PER_S, PEAK_FLOPS_BF16

FWD = ("attn_fwd_kernel", "attn_fwd_mma_kernel", "attn_fwd_tiled_kernel")
BWD = ("attn_bwd_kernel", "attn_bwd_mma_kernel", "attn_bwd_tiled_kernel")
BF16, F32 = 2, 4


def work(backward: bool, B: int, L: int, D: int):
    ops = 4 * B * L * L * D
    act, mask = B * L * D * BF16, B * L * L * F32
    if backward:
        return 3 * ops, 4 * act + mask + 3 * act
    return ops, 3 * act + mask + act


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = rec.info["sizes"]
    bound = seconds = 0.0
    for name, (n, t) in rec.kernels(FWD + BWD).items():
        if not n:
            continue
        ops, nbytes = work(name in BWD, s["B"], s["L"], s["D"])
        bound += n * max(ops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)
        seconds += t
    return None if seconds <= 0 else 100.0 * bound / seconds
