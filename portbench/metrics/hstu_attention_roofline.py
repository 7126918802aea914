"""hstu_attention_roofline: HSTU's attention kernels' share of their
roofline, in %.

csrc/hstu_attention.cu (ops/hstu_attention.py). For each forward launch
(``hstu_fwd_kernel``) and each backward (one launch each of
``hstu_bwd_dq_kernel``, ``hstu_bwd_dkv_kernel`` and
``hstu_rab_reduce_kernel``), the larger of its products at 989 TFLOP/s
(bf16) and its bytes at 3.35 TB/s. Products: the causal pairs
B H L (L + 1) / 2 times 2 dqk + 2 dv; the backward's are the forward's
recompute plus two per product, three times as many. Bytes: q, k, v read
and o written, or q, k, v and the output's gradient read and dq, dk, dv
written, in bf16, and the f32 table (read, and its gradient written by the
backward). dqk = dv = D / H, as the configurations that run it set them.
The sum of those bounds over the four kernels' summed device time. Moves
train_examples_per_s."""
from harness.common import PEAK_BYTES_PER_S, PEAK_FLOPS_BF16

FWD = ("hstu_fwd_kernel",)
BWD = ("hstu_bwd_dq_kernel", "hstu_bwd_dkv_kernel", "hstu_rab_reduce_kernel")
BF16, F32 = 2, 4


def work(backward: bool, B: int, L: int, H: int, dqk: int, dv: int):
    """(products, bytes) of one forward or one backward."""
    ops = B * H * L * (L + 1) // 2 * (2 * dqk + 2 * dv)
    row = B * L * H
    table = (2 * L - 1) * F32
    if backward:
        return 3 * ops, row * (2 * dqk + 2 * dv) * BF16 + row * (2 * dqk + dv) * BF16 \
            + 2 * table
    return ops, row * (2 * dqk + dv) * BF16 + row * dv * BF16 + table


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = rec.info["sizes"]
    B, L, H = s["B"], s["L"], s["H"]
    dh = s["D"] // H
    k = rec.kernels(FWD + BWD)
    seconds = sum(t for _, t in k.values())
    if seconds <= 0:
        return None
    bound = 0.0
    for backward, n in ((False, k["hstu_fwd_kernel"][0]), (True, k["hstu_bwd_dkv_kernel"][0])):
        ops, nbytes = work(backward, B, L, H, dh, dh)
        bound += n * max(ops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)
    return 100.0 * bound / seconds
