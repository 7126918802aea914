"""topk_roofline: full-catalog top-k's share of its roofline, in %.

The work of exact scoring, whatever implements it (ops/topk.py's
fused_catalog_topk: row 5's block maxima, then pass 2's re-scoring): the
2 B N D products at 989 TFLOP/s (bf16), or the bf16 catalog and user rows
read once and the [B, k] int64 ids written once at 3.35 TB/s, whichever is
larger, a request; over the device time of the operations launched inside
the fused_catalog_topk span. Moves serve_users_per_s."""
from harness.common import PEAK_BYTES_PER_S, PEAK_FLOPS_BF16


def read(rec):
    if rec.info["kind"] != "serve":
        return None
    s = rec.info["sizes"]
    t = rec.device_s_under("fused_catalog_topk")
    if not t:
        return None
    B, N, D, k = s["B"], s["n_items"], s["D"], s["topk"]
    bound = max(2 * B * N * D / PEAK_FLOPS_BF16,
                (N * D * 2 + B * D * 2 + B * k * 8) / PEAK_BYTES_PER_S)
    return 100.0 * rec.info["steps"] * bound / t
