"""scatter_roofline: the embedding-gradient scatter's share of its
roofline, in %.

Row 6 (ops/scatter_accum.py: csrc/scatter_add.cu, both bodies). A training
step scatters twice into the [n_items, D] bf16 item-table gradient: the
history windows' B L ids and the candidates' B (1 + n_neg) ids. Its bytes:
each id (4 bytes) and its bf16 gradient row read once, the zeroed
accumulator table written once a launch; the bound is those bytes at 3.35
TB/s (no products), over the kernels' summed device time. A window whose
launches are not two a step has nothing this reader can attribute. Moves
train_examples_per_s."""
from harness.common import PEAK_BYTES_PER_S

KERNELS = ("scatter_sorted_kernel", "scatter_add_kernel")


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s, steps = rec.info["sizes"], rec.info["steps"]
    got = rec.kernels(KERNELS)
    n = sum(c for c, _ in got.values())
    seconds = sum(t for _, t in got.values())
    if n != 2 * steps or seconds <= 0:
        return None
    ids = s["B"] * s["L"] + s["B"] * (1 + s["n_neg"])
    nbytes = ids * (4 + 2 * s["D"]) + 2 * s["n_items"] * s["D"] * 2
    return 100.0 * steps * nbytes / PEAK_BYTES_PER_S / seconds
