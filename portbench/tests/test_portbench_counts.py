"""The operation and byte counts of the configuration files and of the
roofline readers against hand counts at one small shape."""
import importlib.util

import pytest

from harness import common


def metric_module(name):
    spec = importlib.util.spec_from_file_location(
        name, common.BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# L=4, D=8, F=16, H=2, 2 layers, 3 negatives, 10 items
SIZES = {"L": 4, "D": 8, "F": 16, "H": 2, "n_layers": 2, "n_neg": 3, "n_items": 10,
         "topk": 2, "B": 5}


def hand_forward():
    """One example's forward products, written out layer by layer."""
    L, D, F = 4, 8, 16
    full = (3 * 2 * L * D * D          # q, k, v projections of L rows
            + 2 * L * L * D            # scores over the heads
            + 2 * L * L * D            # probabilities times values
            + 2 * L * D * D            # output projection
            + 2 * L * D * F * 2)       # the FFN's two products
    last = (2 * L * D * D * 2          # k, v of L rows
            + 2 * D * D * 2            # q and the output projection of one row
            + 2 * L * D * 2            # one row's scores and values
            + 2 * D * F * 2)           # one row's FFN
    return full, last


@pytest.mark.parametrize("name", ["sasrec_d64_l50", "sasrec_d256_steam"])
def test_train_example_flops(name):
    import json
    cfg = json.loads((common.BENCH_DIR / "configs" / f"{name}.json").read_text())
    full, last = hand_forward()
    want = 3 * (full + last + 2 * 8 * (1 + 3))
    assert common.formula(cfg["flops"]["train_example"], SIZES) == want


def test_serve_user_flops():
    import json
    cfg = json.loads((common.BENCH_DIR / "configs" / "sasrec_d64_l50.json").read_text())
    full, last = hand_forward()
    assert common.formula(cfg["flops"]["serve_user"], SIZES) == full + last + 2 * 10 * 8


def test_layer_roofline_counts():
    mod = metric_module("layer_roofline")
    B, L, D, F = 5, 4, 8, 16
    full, last = hand_forward()
    ops, nbytes = mod.work("layer_fwd", B, L, D, F)
    assert ops == B * full
    w = (4 * D * D + 2 * D * F) * 2 + (4 * D + F + D) * 2 + 4 * D * 4
    assert nbytes == 2 * B * L * D * 2 + B * L * 4 + w
    assert mod.work("layer_bwd", B, L, D, F)[0] == 3 * B * full
    assert mod.work("lastq_fwd", B, L, D, F)[0] == B * last
    assert mod.work("lastq_bwd", B, L, D, F)[0] == 3 * B * last


def test_attention_roofline_counts():
    mod = metric_module("attention_roofline")
    B, L, D = 5, 4, 8
    assert mod.work(False, B, L, D) == (4 * B * L * L * D,
                                        4 * B * L * D * 2 + B * L * L * 4)
    assert mod.work(True, B, L, D) == (12 * B * L * L * D,
                                       7 * B * L * D * 2 + B * L * L * 4)


class _Rec:
    def __init__(self, kind, kernels=None, under=None, steps=3):
        self.info = {"kind": kind, "steps": steps, "sizes": SIZES, "batch": 5,
                     "flops": {}}
        self._k, self._u = kernels or {}, under

    def kernels(self, names):
        return {n: self._k.get(n, (0, 0.0)) for n in names}

    def device_s_under(self, name):
        return self._u


def test_scatter_roofline_counts():
    mod = metric_module("scatter_roofline")
    t = 1e-3
    rec = _Rec("train", {"scatter_sorted_kernel": (6, t)})
    ids = 5 * 4 + 5 * (1 + 3)
    nbytes = ids * (4 + 2 * 8) + 2 * 10 * 8 * 2
    assert mod.read(rec) == pytest.approx(100 * 3 * nbytes / common.PEAK_BYTES_PER_S / t)
    assert mod.read(_Rec("train", {"scatter_sorted_kernel": (5, t)})) is None


def test_topk_roofline_counts():
    mod = metric_module("topk_roofline")
    t = 1e-3
    bound = max(2 * 5 * 10 * 8 / common.PEAK_FLOPS_BF16,
                (10 * 8 * 2 + 5 * 8 * 2 + 5 * 2 * 8) / common.PEAK_BYTES_PER_S)
    assert mod.read(_Rec("serve", under=t)) == pytest.approx(100 * 3 * bound / t)
    assert mod.read(_Rec("serve", under=None)) is None
