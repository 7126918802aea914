"""The readers of the program's spans and counters on hand-built Records:
device time launched inside a span, the device's idle time cut against
span intervals (a gap that begins before a span counts from the span's
start; overlapping spans count once), None where a span never opened,
and pass 2's share of useful rows from the program's counters."""
import importlib.util

import pytest

from harness import common, trace


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, common.BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# a 100 us window, 2 steps: the device runs [0, 10), [40, 50) and [90, 95)
# (launched at 1, 35 and 80), so it idles in [10, 40), [50, 90), [95, 100)
OPS = [("a", 0.0, 10.0, 1.0), ("b", 40.0, 10.0, 35.0), ("c", 90.0, 5.0, 80.0)]


def records(kind, spans):
    spans = dict(spans, **{trace.WINDOW: [(0.0, 100.0)]})
    return trace.Records(OPS, {}, spans, (0.0, 100.0), {},
                         {"kind": kind, "steps": 2, "batch": 4, "sizes": {}, "flops": {}})


def test_device_time_launched_inside_a_span():
    rec = records("train", {"train.forward": [(0.0, 5.0)], "train.backward": [(30.0, 38.0)]})
    assert reader("forward_ms")(rec) == pytest.approx(1e3 * 10e-6 / 2)
    assert reader("backward_ms")(rec) == pytest.approx(1e3 * 10e-6 / 2)
    serve = records("serve", {"topk.pass2": [(70.0, 85.0)]})
    assert reader("pass2_ms")(serve) == pytest.approx(1e3 * 5e-6 / 2)


def test_idle_time_is_cut_against_the_span():
    # the gap [10, 40) begins before the span [30, 60) and ends inside it:
    # 10 us of it count, and 10 of the gap [50, 90)
    rec = records("train", {"train.update": [(30.0, 60.0)]})
    assert reader("update_idle_ms")(rec) == pytest.approx(1e3 * 20e-6 / 2)


def test_idle_time_under_overlapping_spans_counts_once():
    # [5, 20) and [15, 45) overlap: their union [5, 45) holds 30 us of the gap
    # [10, 40); [85, 100) holds 5 of [50, 90) and 5 of [95, 100)
    rec = records("serve", {"serve.windows": [(5.0, 20.0)],
                            "serve.history_gather": [(15.0, 45.0)],
                            "serve.to_device": [(85.0, 100.0)]})
    assert reader("prep_idle_ms.serve")(rec) == pytest.approx(1e3 * 40e-6 / 2)


@pytest.mark.parametrize("name,kind", [
    ("forward_ms", "train"), ("backward_ms", "train"), ("update_idle_ms", "train"),
    ("pass2_ms", "serve"), ("prep_idle_ms.serve", "serve")])
def test_none_where_the_span_never_opened(name, kind):
    # the benchmark's own wrapper spans do not stand in for the program's
    rec = records(kind, {"apply_update": [(0.0, 100.0)], "forward": [(0.0, 100.0)],
                         "fused_catalog_topk": [(0.0, 100.0)],
                         "iter_infer_batches": [(0.0, 100.0)]})
    assert reader(name)(rec) is None
    other = "serve" if kind == "train" else "train"
    assert reader(name)(records(other, {})) is None


def test_pass2_useful_share_is_the_counters_ratio(monkeypatch):
    from unirec_tpu_torch.ops import topk as TK
    read = reader("pass2_useful_share")
    rec = records("serve", {})
    monkeypatch.setattr(TK.fused_catalog_topk, "selected", 4096 * 100)
    monkeypatch.setattr(TK.fused_catalog_topk, "rows_rescored", 4096 * 301 * 16)
    assert read(rec) == pytest.approx(100.0 * 100 / 4816)
    assert read(records("train", {})) is None
    monkeypatch.setattr(TK.fused_catalog_topk, "rows_rescored", 0)
    assert read(rec) is None
