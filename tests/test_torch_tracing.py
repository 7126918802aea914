"""unirec_tpu_torch/utils/tracing.py: the port's spans and counters.

On the CPU, under torch.profiler (CPU activity): one training step of
tests/test_torch_train.py's tiny SASRec opens every ``train.*`` and
``optim.*`` span, one fused top-k request over a catalog large enough for
the two-pass path every ``serve.*`` and ``topk.*`` span, each nested in
its parent in the exported Chrome trace; the work counters of
``fused_catalog_topk`` count exactly B, B k and B kp 16 while a profiler
runs and nothing otherwise; without a profiler no span constructs a
``record_function``; ``counters()`` reads the launch counters as the
benchmark's reader does.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_train import BENCH_MINI, _history, _trainer
from unirec_tpu_torch import config as torch_config
from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
from unirec_tpu_torch.ops import topk as TK
from unirec_tpu_torch.utils import to_device, tracing
from unirec_tpu_torch.utils.registry import get_model_class

ROOT = Path(__file__).resolve().parents[1]

TRAIN_PARENT = {"train.augment": "train.step", "train.forward": "train.step",
                "train.backward": "train.step", "train.reduce": "train.step",
                "train.update": "train.step", "optim.update": "train.update",
                "optim.moments": "optim.update", "optim.bias_correction": "optim.update",
                "optim.direction": "optim.update", "train.apply": "train.update"}
SERVE_PARENT = {"serve.catalog": "serve.request", "serve.windows": "serve.request",
                "serve.history_gather": "serve.request", "serve.to_device": "serve.request",
                "serve.tower": "serve.request", "serve.topk": "serve.request",
                "serve.fetch": "serve.request", "topk.pass1": "serve.topk",
                "topk.pass2": "serve.topk", "data.to_device": "serve.to_device",
                "model.user_emb": "serve.tower"}

# the serving request: 16 users in batches of 8, top-5 of 1,024 items, the
# histories' capacity 24: kp = 5 + 1 (the padding item) + 24 = 30 chunks of
# 16 re-scored a user, fewer than the catalog's 64 chunks (the two-pass path)
N_CATALOG, USERS, BATCH, K, CAP = 1024, 16, 8, 5, 24
KP = K + 1 + CAP


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(tmp_path):
    tr, data = _trainer(tmp_path)
    tr.init_params()
    batch = to_device(tr.mesh.pad_batch(next(iter(data))), "cpu")
    return lambda: tr.train_step(batch)


def _request():
    cfg = torch_config.parse_arguments(
        dict(BENCH_MINI, n_items=N_CATALOG, use_fused_topk=1, test_batch_size=BATCH),
        argv=[], device="cpu")
    model = get_model_class("SASRec")(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.eval()
    hist, users = _history(), np.arange(1, USERS + 1)
    return lambda: get_topk_recommendations(cfg, model, users, hist, K)


def _profiled(fn, tmp_path):
    """fn() under torch.profiler: (its result, the Chrome trace's spans as
    name -> [(start, end)] us)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((float(e["ts"]),
                                                    float(e["ts"]) + float(e["dur"])))
    return out, spans


def _nested(spans, parents):
    """Each child span lies inside some span of its parent."""
    for child, parent in parents.items():
        for s, e in spans[child]:
            assert any(ps <= s + 1e-3 and e <= pe + 1e-3 for ps, pe in spans[parent]), \
                (child, parent)


def test_a_training_step_opens_every_train_and_optim_span(tmp_path):
    step = _step(tmp_path)
    loss, spans = _profiled(step, tmp_path)
    assert torch.isfinite(loss)
    for name in ["train.step", *TRAIN_PARENT]:
        assert len(spans.get(name, [])) == 1, name
    _nested(spans, TRAIN_PARENT)


def test_a_fused_request_opens_every_serve_and_topk_span(tmp_path):
    ids, spans = _profiled(_request(), tmp_path)
    assert ids.shape == (USERS, K)
    assert len(spans["serve.request"]) == 1 and len(spans["serve.catalog"]) == 1
    assert len(spans["serve.windows"]) == USERS // BATCH + 1      # the last finds none
    for name in ("serve.history_gather", "serve.to_device", "serve.tower", "serve.topk",
                 "topk.pass1", "topk.pass2", "model.user_emb"):
        assert len(spans[name]) == USERS // BATCH, name
    assert len(spans["data.to_device"]) == 2 * USERS // BATCH
    assert len(spans["serve.fetch"]) == 1
    _nested(spans, SERVE_PARENT)


def _work():
    c = tracing.counters()
    return np.array([c["topk_users"], c["topk_selected"], c["topk_rows_rescored"]])


def test_the_work_counters_count_b_k_and_b_kp_16_only_under_a_profiler(tmp_path):
    request = _request()
    before = _work()
    request()
    assert (_work() == before).all()
    _profiled(request, tmp_path)
    np.testing.assert_array_equal(_work() - before, [USERS, USERS * K, USERS * KP * 16])


def test_the_counters_stay_on_the_function_when_its_name_is_rebound(tmp_path, monkeypatch):
    """A caller may rebind ``fused_catalog_topk`` on its module to a wrapper
    (the benchmark's span does); the counts still land on the function."""
    orig, request, before = TK.fused_catalog_topk, _request(), _work()
    monkeypatch.setattr(TK, "fused_catalog_topk", lambda *a, **k: orig(*a, **k))
    _profiled(request, tmp_path)
    monkeypatch.undo()
    np.testing.assert_array_equal(_work() - before, [USERS, USERS * K, USERS * KP * 16])


def test_the_dense_path_counts_every_row_it_scores(tmp_path):
    u = torch.randn(4, 8)
    items = torch.randn(300, 8)         # 300 <= 4 k 16: dense
    before = _work()
    _profiled(lambda: TK.fused_catalog_topk(u, items, 10), tmp_path)
    np.testing.assert_array_equal(_work() - before, [4, 40, 4 * 300])


def test_no_record_function_without_a_profiler(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function constructed with no profiler running")

    step, request = _step(tmp_path), _request()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not tracing.profiling()
    assert torch.isfinite(step())
    assert request().shape == (USERS, K)
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            step()


def test_counters_hold_the_benchmarks_launch_counters_and_reset(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "portbench_program", ROOT / "portbench" / "harness" / "program.py")
    program = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(program)
    for i, fn in enumerate(tracing._counted().values()):
        for attr in tracing._counter_attrs(fn):
            monkeypatch.setattr(fn, attr, 3 + i)     # distinct values, restored afterwards
    ours, theirs = tracing.counters(), program.launch_counters()
    assert theirs and {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"topk_users", "topk_selected", "topk_rows_rescored"}
    tracing.reset_counters()
    assert set(tracing.counters().values()) == {0}
