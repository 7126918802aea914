"""``correct`` comes out false when the timed path is broken underneath,
and when the control (the reference in float8 put in the program's place)
stands in; true on a sound tiny run. The harness's look for a card is
skipped: the drivers run the port's plain versions on CPU tensors."""
import warnings

import pytest
import torch

import control
import run
import tiny
from harness import cell, faults


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore", category=UserWarning)
    yield
    torch.set_num_threads(n)


# tiny-size limits: above the sound bf16 run's readings, below the faults'
# and the control's (readings at this size in the test below)
LIMITS = {"TRAIN": {"loss_gap": 2e-4, "grad_gap": 8e-3, "change_gap_median": 1.5e-3,
                    "batch_rows_off": 0},
          "SERVE": {"bad_ids": 0, "topk_gap": 0.02}}
BF16 = {"compute_dtype": "bfloat16"}


@pytest.mark.parametrize("traffic", ["TRAIN", "SERVE"])
def test_sound_run_is_correct(traffic):
    res = run.run_cell(tiny.context(getattr(tiny, traffic), config=BF16,
                                    limits=LIMITS[traffic]))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.TRAIN_FAULTS))
def test_training_faults_are_not_correct(fault):
    ctx = tiny.context(tiny.TRAIN, config=BF16, limits=LIMITS["TRAIN"],
                       hooks={"program": faults.TRAIN_FAULTS[fault]})
    res = run.run_cell(ctx)
    assert not res["correct"], res["checks"]


def test_altered_answer_is_not_correct():
    ctx = tiny.context(tiny.SERVE, config=BF16, limits=LIMITS["SERVE"],
                       hooks={"program": faults.altered_answer})
    try:
        res = run.run_cell(ctx)
    finally:
        from unirec_tpu_torch.ops import topk
        assert topk.fused_catalog_topk.__name__ == "fused_catalog_topk"
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("traffic", ["TRAIN", "SERVE"])
def test_the_control_is_not_correct(traffic):
    ctx = tiny.context(getattr(tiny, traffic), config=BF16, limits=LIMITS[traffic])
    fn = control.train_readings if traffic == "TRAIN" else control.serve_readings
    got = dict(fn(ctx, True, []))
    assert cell.verdict(got["program"], LIMITS[traffic])[0], got["program"]
    assert not cell.verdict(got["control"], LIMITS[traffic])[0], got["control"]
