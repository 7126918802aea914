"""One tiny run of each driver on the card: the kernels instead of the
plain versions, judged by the reference (skips without a card)."""
import pytest
import torch

import run
import tiny


@pytest.mark.gpu
@pytest.mark.parametrize("traffic", ["TRAIN", "SERVE"])
def test_tiny_cell_on_the_card(traffic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = {"TRAIN": {"loss_gap": 1e-2, "grad_gap": 0.1, "change_gap_median": 0.02,
                        "batch_rows_off": 0},
              "SERVE": {"bad_ids": 0, "topk_gap": 0.05}}[traffic]
    ctx = tiny.context(getattr(tiny, traffic), config={"compute_dtype": "bfloat16"},
                       limits=limits)
    ctx.device = torch.device("cuda", 0)
    res = run.run_cell(ctx)
    assert res["device"]["platform"] == "gpu"
    assert res["correct"], res["checks"]
