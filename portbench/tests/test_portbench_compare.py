"""The comparisons that decide ``correct``, at hand-made values."""
import math

import pytest
import torch

from harness import cell, compare

SCORES = torch.tensor([[5.0, 4.0, 3.0, 2.0, 1.0, float("-inf")]])
STD = float(torch.tensor([5.0, 4.0, 3.0, 2.0, 1.0]).std())


@pytest.mark.parametrize("served,bad,gap", [
    ([0, 1], 0, 0.0),                 # the true top 2
    ([1, 0], 0, 0.0),                 # in any order
    ([0, 2], 0, 1.0 / STD),           # one below the 2nd best by 1
    ([0, 5], 1, 0.0),                 # a banned id
    ([0, 0], 1, 0.0),                 # a repeated id
    ([0, 7], 1, 0.0),                 # out of range
])
def test_topk_gaps(served, bad, gap):
    b, g = compare.topk_gaps(SCORES, torch.tensor([served]), 2)
    assert b == bad and g == pytest.approx(gap)


def test_leaf_gaps_use_the_larger_of_the_leaf_and_the_median():
    ref = {"big": 10.0, "mid": 2.0, "tiny": 1e-9}
    prog = {"big": 11.0, "mid": 2.0, "tiny": 0.5}
    got = compare.leaf_gaps(prog, ref, list(ref))
    assert got["leaf"] == "tiny" and got["worst"] == pytest.approx(0.5 / 2.0)
    assert got["median_gap"] == pytest.approx(0.1)
    assert compare.leaf_gaps(prog, ref, ["big", "mid"])["worst"] == pytest.approx(0.1)


def test_verdict_compares_what_the_limits_name():
    assert cell.verdict({"a": 1.0, "b": 9.0}, {"a": 1.0}) == (
        True, {"a": {"value": 1.0, "limit": 1.0}})
    assert not cell.verdict({"a": 1.0}, {"a": 0.5})[0]
    assert not cell.verdict({"a": 1.0}, None)[0]
    assert not cell.verdict({"a": math.nan}, {"a": 1.0})[0]
    assert not cell.verdict({"a": 0.0}, {"a": 1.0, "b": 1.0})[0]
