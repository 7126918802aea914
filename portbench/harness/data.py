"""The general generator of every traffic mix: histories, training rows and
serving requests from the parameters of a traffic file and the run's seed.

Item ids are ``uniform`` over [1, n_items) or ``zipf`` (exponent ``zipf_s``)
over a seeded permutation of those ids, so the popular items differ from
seed to seed while every seed has the same popularity curve. History
lengths are uniform over [lo, hi). Users of training rows are uniform over
[1, n_users); a serving client walks a seeded permutation of the users.
Everything is drawn with one torch generator on the run's device, in a few
large calls, then handed to the program as the host arrays its entry
points take.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


class Draws:
    """A seeded torch generator on ``device`` and the draws made from it."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def items(self, n: int, n_items: int, dist: Dict[str, Any], perm: torch.Tensor):
        """``n`` item ids in [1, n_items) under ``dist``."""
        if dist["kind"] == "uniform":
            return torch.randint(1, n_items, (n,), generator=self.gen, device=self.device)
        if dist["kind"] != "zipf":
            raise ValueError(f"unknown item distribution {dist['kind']}")
        m = n_items - 1
        w = torch.arange(1, m + 1, device=self.device, dtype=torch.float64) ** -float(dist["s"])
        cdf = torch.cumsum(w, 0)
        cdf = (cdf / cdf[-1]).float()
        u = torch.rand((n,), generator=self.gen, device=self.device)
        rank = torch.searchsorted(cdf, u).clamp_(max=m - 1)
        return perm[rank]

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device)


def histories(draws: Draws, n_users: int, n_items: int, traffic: Dict[str, Any],
              perm: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """(items [n_users, cap] int32, right-padded with 0; lengths [n_users])."""
    cap = int(traffic["history_capacity"])
    lo, hi = traffic["history_length"]
    lens = torch.randint(int(lo), int(hi), (n_users,), generator=draws.gen,
                         device=draws.device)
    ids = draws.items(n_users * cap, n_items, traffic["items"], perm).view(n_users, cap)
    ids = ids * (torch.arange(cap, device=draws.device)[None, :] < lens[:, None])
    return ids.to(torch.int32).cpu().numpy(), lens.to(torch.int32).cpu().numpy()


def setup_draws(seed: int, device, port_config: Dict[str, Any],
                traffic: Dict[str, Any]) -> Dict[str, Any]:
    """Everything a run's traffic needs, from its seed: the histories, their
    item popularity, and the training rows or the serving order."""
    draws = Draws(seed, device)
    n_users, n_items = int(port_config["n_users"]), int(port_config["n_items"])
    perm = draws.permutation(n_items - 1) + 1
    hist_items, hist_lens = histories(draws, n_users, n_items, traffic, perm)
    live = np.arange(hist_items.shape[1])[None, :] < hist_lens[:, None]
    popularity = np.bincount(hist_items[live], minlength=n_items)[:n_items].astype(np.int64)
    popularity[0] = 0
    out = {"hist_items": hist_items, "hist_lens": hist_lens, "popularity": popularity}
    if traffic["kind"] == "train":
        n = int(traffic["batch"]) * int(traffic["rows_batches"])
        users = torch.randint(1, n_users, (n,), generator=draws.gen, device=draws.device)
        items = draws.items(n, n_items, traffic["items"], perm)
        out["rows"] = (users.to(torch.int32).cpu().numpy(), items.to(torch.int32).cpu().numpy())
    else:
        out["order"] = (draws.permutation(n_users - 1) + 1).cpu().numpy().astype(np.int64)
    return out
