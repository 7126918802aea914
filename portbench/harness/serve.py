"""The serving driver: every ``"kind": "serve"`` traffic mix.

One client in a closed loop: each request is ``get_topk_recommendations``
(main/reco_topk.py, as ``reco-topk`` serves) over the next
``users_per_request`` users of a seeded order of all users, sent when the
previous one has returned its ids to the host. A request's latency is the
host clock from the call to that return. A seeded reservoir keeps a
sample of the requests the window finished; after the window the reference
scores the whole catalog for their users and judges every served id.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from harness import cell, common, compare, data, program, trace

REF_BLOCK = 1024     # users the reference scores at once


class ServeRun:
    def __init__(self, ctx: cell.Context):
        from unirec_tpu_torch.data.history import UserHistory
        t = ctx.traffic
        self.ctx, self.dev = ctx, ctx.device
        self.cfg = program.port_config(ctx.config, t, ctx.seed, ctx.tmpdir, self.dev.type)
        self.draws = data.setup_draws(ctx.seed, self.dev, self.cfg, t)
        self.model, self.W0 = program.build_model(self.cfg, ctx.seed, self.dev)
        self.model.eval()
        self.history = UserHistory(self.draws["hist_items"], self.draws["hist_lens"])
        self.per = int(t["users_per_request"])
        self.topk = int(t["topk"])
        self.order = self.draws["order"]
        self.at = 0
        self.kept: List[Any] = []
        self.seen = 0
        self.rng = np.random.default_rng([int(ctx.seed), 7])
        self.keep = int(t["sample_requests"])
        self.ref = cell.reference(ctx.config)

    def next_users(self) -> np.ndarray:
        idx = (self.at + np.arange(self.per)) % len(self.order)
        self.at = (self.at + self.per) % len(self.order)
        return self.order[idx]

    def request(self):
        from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
        users = self.next_users()
        t0 = time.perf_counter()
        ids = get_topk_recommendations(self.cfg, self.model, users, self.history, self.topk)
        return time.perf_counter() - t0, users, ids

    def sample(self, users, ids) -> None:
        """Reservoir sampling, seeded, over the requests finished so far."""
        if self.seen < self.keep:
            self.kept.append((users, ids))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.keep:
                self.kept[j] = (users, ids)
        self.seen += 1

    def window(self, seconds: float):
        cell.sync(self.dev)
        t0 = time.perf_counter()
        lat = []
        while time.perf_counter() - t0 < seconds:
            dt, users, ids = self.request()
            lat.append(dt)
            self.sample(users, ids)
        t1 = time.perf_counter()
        return t0, t1, lat

    def traced_window(self, n: int):
        from unirec_tpu_torch.data.history import UserHistory
        from unirec_tpu_torch.main import reco_topk
        from unirec_tpu_torch.ops import topk as topk_ops
        sp = trace.Spans()
        sp.wrap(reco_topk, "iter_infer_batches", "iter_infer_batches", generator=True)
        sp.wrap(UserHistory, "gather", "history_gather")
        sp.wrap(reco_topk, "to_device", "to_device")
        sp.wrap(self.model, "user_emb", "user_emb")
        sp.wrap(topk_ops, "fused_catalog_topk", "fused_catalog_topk")
        sp.wrap(reco_topk, "get_topk_recommendations", "request")
        program.reset_launch_counters()
        cell.reset_peak(self.dev)

        def loop():
            for _ in range(n):
                _, users, ids = self.request()
                self.sample(users, ids)

        try:
            ops, spans, win = trace.traced(loop, self.ctx.tmpdir, lambda: cell.sync(self.dev))
        finally:
            sp.unwrap()
        sizes = common.model_sizes(self.cfg, self.ctx.traffic)
        info = {"kind": "serve", "steps": n, "batch": self.per, "sizes": sizes,
                "flops": {k: common.formula(v, sizes)
                          for k, v in self.ctx.config["flops"].items()},
                "peak_mem_bytes": cell.peak(self.dev)}
        return trace.Records(ops, program.launch_counters(), spans, win, dict(sp.host), info)

    def free(self):
        del self.model
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, kept=None) -> Dict[str, float]:
        """Served ids of the sampled requests against the reference's
        scores: ids out of range, repeated or banned, and the widest gap
        below the k-th best score (over the row's spread)."""
        hi = torch.as_tensor(self.draws["hist_items"], device=self.dev)
        hl = torch.as_tensor(self.draws["hist_lens"], device=self.dev)
        bad, gap = 0, 0.0
        for users, ids in (self.kept if kept is None else kept):
            for lo in range(0, len(users), REF_BLOCK):
                u = torch.as_tensor(users[lo:lo + REF_BLOCK], device=self.dev)
                s = self.ref.catalog_scores(self.W0, self.cfg, u, hi, hl)
                served = torch.as_tensor(np.asarray(ids[lo:lo + REF_BLOCK]), device=self.dev)
                b, g = compare.topk_gaps(s, served, self.topk)
                bad, gap = bad + b, max(gap, g)
        return {"bad_ids": float(bad), "topk_gap": gap}


def run(ctx: cell.Context) -> Dict[str, Any]:
    return cell.with_hooks(ctx, ServeRun(ctx), _run)


def _run(ctx: cell.Context, r) -> Dict[str, Any]:
    for _ in range(int(ctx.traffic.get("warmup_requests", 2))):
        r.request()
    out: Dict[str, Any] = {}
    if ctx.trace:
        rec = r.traced_window(int(ctx.traffic["trace_requests"]))
        attempted = rec.info["steps"]
        metrics = cell.read_per_layer(ctx, rec)
        out["device_extra"] = {"busy_s": rec.busy_s(), "window_s": rec.window_s}
        out["breakdown"] = rec.breakdown()
        out["launch_counters"] = rec.launches
    else:
        t0, t1, lat = r.window(ctx.seconds)
        attempted = len(lat)
        metrics = {"serve_users_per_s": {"value": attempted * r.per / (t1 - t0),
                                         "unit": "users/s"},
                   "serve_p95_ms": {"value": float(np.percentile(np.asarray(lat) * 1e3, 95)),
                                    "unit": "ms"},
                   "setup_s": {"value": ctx.setup_s(t0), "unit": "s"}}
    out["peak"] = cell.peak(r.dev)
    r.free()
    out.update(readings=r.judge(), attempted=attempted, failed=0, metrics=metrics)
    return out
