"""The training driver: every ``"kind": "train"`` traffic mix.

Set-up builds one Trainer (model, optimizer state, device pipeline) from
the seed and drives it through its first three steps by the window's own
call (``Trainer.train_step`` on ``to_device`` of the next ``RawIdBatcher``
batch, as ``Trainer.fit`` feeds it), on rows that all differ, keeping what
the comparison needs: each step's loss, the batch the device pipeline
built, the first gradient as Adam received it (its first moment over
1 - b1) and each leaf's change after the three steps. A few more steps warm
up, then the window runs steps back to back for ``seconds`` (or, traced,
``trace_steps`` steps under the profiler). After the window the program's
state is freed and the reference repeats the three steps.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from harness import cell, common, compare, data, program, trace

BATCH_KEYS = ("item_id", "item_seq", "item_seq_len")
CHECKED_STEPS = 3


def _endless(batcher):
    while True:
        yield from batcher


class TrainRun:
    def __init__(self, ctx: cell.Context):
        from unirec_tpu_torch.data.device_pipeline import RawIdBatcher
        from unirec_tpu_torch.utils import to_device
        self.ctx, self.dev, t = ctx, ctx.device, ctx.traffic
        self.cfg = program.port_config(ctx.config, t, ctx.seed, ctx.tmpdir, self.dev.type)
        self.draws = data.setup_draws(ctx.seed, self.dev, self.cfg, t)
        self.model, self.W0 = program.build_model(self.cfg, ctx.seed, self.dev)
        self.trainer = program.build_trainer(self.cfg, self.model, self.dev,
                                             self.draws["hist_items"], self.draws["hist_lens"],
                                             self.draws["popularity"])
        users, items = self.draws["rows"]
        self.batch = int(t["batch"])
        self.feed = _endless(RawIdBatcher(users, items, self.batch, seed=ctx.seed))
        self._to_device = to_device
        self.names = [n for n, _ in self.model.named_parameters()]
        self.spans = None
        self.ref = cell.reference(ctx.config)

    def step(self):
        tr = self.trainer
        if self.spans is None:
            return tr.train_step(self._to_device(tr.mesh.pad_batch(next(self.feed)), self.dev))
        with self.spans.region("feed"):
            b = self._to_device(tr.mesh.pad_batch(next(self.feed)), self.dev)
        return tr.train_step(b)

    # -------------------------------------------------------- checked steps
    def checked_steps(self) -> Dict[str, Any]:
        """The first three steps, with what the comparison reads."""
        tr, aug = self.trainer, self.trainer._augmenter
        seen = []
        orig = aug.augment

        def capture(raw, gen, rows=None):
            out = orig(raw, gen, rows=rows)
            seen.append({k: out[k].detach().clone() for k in BATCH_KEYS})
            return out

        aug.augment = capture
        raws, losses, grad_norm = [], [], None
        try:
            for i in range(CHECKED_STEPS):
                raw = next(self.feed)
                raws.append(raw)
                losses.append(tr.train_step(self._to_device(tr.mesh.pad_batch(raw), self.dev)))
                if i == 0:
                    grad_norm = {n: float((m / (1.0 - self.ref.ADAM_B1)).norm())
                                 for n, m in zip(self.names, tr.opt_state["mu"])}
        finally:
            del aug.augment
        change = {n: float((p.detach() - self.W0[n]).norm())
                  for n, p in zip(self.names, tr.params)}
        return {"raws": raws, "losses": [float(x) for x in losses], "batches": seen,
                "grad_norm": grad_norm, "change_norm": change}

    # --------------------------------------------------------------- window
    def window(self, seconds: float):
        """Steps back to back from a sync until ``seconds`` have passed;
        the window closes on the sync of the last step's loss."""
        cell.sync(self.dev)
        t0 = time.perf_counter()
        losses = []
        while True:
            losses.append(self.step())
            if time.perf_counter() - t0 >= seconds:
                break
        float(losses[-1])
        t1 = time.perf_counter()
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return t0, t1, len(losses), failed

    def traced_window(self, steps: int):
        sp = self.spans = trace.Spans()
        tr = self.trainer
        sp.wrap(tr._augmenter, "augment", "augment")
        sp.wrap(self.model, "forward", "forward")
        sp.wrap(tr, "apply_update", "apply_update")
        sp.wrap(tr, "train_step", "train_step")
        losses = []
        program.reset_launch_counters()
        cell.reset_peak(self.dev)
        try:
            ops, spans, win = trace.traced(
                lambda: losses.extend(self.step() for _ in range(steps)), self.ctx.tmpdir,
                lambda: cell.sync(self.dev))
        finally:
            sp.unwrap()
        counters = program.launch_counters()
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        sizes = common.model_sizes(self.cfg, self.ctx.traffic)
        info = {"kind": "train", "steps": steps, "batch": self.batch, "sizes": sizes,
                "flops": {k: common.formula(v, sizes)
                          for k, v in self.ctx.config["flops"].items()},
                "peak_mem_bytes": cell.peak(self.dev)}
        rec = trace.Records(ops, counters, spans, win, dict(sp.host), info)
        return rec, failed

    # ---------------------------------------------------------------- judge
    def free(self):
        del self.trainer, self.model, self.feed
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, raws, q=None, dtype=torch.float32) -> Dict[str, Any]:
        """The reference's three steps from the same weights and raw rows;
        ``q``: its precision (float32 unless a control's)."""
        hi = torch.as_tensor(self.draws["hist_items"], device=self.dev)
        hl = torch.as_tensor(self.draws["hist_lens"], device=self.dev)
        return self.ref.train(self.W0, self.cfg, raws, hi, hl, self.ctx.seed,
                              self.draws["popularity"], q=q or self.ref.F32, dtype=dtype)


def readings(names: List[str], prog: Dict[str, Any], refd: Dict[str, Any]) -> Dict[str, float]:
    """The numbers a limits file may compare: the relative gap of the first
    step's loss (``loss1_gap``) and the widest over the three steps
    (``loss_gap``); the rows of the three batches that differ from the
    reference's; the worst leaf's and the median leaf's gap of first-gradient
    norms and of change norms (leaves whose reference gradient is under a
    thousandth of the median leaf's left out of the change)."""
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], refd["losses"])]
    off = 0
    for pb, rb in zip(prog["batches"], refd["batches"]):
        bad = torch.zeros(pb["item_id"].shape[0], dtype=torch.bool, device=pb["item_id"].device)
        for k in BATCH_KEYS:
            a = pb[k].long()
            b = rb[k].long().to(a.device)
            bad |= (a != b).reshape(a.shape[0], -1).any(1)
        off += int(bad.sum())
    med = float(np.median([refd["grad_norm"][n] for n in names]))
    moved = [n for n in names if refd["grad_norm"][n] >= 1e-3 * med]
    grad = compare.leaf_gaps(prog["grad_norm"], refd["grad_norm"], names)
    change = compare.leaf_gaps(prog["change_norm"], refd["change_norm"], moved)
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps), "batch_rows_off": float(off),
            "grad_gap": grad["worst"], "grad_gap_median": grad["median_gap"],
            "change_gap": change["worst"], "change_gap_median": change["median_gap"]}


def run(ctx: cell.Context) -> Dict[str, Any]:
    return cell.with_hooks(ctx, TrainRun(ctx), _run)


def _run(ctx: cell.Context, r) -> Dict[str, Any]:
    prog = r.checked_steps()
    for _ in range(int(ctx.traffic.get("warmup_steps", 2))):
        r.step()
    cell.sync(r.dev)
    out: Dict[str, Any] = {}
    if ctx.trace:
        rec, failed = r.traced_window(int(ctx.traffic["trace_steps"]))
        attempted = rec.info["steps"]
        metrics = cell.read_per_layer(ctx, rec)
        out["device_extra"] = {"busy_s": rec.busy_s(), "window_s": rec.window_s}
        out["breakdown"] = rec.breakdown()
        out["launch_counters"] = rec.launches
    else:
        t0, t1, attempted, failed = r.window(ctx.seconds)
        metrics = {"train_examples_per_s": {"value": attempted * r.batch / (t1 - t0),
                                            "unit": "examples/s"},
                   "setup_s": {"value": ctx.setup_s(t0), "unit": "s"}}
    out["peak"] = cell.peak(r.dev)
    r.free()
    refd = r.reference(prog["raws"])
    out.update(readings=readings(r.names, prog, refd), attempted=attempted, failed=failed,
               metrics=metrics)
    return out
