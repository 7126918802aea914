"""Spans and the device trace of a ``--trace 1`` run.

Spans come from the benchmark's own files: ``Spans`` replaces the port's
entry points on their modules or objects, for the run only, by wrappers
that open a ``torch.profiler.record_function`` of the span's name and keep
the host clock of each call. The program's files are not touched.

``traced`` runs a window under ``torch.profiler`` (CPU and CUDA activity),
exports its Chrome trace into the run's temporary folder and reads it into
``Records``: every device operation (kernels, copies, sets) with the host
time of its launch (by the correlation id of its runtime or driver call),
every span, and the traced window. The metric readers (``metrics/``) read
only ``Records``.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

WINDOW = "portbench.window"


class Spans:
    """Wrap ``(owner, attribute, span name)`` entry points for one run."""

    def __init__(self):
        self.host: Dict[str, List[float]] = defaultdict(list)
        self._undo: List[Tuple[Any, str, Any, bool]] = []

    def wrap(self, owner, attr: str, name: str, generator: bool = False) -> None:
        import torch
        orig = getattr(owner, attr)
        had = attr in vars(owner)      # else inherited or bound: deleting restores it
        raw = vars(owner)[attr] if had else None
        host = self.host[name]

        if generator:
            def wrapped(*a, **k):
                it = orig(*a, **k)
                while True:
                    t0 = time.perf_counter()
                    with torch.profiler.record_function(name):
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                    host.append(time.perf_counter() - t0)
                    yield item
        else:
            def wrapped(*a, **k):
                t0 = time.perf_counter()
                with torch.profiler.record_function(name):
                    out = orig(*a, **k)
                host.append(time.perf_counter() - t0)
                return out

        # on a class the wrapper becomes the method (``self`` passes through)
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, raw, had))

    @contextlib.contextmanager
    def region(self, name: str):
        """A span around the caller's own code."""
        import torch
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.host[name].append(time.perf_counter() - t0)

    def unwrap(self) -> None:
        for owner, attr, orig, had in reversed(self._undo):
            if had:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.clear()


class Records:
    """What a traced window left: device operations, spans, host clocks,
    counters and the sizes of the work, for the metric readers."""

    def __init__(self, ops, launches, spans, window, host, info):
        self.ops = ops                      # [(name, start_us, dur_us, launch_us)]
        self.spans = spans                  # name -> sorted [(start_us, end_us)]
        self.w0, self.w1 = window           # the traced window, us
        self.host = host                    # name -> [host seconds of each call]
        self.info = info                    # steps, batch, sizes, flops, peak memory...
        self._starts = {n: [s for s, _ in iv] for n, iv in spans.items()}
        self.launches = launches

    # ------------------------------------------------------------- window
    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy_s(self) -> float:
        """Seconds in the window in which some device operation ran (the
        union of their intervals)."""
        iv = sorted((max(s, self.w0), min(s + d, self.w1)) for _, s, d, _ in self.ops
                    if s + d > self.w0 and s < self.w1)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start, end) us of the device's idle gaps inside the window."""
        iv = sorted((s, s + d) for _, s, d, _ in self.ops if s + d > self.w0 and s < self.w1)
        gaps, at = [], self.w0
        for s, e in iv:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.w1:
            gaps.append((at, self.w1))
        return gaps

    # -------------------------------------------------------------- spans
    def inside(self, name: str, t_us: float) -> bool:
        starts = self._starts.get(name)
        if not starts:
            return False
        i = bisect.bisect_right(starts, t_us) - 1
        return i >= 0 and self.spans[name][i][1] >= t_us

    def device_s_under(self, name: str) -> Optional[float]:
        """Device seconds of the operations launched inside span ``name``,
        or None when the span never opened."""
        if not self.spans.get(name):
            return None
        return sum(d for _, _, d, t in self.ops if self.inside(name, t)) / 1e6

    def host_s(self, name: str) -> Optional[float]:
        calls = self.host.get(name)
        return sum(calls) if calls else None

    # ------------------------------------------------------------ kernels
    def kernels(self, names) -> Dict[str, Tuple[int, float]]:
        """csrc/ kernel name -> (launches, device seconds) in the window."""
        pats = {n: re.compile(r"(?<![A-Za-z0-9_])" + re.escape(n) + r"[<(]") for n in names}
        out = {n: [0, 0.0] for n in names}
        for op, s, d, _ in self.ops:
            for n, p in pats.items():
                if p.search(op):
                    out[n][0] += 1
                    out[n][1] += d / 1e6
                    break
        return {n: (c, t) for n, (c, t) in out.items()}

    # ---------------------------------------------------------- breakdown
    def breakdown(self) -> Dict[str, List[List[Any]]]:
        """The ten device operations that took most time, and the idle time
        by the span the host was in when each gap began (innermost)."""
        by_op = defaultdict(float)
        for op, _, d, _ in self.ops:
            by_op[op[:160]] += d / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        by_span = defaultdict(float)
        names = [n for n in self.spans if n != WINDOW]
        for s, e in self.idle_gaps():
            inner, inner_len = WINDOW, float("inf")
            for n in names:
                starts = self._starts[n]
                i = bisect.bisect_right(starts, s) - 1
                if i >= 0 and self.spans[n][i][1] >= s:
                    ln = self.spans[n][i][1] - self.spans[n][i][0]
                    if ln < inner_len:
                        inner, inner_len = n, ln
            by_span[inner] += (e - s) / 1e6
        gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def read_chrome_trace(path: str):
    """(device ops, spans, the window) from an exported Chrome trace."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
    ops, spans = [], defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            ops.append((e.get("name", ""), ts, dur, launch.get(corr, ts)))
        elif cat == "user_annotation":
            ts = float(e["ts"])
            spans[e.get("name", "")].append((ts, ts + float(e.get("dur", 0.0))))
    for iv in spans.values():
        iv.sort()
    if not spans.get(WINDOW):
        raise RuntimeError("the trace holds no window span")
    window = spans[WINDOW][0]
    return ops, dict(spans), window


def traced(fn: Callable[[], None], tmpdir: str, sync: Callable[[], None]):
    """Run ``fn`` once under the profiler inside the window span; returns
    (device ops, spans, window) read from its Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            sync()
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return read_chrome_trace(path)
    finally:
        os.remove(path)
