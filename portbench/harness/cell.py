"""One run of one cell: its context, its per-layer readers and its verdict."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from harness import common


@dataclass
class Context:
    """What a run is given: the cell's files, the seed, the window's length,
    whether it traces, the device, its temporary folder, and the clocks from
    which setup_s is taken."""
    name: str
    files: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    tmpdir: str
    metrics: List[Dict[str, Any]]
    t_top: float = 0.0           # perf_counter when the process's first line ran
    age_top: float = 0.0         # the process's age then
    limits: Optional[Dict[str, float]] = None
    hooks: Dict[str, Callable] = field(default_factory=dict)   # faults planted by tests

    @property
    def config(self) -> Dict[str, Any]:
        return self.files["config"]

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.files["traffic"]

    def setup_s(self, t_first: float) -> float:
        return self.age_top + (t_first - self.t_top)


def load_limits(path) -> Optional[Dict[str, float]]:
    try:
        with open(path) as f:
            return json.load(f)["limits"]
    except FileNotFoundError:
        return None


def reference(config_file: Dict[str, Any]):
    """The configuration's plain reference, ``reference/<name>.py`` by the
    name its file gives."""
    return importlib.import_module(f"reference.{config_file['reference']}")


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(records)``."""
    path = common.BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(ctx: Context, rec) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of the cell that its reader found, with its
    unit; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in ctx.metrics:
        value = reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def verdict(readings: Dict[str, float], limits: Optional[Dict[str, float]]):
    """(correct, checks): each number its limits file compares, beside its
    limit. A run without limits, or without a number they name, is not
    correct."""
    if not limits:
        return False, {k: {"value": v, "limit": None} for k, v in readings.items()}
    checks = {k: {"value": readings.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def with_hooks(ctx: Context, run, body):
    """``body(ctx, run)`` with the fault a test planted in ``ctx.hooks``
    under the program for its length."""
    mend = ctx.hooks["program"](run) if "program" in ctx.hooks else None
    try:
        return body(ctx, run)
    finally:
        if mend is not None:
            mend()


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev) -> int:
    import torch
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
