#!/usr/bin/env python3
"""The benchmark of unirec_tpu_torch, the PyTorch/CUDA port, on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. ``<cell>`` is an entry of ``workloads`` in
BENCHMARK.json. The run builds the port's kernels into the checkout's
``build/`` (only a checkout's first run compiles), makes its data and
weights from the seed on the card, warms up the cell's shapes, then
measures for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics)
or traces a fixed stretch of the same work (``--trace 1``: its per-layer
metrics). It then checks what the timed path produced against the plain
reference in ``reference/`` and prints, last on standard output, one JSON
line: correct, attempted, failed, metrics, device (breakdown when traced),
checks. The numbers compared, each beside its limit, are the last lines of
standard error.

It exits non-zero without a result when no CUDA card (or fewer than the
cell asks for) is visible, and when JAX, jaxlib, flax or the JAX package
unirec_tpu is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

from harness import cell, common  # noqa: E402


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    age_top = common.process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    bench = common.load_benchmark()
    files = common.cell_files(bench, args.workload)

    import torch
    chips = int(files["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from harness import program
    program.build_kernels()
    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = cell.Context(name=args.workload, files=files, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device=torch.device("cuda", 0), tmpdir=tmpdir,
                           metrics=common.cell_metrics(bench, args.workload, bool(args.trace)),
                           t_top=T_TOP, age_top=age_top,
                           limits=cell.load_limits(files["limits_path"]))
        result = run_cell(ctx)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    bad = common.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    if "launch_counters" in result:
        print(json.dumps({"launch_counters": result.pop("launch_counters")}), flush=True)
    common.print_result(result)
    return 0


def run_cell(ctx: cell.Context) -> dict:
    """One run of the cell in ``ctx``: its driver by the traffic's kind, then
    the verdict and the result line's fields."""
    import torch
    if ctx.traffic["kind"] == "train":
        from harness import train as driver
    else:
        from harness import serve as driver
    out = driver.run(ctx)
    correct, checks = cell.verdict(out["readings"], ctx.limits)
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": out["peak"]}
    device.update(common.card_info() if dev.type == "cuda" else {})
    device.update(out.get("device_extra", {}))
    result = {"correct": bool(correct) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    if "launch_counters" in out:
        result["launch_counters"] = out["launch_counters"]
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
