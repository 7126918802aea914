#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds k] [--fault-seeds k] [--out <file>]

For each seed, in one process and at the cell's own sizes:

* ``program``: the numbers a run compares, from sound runs of the program
  (training: the three checked steps of set-up; serving: the cell's
  sampled requests out of a short window at its own load);
* ``control`` (the first ``--control-seeds`` seeds): the reference put in
  the program's place and computed in float8 e4m3, the step below the
  configurations' bfloat16, judged by the same numbers;
* each fault of harness/faults.py that the cell can have (the first
  ``--fault-seeds`` seeds), planted under the program.

One JSON line a reading on standard output (and in ``--out``). The
benchmark's own runs never run this. Needs a CUDA card, as run.py does.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import run as bench_run  # noqa: E402
from harness import cell, common, faults  # noqa: E402


def train_readings(ctx, control: bool, fault_names, detail: bool = False):
    from harness import train
    out = []
    r = train.TrainRun(ctx)
    prog = r.checked_steps()
    r.free()
    refd = r.reference(prog["raws"])
    out.append(("program", train.readings(r.names, prog, refd)))
    if detail:
        out.append(("detail", leaf_detail(r, prog, refd)))
    if control:
        ref8 = r.reference(prog["raws"], q=r.ref.Precision("fp8"))
        out.append(("control", train.readings(r.names, ref8, refd)))
    for name in fault_names:
        f = train.TrainRun(ctx)
        mend = faults.TRAIN_FAULTS[name](f)
        try:
            got = f.checked_steps()
        finally:
            mend()
        f.free()
        out.append((name, train.readings(f.names, got, refd)))
    return out


def leaf_detail(r, prog, refd, top: int = 4):
    """Each step's loss on both sides, and the leaves with the widest gaps of
    first-gradient and change norms (with their sizes), to look into a
    reading."""
    sizes = {n: int(w.numel()) for n, w in r.W0.items()}

    def worst(key):
        med = sorted(refd[key][n] for n in r.names)[len(r.names) // 2]
        gaps = {n: abs(prog[key][n] - refd[key][n]) / max(refd[key][n], med, 1e-30)
                for n in r.names}
        return [{"leaf": n, "gap": gaps[n], "prog": prog[key][n], "ref": refd[key][n],
                 "size": sizes[n]} for n in sorted(gaps, key=gaps.get, reverse=True)[:top]]

    return {"losses": [prog["losses"], refd["losses"]], "grad": worst("grad_norm"),
            "change": worst("change_norm")}


def serve_readings(ctx, control: bool, fault_names, detail: bool = False):
    from harness import serve
    out = []
    n = int(ctx.traffic["sample_requests"])
    r = serve.ServeRun(ctx)
    for _ in range(int(ctx.traffic.get("warmup_requests", 2))):
        r.request()
    for _ in range(2 * n):
        _, users, ids = r.request()
        r.sample(users, ids)
    kept = list(r.kept)
    for name in fault_names:
        mend = faults.SERVE_FAULTS[name](r)
        try:
            bad = []
            for _ in range(n):
                _, users, ids = r.request()
                bad.append((users, ids))
        finally:
            mend()
        out.append((name, bad))
    r.free()
    out = [("program", r.judge(kept))] + [(k, r.judge(v)) for k, v in out]
    if control:
        import torch
        hi = torch.as_tensor(r.draws["hist_items"], device=r.dev)
        hl = torch.as_tensor(r.draws["hist_lens"], device=r.dev)
        ctrl = []
        for users, _ in kept:
            ids = []
            for lo in range(0, len(users), serve.REF_BLOCK):
                u = torch.as_tensor(users[lo:lo + serve.REF_BLOCK], device=r.dev)
                s8 = r.ref.catalog_scores(r.W0, r.cfg, u, hi, hl, q=r.ref.Precision("fp8"))
                ids.append(r.ref.topk_ids(s8, r.topk).cpu())
            ctrl.append((users, torch.cat(ids).numpy()))
        out.append(("control", r.judge(ctrl)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--detail", action="store_true",
                    help="also each step's losses and the widest leaves (training)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench_run.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from harness import program
    program.build_kernels()
    bench = common.load_benchmark()
    files = common.cell_files(bench, args.workload)
    kind = files["traffic"]["kind"]
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
            ctx = cell.Context(name=args.workload, files=files, seed=seed, seconds=0.0,
                               trace=False, device=torch.device("cuda", 0), tmpdir=tmp,
                               metrics=[])
            names = (faults.TRAIN_FAULTS if kind == "train" else faults.SERVE_FAULTS) \
                if i < args.fault_seeds else {}
            names = [n for n in names if n != "frozen_state"]   # reads 1 by its measure
            fn = train_readings if kind == "train" else serve_readings
            got = fn(ctx, i < args.control_seeds, names, args.detail)
        for mode, reading in got:
            line = json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                               "readings": reading, "s": time.perf_counter() - t0,
                               "card": common.card_info()["smi"]})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
