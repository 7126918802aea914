"""Hyperparameter sweeps (the port's copy of unirec_tpu/facility/sweep.py).

The reference drives sweeps through a W&B agent (main.py:471-484,
examples/training/wandb.yaml). ``run_sweep`` consumes the same sweep-yaml shape
(``method``: grid / random, ``metric``: {name, goal}, ``parameters``: values
lists or {min, max} ranges) but runs locally: each trial is a full
``main.run`` with the sampled overrides, results stream to
``sweep_results.tsv``, and the best config is returned/printed. When wandb is
installed and ``use_wandb`` is set, each trial additionally logs there; without
the package the sweep warns once and runs its trials with ``use_wandb`` 0, as
the trainer does. ``device`` among the base arguments (``cpu``) passes to every
trial; the trials run on the CUDA card otherwise.
"""
from __future__ import annotations

import importlib.util
import itertools
import logging
import os
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np


def _param_space(params: Dict[str, Any]):
    names, choices, ranges = [], [], {}
    for name, spec in params.items():
        if isinstance(spec, dict) and "values" in spec:
            names.append(name)
            choices.append(list(spec["values"]))
        elif isinstance(spec, dict) and "min" in spec and "max" in spec:
            ranges[name] = (float(spec["min"]), float(spec["max"]),
                            isinstance(spec["min"], int) and isinstance(spec["max"], int))
        else:
            names.append(name)
            choices.append([spec])
    return names, choices, ranges


def _iter_trials(sweep: Dict[str, Any], n_trials: int,
                 seed: int) -> Iterator[Dict[str, Any]]:
    method = sweep.get("method", "grid")
    names, choices, ranges = _param_space(sweep.get("parameters", {}))
    rng = np.random.default_rng(seed)
    if method == "grid":
        if ranges:
            raise ValueError("grid sweeps need discrete 'values' for every "
                             f"parameter; ranges given for {sorted(ranges)}")
        for combo in itertools.product(*choices):
            yield dict(zip(names, combo))
    else:  # random (the 'bayes' method degrades to random here)
        for _ in range(n_trials):
            trial = {n: c[rng.integers(len(c))] for n, c in zip(names, choices)}
            for n, (lo, hi, is_int) in ranges.items():
                v = rng.uniform(lo, hi)
                trial[n] = int(round(v)) if is_int else float(v)
            yield trial


def run_sweep(sweep_file: str, base_args: Dict[str, Any],
              n_trials: int = 20) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    import yaml

    from unirec_tpu_torch.main import main as main_mod

    if int(base_args.get("use_wandb", 0) or 0) and importlib.util.find_spec("wandb") is None:
        logging.getLogger("unirec_tpu_torch").warning("wandb unavailable; disabling")
        base_args = dict(base_args, use_wandb=0)
    with open(sweep_file) as f:
        sweep = yaml.safe_load(f)
    metric = sweep.get("metric", {})
    metric_name = str(metric.get("name", "ndcg@5")).split("/")[-1]
    maximize = metric.get("goal", "maximize") != "minimize"
    out_path = base_args.get("output_path", "./sweep")
    os.makedirs(out_path, exist_ok=True)
    results_file = os.path.join(out_path, "sweep_results.tsv")

    records: List[Dict[str, Any]] = []
    best = None
    seed = int(base_args.get("seed", 2022))
    with open(results_file, "w") as rf:
        header_written = False
        for i, trial in enumerate(_iter_trials(sweep, n_trials, seed)):
            args = dict(base_args)
            args.update(trial)
            args["exp_name"] = f"{base_args.get('exp_name', 'sweep')}-t{i}"
            args["output_path"] = os.path.join(out_path, f"trial_{i}")
            result = main_mod.run(args) or {}
            score = result.get(metric_name, float("nan"))
            rec = {"trial": i, **trial, metric_name: score}
            records.append(rec)
            if not header_written:
                rf.write("\t".join(rec.keys()) + "\n")
                header_written = True
            rf.write("\t".join(str(v) for v in rec.values()) + "\n")
            rf.flush()
            if np.isfinite(score) and (
                    best is None or
                    (score > best[metric_name]) == maximize):
                best = rec
    return best, records
