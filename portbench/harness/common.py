"""What every run of the benchmark shares: the files a cell is made of, the
card's peaks, the result line, the import check and the formulas of the
configuration files.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
and a traffic mix; the harness finds ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and, for each per-layer
metric, ``metrics/<metric>.py`` under this folder by name, so a new cell or
metric is new files and entries, never an edit.
"""
from __future__ import annotations

import ast
import json
import math
import operator
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# one NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores, HBM3
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "unirec_tpu")


def load_benchmark(path: Optional[Path] = None) -> Dict[str, Any]:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The workload entry ``name`` with its configuration entry, and the
    configuration, traffic and limits files it names."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    return {"cell": cell, "config_entry": entry,
            "config": load_json(ROOT / entry["file"]),
            "traffic": load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
            "limits_path": BENCH_DIR / "limits" / f"{name}.json"}


def cell_metrics(bench: Dict[str, Any], name: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    (those without ``workloads`` and those that list it), or with ``trace``
    its per-layer ones (those that list it, and those without ``workloads``
    whose ``moves`` it reports)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ((name in m["workloads"]) if "workloads" in m else m["moves"] in moved)]


# ----------------------------------------------------------------- formulas
_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv, ast.Pow: operator.pow,
        ast.USub: operator.neg}


def formula(expr: str, sizes: Dict[str, float]) -> float:
    """The value of an arithmetic formula over the named sizes (+ - * / //
    ** and ceil8(x), the next multiple of 8); nothing else is evaluated."""
    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.Name):
            return sizes[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "ceil8" \
                and len(node.args) == 1:
            return int(math.ceil(ev(node.args[0]) / 8) * 8)
        raise ValueError(f"unsupported formula element: {ast.dump(node)}")
    return float(ev(ast.parse(expr, mode="eval")))


def model_sizes(port_config: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, float]:
    """The sizes the configuration files' formulas and the metric readers
    use: L, D, F, H (heads), n_layers, n_neg, n_items, and B, the examples
    of a training step or the users of a request."""
    c = port_config
    D = int(c.get("hidden_size") or c.get("embedding_size"))
    return {"L": int(c["max_seq_len"]), "D": D, "F": int(c.get("inner_size", 256)),
            "H": int(c.get("n_heads", 2)), "n_layers": int(c.get("n_layers", 2)),
            "n_neg": int(c.get("n_sample_neg_train", 0) or 0),
            "n_items": int(c["n_items"]), "topk": int(traffic.get("topk", 0)),
            "B": int(traffic.get("batch") or traffic.get("users_per_request"))}


# ------------------------------------------------------------- the card
def card_info() -> Dict[str, Any]:
    """The card's name and power limit as nvidia-smi reads them ("" when
    it cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"smi": ""}
    return {"smi": out}


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def process_age_s() -> float:
    """Seconds since this process started (from /proc; 0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def print_result(result: Dict[str, Any]) -> None:
    """The numbers compared, beside their limits, as the last lines on
    standard error; then the result as the last line on standard output,
    its ``checks`` last."""
    print(f"correct = {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
