"""Process-group bring-up (counterpart of unirec_tpu/core/distributed.py).

The JAX package calls ``jax.distributed.initialize`` and then sees every
host's devices as one mesh. The port runs one process a device on
``torch.distributed``: every process runs the same program, and
``initialize_distributed`` joins them into one process group before the
mesh (core/mesh.py) splits it into its ``data`` and ``model`` groups.

The rendezvous comes from the config's keys, as in the JAX package
(``coordinator_address`` as host:port, ``num_processes``, ``process_id``),
or else from torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``). The backend is
``cuda:nccl,cpu:gloo``, or gloo alone when the caller names the CPU. A
process group that is already up is used as it is: a caller (a test,
chip_smoke.py) may bring up gloo itself. Every group is made with a
timeout of ``GROUP_TIMEOUT``, so a collective that one rank misses fails
instead of hanging. A rank computes on ``cuda:LOCAL_RANK`` unless the
caller names another device; nothing falls back to the CPU.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from unirec_tpu_torch.utils import resolve_device

GROUP_TIMEOUT = datetime.timedelta(seconds=120)


def initialize_distributed(config: Optional[Dict[str, Any]] = None,
                           device=None) -> bool:
    """Idempotent. Returns True when the process group spans more than one
    process; with no rendezvous in the config or the environment it starts
    nothing and returns False."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    config = config or {}
    env = os.environ
    coord = config.get("coordinator_address")
    n_proc = config.get("num_processes") or env.get("WORLD_SIZE")
    pid = config.get("process_id")
    if pid is None:
        pid = env.get("RANK")
    if coord is None and n_proc is None:
        return False
    if coord is None and "MASTER_ADDR" not in env:
        raise ValueError("num_processes without coordinator_address or MASTER_ADDR")
    if n_proc is None or pid is None:
        raise ValueError("a rendezvous needs num_processes (WORLD_SIZE) and "
                         "process_id (RANK)")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo" if dev.type == "cpu" else "cuda:nccl,cpu:gloo",
        init_method=f"tcp://{coord}" if coord is not None else "env://",
        world_size=int(n_proc), rank=int(pid), timeout=GROUP_TIMEOUT)
    return dist.get_world_size() > 1


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for an unnumbered CUDA
    request (the default) while a rendezvous is configured, else the
    device as named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and (
            dist.is_initialized() or "LOCAL_RANK" in os.environ):
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(dev)


def is_main_process() -> bool:
    """Rank 0, or the only process: the one that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()
