"""Experiment logger: per-experiment file + console handlers (copy of
unirec_tpu/utils/logger.py)."""
from __future__ import annotations

import logging
import os
import random
import string
import time
from typing import Optional


def rand_token(n: int = 6) -> str:
    return "".join(random.choice(string.ascii_lowercase + string.digits)
                   for _ in range(n))


def setup_logger(exp_name: str, out_dir: Optional[str] = None,
                 level: str = "INFO") -> logging.Logger:
    logger = logging.getLogger(exp_name)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        time_str = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(
            out_dir, f"{exp_name}.{time_str}.{rand_token()}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
