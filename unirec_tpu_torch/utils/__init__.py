"""Host-side helpers of the port."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from unirec_tpu_torch.utils import tracing


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one. Asking for CUDA where no card is present raises; nothing
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


def to_device(batch: Dict[str, Any], device,
              dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Host batch (arrays or scalars) -> tensors on ``device``, each cast to
    ``dtype`` when one is given (int64 for the serving path's gather
    indices), else keeping its own."""
    with tracing.span("data.to_device"):
        return {k: torch.as_tensor(np.asarray(v)).to(device=device, dtype=dtype,
                                                     non_blocking=True)
                for k, v in batch.items()}
