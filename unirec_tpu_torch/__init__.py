"""unirec_tpu_torch: the PyTorch/CUDA port of unirec_tpu for NVIDIA Hopper.

The JAX package ``unirec_tpu`` is the reference. This package keeps its
module layout and names (``models/modules.py`` here is the counterpart of
``unirec_tpu/models/modules.py``) and imports nothing from it: host-side
helpers are copied, and every Pallas kernel on a ported path is a CUDA C++
kernel under ``csrc/`` built for ``sm_90a``.

Ported so far: SASRec top-k serving (``reco-topk``) and user-embedding
inference (``infer-embedding``). See ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"
