#!/usr/bin/env python3
"""chip_smoke.py's sequential-family phase at several seeds, on one NVIDIA card.

    python3 tools/family_seeds.py [seed ...]      # default: 0 1000 2000

Builds the kernels, then runs ``chip_smoke.seq_family_path`` (six
main.run trainings at run_seq_benchmark.sh's options, their gates and
``seq_family_check``) once a seed, with the script's SEED set to it: the
training rows drawn, the weights and the dropout and augmentation streams
change, the data written once stays. Prints the script's JSON lines, then
``SEED_OK <seed> <seconds>`` or ``SEED_FAILED <seed> <reason>`` for each;
exits 1 if a seed failed. About 100 s a seed after a 1.5-minute build.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("family_seeds: no CUDA device", file=sys.stderr)
        return 2
    from unirec_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.smi_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build()
    print("build", time.perf_counter() - t0, flush=True)
    failed = []
    for seed in [int(a) for a in argv] or [cs.SEED, cs.SEED + 1000, cs.SEED + 2000]:
        cs.SEED = seed
        t0 = time.perf_counter()
        try:
            cs.seq_family_path(torch, card)
            print("SEED_OK", seed, time.perf_counter() - t0, flush=True)
        except AssertionError as e:
            failed.append(seed)
            print("SEED_FAILED", seed, str(e)[:3000], flush=True)
    print("FAILED_SEEDS", failed, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
