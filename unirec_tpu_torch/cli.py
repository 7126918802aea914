"""Command-line entry point of the port.

    python -m unirec_tpu_torch.cli reco-topk --model_file ckpt.pkl --dataset_path ... --topk 100
    python -m unirec_tpu_torch.cli infer-embedding --model_file ckpt.pkl --node_type user ...

Counterpart of unirec_tpu/cli.py for the ported commands. Every
``--key value`` flag flows into the config dict; ``--device cpu`` runs on
the CPU (the default is the CUDA card). Checkpoints written by the JAX
package load directly.
"""
from __future__ import annotations

import sys

from unirec_tpu_torch import config as config_mod

COMMANDS = ("infer-embedding", "reco-topk")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        raise SystemExit(f"unknown command '{cmd}'. Available: {COMMANDS}")
    args = config_mod.parse_cmd_arguments(rest)
    if cmd == "infer-embedding":
        from unirec_tpu_torch.main import infer_embedding
        infer_embedding.run(args)
        return 0
    from unirec_tpu_torch.main import reco_topk
    reco_topk.do_topk_reco(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
