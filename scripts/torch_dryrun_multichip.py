#!/usr/bin/env python3
"""The port's twin of ``__graft_entry__.py``'s multi-chip dryrun, its
training and pipeline parts:

    python3 scripts/torch_dryrun_multichip.py N [--device cpu|cuda]

spawns N ranks (gloo on the CPU, the default; NCCL with ``--device cuda``,
one card a rank) and runs ``parallel/dryrun.py::dryrun`` on them: a dp×tp
``ContrastiveTrainer`` step on ``DualEncoderConfig.tiny()`` (tp = 2 where N
is even) and a 4-layer LlamaBlock stack pipelined over 4, 2 or 1 stages,
held to the sequential stack within 1e-4. Prints one summary line, as the
JAX dryrun does; a failing rank fails the run. The serving and parse parts
of the JAX dryrun are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_embeddings_tpu_torch.core.mesh import launch  # noqa: E402
from multimodal_embeddings_tpu_torch.parallel.dryrun import dryrun  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, help="number of ranks")
    parser.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = parser.parse_args(argv)
    res = launch(dryrun, args.n, args.device, device=args.device)[0]
    print(f"dryrun_multichip ok: mesh={res['mesh']} params={res['params']:,} "
          f"loss={res['loss']:.4f} pp_stages={res['pp_stages']} "
          f"pp_max_err={res['pp_max_err']:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
