#!/usr/bin/env python3
"""The port's twin of ``__graft_entry__.py``'s multi-chip dryrun:

    python3 scripts/torch_dryrun_multichip.py N [--device cpu|cuda]

spawns N ranks (gloo on the CPU, the default; NCCL with ``--device cuda``,
one card a rank) and runs ``parallel/dryrun.py::dryrun`` on them: a dp×tp
``ContrastiveTrainer`` step on ``DualEncoderConfig.tiny()`` (tp = 2 where N
is even); a 4-layer LlamaBlock stack pipelined over 4, 2 or 1 stages, held
to the sequential stack within 1e-4; the fused batch over the N ranks
against the page function per page (< 1e-4); the tiny mmE5 embedder
tensor-sharded over (N/2, 2) against the unsharded one (< 2e-5) and the
dp×tp split batch against the split page function (< 1e-4); the hybrid
mesh on two simulated host groups; the data-parallel parse's tokens EQUAL
to the single-device ones. Prints one summary line with the JAX dryrun's
keys in its order; a failing rank fails the run.
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
    tp = "tp=skipped"
    if res["mme5_tp_max_err"] is not None:
        tp = (f"mme5_tp_max_err={res['mme5_tp_max_err']:.2e} "
              f"dp_tp_split_max_err={res['dp_tp_split_max_err']:.2e}")
    hybrid = "hybrid=skipped" if res["hybrid_mesh"] is None else \
        f"hybrid_mesh={res['hybrid_mesh']}"
    print(f"dryrun_multichip ok: mesh={res['mesh']} params={res['params']:,} "
          f"loss={res['loss']:.4f} pp_stages={res['pp_stages']} "
          f"pp_max_err={res['pp_max_err']:.2e} serving_dp_pages={res['serving_dp_pages']} "
          f"{tp} {hybrid} dp_parse_pages={res['dp_parse_pages']} "
          f"dp_parse_token_equal={res['dp_parse_token_equal']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
