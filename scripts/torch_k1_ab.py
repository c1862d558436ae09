#!/usr/bin/env python3
"""Time K1 of two checkouts of the PyTorch port on one NVIDIA GPU, in turns.

    python3 scripts/torch_k1_ab.py parent=<dir> change=<dir> \
        parent change change parent ...

Each ``label=<dir>`` names a tree holding ``multimodal_embeddings_tpu_torch``;
the remaining arguments give the order of the runs. Every run is a fresh
process that builds that tree's kernels into its own directory and prints
the median of 25 launches (CUDA events, after 3 warm-up launches) of
``encoder_attention_blf`` at the ViT page's shape (48, 784, 768), H=12, and
of ``encoder_attention_blf_packed`` at the PSA shape (30, 1024, 576),
4×(36|36|72), both bf16. Two versions compare only within one call, on one
card, alternating.
"""

import os
import subprocess
import sys
import tempfile

ONE = r'''
import statistics, torch
from multimodal_embeddings_tpu_torch.kernels import encoder_attention as k1
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn((48, 784, 768), generator=g, device="cuda").bfloat16() for _ in range(3))
qkv = torch.randn((30, 1024, 576), generator=g, device="cuda").bfloat16()
def med(fn, n=25):
    for _ in range(3):
        fn()
    t = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record(); e.synchronize(); t.append(s.elapsed_time(e))
    return statistics.median(t)
print("RESULT", med(lambda: k1.encoder_attention_blf(q, k, v, heads=12)),
      med(lambda: k1.encoder_attention_blf_packed(qkv, 4, 36, 72)))
'''


def main(argv) -> int:
    trees = dict(a.split("=", 1) for a in argv if "=" in a)
    order = [a for a in argv if "=" not in a]
    with tempfile.TemporaryDirectory() as build_root:
        for label in order:
            tree = os.path.abspath(trees[label])
            env = dict(os.environ, PYTHONPATH=tree,
                       MMTPU_TORCH_BUILD_DIR=os.path.join(build_root, label))
            out = subprocess.run([sys.executable, "-c", ONE], env=env, cwd=tree,
                                 capture_output=True, text=True, check=True).stdout
            vit, psa = map(float, out.split("RESULT")[1].split())
            print(f"{label}: vit {vit:.3f} ms psa {psa:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
