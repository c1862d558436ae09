#!/usr/bin/env python3
"""Time encoder-attention layout variants of the port in one mini block
(q/k/v projection, attention, out projection, bf16): the PyTorch twin of
``scripts/enc_attn_blhd_probe.py``, with its variants, shapes and JSON line.

    python3 scripts/torch_enc_attn_blhd_probe.py --variant <name> [--shape vit|psa]

Variants, each on the port's kernels (K1 is one CUDA kernel reading q/k/v
through (batch, row, head) strides, so the TPU layout-legality questions of
the JAX probe do not arise; what is left is where the copies fall):

  xla         — projections to (B, L, H, D), ``sdpa`` on its XLA-numerics path
  bhld        — (B, L, H, D) projections transposed to contiguous (B, H, L, D)
                copies, ``encoder_attention(bhld_inputs=True)``
  blhd_static — (B, L, H, D) projections, ``encoder_attention_blhd``
  blhd_grid   — the same call (one kernel serves both JAX layouts)
  proj_bhld   — projections straight to (B, H, L, D) with ``torch.einsum``,
                ``encoder_attention(bhld_inputs=True)`` on them, the out
                projection contracting from (B, H, L, D)
  blf         — plain matmuls to (B, L, H·D), ``encoder_attention_blf``
  blf_packed  — one matmul to a per-head [q|k|v] slab,
                ``encoder_attention_blf_packed``

Shapes: ``vit`` (B, L, H, D, Dv) = (48, 784, 12, 64, 64); ``psa`` (30, 1024,
4, 64, 128), q/k at half the value width. The inputs are the JAX probe's:
numpy ``default_rng(0)`` in the same order, cast to bf16. Prints one JSON
line: variant, shape, dims, the mean ms of a block over ``--iters`` calls
after one warm-up (CUDA events on the card, the host clock on the CPU), the
K1 launches the timing made, and the device. ``--batch`` cuts B for a drive
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_embeddings_tpu_torch.kernels import encoder_attention as k1  # noqa: E402
from multimodal_embeddings_tpu_torch.models.transformer import sdpa  # noqa: E402
from scripts.torch_attn_candidates_bench import time_ms  # noqa: E402

VARIANTS = ("xla", "bhld", "blhd_static", "blhd_grid", "proj_bhld", "blf", "blf_packed")
SHAPES = {"vit": (48, 784, 12, 64, 64), "psa": (30, 1024, 4, 64, 128)}
COUNTERS = {
    "encoder_attention": k1.encoder_attention,
    "encoder_attention_bhld": k1.encoder_attention.bhld,
    "encoder_attention_blhd": k1.encoder_attention_blhd,
    "encoder_attention_blf": k1.encoder_attention_blf,
    "encoder_attention_blf_packed": k1.encoder_attention_blf_packed,
}


def inputs(shape: str, device, batch=None):
    """x (B, L, C) and the weights wq, wk (C, H, D), wv (C, H, Dv), wo (H,
    Dv, C), wqkv (C, H·(2D + Dv)), bf16, drawn as the JAX probe draws them;
    ``batch`` keeps the first rows of x."""
    b, l, h, d, dv = SHAPES[shape]
    c = h * dv
    rng = np.random.default_rng(0)

    def draw(size, div):
        return torch.from_numpy(rng.normal(size=size).astype(np.float32) / div).to(
            device=device, dtype=torch.bfloat16)

    x = draw((b, l, c), 1.0)
    weights = [draw(size, math.sqrt(c)) for size in ((c, h, d), (c, h, d), (c, h, dv),
                                                     (h, dv, c), (c, h * (2 * d + dv)))]
    return (x if batch is None else x[:batch].contiguous()), *weights


def block(variant: str, shape: str):
    """The mini block of ``variant``: a function of (x, wq, wk, wv, wo,
    wqkv) returning (B, L, C)."""
    _, _, h, d, dv = SHAPES[shape]
    c = h * dv

    def heads(x, w):  # (B, L, C) @ (C, H, D) -> (B, L, H, D)
        return (x @ w.reshape(c, -1)).view(*x.shape[:2], h, w.shape[2])

    def out_blhd(o, wo):
        return torch.einsum("blhd,hdc->blc", o, wo)

    def xla(x, wq, wk, wv, wo, wqkv):
        q, k, v = heads(x, wq), heads(x, wk), heads(x, wv)
        every_key = torch.ones(1, 1, 1, x.shape[1], dtype=torch.bool, device=x.device)
        return out_blhd(sdpa(q, k, v, mask=every_key), wo)

    def bhld(x, wq, wk, wv, wo, wqkv):
        q, k, v = (heads(x, w).transpose(1, 2).contiguous() for w in (wq, wk, wv))
        o = k1.encoder_attention(q, k, v, bhld_inputs=True)
        return out_blhd(o.transpose(1, 2), wo)

    def blhd(x, wq, wk, wv, wo, wqkv):
        return out_blhd(k1.encoder_attention_blhd(heads(x, wq), heads(x, wk), heads(x, wv)), wo)

    def proj_bhld(x, wq, wk, wv, wo, wqkv):
        q, k, v = (torch.einsum("blc,chd->bhld", x, w) for w in (wq, wk, wv))
        o = k1.encoder_attention(q, k, v, bhld_inputs=True)
        return torch.einsum("bhld,hdc->blc", o, wo)

    def blf(x, wq, wk, wv, wo, wqkv):
        q, k, v = (x @ w.reshape(c, -1) for w in (wq, wk, wv))
        return k1.encoder_attention_blf(q, k, v, heads=h) @ wo.reshape(h * dv, c)

    def blf_packed(x, wq, wk, wv, wo, wqkv):
        o = k1.encoder_attention_blf_packed(x @ wqkv, heads=h, key_dim=d, head_dim=dv)
        return o @ wo.reshape(h * dv, c)

    return {"xla": xla, "bhld": bhld, "blhd_static": blhd, "blhd_grid": blhd,
            "proj_bhld": proj_bhld, "blf": blf, "blf_packed": blf_packed}[variant]


def run(variant: str, shape: str = "vit", iters: int = 20, device: str = "cuda",
        batch=None) -> dict:
    """Time one variant; returns (and prints) its JSON line."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    args = inputs(shape, dev, batch)
    fn = block(variant, shape)
    before = {name: c.launches for name, c in COUNTERS.items()}
    ms = time_ms(lambda: fn(*args), iters, dev)
    out = {
        "variant": variant, "shape": shape,
        "dims": [args[0].shape[0], *SHAPES[shape][1:]],
        "ms": ms,
        "launches": {name: c.launches - before[name] for name, c in COUNTERS.items()
                     if c.launches != before[name]},
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variant", required=True, choices=VARIANTS)
    parser.add_argument("--shape", default="vit", choices=sorted(SHAPES))
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--batch", type=int, default=None,
                        help="keep the first B rows of x (a drive on the CPU)")
    parser.add_argument("--scratch", action="store_true",
                        help="a TPU VMEM knob of the JAX probe; accepted and ignored here")
    parser.add_argument("--hpb", type=int, default=None,
                        help="a TPU VMEM knob of the JAX probe (heads per block); "
                        "accepted and ignored here")
    args = parser.parse_args(argv)
    run(args.variant, args.shape, args.iters, args.device, args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
