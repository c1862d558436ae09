#!/usr/bin/env python3
"""Time the port's attention candidates at the encoder shapes of
``scripts/attn_candidates_bench.py``: the XLA-numerics path of ``sdpa``,
flash attention (K4, ``flash_attention``) and K4 on its K/V-resident
schedule (``flash_attention_v2``), bf16.

    python3 scripts/torch_attn_candidates_bench.py [--iters 20] [--device cuda]

Shapes (B, L, H, D) and valid keys, as in the JAX script: the ViT-B/16 page
tower (48, 784, 12, 64), all keys; the mmE5-2B vision chunk (8, 1608, 16, 80),
1601; the 4-tile mmE5-11B chunk (2, 6432, 16, 80), 6404. For each shape it
prints the name and one JSON line: the mean ms per call of each candidate
over ``--iters`` calls after one warm-up (CUDA events on the card, the host
clock on the CPU), the K4 launches the timing made, and the device.
``--max-len`` cuts L (keeping the number of masked keys) for a drive on the
CPU. The script writes no file: ``scripts/attn_candidates_results.json``
holds the JAX package's TPU numbers and stays as it is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_embeddings_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_v2,
)
from multimodal_embeddings_tpu_torch.models.transformer import sdpa  # noqa: E402

CASES = (
    ("siglip_vitb_448", (48, 784, 12, 64), None),
    ("mme5_vision_2b_chunk8", (8, 1608, 16, 80), 1601),
    ("mme5_vision_11b_chunk2_4tile", (2, 6432, 16, 80), 6404),
)


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after one warm-up."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def xla_sdpa(q, k, v, lengths):
    """The port's ``sdpa`` on its XLA-numerics path: a key mask (every key
    when there are no lengths) keeps it off both kernels."""
    b, l = q.shape[:2]
    valid = torch.full((b,), l, device=q.device) if lengths is None else lengths
    mask = torch.arange(l, device=q.device)[None, :] < valid[:, None]
    return sdpa(q, k, v, mask=mask[:, None, None, :])


def run(iters: int = 20, device: str = "cuda", max_len=None) -> dict:
    """Every case's JSON entry, by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    name_of_device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (b, l0, h, d), valid in CASES:
        l = l0 if max_len is None else min(l0, max_len)
        if valid is not None:
            valid = max(1, l - (l0 - valid))
        q, k, v = (torch.randn((b, l, h, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        lengths = None
        if valid is not None:
            lengths = torch.full((b,), valid, dtype=torch.int32, device=dev)
        before = (flash_attention.launches, flash_attention_v2.launches)
        entry = {
            "shape": [b, l, h, d], "valid": l if valid is None else valid,
            "sdpa_ms": time_ms(lambda: xla_sdpa(q, k, v, lengths), iters, dev),
            "flash_v1_ms": time_ms(lambda: flash_attention(q, k, v, lengths=lengths), iters, dev),
            "flash_v2_ms": time_ms(lambda: flash_attention_v2(q, k, v, lengths=lengths),
                                   iters, dev),
            "launches": {"flash_attention": flash_attention.launches - before[0],
                         "flash_attention_v2": flash_attention_v2.launches - before[1]},
            "device": name_of_device,
        }
        results[name] = entry
        print(name, json.dumps(entry), flush=True)
        del q, k, v
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--max-len", type=int, default=None,
                        help="cut every L to at most this (a drive on the CPU)")
    args = parser.parse_args(argv)
    run(args.iters, args.device, args.max_len)
    return 0


if __name__ == "__main__":
    sys.exit(main())
