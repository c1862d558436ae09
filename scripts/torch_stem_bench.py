#!/usr/bin/env python3
"""Time the detector's stem conv in its two exact forms: the stride-2 3×3
conv as ``nn.Conv2d`` runs it, and the space-to-depth rewrite that the JAX
package offers as ``DetectorConfig.s2d_stem`` (one 2×2 conv over 4·Cin
channels at half resolution, ``multimodal_embeddings_tpu/models/layers.py``).

    python3 scripts/torch_stem_bench.py [--batch 30] [--size 1024] [--variant m]
                                        [--iters 20] [--device cuda]

The defaults are stage 1's batch: the 30 views of a page at 1024 px, bf16,
DocLayout-YOLOv10-m (48 stem channels), channels-last as the detector feeds
its stem. It prints one JSON line: the largest difference of the two forms
in f32 on a small input, the mean ms per call of each form (stem conv plus
SiLU) and of the whole detector's forward with each stem, in the order
plain, s2d, s2d, plain (CUDA events on the card, the host clock on the
CPU), and the card's name and power limit. ``--batch 2 --size 64
--variant n --device cpu`` is a drive on the CPU. The script writes no file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_embeddings_tpu_torch.config import DetectorConfig  # noqa: E402
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector  # noqa: E402


def s2d_conv(conv: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (k=3, s=2, p=1) by its space-to-depth rewrite: the input's
    2×2 parity blocks as 4·Cin channels, the weight reindexed by parity,
    ``W2[o, (py, px, c), dy, dx] = W[o, c, 2dy+py, 2dx+px]`` (zero outside
    the 3×3 taps)."""
    b, c_in, h, w = x.shape
    c_out = conv.out_channels
    w2 = (
        F.pad(conv.weight, (0, 1, 0, 1))
        .reshape(c_out, c_in, 2, 2, 2, 2)  # (O, C, dy, py, dx, px)
        .permute(0, 3, 5, 1, 2, 4)
        .reshape(c_out, 4 * c_in, 2, 2)
    )
    xp = F.pad(x, (1, 1, 1, 1))
    h2, wd2 = (h + 2) // 2, (w + 2) // 2
    xs = (
        xp.reshape(b, c_in, h2, 2, wd2, 2)  # (B, C, i, py, j, px)
        .permute(0, 3, 5, 1, 2, 4)
        .reshape(b, 4 * c_in, h2, wd2)
        .contiguous(memory_format=torch.channels_last)
    )
    return F.conv2d(xs, w2, conv.bias)


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=30)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--variant", default="m")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    # exactness in f32 on a small input
    small = LayoutDetector(DetectorConfig(image_size=64, variant=args.variant),
                           dtype=torch.float32, device="cpu", seed=0)
    stem = small.model.backbone.stem.conv
    x = torch.randn(2, 3, 34, 38, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        max_abs_err = (stem(x) - s2d_conv(stem, x)).abs().max().item()

    det = LayoutDetector(DetectorConfig(image_size=args.size, variant=args.variant),
                         dtype=torch.bfloat16, device=args.device, seed=0)
    device = det.device
    model = det.model
    conv = model.backbone.stem.conv
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.rand(args.batch, args.size, args.size, 3, generator=gen, device=device)
    x = images.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    plain_forward = conv.forward

    forms = {
        "plain": lambda: F.silu(conv(x)),
        "s2d": lambda: F.silu(s2d_conv(conv, x)),
    }
    stem_ms = {"plain": [], "s2d": []}
    forward_ms = {"plain": [], "s2d": []}
    with torch.inference_mode():
        for name in ("plain", "s2d", "s2d", "plain"):
            stem_ms[name].append(time_ms(forms[name], args.iters, device))
            conv.forward = plain_forward if name == "plain" else (lambda t: s2d_conv(conv, t))
            forward_ms[name].append(
                time_ms(lambda: model(images), max(1, args.iters // 4), device))
        conv.forward = plain_forward
    print(json.dumps({
        "shape": [args.batch, 3, args.size, args.size],
        "variant": args.variant,
        "stem_channels": conv.out_channels,
        "dtype": "bfloat16",
        "s2d_max_abs_err_f32": max_abs_err,
        "stem_ms": stem_ms,
        "forward_ms": forward_ms,
        "order": ["plain", "s2d", "s2d", "plain"],
        "device": str(device),
        "card": card_line() if device.type == "cuda" else None,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
