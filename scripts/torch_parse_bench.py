#!/usr/bin/env python3
"""Time the port's Qwen2.5-VL page parse: prefill, decode steps and pages per
hour, the twin of ``scripts/parse_bench.py`` with its modes and result keys.

    python3 scripts/torch_parse_bench.py --size 32b-int4 --native
    python3 scripts/torch_parse_bench.py --size 32b-int4 --native --batch 8 \\
        --prefill_chunk 1 --early_stop --eos_ragged linspace:16:128
    python3 scripts/torch_parse_bench.py --size 32b-int4 --native --batch 8 \\
        --continuous 16 --eos_ragged linspace:16:128 [--cont_scan] [--ab --iters 4]
    python3 scripts/torch_parse_bench.py --size tiny --device cpu \\
        --continuous 4 --batch 2 --eos_ragged 1,3

One page (``--page``, else a white 1700x2200 page) is sized as the parser
sizes it (the fixed square, or ``--native``: smart-resized into the
1280·28·28 pixel budget), given the parser's prompt, and replicated over the
batch. The default mode times ``build_generate_fns``: the fixed loop of
``--max_new_tokens`` steps, or with ``--early_stop`` the early-exit loop
(with ``--eos_ragged`` stops forced per row: an explicit comma list, one per
row, or ``linspace:LO:HI`` over the batch). ``--continuous PAGES`` serves
that many copies of the page through ``models/qwen_serve.py``'s
``continuous_generate`` (``--batch`` rows, ``--chunk`` steps per host sync,
the stops cycling over the pages; ``--cont_scan`` takes the fixed chunk
instead of the early exit), after one warm pass; ``--ab`` then runs the three
schedules of those pages (waves of ``--batch`` pages through
``build_generate_fns(prefill_chunk=1, early_stop=True)``, early-exit chunks,
fixed chunks) for one warm round and ``--iters`` rounds, the order rotating
each round, each run's tokens held equal to the waves', and reports each
schedule's median under ``ab``. Times are host wall clock ending in a device
synchronize: the smallest of ``--iters`` runs, one run in ``--continuous``
mode, medians under ``ab``.

Random weights from seed 0 are drawn on the device (``build_qwen``). The
model computes in bf16 on the card and in f32 on the CPU (``--device
cpu``, the tiny size: at most 16 new tokens, 56 px). The script prints one
JSON line and writes no file: ``BENCH_PARSE.json`` is the JAX package's
record. The JAX script's ``--record`` and ``--profile`` are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZES = ("tiny", "tiny-int8", "3b", "3b-int8", "3b-int4", "7b", "7b-int8", "32b", "32b-int8",
         "32b-int4")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", default="3b", choices=SIZES)
    parser.add_argument("--batch", type=int, default=1,
                        help="pages per generate call, or decoder rows with --continuous")
    parser.add_argument("--image_size", type=int, default=448)
    parser.add_argument("--native", action="store_true",
                        help="smart_resize the page into the 1280*28*28 pixel budget")
    parser.add_argument("--prefill_chunk", type=int, default=0,
                        help="prefill C pages at a time (token-identical; 0 = whole batch)")
    parser.add_argument("--early_stop", action="store_true",
                        help="time the early-exit loop instead of the fixed one")
    parser.add_argument("--eos_ragged", default=None, metavar="SPEC",
                        help="per-row forced stops: 'a,b,...' (one per row) or "
                        "'linspace:LO:HI' over the batch")
    parser.add_argument("--continuous", type=int, default=0, metavar="PAGES",
                        help="serve PAGES pages through the continuous-batching loop")
    parser.add_argument("--chunk", type=int, default=64,
                        help="decode steps per host sync in --continuous mode")
    parser.add_argument("--cont_scan", action="store_true",
                        help="the fixed chunk in --continuous mode instead of the early exit")
    parser.add_argument("--ab", action="store_true",
                        help="with --continuous: alternate waves, early-exit and fixed chunks "
                        "for --iters rounds and report each one's median")
    parser.add_argument("--max_new_tokens", type=int, default=1024)
    parser.add_argument("--page", default=None, help="a page image (default: a white page)")
    parser.add_argument("--iters", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch
    from PIL import Image

    from multimodal_embeddings_tpu_torch.analysis.doc_parser import (
        DocumentParser,
        preprocess_page,
        round_to_patch_grid,
        smart_resize,
    )
    from multimodal_embeddings_tpu_torch.cli.parse import make_config
    from multimodal_embeddings_tpu_torch.models.qwen_serve import continuous_generate
    from multimodal_embeddings_tpu_torch.models.qwen_vl import build_generate_fns
    from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
    from multimodal_embeddings_tpu_torch.models.weights import build_qwen, resolve_device

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    config = make_config(args.size)
    t0 = time.perf_counter()
    model = build_qwen(config, torch.bfloat16 if dev.type == "cuda" else torch.float32, dev,
                       seed=0)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sync()  # the weights are drawn on the device: this waits for the draws
    upload_s = time.perf_counter() - t0

    unit = config.vision.patch_size * config.vision.merge_size
    max_new = args.max_new_tokens
    if args.size.startswith("tiny"):
        args.image_size = unit * 2
        max_new = min(max_new, 16)
    image = (Image.open(args.page).convert("RGB") if args.page
             else Image.new("RGB", (1700, 2200), "white"))
    if args.native:
        input_h, input_w = smart_resize(image.height, image.width, factor=unit,
                                        min_pixels=unit * unit, max_pixels=1280 * 28 * 28)
    else:
        input_w, input_h = round_to_patch_grid(args.image_size, args.image_size,
                                               config.vision.patch_size,
                                               config.vision.merge_size)
    arr = preprocess_page(image, input_w, input_h)
    batch = max(1, args.batch)
    n_tokens = (input_h // unit) * (input_w // unit)
    doc = DocumentParser(model, ByteTokenizer(), device=dev)
    ids = doc.build_prompt_ids(n_tokens, config.text.max_len - max_new)
    prompt_len = ids.shape[1]

    force_steps = None
    if args.eos_ragged:
        if args.eos_ragged.startswith("linspace:"):
            _, lo, hi = args.eos_ragged.split(":")
            fs = np.linspace(int(lo), int(hi), batch).round().astype(np.int32)
        else:
            fs = np.asarray([int(x) for x in args.eos_ragged.split(",")], np.int32)
            if fs.shape[0] != batch:
                raise SystemExit(f"--eos_ragged gave {fs.shape[0]} stops for batch {batch}")
        force_steps = np.clip(fs, 1, max_new)

    if args.continuous:
        n_pages = args.continuous
        pages = [(ids[0], arr[0])] * n_pages
        stops = None
        if force_steps is not None:
            stops = [int(force_steps[i % len(force_steps)]) for i in range(n_pages)]

        def serve(stats):
            out = continuous_generate(model, pages, batch=batch, max_new_tokens=max_new,
                                      chunk=args.chunk, stops=stops, stats=stats,
                                      early_exit=not args.cont_scan)
            sync()
            return out

        t0 = time.perf_counter()
        serve({})  # warm pass (the first launches build the kernels)
        warm_s = time.perf_counter() - t0
        stats: dict = {}
        outs = serve(stats)
        assert len(outs) == n_pages
        wall = stats["wall_s"]
        useful = sum(min(s, max_new) for s in stops) if stops is not None else n_pages * max_new
        ideal_steps = (sum(min(max(s, 1), max_new) for s in stops) if stops is not None
                       else n_pages * max_new)
        result = {
            "metric": (
                f"Qwen2.5-VL-{args.size} CONTINUOUS batch parse ({n_pages} pages through "
                f"{batch} rows, chunk {args.chunk}, prompt {prompt_len} tokens incl. "
                f"{n_tokens} image tokens @ {input_w}x{input_h}, max {max_new} new tokens, "
                f"per-row exit + refill)"
                + (f" [ragged EOS {args.eos_ragged}]" if args.eos_ragged else "")
            ),
            "size": args.size,
            "mode": "continuous",
            "pages": n_pages,
            "batch": batch,
            "chunk": args.chunk,
            "early_exit": not args.cont_scan,
            "input_wh": [input_w, input_h],
            "prompt_len": int(prompt_len),
            "max_new_tokens": int(max_new),
            "wall_s": round(wall, 2),
            "pages_per_hour": round(n_pages * 3600.0 / wall, 1),
            "useful_tokens_per_sec": round(useful / wall, 1),
            "decode_steps_executed": stats["decode_steps"],
            "ideal_row_steps": int(-(-ideal_steps // batch)),
            "splice_s": round(stats["splice_s"], 2),
            "chunks": stats["chunks"],
            "warm_pass_s": round(warm_s, 1),
            "init_s": round(init_s, 1),
            "weights_upload_s": round(upload_s, 1),
            "device": str(dev),
        }
        if stops is not None:
            result["eos_ragged"] = {"spec": args.eos_ragged,
                                    "stops_cycle": force_steps.tolist()}
        if args.ab:
            result["ab"] = alternate(model, pages, stops, batch, max_new, args, dev, sync)
        print(json.dumps(result))
        return 0

    tok = torch.from_numpy(np.tile(ids, (batch, 1))).long().to(dev)
    px = torch.from_numpy(np.tile(arr, (batch, 1, 1, 1))).to(dev)
    force = None if force_steps is None else torch.from_numpy(force_steps).to(dev)
    prefill, decode = build_generate_fns(model, prompt_len, max_new,
                                         early_stop=args.early_stop,
                                         prefill_chunk=args.prefill_chunk)

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        return out, time.perf_counter() - t0

    # the first calls build the kernels
    (last, caches, delta), prefill_first_s = timed(prefill, tok, px)
    _, decode_first_s = timed(decode, last, caches, delta, force)
    del caches
    pre_ts, dec_ts = [], []
    for _ in range(max(1, args.iters)):
        (last, caches, delta), s = timed(prefill, tok, px)
        pre_ts.append(s)
        _, s = timed(decode, last, caches, delta, force)
        dec_ts.append(s)
        del caches
    prefill_s, decode_s = min(pre_ts), min(dec_ts)
    if force_steps is not None:
        useful = int(np.sum(force_steps))
        tok_per_s = useful / decode_s
    else:
        useful = batch * max_new
        tok_per_s = batch * max_new / decode_s
    page_s = prefill_s + decode_s
    if args.early_stop and args.eos_ragged:
        loop = "early-exit decode loop)"
    elif args.early_stop:
        loop = "early-exit decode loop, no-exit worst case)"
    else:
        loop = "fixed decode loop)"
    result = {
        "metric": (f"Qwen2.5-VL-{args.size} page parse (batch {batch}, prompt {prompt_len} "
                   f"tokens incl. {n_tokens} image tokens @ {input_w}x{input_h}, {max_new} "
                   f"new tokens, greedy " + loop),
        "size": args.size,
        "batch": batch,
        "input_wh": [input_w, input_h],
        "prompt_len": int(prompt_len),
        "max_new_tokens": int(max_new),
        "prefill_ms": round(prefill_s * 1e3, 1),
        "decode_tokens_per_sec": round(tok_per_s, 2),
        "ms_per_token": round(decode_s * 1e3 / (batch * max_new), 3),
        "ms_per_step": round(decode_s * 1e3 / max_new, 3),
        "page_seconds": round(page_s / batch, 3),
        "pages_per_hour": round(batch * 3600.0 / page_s, 1),
        "init_s": round(init_s, 1),
        "weights_upload_s": round(upload_s, 1),
        # the port compiles nothing: the first calls' seconds (kernel builds
        # included) stand where the JAX script reports its compiles
        "compile_s": [round(prefill_first_s, 1), round(decode_first_s, 1)],
        "device": str(dev),
    }
    if force_steps is not None:
        result["eos_ragged"] = {
            "spec": args.eos_ragged,
            "force_steps": force_steps.tolist(),
            "useful_tokens": int(useful),
            "max_stop": int(force_steps.max()),
            "decode_wall_ms": round(decode_s * 1e3, 1),
        }
        result["metric"] += f" [ragged EOS {args.eos_ragged}]"
    print(json.dumps(result))
    return 0


def alternate(model, pages, stops, batch, max_new, args, dev, sync) -> dict:
    """The three schedules of ``pages`` (waves, early-exit chunks, fixed
    chunks), one warm round and ``--iters`` rounds, the order rotating each
    round; each run's tokens must equal the waves'. Returns each schedule's
    median seconds, runs, pages per hour and decode steps."""
    import numpy as np
    import torch

    from multimodal_embeddings_tpu_torch.models.qwen_serve import continuous_generate
    from multimodal_embeddings_tpu_torch.models.qwen_vl import build_generate_fns

    n = len(pages)
    prefill, decode = build_generate_fns(model, len(pages[0][0]), max_new, early_stop=True,
                                         prefill_chunk=1)

    def waves():
        outs = []
        for w in range(0, n, batch):
            tok = torch.from_numpy(np.stack([p[0] for p in pages[w : w + batch]])).long()
            px = torch.from_numpy(np.stack([p[1] for p in pages[w : w + batch]]))
            force = (None if stops is None else
                     torch.tensor(stops[w : w + batch], dtype=torch.int32, device=dev))
            last, caches, delta = prefill(tok.to(dev), px.to(dev))
            outs.extend(decode(last, caches, delta, force).cpu().numpy())
            del caches
        return outs, None

    def continuous(early):
        def run():
            stats = {}
            outs = continuous_generate(model, pages, batch=batch, max_new_tokens=max_new,
                                       chunk=args.chunk, stops=stops, stats=stats,
                                       early_exit=early)
            return outs, stats["decode_steps"]
        return run

    schedules = {"waves": waves, "early_exit": continuous(True), "fixed": continuous(False)}
    walls = {name: [] for name in schedules}
    steps = {}
    want = None
    order = list(schedules)
    for r in range(max(1, args.iters) + 1):
        for name in order:
            sync()
            t0 = time.perf_counter()
            outs, steps[name] = schedules[name]()
            sync()
            wall = time.perf_counter() - t0
            want = outs if want is None else want
            if not all(np.array_equal(a, b) for a, b in zip(outs, want)):
                raise SystemExit(f"--ab: {name}'s tokens differ from the waves'")
            if r:
                walls[name].append(wall)
        order = order[1:] + order[:1]
    return {name: {"median_s": statistics.median(w), "runs_s": w,
                   "pages_per_hour": n * 3600.0 / statistics.median(w),
                   "decode_steps": steps[name]}
            for name, w in walls.items()}


if __name__ == "__main__":
    raise SystemExit(main())
