#!/usr/bin/env python3
"""Drive the PyTorch port's page programs once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: name and power limit (``nvidia-smi``), torch and CUDA
   versions; both TF32 flags are set off and printed;
2. the build: the encoder-attention kernel (K1) and the int8 weight matmul
   (K2), each compiled by its own ``nvcc`` for ``sm_90a`` from
   ``multimodal_embeddings_tpu_torch/csrc``, both started together;
3. K1 against its plain PyTorch version at the ViT page's shapes — ViT
   ``(48, 784, 768)`` H=12 in bf16 and f32, PSA ``(30, 1024, 576)``
   4×(36|36|72) in bf16 — errors against stated tolerances, the median
   time of each, of ``scaled_dot_product_attention`` on the same inputs (a
   yardstick the port never calls) and the bound;
4. the full-width ViT page: DocLayout-YOLO-m with GL-CRM over 30 views at
   1024 px and a ViT-B/16 at 448 over the top 48 regions, bf16, random
   weights from seed 0, on 3 synthetic 2200×1700 pages after one warm-up
   page; output shapes, finiteness, unit-norm embeddings, and K1's launch
   counts (12 per embed call, 1 per detect call);
5. the card against the CPU for the ViT: two of the page's crops embedded
   by the same tower in f32 on the CPU, cosine ≥ 0.999;
6. K1 with the Mllama key prefix against its plain version:
   ``(8, 1608, 16, 80)`` with 1601 valid keys in bf16 and f32, and
   ``valid_len`` ∈ {1, L−1, L} at L ∈ {17, 130, 1608};
7. K2 against its plain version at the mmE5-11B text stack's five shapes
   in bf16, one f32 shape and ragged shapes, with the bf16 cuBLAS time of
   ``x @ W_bf16`` beside it as context (not the same function);
8. the full-width mmE5 page: the same detector, then mmE5-Mllama-11B
   ``int8-mixed`` (bf16 vision tower, int8 text stack) at full width and
   depth over 48 crops at 560 px in chunks of 8, random weights from seed 0
   drawn on the card; 1 warm-up and 2 timed pages; shapes, finiteness,
   unit norms and launch counts per page (K1 with the prefix 240, K2 1680,
   K1 packed 1); the detect/vision/text split, peak memory, parameter
   bytes, and a ``torch.profiler`` breakdown of one page;
9. the card against the CPU for mmE5: the 11B widths at reduced depth,
   ``int8-mixed``, built once in f32 on the CPU from a seed, carried to the
   card in bf16 through the weight bridge; two of the page's crops,
   cosine ≥ 0.999.

It prints the card line and one JSON line of per-kernel results, then, as
the last line, ``{"ok": true, "device": {...}}``. Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# stated tolerances for K1 against its plain version on the card. Both sum
# in f32 in different orders, so a bf16 output may round to the neighbouring
# value: at most 2 bf16 steps at the output's own magnitude, and a mean that
# stays near zero (H100 runs read 1 step and a mean of 1.7e-9). Skipping the
# bf16 rounding of e, or truncating the output, moves 40-50% of the ViT
# shape's outputs, a mean of 7e-5 to 1.3e-4. f32 differs only by order.
MAX_BF16_STEPS, ATOL_BF16_MEAN = 2.0, 1e-6
ATOL_F32_MAX = 1e-5
# K2 against its plain version: both sum K products in f32 in different
# orders, and each sum is within K·2^-24·Σ|x·q| of the exact one, so an
# output may differ by twice that (times |scale|) plus, in bf16, 2 steps of
# its own rounding. Outputs that cancel to near zero make a bound in steps
# alone meaningless (H100 readings: up to 1468 steps at |y| ~ 1e-6). The
# mean error must stay under 5% of the mean bf16 step: rounding flips are
# rare, truncation would move half the outputs.
K2_MEAN_STEP_SHARE = 0.05
COSINE_MIN = 0.999  # BASELINE.json's embedding-parity target
PAGE_HW = (2200, 1700)
NUM_REGIONS = 48
TIMED_PAGES = 3
MME5_CHUNK = 8
MME5_TIMED_PAGES = 2
# H100 SXM datasheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """The least time the card could take: max(flops / peak rate of the
    type, bytes / HBM rate), in ms, and which of the two bounds it."""
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, l, n, d, dv, dtype) -> tuple:
    """K1's work over ``n`` valid keys: QK and PV products; q and o over L
    rows, k and v over the n keys read, each once."""
    import torch

    elem = torch.finfo(dtype).bits // 8
    flops = 2.0 * b * h * l * n * (d + dv)
    nbytes = elem * b * h * (l * d + n * d + n * dv + l * dv)
    return bound_ms(flops, nbytes, dtype)


def bf16_step(want):
    """The bf16 step at ``|want|`` (8 significant bits: the step in
    ``[2^(e−1), 2^e)`` is ``2^(e−8)``)."""
    import torch

    want = want.float()
    _, exp = torch.frexp(want.abs().clamp_min(2.0**-126))
    return torch.ldexp(torch.ones_like(want), exp - 8)


def bf16_steps(got, want) -> float:
    """Largest ``|got − want|`` in bf16 steps at ``|want|``."""
    return ((got.float() - want.float()).abs() / bf16_step(want)).max().item()


def card() -> str:
    import torch

    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def build(k1, k2) -> None:
    phase("2. build (one nvcc per source, started together)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        infos = list(pool.map(lambda m: m.build_info(), (k1, k2)))
    for label, info in zip(("K1", "K2"), infos):
        print(f"{label} library {info.path.name}: nvcc {info.seconds:.1f} s")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())
    print(f"build wall time {time.perf_counter() - t0:.1f} s")


def compare_attention(name, kernel, plain, library, dtype, bound) -> dict:
    """K1 against its plain version (errors, gates, median times), the
    library call's median time, and the bound."""
    import torch

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    if dtype == torch.bfloat16:
        steps = bf16_steps(got, want)
        check(steps <= MAX_BF16_STEPS, f"{name}: max err {steps} bf16 steps > {MAX_BF16_STEPS}")
        check(mean_err <= ATOL_BF16_MEAN, f"{name}: mean err {mean_err} > {ATOL_BF16_MEAN}")
        steps_note = f" ({steps:g} bf16 steps)"
    else:
        check(max_err <= ATOL_F32_MAX, f"{name}: max err {max_err} > {ATOL_F32_MAX}")
        steps_note = ""
    ms, plain_ms, library_ms = median_ms(kernel), median_ms(plain), median_ms(library)
    b_ms, b_by = bound
    print(f"{name}: max_abs_err {max_err:.3e}{steps_note} mean_abs_err {mean_err:.3e} "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms sdpa {library_ms:.3f} ms "
          f"bound {b_ms:.4f} ms ({b_by})")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def kernel_checks(k1) -> dict:
    """K1 against the plain version at the ViT page's shapes."""
    import torch
    import torch.nn.functional as F

    phase("3. K1 against its plain version (ViT page shapes)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    results = {}

    def heads(x, h):  # (B, L, H·D) → (B, H, L, D) view
        b, l, f = x.shape
        return x.view(b, l, h, f // h).transpose(1, 2)

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (
            torch.randn((48, 784, 768), generator=gen, device=dev).to(dtype)
            for _ in range(3)
        )
        results[("vit", dtype)] = compare_attention(
            f"vit (48,784,768) H=12 {dtype}",
            lambda: k1.encoder_attention_blf(q, k, v, heads=12),
            lambda: k1.encoder_attention_blf_reference(q, k, v, heads=12),
            lambda: F.scaled_dot_product_attention(heads(q, 12), heads(k, 12), heads(v, 12)),
            dtype, attention_bound(48, 12, 784, 784, 64, 64, dtype),
        )
    qkv = torch.randn((30, 1024, 576), generator=gen, device=dev).to(torch.bfloat16)
    per_head = qkv.view(30, 1024, 4, 144).transpose(1, 2)
    results["psa"] = compare_attention(
        "psa (30,1024,576) 4x(36|36|72) bf16",
        lambda: k1.encoder_attention_blf_packed(qkv, 4, 36, 72),
        lambda: k1.encoder_attention_blf_packed_reference(qkv, 4, 36, 72),
        lambda: F.scaled_dot_product_attention(
            per_head[..., :36], per_head[..., 36:72], per_head[..., 72:]
        ),
        torch.bfloat16, attention_bound(30, 4, 1024, 1024, 36, 72, torch.bfloat16),
    )

    # edges the main path does not reach (784 and 1024 are multiples of the
    # 16-row tile): ragged row tiles, a single key tile, Dv != D, operands
    # that are column slices of wider rows; f32, so indexing errors show
    worst = 0.0
    for l in (1, 17, 77, 130):
        wide = torch.randn((2, l, 3 * 40 * 2 + 3 * 56), generator=gen, device=dev)
        q, k, v = wide[..., :120], wide[..., 120:240], wide[..., 240:]
        got = k1.encoder_attention_blf(q, k, v, heads=3)
        want = k1.encoder_attention_blf_reference(q, k, v, heads=3)
        worst = max(worst, (got - want).abs().max().item())
        qkv = torch.randn((2, l, 2 * (2 * 20 + 24)), generator=gen, device=dev)
        got = k1.encoder_attention_blf_packed(qkv, 2, 20, 24)
        want = k1.encoder_attention_blf_packed_reference(qkv, 2, 20, 24)
        worst = max(worst, (got - want).abs().max().item())
    print(f"edge shapes (L = 1, 17, 77, 130; strided; Dv != D) f32: max_abs_err {worst:.3e}")
    check(worst <= ATOL_F32_MAX, f"edge shapes: max err {worst} > {ATOL_F32_MAX}")
    return results


def check_page(res, embed_dim) -> None:
    import torch

    shapes = [tuple(t.shape) for t in res]
    want = [(NUM_REGIONS, 4), (NUM_REGIONS,), (NUM_REGIONS,), (NUM_REGIONS,),
            (NUM_REGIONS, embed_dim)]
    check(shapes == want, f"output shapes {shapes} != {want}")
    check(res.valid.dtype == torch.bool and res.classes.dtype == torch.int32,
          "valid/classes dtypes")
    for name in ("boxes", "scores", "embeddings"):
        check(bool(torch.isfinite(getattr(res, name)).all()), f"non-finite {name}")
    norms = res.embeddings.norm(dim=-1)
    check(bool(((norms - 1).abs() < 1e-3).all()), f"embedding norms {norms}")
    check(bool(((res.classes >= 0) & (res.classes < 10)).all()), "class ids")
    b = res.boxes[res.valid]
    check(bool((b[:, 0] <= b[:, 2]).all() and (b[:, 1] <= b[:, 3]).all()),
          "box corners out of order")


def make_detector():
    import torch

    from multimodal_embeddings_tpu_torch.config import DetectorConfig
    from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector

    return LayoutDetector(
        DetectorConfig(image_size=1024, variant="m"),
        dtype=torch.bfloat16, device="cuda", seed=0,
    )


def make_pages(n):
    import torch

    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    return [torch.from_numpy(make_page(*PAGE_HW, seed=i)).to("cuda") for i in range(n)]


def full_slice(k1):
    """The ViT page program at full width; returns the launch counts, one
    page's crops and embeddings, and the model config."""
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.vision_encoder import (
        DualEncoderConfig,
        VisionConfig,
    )
    from multimodal_embeddings_tpu_torch.pipeline.fused import build_split_page_fn

    phase("4. full-width ViT page program")
    t0 = time.perf_counter()
    detector = make_detector()
    model_config = DualEncoderConfig(
        vision=VisionConfig(448, 16, 768, 12, 12), embed_dim=768
    )
    embedder = MultimodalEmbedder(
        EmbedderConfig(family="siglip", dtype="bfloat16"),
        model_config=model_config, device="cuda", seed=0,
    )
    fn = build_split_page_fn(
        detector, embedder, PAGE_HW, num_regions=NUM_REGIONS, embed_chunk=NUM_REGIONS
    )
    pages = make_pages(1 + TIMED_PAGES)
    torch.cuda.synchronize()
    print(f"set-up (random init, upload): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fn(pages[0])
    torch.cuda.synchronize()
    print(f"warm-up page: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    torch.cuda.reset_peak_memory_stats()
    k1.encoder_attention_blf.launches = 0
    k1.encoder_attention_blf_packed.launches = 0
    page_ms, results = [], []
    for page in pages[1:]:
        t0 = time.perf_counter()
        res = fn(page)
        torch.cuda.synchronize()
        page_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    launches = {
        "blf": k1.encoder_attention_blf.launches,
        "packed": k1.encoder_attention_blf_packed.launches,
    }
    peak = torch.cuda.max_memory_allocated()

    vit_layers = model_config.vision.layers
    check(launches["blf"] == vit_layers * TIMED_PAGES,
          f"ViT attention launches {launches['blf']} != {vit_layers}·{TIMED_PAGES}")
    check(launches["packed"] == TIMED_PAGES,
          f"PSA attention launches {launches['packed']} != {TIMED_PAGES}")
    for res in results:
        check_page(res, 768)
    print(f"ms/page {statistics.mean(page_ms):.1f} (pages: "
          + ", ".join(f"{t:.1f}" for t in page_ms) + ")")
    print(f"valid regions per page: {[int(r.valid.sum()) for r in results]}")
    print(f"K1 launches: vit {launches['blf']} psa {launches['packed']} "
          f"over {TIMED_PAGES} pages")
    print(f"peak device memory: {peak / 2**30:.2f} GiB")

    # the two halves of the same path, timed apart
    det_ms, emb_ms = [], []
    for page in pages[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *_, crops = fn.detect(page)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        embs = fn.embed(crops)
        torch.cuda.synchronize()
        det_ms.append((t1 - t0) * 1e3)
        emb_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"detect+crop {statistics.mean(det_ms):.1f} ms/page, "
          f"embed {statistics.mean(emb_ms):.1f} ms/page")
    return launches, crops, embs, model_config, detector


def card_vs_cpu(crops, embs, model_config) -> None:
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder

    phase("5. ViT: card (bf16) against the CPU (f32, plain attention)")
    cpu = MultimodalEmbedder(
        EmbedderConfig(family="siglip", dtype="float32"),
        model_config=model_config, device="cpu", seed=0,
    )
    ref = cpu.encode_image(crops[:2].float().cpu())
    got = embs[:2].float().cpu()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    print(f"cosine card vs cpu: {[round(c, 6) for c in cos.tolist()]}")
    check(bool((cos >= COSINE_MIN).all()), f"cosine {cos.tolist()} < {COSINE_MIN}")


def masked_checks(k1) -> dict:
    """K1 with the key prefix against its plain version."""
    import torch
    import torch.nn.functional as F

    phase("6. K1 with the key prefix against its plain version (Mllama shapes)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    results = {}
    b, l, h, d, n = MME5_CHUNK, 1608, 16, 80, 1601
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (
            torch.randn((b, l, h, d), generator=gen, device=dev).to(dtype) for _ in range(3)
        )
        results[dtype] = compare_attention(
            f"mllama ({b},{l},{h},{d}) valid {n} {dtype}",
            lambda: k1.encoder_attention(q, k, v, valid_len=n),
            lambda: k1.encoder_attention_reference(q, k, v, n),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2)[:, :, :n], v.transpose(1, 2)[:, :, :n]
            ),
            dtype, attention_bound(b, h, l, n, d, d, dtype),
        )
    # valid_len at its edges, Dv != D, operands that are column slices of
    # wider rows; f32, so indexing errors show
    worst = 0.0
    for l in (17, 130, 1608):
        for n in (1, l - 1, l):
            wide = torch.randn((2, l, 3 * (40 + 40 + 56)), generator=gen, device=dev)
            q = wide[..., :120].view(2, l, 3, 40)
            k = wide[..., 120:240].view(2, l, 3, 40)
            v = wide[..., 240:].view(2, l, 3, 56)
            got = k1.encoder_attention(q, k, v, valid_len=n)
            want = k1.encoder_attention_reference(q, k, v, n)
            worst = max(worst, (got - want).abs().max().item())
    print(f"edge prefixes (valid_len 1, L-1, L at L = 17, 130, 1608; strided; "
          f"Dv != D) f32: max_abs_err {worst:.3e}")
    check(worst <= ATOL_F32_MAX, f"edge prefixes: max err {worst} > {ATOL_F32_MAX}")
    return results


# (M, K, N) of the mmE5-11B text stack at 8 crops × 64 prompt tokens, and
# how often each runs per embed chunk (32 Llama + 8 cross-attention layers)
K2_SHAPES = {
    "q,o (512,4096)x(4096,4096)": ((512, 4096, 4096), 80),
    "k,v (512,4096)x(4096,1024)": ((512, 4096, 1024), 64),
    "gate,up (512,4096)x(4096,14336)": ((512, 4096, 14336), 80),
    "down (512,14336)x(14336,4096)": ((512, 14336, 4096), 40),
    "cross k,v (12808,4096)x(4096,1024)": ((12808, 4096, 1024), 16),
}
K2_HEADLINE = "gate,up (512,4096)x(4096,14336)"


def int8_checks(k2) -> dict:
    """K2 against its plain version at the text stack's shapes."""
    import torch

    phase("7. K2 against its plain version (mmE5-11B text shapes)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")

    def run(name, m, k, n, dtype, timed):
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        q = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        scale = (torch.rand((n,), generator=gen, device=dev) + 0.5) * (0.02 / 127)
        got = k2.int8_matmul(x, q, scale)
        want = k2.int8_matmul_reference(x, q, scale)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == (m, n), f"{name}: {got.dtype} {got.shape}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = (got.float() - want.float()).abs()
        order = 2 * k * 2.0**-24 * (x.float().abs() @ q.float().abs()) * scale.abs()
        allowed = order + (MAX_BF16_STEPS * bf16_step(want) if dtype == torch.bfloat16 else 0)
        ratio = (err / allowed).max().item()
        check(ratio <= 1.0, f"{name}: error {ratio:.3g}× its bound")
        max_err, mean_err = err.max().item(), err.mean().item()
        note = ""
        if dtype == torch.bfloat16:
            share = mean_err / bf16_step(want).mean().item()
            check(share <= K2_MEAN_STEP_SHARE,
                  f"{name}: mean err {share:.3g} of a bf16 step > {K2_MEAN_STEP_SHARE}")
            note = f" mean/step {share:.2e}"
        out = {"max_abs_err": max_err, "mean_abs_err": mean_err, "bound_share": ratio}
        line = (f"{name} {str(dtype).split('.')[-1]}: max_abs_err {max_err:.3e} "
                f"mean_abs_err {mean_err:.3e}{note} err/allowed {ratio:.3f}")
        if timed:
            w = q.to(dtype)
            out["ms"] = median_ms(lambda: k2.int8_matmul(x, q, scale))
            out["plain_ms"] = median_ms(lambda: k2.int8_matmul_reference(x, q, scale), runs=10)
            out["cublas_ms"] = median_ms(lambda: x @ w)
            out["bound_ms"], out["bound_by"] = bound_ms(
                2.0 * m * k * n,
                m * k * x.element_size() + k * n + 4 * n + m * n * x.element_size(),
                dtype,
            )
            line += (f" kernel {out['ms']:.4f} ms plain {out['plain_ms']:.4f} ms "
                     f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}) "
                     f"[context: cuBLAS bf16 x@W {out['cublas_ms']:.4f} ms]")
        print(line, flush=True)
        return out

    results = {}
    for name, ((m, k, n), _) in K2_SHAPES.items():
        results[name] = run(name, m, k, n, torch.bfloat16, timed=True)
    results["f32"] = run("k,v f32 (512,4096)x(4096,1024)", 512, 4096, 1024,
                         torch.float32, timed=True)
    for m, k, n in ((37, 200, 136), (1, 8, 16), (130, 72, 200), (300, 1000, 1030)):
        for dtype in (torch.bfloat16, torch.float32):
            run(f"ragged ({m},{k})x({k},{n})", m, k, n, dtype, timed=False)
    chunk_ms = sum(results[s]["ms"] * count for s, (_, count) in K2_SHAPES.items())
    print(f"K2 per embed chunk (280 launches) from these medians: {chunk_ms:.2f} ms")
    return results


def profile_page(fn, page) -> None:
    """Device time of one page by kernel family (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(page)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    families = {"K1 enc_attn": 0.0, "K2 int8_mm": 0.0, "GEMM (cuBLAS)": 0.0,
                "conv (cuDNN)": 0.0, "other": 0.0}
    counts = dict.fromkeys(families, 0)
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.key.lower()
        if "enc_attn" in name:
            fam = "K1 enc_attn"
        elif "int8_mm" in name:
            fam = "K2 int8_mm"
        elif any(s in name for s in ("conv", "cudnn", "implicit", "fprop")):
            fam = "conv (cuDNN)"  # before GEMM: cuDNN names its kernels *_implicit_gemm_*
        elif any(s in name for s in ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")):
            fam = "GEMM (cuBLAS)"
        else:
            fam = "other"
        ms = ev.device_time_total / 1e3
        families[fam] += ms
        counts[fam] += ev.count
        kernels.append((ms, ev.count, ev.key))
    busy = sum(families.values())
    print(f"profiled page: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(kernel time summed), idle {100 * (1 - busy / wall):.1f}%")
    for fam, t in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"  {fam}: {t:.1f} ms over {counts[fam]} launches ({100 * t / busy:.1f}%)")
    print("  largest kernels:")
    for ms, count, key in sorted(kernels, reverse=True)[:8]:
        print(f"    {ms:9.1f} ms {count:6d}x {key[:100]}")


def mme5_page(k1, k2, detector):
    """The mmE5-11B int8-mixed page at full width; returns its launch
    counts, two crops and their embeddings."""
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.mllama_processor import IMAGE_MEAN, IMAGE_STD
    from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig
    from multimodal_embeddings_tpu_torch.models.quantized import param_bytes
    from multimodal_embeddings_tpu_torch.pipeline.fused import build_split_page_fn

    phase("8. full-width mmE5-11B int8-mixed page program")
    t0 = time.perf_counter()
    config = MllamaConfig.mme5_11b_int8_mixed()
    embedder = MultimodalEmbedder(
        EmbedderConfig(family="mme5", dtype="bfloat16", quantize="int8-mixed"),
        model_config=config, device="cuda", seed=0,
    )
    fn = build_split_page_fn(
        detector, embedder, PAGE_HW, num_regions=NUM_REGIONS, embed_chunk=MME5_CHUNK
    )
    pages = make_pages(1 + MME5_TIMED_PAGES)
    torch.cuda.synchronize()
    nbytes = param_bytes(embedder.model)
    print(f"set-up (random init on the card): {time.perf_counter() - t0:.1f} s; "
          f"embedder parameters {nbytes / 1e9:.3f} GB ({nbytes} bytes)")

    t0 = time.perf_counter()
    fn(pages[0])
    torch.cuda.synchronize()
    print(f"warm-up page: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    torch.cuda.reset_peak_memory_stats()
    for wrapper in (k1.encoder_attention, k1.encoder_attention_blf,
                    k1.encoder_attention_blf_packed, k2.int8_matmul):
        wrapper.launches = 0
    page_ms, results = [], []
    for page in pages[1:]:
        t0 = time.perf_counter()
        res = fn(page)
        torch.cuda.synchronize()
        page_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    launches = {
        "masked": k1.encoder_attention.launches,
        "blf": k1.encoder_attention_blf.launches,
        "packed": k1.encoder_attention_blf_packed.launches,
        "int8": k2.int8_matmul.launches,
    }
    peak = torch.cuda.max_memory_allocated()
    chunks = NUM_REGIONS // MME5_CHUNK
    v, t = config.vision, config.text
    want = {
        "masked": (v.layers + v.global_layers) * chunks * MME5_TIMED_PAGES,
        "blf": 0,
        "packed": MME5_TIMED_PAGES,
        "int8": 7 * t.layers * chunks * MME5_TIMED_PAGES,
    }
    check(launches == want, f"launches {launches} != {want}")
    for res in results:
        check_page(res, t.hidden)
    print(f"ms/page {statistics.mean(page_ms):.1f} (pages: "
          + ", ".join(f"{x:.1f}" for x in page_ms) + ")")
    print(f"valid regions per page: {[int(r.valid.sum()) for r in results]}")
    print(f"launches over {MME5_TIMED_PAGES} pages: K1 prefix {launches['masked']}, "
          f"K2 {launches['int8']}, K1 packed {launches['packed']}, K1 blf {launches['blf']}")
    print(f"peak device memory: {peak / 2**30:.2f} GiB")

    # the three stages of the same path, timed apart
    mean = torch.tensor(IMAGE_MEAN, device="cuda")
    std = torch.tensor(IMAGE_STD, device="cuda")
    model = embedder.model
    det_ms, vis_ms, txt_ms = [], [], []
    with torch.inference_mode():
        for page in pages[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *_, crops = fn.detect(page)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            states = [
                model.encode_vision((crops[i : i + MME5_CHUNK] - mean.to(crops.dtype))
                                    / std.to(crops.dtype))
                for i in range(0, NUM_REGIONS, MME5_CHUNK)
            ]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ids = embedder.prompt_ids.expand(MME5_CHUNK, -1)
            mask = embedder.prompt_mask.expand(MME5_CHUNK, -1)
            embs = torch.cat([model.embed_from_vision(ids, mask, *s) for s in states])
            torch.cuda.synchronize()
            det_ms.append((t1 - t0) * 1e3)
            vis_ms.append((t2 - t1) * 1e3)
            txt_ms.append((time.perf_counter() - t2) * 1e3)
    print(f"detect+crop {statistics.mean(det_ms):.1f} ms/page, vision tower "
          f"{statistics.mean(vis_ms):.1f} ms/page, text stack {statistics.mean(txt_ms):.1f} "
          f"ms/page")
    profile_page(fn, pages[-1])
    return launches, crops, embs, config


def mme5_card_vs_cpu(crops, config) -> None:
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.mllama_processor import IMAGE_MEAN, IMAGE_STD
    from multimodal_embeddings_tpu_torch.models.weights import export_jax_params

    phase("9. mmE5: card (bf16) against the CPU (f32, plain kernels)")
    reduced = dataclasses.replace(
        config,
        vision=dataclasses.replace(config.vision, layers=2, global_layers=1,
                                   intermediate_layers=(0, 1)),
        text=dataclasses.replace(config.text, layers=2, cross_attn_layers=(1,)),
    )
    t0 = time.perf_counter()
    cpu = MultimodalEmbedder(
        EmbedderConfig(family="mme5", dtype="float32", quantize="int8-mixed"),
        model_config=reduced, device="cpu", seed=0,
    )
    gpu = MultimodalEmbedder(
        EmbedderConfig(family="mme5", dtype="bfloat16", quantize="int8-mixed"),
        model_config=reduced, device="cuda", params=export_jax_params(cpu.model),
    )
    print(f"set-up (CPU f32 build, bridge to the card in bf16): {time.perf_counter() - t0:.1f} s")
    mean, std = torch.tensor(IMAGE_MEAN), torch.tensor(IMAGE_STD)
    two = crops[:2]
    got = gpu.encode_image((two - mean.to(two)) / std.to(two))
    x = two.float().cpu()
    ref = cpu.encode_image((x - mean) / std)
    cos = torch.nn.functional.cosine_similarity(got.float().cpu(), ref, dim=-1)
    print(f"cosine card vs cpu: {[round(c, 6) for c in cos.tolist()]}")
    check(bool((cos >= COSINE_MIN).all()), f"cosine {cos.tolist()} < {COSINE_MIN}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from multimodal_embeddings_tpu_torch.kernels import encoder_attention as k1
    from multimodal_embeddings_tpu_torch.kernels import quantization as k2

    start = time.perf_counter()
    smi = card()
    build(k1, k2)
    checks = kernel_checks(k1)
    vit_launches, crops, embs, model_config, detector = full_slice(k1)
    card_vs_cpu(crops, embs, model_config)
    masked = masked_checks(k1)
    int8 = int8_checks(k2)
    mme5_launches, mme5_crops, _, mme5_config = mme5_page(k1, k2, detector)
    mme5_card_vs_cpu(mme5_crops, mme5_config)
    print(f"all phases: {time.perf_counter() - start:.1f} s")

    src = "multimodal_embeddings_tpu_torch/csrc/encoder_attention.cu"
    ref = "multimodal_embeddings_tpu/kernels/encoder_attention.py"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(name, source, replaces, launches, by_path, shape, res, library=True):
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, "launches_by_path": by_path, "shape": shape}
        out.update({k: res.get(k) if library or k != "library_ms" else None for k in keys})
        return out

    vit, psa = checks[("vit", torch.bfloat16)], checks["psa"]
    k2_head = dict(int8[K2_HEADLINE])
    k2_head["max_abs_err"] = max(int8[s]["max_abs_err"] for s in K2_SHAPES)
    kernels = [
        entry("encoder_attention_blf", src, f"{ref}:327", vit_launches["blf"],
              {"vit_page": vit_launches["blf"], "mme5_page": mme5_launches["blf"]},
              "(48,784,768) H=12 bf16", vit),
        entry("encoder_attention_blf_packed", src, f"{ref}:458", vit_launches["packed"],
              {"vit_page": vit_launches["packed"], "mme5_page": mme5_launches["packed"]},
              "(30,1024,576) 4x(36|36|72) bf16", psa),
        entry("encoder_attention", src, f"{ref}:523 (and encoder_attention_padded :619)",
              mme5_launches["masked"], {"mme5_page": mme5_launches["masked"]},
              "(8,1608,16,80) valid 1601 bf16", masked[torch.bfloat16]),
        entry("int8_matmul", "multimodal_embeddings_tpu_torch/csrc/int8_matmul.cu",
              "multimodal_embeddings_tpu/kernels/quantization.py:219",
              mme5_launches["int8"], {"mme5_page": mme5_launches["int8"]},
              K2_HEADLINE + " bf16 (max_abs_err over the five text shapes)",
              k2_head, library=False),
    ]
    kernels[-1]["cublas_bf16_ms_context"] = k2_head["cublas_ms"]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
