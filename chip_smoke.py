#!/usr/bin/env python3
"""Drive the PyTorch port's page program once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: name and power limit (``nvidia-smi``), torch and CUDA
   versions; both TF32 flags are set off and printed;
2. the build: the encoder-attention kernel (K1) compiled with ``nvcc`` for
   ``sm_90a`` from ``multimodal_embeddings_tpu_torch/csrc``;
3. K1 against its plain PyTorch version at the page program's shapes — ViT
   ``(48, 784, 768)`` H=12 in bf16 and f32, PSA ``(30, 1024, 576)``
   4×(36|36|72) in bf16 — errors against stated tolerances, and the median
   time of each;
4. the full-width slice: DocLayout-YOLO-m with GL-CRM over 30 views at
   1024 px and a ViT-B/16 at 448 over the top 48 regions, bf16, random
   weights from seed 0, on 3 synthetic 2200×1700 pages after one warm-up
   page; output shapes, finiteness, unit-norm embeddings, and K1's launch
   counts (12 per embed call, 1 per detect call);
5. the card against the CPU: two of the page's crops embedded by the same
   tower in f32 on the CPU (plain attention), cosine ≥ 0.999 against the
   card's bf16 embeddings.

It prints one JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# stated tolerances for K1 against its plain version on the card. Both sum
# in f32 in different orders, so a bf16 output may round to the neighbouring
# value: at most 2 bf16 steps at the output's own magnitude, and a mean that
# stays near zero (H100 runs read 1 step and a mean of 1.7e-9). Skipping the
# bf16 rounding of e, or truncating the output, moves 40-50% of the ViT
# shape's outputs, a mean of 7e-5 to 1.3e-4. f32 differs only by order.
MAX_BF16_STEPS, ATOL_BF16_MEAN = 2.0, 1e-6
ATOL_F32_MAX = 1e-5
COSINE_MIN = 0.999  # BASELINE.json's embedding-parity target
PAGE_HW = (2200, 1700)
NUM_REGIONS = 48
TIMED_PAGES = 3


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


def bf16_steps(got, want) -> float:
    """Largest ``|got − want|`` in bf16 steps at ``|want|`` (8 significant
    bits: the step in ``[2^(e−1), 2^e)`` is ``2^(e−8)``)."""
    import torch

    want = want.float()
    _, exp = torch.frexp(want.abs().clamp_min(2.0**-126))
    step = torch.ldexp(torch.ones_like(want), exp - 8)
    return ((got.float() - want).abs() / step).max().item()


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


def build(k1) -> None:
    phase("2. build")
    info = k1.build_info()
    print(f"K1 library {info.path.name}: nvcc {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())


def kernel_checks(k1) -> dict:
    """K1 against the plain version at the main path's shapes."""
    import torch

    phase("3. K1 against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    results = {}

    def compare(name, kernel, plain, dtype):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        if dtype == torch.bfloat16:
            steps = bf16_steps(got, want)
            check(steps <= MAX_BF16_STEPS,
                  f"{name}: max err {steps} bf16 steps > {MAX_BF16_STEPS}")
            check(mean_err <= ATOL_BF16_MEAN, f"{name}: mean err {mean_err} > {ATOL_BF16_MEAN}")
            steps_note = f" ({steps:g} bf16 steps)"
        else:
            check(max_err <= ATOL_F32_MAX, f"{name}: max err {max_err} > {ATOL_F32_MAX}")
            steps_note = ""
        ms = median_ms(kernel)
        plain_ms = median_ms(plain)
        print(f"{name}: max_abs_err {max_err:.3e}{steps_note} mean_abs_err {mean_err:.3e} "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        return {"max_abs_err": max_err, "mean_abs_err": mean_err, "ms": ms,
                "plain_ms": plain_ms}

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (
            torch.randn((48, 784, 768), generator=gen, device=dev).to(dtype)
            for _ in range(3)
        )
        results[("vit", dtype)] = compare(
            f"vit (48,784,768) H=12 {dtype}",
            lambda: k1.encoder_attention_blf(q, k, v, heads=12),
            lambda: k1.encoder_attention_blf_reference(q, k, v, heads=12),
            dtype,
        )
    qkv = torch.randn((30, 1024, 576), generator=gen, device=dev).to(torch.bfloat16)
    results["psa"] = compare(
        "psa (30,1024,576) 4x(36|36|72) bf16",
        lambda: k1.encoder_attention_blf_packed(qkv, 4, 36, 72),
        lambda: k1.encoder_attention_blf_packed_reference(qkv, 4, 36, 72),
        torch.bfloat16,
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


def full_slice(k1):
    """The page program at full width; returns the run's numbers, the
    launch counts, one page's crops and embeddings, and the model config."""
    import torch

    from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.vision_encoder import (
        DualEncoderConfig,
        VisionConfig,
    )
    from multimodal_embeddings_tpu_torch.pipeline.fused import build_split_page_fn
    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    phase("4. full-width page program")
    t0 = time.perf_counter()
    detector = LayoutDetector(
        DetectorConfig(image_size=1024, variant="m"),
        dtype=torch.bfloat16, device="cuda", seed=0,
    )
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
    pages = [
        torch.from_numpy(make_page(*PAGE_HW, seed=i)).to("cuda")
        for i in range(1 + TIMED_PAGES)
    ]
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
        shapes = [tuple(t.shape) for t in res]
        want = [(48, 4), (48,), (48,), (48,), (48, 768)]
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
    return launches, crops, embs, model_config


def card_vs_cpu(crops, embs, model_config) -> None:
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder

    phase("5. card (bf16) against the CPU (f32, plain attention)")
    cpu = MultimodalEmbedder(
        EmbedderConfig(family="siglip", dtype="float32"),
        model_config=model_config, device="cpu", seed=0,
    )
    ref = cpu.encode_image(crops[:2].float().cpu())
    got = embs[:2].float().cpu()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    print(f"cosine card vs cpu: {[round(c, 6) for c in cos.tolist()]}")
    check(bool((cos >= COSINE_MIN).all()), f"cosine {cos.tolist()} < {COSINE_MIN}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from multimodal_embeddings_tpu_torch.kernels import encoder_attention as k1

    smi = card()
    build(k1)
    checks = kernel_checks(k1)
    launches, crops, embs, model_config = full_slice(k1)
    card_vs_cpu(crops, embs, model_config)

    src = "multimodal_embeddings_tpu_torch/csrc/encoder_attention.cu"
    ref = "multimodal_embeddings_tpu/kernels/encoder_attention.py"
    vit, psa = checks[("vit", torch.bfloat16)], checks["psa"]
    kernels = [
        {"name": "encoder_attention_blf", "route": "cuda", "source": src,
         "replaces": f"{ref}:327", "launches": launches["blf"],
         "max_abs_err": vit["max_abs_err"], "ms": vit["ms"], "plain_ms": vit["plain_ms"]},
        {"name": "encoder_attention_blf_packed", "route": "cuda", "source": src,
         "replaces": f"{ref}:458", "launches": launches["packed"],
         "max_abs_err": psa["max_abs_err"], "ms": psa["ms"], "plain_ms": psa["plain_ms"]},
    ]
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
