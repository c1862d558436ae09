"""Device kernels sorted into families by name: the port's hand-written
kernels K1-K8 by their CUDA symbols, then the library families. A copy kept
with the benchmark, so that a kernel renamed in the program has to be named
here too before a per-layer metric reads it."""

from __future__ import annotations

from typing import Tuple

# (family, lower-case name fragments), first match wins; cuDNN names its
# kernels *_implicit_gemm_*, so convolutions come before GEMMs
FAMILIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("K1", ("enc_attn",)),
    ("K2", ("int8_mm",)),
    ("K3", ("int4_mm", "int4_gemv")),
    ("K4", ("flash_wgmma", "flash_f32", "flash_v2_f32")),
    ("K5", ("conv3x3_bf16", "conv3x3_f32")),
    ("K6", ("ln_mm_wgmma", "ln_mm_bf16", "ln_mm_f32")),
    ("K7", ("ln_stats_kernel",)),
    ("K8", ("sr_quantize",)),
    ("conv", ("conv", "cudnn", "implicit", "fprop")),
    ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")),
    ("memcpy", ("memcpy", "memset")),
    ("sort", ("sort", "radix")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def family_of(name: str) -> str:
    low = name.lower()
    for family, fragments in FAMILIES:
        if any(f in low for f in fragments):
            return family
    return "other"
