"""The port stands alone: no JAX, no JAX package, no library attention and
no fallback around a kernel launch."""

import pathlib
import re
import subprocess
import sys

import pytest

import multimodal_embeddings_tpu_torch

PKG = pathlib.Path(multimodal_embeddings_tpu_torch.__file__).parent
REPO = PKG.parent
MODULES = sorted(
    "multimodal_embeddings_tpu_torch."
    + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if p.name != "__init__.py"
)


def test_every_module_imports_without_jax():
    """In a fresh interpreter: import every port module (and chip_smoke),
    then neither jax, flax nor the JAX package may be loaded."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'multimodal_embeddings_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_twin_scripts_import_without_jax():
    """The port's twins of the JAX package's scripts (``scripts/torch_*.py``,
    the serve-vs-exact parity tools among them) load in a fresh interpreter
    without JAX."""
    scripts = sorted(str(p) for p in (REPO / "scripts").glob("torch_*.py"))
    assert any(s.endswith("torch_attn_candidates_bench.py") for s in scripts)
    assert any(s.endswith("torch_enc_attn_blhd_probe.py") for s in scripts)
    assert any(s.endswith("torch_parse_bench.py") for s in scripts)
    assert any(s.endswith("torch_dryrun_multichip.py") for s in scripts)
    assert any(s.endswith("torch_serve_parity.py") for s in scripts)
    assert any(s.endswith("torch_knife_edge_probe.py") for s in scripts)
    code = (
        "import importlib.util, sys\n"
        f"for path in {scripts!r}:\n"
        "    spec = importlib.util.spec_from_file_location('twin', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'multimodal_embeddings_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_module_list_covers_the_slice():
    for name in (
        "kernels.encoder_attention", "kernels._build", "models.transformer",
        "models.vision_encoder", "models.layers", "models.yolo", "models.yolo_decode",
        "models.weights", "models.detector", "models.embedder", "ops.iou", "ops.nms",
        "ops.edge_filter", "ops.grid", "ops.image", "pipeline.fused", "config",
        "kernels.quantization", "models.quantized", "models.mme5",
        "models.mllama_processor", "models.tokenizer", "kernels.flash_attention",
        "kernels.quantization_int4", "models.qwen_vl", "analysis.doc_parser", "cli.parse",
        "kernels.conv", "kernels.ln_matmul", "kernels.ln_stats", "io.images",
        "models.qwen_serve", "models.bpe", "io.logging_setup", "io.json_io", "io.progress",
        "io.prefetch", "utils.native", "store.embedding_store", "pipeline.regions",
        "cli.serve", "ops.skew", "ops.widths", "ops.peaks", "ops.columns", "utils.colormap",
        "utils.errors", "utils.profiling", "analysis.visualization", "pipeline.orientation",
        "pipeline.detect", "pipeline.stages", "pipeline.runner", "cli.orientation",
        "cli.detect", "cli.edge_filter", "cli.combine", "cli.medians", "cli.columns",
        "cli.pipeline", "analysis.html", "analysis.clustering", "analysis.reports",
        "analysis.cross_compare", "analysis.region_compare", "analysis.demo_queries",
        "cli.workflow", "cli.demo", "ops.hough", "models.hf_port", "analysis.activations",
        "analysis.parity", "cli.parity", "utils.flops", "utils.trace_analysis",
        "core.mesh", "parallel.sharding", "parallel.pipeline", "parallel.dryrun",
        "training.contrastive", "models.qwen_pp",
    ):
        assert f"multimodal_embeddings_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize(
    "pattern",
    [r"scaled_dot_product_attention", r"torch\.compile", r"\bcudnn\.(?!allow_tf32)",
     r"^\s*try\s*:", r"^\s*(import|from)\s+(jax|flax|multimodal_embeddings_tpu)\b"],
)
def test_package_source_has_no(pattern):
    """No library attention, no torch.compile, no try/except (so no kernel
    launch can fall back), and no JAX."""
    rx = re.compile(pattern, re.M)
    hits = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py") if rx.search(p.read_text())]
    assert not hits, hits


def test_package_imports_without_pil():
    """PIL is imported only where an image is opened, resized or drawn."""
    code = (
        "import importlib, sys\n"
        "sys.modules['PIL'] = None\n"
        f"for m in {MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_package_imports_without_cv2():
    """cv2 is found by ``find_spec`` and imported only where an image is
    read, written or drawn: importing every module loads none of it, and
    the package imports with cv2 taken away."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert 'cv2' not in sys.modules\n"
        "sys.modules['cv2'] = None\n"
        "from multimodal_embeddings_tpu_torch.io.images import cv2_module\n"
        "assert cv2_module() is None\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """Here torch has no CUDA: the script must exit non-zero and print no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
