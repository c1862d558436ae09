"""The import guard compares top-level module names whole: the port's name
begins with the JAX package's name and must not be taken for it."""

import os
import subprocess
import sys

from benchlib.cells import HERE
from benchlib.guard import forbidden_modules


def test_top_level_names_compared_whole():
    names = ["multimodal_embeddings_tpu_torch", "multimodal_embeddings_tpu_torch.models.yolo",
             "jaxtyping", "flaxen", "multimodal_embeddings_tpu", "jax.numpy", "jaxlib.xla",
             "flax.linen", "multimodal_embeddings_tpu.ops"]
    assert forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib.xla",
                                        "multimodal_embeddings_tpu",
                                        "multimodal_embeddings_tpu.ops"]


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import benchlib.cells, benchlib.trace, drivers.page, drivers.parse\n"
        "import reference.page_ref, reference.qwen_ref, run, control\n"
        "from benchlib.cells import load_cell\n"
        "for name in ('vitb16_doclayout_m.stream', 'qwen25vl_32b_int4.parse_short'):\n"
        "    cell = load_cell(name)\n"
        "    cell.driver(); [cell.metric_reader(m['name']) for m in cell.per_layer]\n"
        "import multimodal_embeddings_tpu_torch.pipeline.fused\n"
        "import multimodal_embeddings_tpu_torch.models.qwen_serve\n"
        "import multimodal_embeddings_tpu_torch.analysis.doc_parser\n"
        "from benchlib.guard import forbidden_modules\n"
        "print(forbidden_modules())\n" % (HERE, os.path.dirname(HERE)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "USE_FLAX": "0"}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(HERE, "reference")):
        if name.endswith(".py"):
            text = open(os.path.join(HERE, "reference", name)).read()
            assert "multimodal_embeddings_tpu" not in text and "import jax" not in text
