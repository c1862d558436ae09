"""FLOP counting: the port against the JAX package.

1. The config-driven counters are verbatim copies (sources equal) and give
   JAX's counts exactly on the tiny, 2b and 11b mmE5 configs.
2. ``headline_flops_per_page`` (``FlopCounterMode`` over the port's plain
   routes on the CPU) equals JAX's (its jaxpr walker with the Pallas
   dispatch forced off) exactly, on a tiny detector (with and without
   GL-CRM) and a tiny ViT, on one bridged tree. The two counters agree op
   for op: grouped (depthwise) convolutions count ``2·out·(C_in/groups)·k²``
   in both, and the attention products (``bmm``) and projections (``mm``,
   ``addmm``) are the JAX ``dot_general``s; no op differs.
"""

import copy
import inspect
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from multimodal_embeddings_tpu.config import DetectorConfig as JDetectorConfig
from multimodal_embeddings_tpu.models import mme5 as jm
from multimodal_embeddings_tpu.models import vision_encoder as jve
from multimodal_embeddings_tpu.models import yolo as jyolo
from multimodal_embeddings_tpu.models.weights import unflatten_params
from multimodal_embeddings_tpu.utils import flops as jf
from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
from multimodal_embeddings_tpu_torch.models import mme5 as tm
from multimodal_embeddings_tpu_torch.models import vision_encoder as tve
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.weights import export_jax_params
from multimodal_embeddings_tpu_torch.utils import flops as tf

torch.set_num_threads(2)

SIZES = ("tiny", "mme5_2b", "mme5_11b")


@pytest.mark.parametrize("name", ["_pad_to_multiple", "encoder_block_flops",
                                  "mllama_vision_flops", "mllama_text_flops",
                                  "mllama_embed_flops"])
def test_sources_equal(name):
    assert inspect.getsource(getattr(tf, name)) == inspect.getsource(getattr(jf, name))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("text_len,tiles", [(8, 1), (64, 1), (64, 4), (250, 2)])
def test_analytic_counters_equal_jax(size, text_len, tiles):
    jcfg, tcfg = getattr(jm.MllamaConfig, size)(), getattr(tm.MllamaConfig, size)()
    assert tf.mllama_vision_flops(tcfg, tiles) == jf.mllama_vision_flops(jcfg, tiles)
    assert tf.mllama_text_flops(tcfg, text_len, 1601) == jf.mllama_text_flops(jcfg, text_len, 1601)
    got = tf.mllama_embed_flops(tcfg, text_len, tiles)
    assert got == jf.mllama_embed_flops(jcfg, text_len, tiles)
    assert got["total_flops_per_crop"] == got["vision_flops_per_crop"] + got["text_flops_per_crop"]


@pytest.mark.parametrize("seq,width,ratio", [(784, 768, 4.0), (1, 32, 4.0), (1608, 1280, 4.0),
                                             (100, 64, 2.5)])
def test_encoder_block_flops_equal_jax(seq, width, ratio):
    assert tf.encoder_block_flops(seq, width, ratio) == jf.encoder_block_flops(seq, width, ratio)


def _engines(glcrm):
    det = LayoutDetector(DetectorConfig(image_size=64, variant="n", glcrm=glcrm),
                         dtype=torch.float32, device="cpu", seed=1)
    emb = MultimodalEmbedder(EmbedderConfig(family="siglip", dtype="float32"),
                             model_config=tve.DualEncoderConfig.tiny(), device="cpu", seed=1)
    jdet = SimpleNamespace(model=jyolo.DocLayoutYOLO(num_classes=10, variant="n", glcrm=glcrm),
                           variables=unflatten_params(export_jax_params(det.model)),
                           config=JDetectorConfig(image_size=64, variant="n", glcrm=glcrm))
    jcfg = jve.DualEncoderConfig.tiny()
    jemb = SimpleNamespace(model=jve.DualEncoder(jcfg), model_config=jcfg,
                           variables=unflatten_params(export_jax_params(emb.model)))
    return det, emb, jdet, jemb


@pytest.mark.parametrize("glcrm", [False, True])
def test_headline_flops_equal_jax(glcrm):
    det, emb, jdet, jemb = _engines(glcrm)
    got = tf.headline_flops_per_page(det, emb, n_views=3, n_regions=5)
    assert got == jf.headline_flops_per_page(jdet, jemb, n_views=3, n_regions=5)
    assert got["detect_flops_per_page"] > 0 and got["embed_flops_per_page"] > 0


def _by_op(module, method, shape):
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        getattr(copy.deepcopy(module), method)(torch.zeros(shape))
    return {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}


def test_ops_counted():
    """What the port's counter sees: the detector's convolutions (depthwise
    ones included) and the PSA's two attention products; the ViT's patch
    conv, projections and attention products. Nothing else carries FLOPs."""
    det, emb, _, _ = _engines(True)
    ops = _by_op(det.model, "forward", (1, 64, 64, 3))
    assert set(ops) == {"aten.convolution", "aten.bmm"}
    size = emb.model_config.vision.image_size
    ops = _by_op(emb.model, "encode_image", (1, size, size, 3))
    assert set(ops) == {"aten.convolution", "aten.mm", "aten.bmm", "aten.addmm"}
