"""LayoutDetector: the detection engine of the page program, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/detector.py::LayoutDetector``'s
construction: the DocLayout-YOLO network of a ``DetectorConfig`` with
parameters from a JAX flat dict, a JAX ``.npz`` checkpoint
(``config.weights_path``) or a seed, in ``dtype`` on ``device`` (the card
unless the caller asks for the CPU; asking for the card where there is none
raises). ``config.pallas_convs``/``pallas_mode`` route the GL-CRM stages
through the 3×3 conv kernel (K5), whose folded biases stay f32. The page
program (``pipeline/fused.py``) runs it over all views of a page as one
batch. The host-side per-image API (letterboxing, JSON regions, cache)
is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_embeddings_tpu_torch.config import DetectorConfig
from multimodal_embeddings_tpu_torch.models.weights import Flat, load_params, resolve_device
from multimodal_embeddings_tpu_torch.models.yolo import DocLayoutYOLO


class LayoutDetector:
    def __init__(
        self,
        config: DetectorConfig = DetectorConfig(),
        num_classes: int = 10,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        params: Optional[Flat] = None,
    ):
        self.config = config
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        model = DocLayoutYOLO(num_classes, config.variant, config.glcrm,
                              config.pallas_convs, config.pallas_mode)
        load_params(model, seed, params, config.weights_path)
        f32 = {name: p.detach().clone() for name, p in model.named_parameters()
               if name in model.kernel_bias_names()}
        self.model = model.to(self.device, dtype, memory_format=torch.channels_last).eval()
        for name, p in self.model.named_parameters():
            if name in f32:  # K5's folded biases stay f32
                p.data = f32[name].to(self.device)
