"""MultimodalEmbedder: the region-embedding engine, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/embedder.py::MultimodalEmbedder``
for ``family="siglip"``: the dual encoder's ViT image tower with
parameters from a JAX flat dict (the ``vision`` scope of a ``DualEncoder``
tree), a JAX ``.npz`` checkpoint or a seed, in the config's dtype on
``device``. The mme5 family, the text tower and the host-side image API
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_embeddings_tpu_torch.config import EmbedderConfig
from multimodal_embeddings_tpu_torch.models.vision_encoder import (
    DualEncoderConfig,
    ViTower,
)
from multimodal_embeddings_tpu_torch.models.weights import Flat, load_params

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class MultimodalEmbedder:
    def __init__(
        self,
        config: EmbedderConfig = EmbedderConfig(),
        model_config: Optional[DualEncoderConfig] = None,
        seed: int = 0,
        device="cpu",
        params: Optional[Flat] = None,
    ):
        if config.family != "siglip":
            raise ValueError(f"family {config.family!r} is not ported (siglip only)")
        self.config = config
        self.model_config = model_config or DualEncoderConfig.base()
        self.image_size = self.model_config.vision.image_size
        self.dtype = _DTYPES[config.dtype]
        self.device = torch.device(device)
        model = ViTower(self.model_config.vision, self.model_config.embed_dim)
        load_params(model, seed, params, config.weights_path, prefix="vision")
        self.model = model.to(self.device, self.dtype).eval()

    @torch.inference_mode()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) in [0, 1] → (B, embed_dim) f32, L2-normalised."""
        return self.model(images)
