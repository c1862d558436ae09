"""MultimodalEmbedder: the region-embedding engine, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/embedder.py::MultimodalEmbedder``
for both families, on ``device`` (the card unless the caller asks for the
CPU; asking for the card where there is none raises):

* ``family="siglip"``: the dual encoder's ViT image tower with parameters
  from a JAX flat dict (its ``vision`` scope), a JAX ``.npz`` checkpoint or
  a seed, in the config's dtype;
* ``family="mme5"``: the Mllama model of ``model_config`` (default the 11B
  layout; ``config.quantize`` selects the weight storage when the model
  config has none), built on its device (``weights.build_mme5``), and the
  config's prompt tokenized by the ``ByteTokenizer`` to
  ``min(64, max_len)`` tokens.

The text towers' ``get_text_embeddings`` and the host-side image API
(decoding, ``preprocess_image`` tiling) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from multimodal_embeddings_tpu_torch.config import EmbedderConfig
from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig
from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
from multimodal_embeddings_tpu_torch.models.vision_encoder import (
    DualEncoderConfig,
    ViTower,
)
from multimodal_embeddings_tpu_torch.models.weights import (
    Flat,
    build_mme5,
    load_params,
    resolve_device,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TEXT_MAX_LEN = 64


class MultimodalEmbedder:
    def __init__(
        self,
        config: EmbedderConfig = EmbedderConfig(),
        model_config=None,
        seed: int = 0,
        device="cuda",
        params: Optional[Flat] = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.dtype]
        if config.family == "siglip":
            self.model_config = model_config or DualEncoderConfig.base()
            model = ViTower(self.model_config.vision, self.model_config.embed_dim)
            load_params(model, seed, params, config.weights_path, prefix="vision")
            self.model = model.to(self.device, self.dtype).eval()
            self.image_size = self.model_config.vision.image_size
        elif config.family == "mme5":
            mc = model_config or MllamaConfig.mme5_11b()
            if config.quantize and not mc.quantize:
                mc = dataclasses.replace(mc, quantize=config.quantize)
            self.model_config = mc
            self.model = build_mme5(
                mc, self.dtype, self.device, seed, params, config.weights_path
            )
            self.image_size = mc.vision.image_size
            self.text_len = min(TEXT_MAX_LEN, mc.text.max_len)
            ids, mask = ByteTokenizer().encode_batch([config.prompt], self.text_len)
            self.prompt_ids = torch.from_numpy(ids).to(self.device)
            self.prompt_mask = torch.from_numpy(mask).to(self.device)
        else:
            raise ValueError(f"unknown embedder family {config.family!r}")

    @torch.inference_mode()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) → (B, D) f32, L2-normalised. siglip: pixels in
        [0, 1]; mme5: CLIP-normalised single-tile crops, embedded with the
        prompt."""
        if self.config.family == "siglip":
            return self.model(images)
        n = images.shape[0]
        ids = self.prompt_ids.expand(n, -1)
        mask = self.prompt_mask.expand(n, -1)
        return self.model(ids, mask, images)
