"""MultimodalEmbedder: the region-embedding engine, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/embedder.py::MultimodalEmbedder``
for both families, on ``device`` (the card unless the caller asks for the
CPU; asking for the card where there is none raises):

* ``family="siglip"``: the dual encoder (``DualEncoder``: image and text
  towers) with parameters from a JAX flat dict, a JAX ``.npz`` or
  ``.safetensors`` checkpoint or a seed, in the config's dtype;
* ``family="mme5"``: the Mllama model of ``model_config`` (default the 11B
  layout; ``config.quantize`` selects the weight storage when the model
  config has none), built on its device (``weights.build_mme5``; a float
  checkpoint is quantized there at load), and the config's prompt
  tokenized to ``min(64, max_len)`` tokens.

The host API is the reference contract: ``get_image_embeddings`` (paths or
arrays; decoded, capped at ``max_image_dim`` by LANCZOS; siglip resized
BILINEAR to ``image_size`` and scaled to ``[0, 1]``, mme5 tiled by
``preprocess_image`` into stacks of ``max_tiles``; ``None`` for a path
that is not a readable file) and ``get_text_embeddings``, both returning
float64 lists. The package keeps no ``try``/``except``, so a file that
exists but does not decode raises where the JAX engine returns ``None``
(it catches every exception of the decode). PyTorch runs eagerly, so a
batch is not padded to ``batch_size`` as the JAX engine pads it for
``jit``: the rows of a batch are independent, so the results are the same.

``mesh`` (``core/mesh.py::Mesh``; every rank of it builds the engine and
makes the same calls) shards the engine as the JAX engine's ``mesh`` does:
the parameters are cut over the model axis by
``parallel/sharding.py::shard_variables`` (attention heads, MLP columns,
the vocab; each rank cuts its shard from the whole tree, loaded through the
bridge), and ``get_image_embeddings`` pads each batch to a multiple of the
data axis, embeds each rank's rows on its device and all-gathers them, so
every rank returns the whole list. The quantized (``int8``/``int4``) trees
refuse a mesh, as in JAX.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.config import EmbedderConfig
from multimodal_embeddings_tpu_torch.core.mesh import (
    DATA_AXIS,
    pad_to_multiple,
    rank_device,
    shard_batch,
)
from multimodal_embeddings_tpu_torch.io.images import resize_image_if_needed
from multimodal_embeddings_tpu_torch.models.mllama_processor import preprocess_image
from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig
from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
from multimodal_embeddings_tpu_torch.models.vision_encoder import (
    DualEncoder,
    DualEncoderConfig,
)
from multimodal_embeddings_tpu_torch.models.weights import (
    Flat,
    build_mme5,
    load_params,
    resolve_device,
)
from multimodal_embeddings_tpu_torch.parallel.sharding import shard_variables

logger = logging.getLogger("multimodal_embeddings_tpu_torch.embedder")

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
        tokenizer=None,
        mesh=None,
    ):
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else rank_device(device)
        self.dtype = _DTYPES[config.dtype]
        self.tokenizer = tokenizer or ByteTokenizer()
        if config.family == "siglip":
            self.model_config = model_config or DualEncoderConfig.base()
            model = DualEncoder(self.model_config)
            load_params(model, seed, params, config.weights_path)
            self.model = model.to(self.device, self.dtype).eval()
            self.image_size = self.model_config.vision.image_size
            self.text_len = self.model_config.text.max_len
        elif config.family == "mme5":
            mc = model_config or MllamaConfig.mme5_11b()
            if config.quantize and not mc.quantize:
                mc = dataclasses.replace(mc, quantize=config.quantize)
            if mc.quantize and mesh is not None:
                raise ValueError(
                    "the int8/int4 serving path is single-chip (quantized "
                    "params carry no TP axis metadata); use bf16 + tensor "
                    "parallelism on meshes"
                )
            self.model_config = mc
            self.model = build_mme5(
                mc, self.dtype, self.device, seed, params, config.weights_path
            )
            self.image_size = mc.vision.image_size
            self.max_tiles = mc.vision.max_tiles
            self.text_len = min(TEXT_MAX_LEN, mc.text.max_len)
            ids, mask = self.tokenizer.encode_batch([config.prompt], self.text_len)
            self.prompt_ids = torch.from_numpy(ids).to(self.device)
            self.prompt_mask = torch.from_numpy(mask).to(self.device)
        else:
            raise ValueError(f"unknown embedder family {config.family!r}")
        if mesh is not None:
            shard_variables(self.model, mesh)

    # -- device entry points ------------------------------------------------

    @torch.inference_mode()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) → (B, D) f32, L2-normalised. siglip: pixels in
        [0, 1]; mme5: CLIP-normalised single-tile crops, embedded with the
        prompt."""
        if self.config.family == "siglip":
            return self.model.encode_image(images)
        return self.encode_tiles(images)

    @torch.inference_mode()
    def encode_tiles(self, images, aspect_ratio_ids=None, tile_mask=None) -> torch.Tensor:
        """mme5: CLIP-normalised tile stacks (B, T, S, S, 3) (or single
        tiles (B, S, S, 3)) with their aspect-ratio ids and tile masks (None:
        every tile real), embedded with the prompt → (B, hidden) f32,
        L2-normalised."""
        n = images.shape[0]
        ids = self.prompt_ids.expand(n, -1)
        mask = self.prompt_mask.expand(n, -1)
        return self.model(ids, mask, images, aspect_ratio_ids, tile_mask)

    @torch.inference_mode()
    def vision_states(self, images, aspect_ratio_ids=None, tile_mask=None) -> torch.Tensor:
        """mme5: the vision tower alone over ``encode_tiles``' inputs → the
        states the text stack attends to, (B, T·(1+P), hidden)."""
        return self.model.encode_vision(images, aspect_ratio_ids, tile_mask)[0]

    @torch.inference_mode()
    def embed_vision_states(self, states: torch.Tensor) -> torch.Tensor:
        """mme5: the text stack with the prompt over ``vision_states``
        (every token real) → (B, hidden) f32, L2-normalised."""
        n = states.shape[0]
        return self.model.embed_from_vision(
            self.prompt_ids.expand(n, -1), self.prompt_mask.expand(n, -1), states
        )

    # -- host API (the reference contract) ----------------------------------

    def _prepare(self, image: Union[str, np.ndarray]):
        """One input ready for the device (siglip: ``[0, 1]`` pixels at
        ``image_size``; mme5: a ``TiledImage``), or None for a path that is
        not a readable file."""
        from PIL import Image

        if isinstance(image, str):
            if not (os.path.isfile(image) and os.access(image, os.R_OK)):
                logger.error("failed to preprocess %s: not a readable file", image)
                return None
            img = Image.open(image).convert("RGB")
        else:
            img = Image.fromarray(np.asarray(image).astype(np.uint8))
        img = resize_image_if_needed(img, self.config.max_image_dim)
        if self.config.family == "mme5":
            return preprocess_image(
                np.asarray(img), max_tiles=self.max_tiles, tile_size=self.image_size
            )
        img = img.resize((self.image_size, self.image_size), Image.BILINEAR)
        return np.asarray(img, np.float32) / 255.0

    def _embed_batch(self, batch: list) -> np.ndarray:
        if self.config.family == "siglip":
            inputs = (np.stack(batch),)
        else:
            inputs = (np.stack([t.tiles for t in batch]),
                      np.asarray([t.aspect_ratio_id for t in batch], np.int64),
                      np.stack([t.tile_mask for t in batch]))
        n = len(batch)
        if self.mesh is not None:
            # pad to the data axis (tiles zero, aspect id 1, tile mask 0, as
            # JAX pads), embed this rank's rows, gather every rank's
            pad = pad_to_multiple(n, self.mesh.shape[DATA_AXIS]) - n
            inputs = tuple(shard_batch(self.mesh, np.concatenate(
                [x, np.full((pad, *x.shape[1:]), fill, x.dtype)]))
                for x, fill in zip(inputs, (0, 1, 0)))
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(self.device) for x in inputs]
        emb = self.encode_image(*args) if self.config.family == "siglip" \
            else self.encode_tiles(*args)
        if self.mesh is not None:
            emb = self.mesh.all_gather(emb, DATA_AXIS)
        return emb[:n].cpu().numpy()

    def get_image_embeddings(
        self,
        images: Sequence[Union[str, np.ndarray]],
        is_query: bool = False,
        batch_size: Optional[int] = None,
    ) -> List[Optional[List[float]]]:
        """Embed images (paths or arrays). Returns one L2-normalised vector
        per input, None for a path that is not a readable file
        (``embedder.py:141-226``)."""
        batch_size = batch_size or self.config.batch_size
        if self.mesh is not None:
            # padded batches must divide evenly over the data axis
            batch_size = pad_to_multiple(batch_size, self.mesh.shape[DATA_AXIS])
        results: List[Optional[List[float]]] = [None] * len(images)
        pending = [(i, p) for i, p in enumerate(map(self._prepare, images)) if p is not None]
        for start in range(0, len(pending), batch_size):
            chunk = pending[start : start + batch_size]
            emb = self._embed_batch([p for _, p in chunk])
            for (idx, _), e in zip(chunk, emb):
                results[idx] = e.astype(np.float64).tolist()
        return results

    @torch.inference_mode()
    def get_text_embeddings(self, text: Union[str, Sequence[str]]) -> List:
        """Embed text (``embedder.py:228-254``). A single string returns one
        vector; a sequence returns one per entry."""
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        ids, mask = self.tokenizer.encode_batch(texts, self.text_len)
        ids = torch.from_numpy(ids).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        if self.config.family == "mme5":
            emb = self.model(ids, mask)
        else:
            emb = self.model.encode_text(ids, mask)
        out = [e.astype(np.float64).tolist() for e in emb.cpu().numpy()]
        return out[0] if single else out
