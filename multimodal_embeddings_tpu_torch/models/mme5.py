"""The mmE5 embedder: an Mllama-style multimodal model, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/mme5.py``. The system's
embedding model is ``intfloat/mmE5-mllama-11b-instruct``: a tiled ViT
vision tower (patch 14, class token, 32 local and 8 tanh-gated global
layers, channel-interleaved intermediate layers projected to the text
width) feeding a Llama-3 text stack (RMSNorm, RoPE, GQA, SwiGLU) with
tanh-gated cross-attention blocks, pooled at the last attended token and
L2-normalised.

The config dataclasses mirror the JAX ones field for field. ``quantize``
selects the weight storage (``split_quantize``): False (float), True or
``"int8"`` (every projection int8, K2), ``"int4"`` (every projection packed
int4 with group-128 scales, K3), ``"int8-mixed"`` (float vision tower, int8
text stack — the serving default) and ``"int4-mixed"`` (float vision
tower, int4 text stack). The multi-modal projector stays float in every
form, as in JAX. Module and parameter names follow the JAX scopes, so
``models/weights.py`` bridges a JAX tree by path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_embeddings_tpu_torch.models.mllama_processor import (
    num_aspect_ratio_ids,
)
from multimodal_embeddings_tpu_torch.models.transformer import (
    CrossAttentionBlock,
    Dense,
    EncoderBlock,
    FastLayerNorm,
    GatedEncoderBlock,
    LlamaBlock,
    RMSNorm,
    last_token_pool,
)


@dataclasses.dataclass(frozen=True)
class MllamaVisionConfig:
    image_size: int = 560
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    global_layers: int = 8
    heads: int = 16
    mlp_ratio: float = 4.0
    intermediate_layers: Tuple[int, ...] = (3, 7, 15, 23, 30)
    max_tiles: int = 4
    # fused LayerNorm→matmul prologue (K6, kernels/ln_matmul.py) in the
    # local blocks: False | True | "attn" | "mlp" (the fc1 site is the
    # JAX package's measured target)
    fuse_ln: object = False

    @property
    def patches_per_tile(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_aspect_ratio_ids(self) -> int:
        return num_aspect_ratio_ids(self.max_tiles)


@dataclasses.dataclass(frozen=True)
class MllamaTextConfig:
    vocab_size: int = 128256
    hidden: int = 4096
    layers: int = 40
    heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    mlp_hidden: int = 14336
    max_len: int = 512
    rope_theta: float = 500000.0
    cross_attn_layers: Tuple[int, ...] = (3, 8, 13, 18, 23, 28, 33, 38)


@dataclasses.dataclass(frozen=True)
class MllamaConfig:
    vision: MllamaVisionConfig = dataclasses.field(default_factory=MllamaVisionConfig)
    text: MllamaTextConfig = dataclasses.field(default_factory=MllamaTextConfig)
    quantize: Any = False

    @classmethod
    def tiny(cls) -> "MllamaConfig":
        return cls(
            vision=MllamaVisionConfig(
                image_size=28, patch_size=14, width=32, layers=2, global_layers=1,
                heads=2, intermediate_layers=(0, 1),
            ),
            text=MllamaTextConfig(
                vocab_size=256, hidden=64, layers=4, heads=4, kv_heads=2,
                head_dim=16, mlp_hidden=128, max_len=32, cross_attn_layers=(1, 3),
            ),
        )

    @classmethod
    def mme5_11b(cls) -> "MllamaConfig":
        """The full mmE5-mllama-11b-instruct layout."""
        return cls()

    @classmethod
    def mme5_11b_int8(cls) -> "MllamaConfig":
        """The 11B layout with every projection int8 (tower and text)."""
        return cls(quantize=True)

    @classmethod
    def mme5_11b_int8_mixed(cls) -> "MllamaConfig":
        """11B with a bf16 vision tower and an int8 text stack (11.57 GB of
        parameters by ``param_bytes``)."""
        return cls(quantize="int8-mixed")

    @classmethod
    def mme5_11b_int4(cls) -> "MllamaConfig":
        """The 11B layout with every projection packed int4, group-128
        scales (tower and text)."""
        return cls(quantize="int4")

    @classmethod
    def mme5_2b(cls) -> "MllamaConfig":
        """The full vision tower over a scaled-down Llama text stack."""
        return cls(
            vision=MllamaVisionConfig(max_tiles=1),
            text=MllamaTextConfig(
                hidden=2048, layers=16, heads=16, kv_heads=8, head_dim=128,
                mlp_hidden=8192, cross_attn_layers=(3, 8, 13),
            ),
        )


def split_quantize(quantize) -> Tuple[Any, Any]:
    """``quantize`` → (vision, text) storage, as ``MmE5Embedder.setup`` of
    the JAX package maps it: the mixed forms keep the tower float, every
    other value applies to both stacks."""
    if quantize == "int8-mixed":
        return False, True
    if quantize == "int4-mixed":
        return False, "int4"
    return quantize, quantize


class TilePositionalEmbedding(nn.Module):
    """A per-aspect-ratio, per-tile embedding added to every token of the
    tile, tanh-gated; table ``(num_ids, max_tiles·width)``."""

    def __init__(self, max_tiles: int, width: int, num_ids: int):
        super().__init__()
        self.max_tiles, self.width = max_tiles, width
        self.embedding = nn.Parameter(torch.empty(num_ids, max_tiles * width))
        self.gate = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, aspect_ratio_ids: torch.Tensor) -> torch.Tensor:
        """x: (B, T, L, W); short stacks take the first T slots."""
        emb = self.embedding[aspect_ratio_ids].reshape(-1, self.max_tiles, 1, self.width)
        return x + torch.tanh(self.gate) * emb[:, : x.shape[1]].to(x.dtype)


class GatedPositionalEmbedding(nn.Module):
    """``x + (1 − tanh g)·pos + tanh g·tile_pos[aspect_ratio_id]``."""

    def __init__(self, max_tiles: int, width: int, num_ids: int, num_patches: int):
        super().__init__()
        self.max_tiles, self.width, self.num_patches = max_tiles, width, num_patches
        self.embedding = nn.Parameter(torch.empty(num_patches, width))
        self.tile_embedding = nn.Parameter(
            torch.empty(num_ids, max_tiles * num_patches * width)
        )
        self.gate = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, aspect_ratio_ids: torch.Tensor) -> torch.Tensor:
        g = torch.tanh(self.gate)
        x = x + ((1.0 - g) * self.embedding)[None, None].to(x.dtype)
        tile_pos = self.tile_embedding[aspect_ratio_ids].reshape(
            -1, self.max_tiles, self.num_patches, self.width
        )
        return x + (g * tile_pos[:, : x.shape[1]]).to(x.dtype)


def _pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


class MllamaVisionEncoder(nn.Module):
    """Patch conv → gated pre-tile embedding → class token → gated
    positions → pre-LN → local layers over the tiles' sequences, each padded
    to a multiple of 8 → post-LN → gated post-tile embedding → gated global
    layers → [final, channel-interleaved intermediates] → projector.

    With every tile real and one tile (the page program's crops), the key
    mask is the static prefix ``< 1 + patches`` and the attention runs on K1
    with that prefix; otherwise padding and invalid tiles are masked keys
    of the plain attention."""

    def __init__(self, config: MllamaVisionConfig, out_dim: int, dtype, quantize=False):
        super().__init__()
        c, w = config, config.width
        self.config = c
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, w, c.patch_size, stride=c.patch_size, bias=False)
        n_ids = c.num_aspect_ratio_ids
        self.pre_tile_pos_embed = TilePositionalEmbedding(c.max_tiles, w, n_ids)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.gated_pos_embed = GatedPositionalEmbedding(
            c.max_tiles, w, n_ids, c.patches_per_tile + 1
        )
        self.pre_ln = FastLayerNorm(w, dtype=dtype)
        for i in range(c.layers):
            self.add_module(
                f"local{i}",
                EncoderBlock(w, c.heads, c.mlp_ratio, quantize, dtype, fuse_ln=c.fuse_ln),
            )
        self.post_ln = FastLayerNorm(w, dtype=dtype)
        self.post_tile_pos_embed = TilePositionalEmbedding(c.max_tiles, w, n_ids)
        for i in range(c.global_layers):
            self.add_module(
                f"global{i}", GatedEncoderBlock(w, c.heads, c.mlp_ratio, quantize, dtype)
            )
        feats = w * (1 + len(c.intermediate_layers))
        self.multi_modal_projector = Dense(feats, out_dim)

    def forward(
        self,
        images: torch.Tensor,  # (B, T, S, S, 3) normalised tiles
        aspect_ratio_ids: torch.Tensor,  # (B,)
        tile_mask: Optional[torch.Tensor] = None,  # (B, T); None: every tile real
    ):
        """→ (vision states (B, T·(1+P), out_dim), token mask (B, T·(1+P)))."""
        c = self.config
        b, t, s = images.shape[0], images.shape[1], images.shape[2]
        if t > c.max_tiles:
            raise ValueError(f"tile stack ({t}) exceeds max_tiles ({c.max_tiles})")
        x = self.patch_embed(images.reshape(b * t, s, s, 3).to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B·T, P, W), row-major patches
        patches = x.shape[1]
        x = self.pre_tile_pos_embed(x.reshape(b, t, patches, c.width), aspect_ratio_ids)
        cls = self.class_embedding.to(x.dtype).expand(b, t, 1, c.width)
        x = torch.cat([cls, x], dim=2)
        seq = patches + 1
        x = self.pre_ln(self.gated_pos_embed(x, aspect_ratio_ids))

        padded = _pad_to_multiple(seq, 8)
        x = F.pad(x, (0, 0, 0, padded - seq))
        real = (
            torch.ones(b, t, dtype=torch.bool, device=x.device)
            if tile_mask is None else tile_mask.bool()
        )
        mask = key_valid_len = None
        if tile_mask is None and t == 1:
            key_valid_len = seq
        else:
            pos_valid = torch.arange(padded, device=x.device) < seq
            mask = (real[:, :, None] & pos_valid).reshape(b, 1, 1, t * padded)
        x = x.reshape(b, t * padded, c.width)

        intermediates = []
        for i in range(c.layers):
            # HF's intermediate index i is the INPUT of layer i
            if i in c.intermediate_layers:
                intermediates.append(x)
            x = getattr(self, f"local{i}")(x, mask=mask, key_valid_len=key_valid_len)
        x = self.post_ln(x)
        x = self.post_tile_pos_embed(x.reshape(b, t, padded, c.width), aspect_ratio_ids)
        x = x.reshape(b, t * padded, c.width)
        for i in range(c.global_layers):
            x = getattr(self, f"global{i}")(x, mask=mask, key_valid_len=key_valid_len)

        # [final, stack(intermediates, -1)]: the intermediate block is
        # channel-interleaved (index = channel·n + layer)
        inter = torch.stack(intermediates, dim=-1).reshape(b, t * padded, -1)
        dt = torch.promote_types(x.dtype, inter.dtype)
        feats = torch.cat([x.to(dt), inter.to(dt)], dim=-1)
        feats = feats.reshape(b, t, padded, -1)[:, :, :seq].reshape(b, t * seq, -1)
        out = self.multi_modal_projector(feats)
        token_mask = real[:, :, None].expand(b, t, seq).reshape(b, t * seq)
        return out, token_mask


class Embed(nn.Module):
    """``flax.linen.Embed``: rows of ``embedding`` in the compute dtype."""

    def __init__(self, vocab: int, width: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(vocab, width))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids].to(self.dtype)


class MllamaTextModel(nn.Module):
    """Token embedding → Llama blocks with cross-attention blocks at
    ``cross_attn_layers`` → final RMSNorm."""

    def __init__(self, config: MllamaTextConfig, dtype, quantize=False):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.tok_embed = Embed(c.vocab_size, c.hidden, dtype)
        for i in range(c.layers):
            if i in c.cross_attn_layers:
                block = CrossAttentionBlock(
                    c.hidden, c.heads, c.kv_heads, c.head_dim, c.mlp_hidden, quantize, dtype
                )
                self.add_module(f"cross{i}", block)
            else:
                block = LlamaBlock(
                    c.hidden, c.heads, c.kv_heads, c.head_dim, c.mlp_hidden,
                    c.rope_theta, quantize, dtype,
                )
                self.add_module(f"layer{i}", block)
        self.final_norm = RMSNorm(c.hidden, dtype=dtype)

    def forward(
        self,
        token_ids: torch.Tensor,  # (B, L)
        attention_mask: torch.Tensor,  # (B, L)
        vision_states: Optional[torch.Tensor] = None,  # (B, Lv, hidden)
        vision_mask: Optional[torch.Tensor] = None,  # (B, Lv) 1 = real token
    ) -> torch.Tensor:
        c = self.config
        x = self.tok_embed(token_ids)
        pad_mask = attention_mask[:, None, None, :].bool()
        if vision_states is None:
            # text only: the cross blocks attend to one zero token
            vision_states = torch.zeros(x.shape[0], 1, c.hidden, dtype=x.dtype, device=x.device)
        cross_mask = None if vision_mask is None else vision_mask[:, None, None, :].bool()
        for i in range(c.layers):
            if i in c.cross_attn_layers:
                x = getattr(self, f"cross{i}")(x, vision_states, cross_mask=cross_mask)
            else:
                x = getattr(self, f"layer{i}")(x, mask=pad_mask)
        return self.final_norm(x)


class MmE5Embedder(nn.Module):
    """The vision tower and the text stack with the mmE5 pooling contract."""

    def __init__(self, config: MllamaConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        vision_q, text_q = split_quantize(config.quantize)
        self.vision_model = MllamaVisionEncoder(
            config.vision, config.text.hidden, dtype, quantize=vision_q
        )
        self.text_model = MllamaTextModel(config.text, dtype, quantize=text_q)

    def forward(
        self,
        token_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        images: Optional[torch.Tensor] = None,  # (B, T, S, S, 3) or (B, S, S, 3)
        aspect_ratio_ids: Optional[torch.Tensor] = None,
        tile_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        states = mask = None
        if images is not None:
            states, mask = self.encode_vision(images, aspect_ratio_ids, tile_mask)
        return self.embed_from_vision(token_ids, attention_mask, states, mask)

    def encode_vision(self, images, aspect_ratio_ids=None, tile_mask=None):
        """Vision tower only → (vision states, vision mask). A 4-D input is
        one (1, 1)-aspect tile per image; no ``tile_mask`` means every tile
        is real."""
        if images.dim() == 4:
            images = images[:, None]
        if aspect_ratio_ids is None:  # id 1: the (1, 1) arrangement
            aspect_ratio_ids = torch.ones(images.shape[0], dtype=torch.long, device=images.device)
        if tile_mask is not None and tile_mask.shape[1] != images.shape[1]:
            raise ValueError(f"tile_mask covers {tile_mask.shape[1]} tiles, images {images.shape[1]}")
        return self.vision_model(images, aspect_ratio_ids, tile_mask)

    def embed_from_vision(self, token_ids, attention_mask, vision_states=None, vision_mask=None):
        """Text stack and pooling over precomputed vision states → (B, hidden)
        f32, L2-normalised."""
        hidden = self.text_model(token_ids, attention_mask, vision_states, vision_mask)
        return last_token_pool(hidden.float(), attention_mask, normalize=True)
