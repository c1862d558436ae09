"""The SigLIP/CLIP-style dual encoder, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/vision_encoder.py``: the config
dataclasses (mirrored field for field, so a config means the same model in
both packages), ``ViTower`` (the image tower), ``TextTower`` and
``DualEncoder`` (both towers and the learnable logit scale, the siglip
engine's model). The text tower's padding mask sends its attention down
``sdpa``'s plain path, as in JAX, so it runs no kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_embeddings_tpu_torch.models.mme5 import Embed
from multimodal_embeddings_tpu_torch.models.transformer import (
    Dense,
    EncoderBlock,
    FastLayerNorm,
    last_token_pool,
)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    # fused LayerNorm→matmul prologue (K6, kernels/ln_matmul.py) in every
    # block; bf16 towers of a width divisible by 128 only, as in JAX
    fuse_ln: bool = False


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 32000
    max_len: int = 64
    width: int = 512
    layers: int = 6
    heads: int = 8
    mlp_ratio: float = 4.0


@dataclasses.dataclass(frozen=True)
class DualEncoderConfig:
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    embed_dim: int = 768

    @classmethod
    def tiny(cls) -> "DualEncoderConfig":
        return cls(
            vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=2, heads=2),
            text=TextConfig(vocab_size=512, max_len=16, width=64, layers=2, heads=2),
            embed_dim=64,
        )

    @classmethod
    def base(cls) -> "DualEncoderConfig":
        return cls(
            vision=VisionConfig(image_size=448, patch_size=16, width=768, layers=12, heads=12),
            text=TextConfig(vocab_size=32000, max_len=64, width=512, layers=6, heads=8),
            embed_dim=768,
        )


class ViTower(nn.Module):
    """Patch conv → learned positions → pre-LN blocks → final LN → mean
    pool → projection → L2 normalisation (f32)."""

    def __init__(self, config: VisionConfig, embed_dim: int):
        super().__init__()
        self.config = config
        c, p = config.width, config.patch_size
        self.patch_embed = nn.Conv2d(3, c, p, stride=p)
        self.pos_embed = nn.Parameter(
            torch.empty(1, (config.image_size // p) ** 2, c)
        )
        for i in range(config.layers):
            self.add_module(
                f"block{i}",
                EncoderBlock(c, config.heads, config.mlp_ratio, fuse_ln=config.fuse_ln),
            )
        self.final_ln = FastLayerNorm(c)
        self.proj = Dense(c, embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, S, S, 3) float in [0, 1] → (B, embed_dim) f32,
        L2-normalised."""
        dtype = self.pos_embed.dtype
        x = self.patch_embed(images.to(dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, gh·gw, C), row-major patches
        x = x + self.pos_embed[:, : x.shape[1]]
        for i in range(self.config.layers):
            x = getattr(self, f"block{i}")(x)
        x = self.final_ln(x)
        return _l2(self.proj(x.mean(dim=1)))


def _l2(out: torch.Tensor) -> torch.Tensor:
    out = out.float()
    return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class TextTower(nn.Module):
    """Token embedding + learned positions (an f32 residual stream, as the
    JAX tower's f32 positions promote it) → pre-LN blocks with the key
    padding mask → final LN → the last attended token (f32, not
    normalised) → projection → L2 normalisation (f32)."""

    def __init__(self, config: TextConfig, embed_dim: int):
        super().__init__()
        self.config = config
        c = config.width
        self.tok_embed = Embed(config.vocab_size, c, torch.float32)
        self.pos_embed = nn.Parameter(torch.empty(1, config.max_len, c))
        for i in range(config.layers):
            self.add_module(f"block{i}", EncoderBlock(c, config.heads, config.mlp_ratio))
        self.final_ln = FastLayerNorm(c)
        self.proj = Dense(c, embed_dim)

    def forward(self, token_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """token_ids, attention_mask: (B, L) → (B, embed_dim) f32,
        L2-normalised."""
        x = self.tok_embed(token_ids.long()) + self.pos_embed[:, : token_ids.shape[1]]
        mask = attention_mask[:, None, None, :].bool()
        for i in range(self.config.layers):
            x = getattr(self, f"block{i}")(x, mask=mask)
        x = self.final_ln(x)
        pooled = last_token_pool(x.float(), attention_mask, normalize=False)
        return _l2(self.proj(pooled))


class DualEncoder(nn.Module):
    """The image and text towers in one embedding space, and the learnable
    logit scale (stored as its log, ``exp`` at use)."""

    def __init__(self, config: DualEncoderConfig):
        super().__init__()
        self.config = config
        self.vision = ViTower(config.vision, config.embed_dim)
        self.text = TextTower(config.text, config.embed_dim)
        self.logit_scale = nn.Parameter(torch.full((1,), math.log(1 / 0.07)))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.vision(images)

    def encode_text(self, token_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.text(token_ids, attention_mask)

    def forward(self, images, token_ids, attention_mask):
        return (self.encode_image(images), self.encode_text(token_ids, attention_mask),
                torch.exp(self.logit_scale))
