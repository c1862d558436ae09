"""ViT image tower of the SigLIP/CLIP-style dual encoder, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/vision_encoder.py``: the config
dataclasses (mirrored field for field, so a config means the same model in
both packages) and ``ViTower`` (``DualEncoder.encode_image``). The text
tower is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_embeddings_tpu_torch.models.transformer import (
    Dense,
    EncoderBlock,
    FastLayerNorm,
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
        out = self.proj(x.mean(dim=1)).float()
        return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-12)
