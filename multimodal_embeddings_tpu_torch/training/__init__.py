"""Training: contrastive fine-tuning over the mesh of ranks."""

from multimodal_embeddings_tpu_torch.training.contrastive import (
    ContrastiveTrainer,
    TrainerConfig,
    clip_loss,
)
