"""Core: the mesh of ranks, sharding helpers, dtype policy."""

from multimodal_embeddings_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DTypePolicy,
    data_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
