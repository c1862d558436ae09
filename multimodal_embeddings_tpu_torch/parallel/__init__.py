"""Parallelism: logical-axis sharding rules over the (data, model) mesh of
ranks, and the GPipe pipeline over a stage axis."""

from multimodal_embeddings_tpu_torch.parallel.sharding import (
    LOGICAL_AXIS_RULES,
    batch_spec,
    shard_variables,
    unbox,
)
