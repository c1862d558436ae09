"""Pipeline: the page program, the numbered chain's stage functions and
its processors (the JAX package's ``pipeline`` exports)."""

from multimodal_embeddings_tpu_torch.pipeline.fused import build_fused_page_fn
from multimodal_embeddings_tpu_torch.pipeline.stages import (
    run_columns_stage,
    run_combine_stage,
    run_edge_filter_stage,
    run_median_stage,
)
