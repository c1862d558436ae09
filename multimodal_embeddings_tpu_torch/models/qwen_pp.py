"""Pipeline-parallel Qwen greedy generation (the 32B serving assembly).

Port of ``multimodal_embeddings_tpu/models/qwen_pp.py``: the decoder stack
of ``models/qwen_vl.py`` split over the stage ranks of
``parallel/pipeline.py`` in a full greedy-decode loop over a prompt (the
reference notebook's ``inference()``):

* prefill: one ``pipeline_decode_step`` pass whose layer function runs the
  full-sequence causal block and returns its KV cache, padded to the
  generation's ``cache_len`` (prompt + new tokens, rounded up to 128, at
  most ``max_len``: the rule of ``build_generate_fns``), as the layer's
  state;
* decode: one ``pipeline_decode_step`` per token, each stage's caches
  written in place;
* the embedding, the vision tower, the final norm and the LM head (float,
  int8 or int4, as the model stores it) run on every rank outside the
  ring.

Each step is the model's own ``decode_step`` cut at the stage boundaries,
with the same tensors and kernels, so with one stage the tokens are those
of ``greedy_generate`` on the same model, bit for bit; on the CPU they are
JAX's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_embeddings_tpu_torch.models.qwen_vl import (
    QwenVLConfig,
    QwenVLModel,
    qwen_mrope_position_ids,
)
from multimodal_embeddings_tpu_torch.models.weights import build_qwen
from multimodal_embeddings_tpu_torch.parallel.pipeline import (
    pipeline_decode_step,
    stack_layer_params,
)


def pp_greedy_generate(
    config: QwenVLConfig,
    model_or_params,
    token_ids,  # (B, L) prompt with image-pad placeholders
    *,
    mesh,
    n_stages: int,
    max_new_tokens: int = 16,
    images=None,
    device="cuda",
) -> np.ndarray:
    """Greedy decode with the decoder stack pipelined over ``n_stages``.

    ``model_or_params`` is a ``QwenVLModel`` (run on its device) or a JAX
    flat parameter dict (a model of ``config`` is built from it in f32 on
    ``device``, as the JAX function computes in f32). ``images`` (B, H, W,
    3) runs the vision tower before the ring and splices its tokens into
    the ``image_pad_id`` slots; the M-RoPE streams use the merged grid.
    Returns (B, max_new_tokens) int32 token ids, EOS-padded."""
    model = model_or_params
    if not isinstance(model, QwenVLModel):
        model = build_qwen(config, torch.float32, device, params=model_or_params)
    text = config.text
    dev = next(model.parameters()).device
    prompt = torch.as_tensor(np.asarray(token_ids), dtype=torch.long).to(dev)
    b, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > text.max_len:
        raise ValueError("prompt + new tokens exceed max_len")
    imgs = None if images is None else torch.as_tensor(np.asarray(images, np.float32)).to(dev)
    stacked = stack_layer_params(model.blocks, n_stages)
    # the static cache of build_generate_fns: decode steps read the whole
    # padded cache under the position mask, so it is sized to the generation
    cache_len = min(text.max_len, -(-(prompt_len + max_new_tokens) // 128) * 128)
    eos = config.eos_id

    def head(hidden):
        logits = model.lm_head(model.final_norm(hidden[:, -1:]))
        return logits[:, -1].argmax(dim=-1).to(torch.int32)

    with torch.inference_mode():
        # -- prefill: full causal pass, caches captured as pipeline state --
        x = model.embed_multimodal(prompt, imgs)
        position_ids, delta = qwen_mrope_position_ids(prompt, config.image_pad_id,
                                                      model.merged_grid(imgs))
        cos, sin = model.mrope(position_ids)

        def prefill_fn(block, _, h):
            h, (k, v) = block(h, cos, sin)
            pad = cache_len - k.shape[1]
            return h, (F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad)))

        no_state = [[None] * len(stage) for stage in stacked]
        hidden, state = pipeline_decode_step(prefill_fn, stacked, no_state, x, mesh=mesh)
        token = head(hidden)

        # -- decode: one ring pass per token --
        done = token == eos
        positions = torch.arange(prompt_len, prompt_len + max_new_tokens, dtype=torch.int32,
                                 device=dev)
        slots = torch.arange(cache_len, device=dev)
        rows = torch.arange(b, device=dev)
        out = []
        for t in range(max_new_tokens):
            out.append(torch.where(done, torch.full_like(token, eos), token))
            pos = torch.broadcast_to(positions[t], (b,))
            mask = slots[None, None, None, :] <= pos[:, None, None, None]
            index = (rows, pos.long())
            rot = pos + delta
            cos_t, sin_t = model.mrope(rot[None, :, None].expand(3, b, 1))

            def decode_fn(block, cache, h, cos_t=cos_t, sin_t=sin_t, mask=mask, index=index):
                return block(h, cos_t, sin_t, mask=mask, cache=cache, index=index)

            h = model.tok_embed(out[-1][:, None])
            hidden, state = pipeline_decode_step(decode_fn, stacked, state, h, mesh=mesh)
            token = head(hidden)
            done = done | (token == eos)
    return torch.stack(out, dim=1).cpu().numpy()
