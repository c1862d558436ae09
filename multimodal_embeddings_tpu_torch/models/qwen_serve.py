"""Continuous-batching greedy serving for the Qwen2.5-VL parse, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/qwen_serve.py``. A wave of B
pages (``qwen_vl.build_generate_fns``) decodes until its longest page ends;
here a fixed B-row decoder frees each row at that row's own EOS (or at
``max_new_tokens``) and splices the next queued page into it:

- ``prefill1``: one page's prefill, its KV caches padded to the decoder's
  ``cache_len``;
- ``splice_row``: copies that page's caches, first token, clock and M-RoPE
  delta into one row of the live state, in place;
- ``decode_chunk`` / ``decode_chunk_exit``: C greedy steps over the B rows
  with per-row cache depths (``QwenVLModel.decode_step`` with a ``(B,)``
  position), the host reading the result once per chunk.

Rows never wait for each other. Tokens equal the one-shot decoders' for
every page under the same stop injection (``stops`` mirrors
``build_generate_fns``'s ``force_steps``: random weights never emit a real
EOS, so measurements inject a per-page stop).

The port keeps the JAX functions' names, state keys and ``stats`` keys. The
functions take no parameter tree: the weights live in the model, as
everywhere in the port.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.models.qwen_vl import _KV_DTYPES, QwenVLModel


def build_continuous_fns(
    model: QwenVLModel,
    batch: int,
    prompt_len: int,
    max_new_tokens: int,
    chunk: int,
):
    """(prefill1, splice_row, decode_chunk, decode_chunk_exit, init_state)
    for continuous batching on the model's device.

    The state is a dict of tensors on that device:

    - ``token`` (B,) int32 — the carry token, output position ``t``
    - ``t`` (B,) int32 — per-row output clock (position of ``token``)
    - ``done`` (B,) bool — row has emitted EOS
    - ``stops`` (B,) int32 — per-row injected stop (``max_new+1`` = off)
    - ``delta`` (B,) int32 — per-row M-RoPE delta
    - ``caches`` — per-layer (K, V) static caches, (B, S, kvh, d)

    ``decode_chunk`` emits (C, B) tokens at per-row output positions
    ``t+1 .. t+C`` (position 0, the prefill's argmax, is returned by
    ``splice_row``). Each step feeds row r at cache slot ``prompt_len +
    min(t[r], max_new_tokens − 1)``. A done row keeps stepping: it emits EOS
    and writes EOS k/v into its own advancing slots (clamped only from ``t =
    max_new_tokens − 1`` on), never into another row's. Those writes are
    harmless: the row's tokens are pinned to EOS, and the next splice
    overwrites the whole row, every slot of every layer.

    There is no compiled-program cache (JAX keeps one, ``_SERVE_CACHE``,
    because each (batch, prompt, chunk) bucket compiles once): PyTorch runs
    these functions eagerly, so building them costs nothing.
    """
    cfg = model.config.text
    eos = model.config.eos_id
    cache_len = min(cfg.max_len, -(-(prompt_len + max_new_tokens) // 128) * 128)
    device = next(model.parameters()).device

    @torch.inference_mode()
    def prefill1(tokens, imgs):
        logits, caches, delta = model(tokens, imgs, cache_len=cache_len, last_only=True)
        return logits[:, -1], caches, delta

    @torch.inference_mode()
    def splice_row(state, row, last_logits, new_caches, new_delta, stop):
        """Row ``row`` takes the page: its caches are COPIED into the state's
        (no view of the prefill's tensors survives), every other row is left
        as it was. Returns (state, first token as a 0-d device tensor)."""
        first = last_logits[0].argmax(dim=-1).to(torch.int32)
        if stop <= 0:
            first = torch.full_like(first, eos)
        for (k, v), (nk, nv) in zip(state["caches"], new_caches):
            k[row].copy_(nk[0])
            v[row].copy_(nv[0])
        state["token"][row] = first
        state["t"][row] = 0
        state["done"][row] = first == eos
        state["stops"][row] = stop
        state["delta"][row] = new_delta[0]
        return state, first

    def _step(token, t, done, stops, delta, caches):
        pos = prompt_len + torch.clamp(t, max=max_new_tokens - 1)
        logits, caches = model.decode_step(token[:, None], caches, pos, delta)
        next_token = logits[:, -1].argmax(dim=-1).to(torch.int32)
        eos_t = torch.full_like(next_token, eos)
        next_token = torch.where(t + 1 >= stops, eos_t, next_token)
        next_token = torch.where(done, eos_t, next_token)
        return next_token, t + 1, done | (next_token == eos), caches

    @torch.inference_mode()
    def decode_chunk(state):
        """C steps with no host read; returns (state, emitted (C, B),
        steps = C)."""
        token, t, done = state["token"], state["t"], state["done"]
        caches = state["caches"]
        emitted = []
        for _ in range(chunk):
            token, t, done, caches = _step(token, t, done, state["stops"], state["delta"],
                                           caches)
            emitted.append(token)
        return {**state, "token": token, "t": t, "done": done, "caches": caches}, \
            torch.stack(emitted), chunk

    @torch.inference_mode()
    def decode_chunk_exit(state, want_exit):
        """Like ``decode_chunk`` but exits as soon as any row that was
        ACTIVE at entry finishes (rows already done at entry, retired rows
        idling on an empty queue, don't trigger), and whenever every row is
        done. ``want_exit=False`` disables the first exit (the host passes
        it when the page queue is empty). The condition is JAX's
        ``while_loop`` condition, ``(i < chunk) & ~all(done) &
        (~any(done & ~done0) | ~want_exit)``, read on the host once before
        every step (one device flag read per step, as ``decode_early``
        does). Returns (state, emitted (C, B), steps run); emitted slots
        from ``steps`` on are EOS filler the host discards."""
        done0 = state["done"]
        token, t, done = state["token"], state["t"], done0
        caches = state["caches"]
        out = torch.full((chunk, done0.shape[0]), eos, dtype=torch.int32, device=done0.device)
        i = 0
        while i < chunk:
            stop = done.all()
            if want_exit:
                stop = stop | (done & ~done0).any()
            if bool(stop):
                break
            token, t, done, caches = _step(token, t, done, state["stops"], state["delta"],
                                           caches)
            out[i] = token
            i += 1
        return {**state, "token": token, "t": t, "done": done, "caches": caches}, out, i

    @torch.inference_mode()
    def init_state():
        kvd = _KV_DTYPES[cfg.kv_dtype]
        shape = (batch, cache_len, cfg.kv_heads, cfg.head_dim)
        caches = [
            (torch.zeros(shape, dtype=kvd, device=device),
             torch.zeros(shape, dtype=kvd, device=device))
            for _ in range(cfg.layers)
        ]
        return {
            "token": torch.full((batch,), eos, dtype=torch.int32, device=device),
            "t": torch.zeros((batch,), dtype=torch.int32, device=device),
            "done": torch.ones((batch,), dtype=torch.bool, device=device),
            "stops": torch.full((batch,), max_new_tokens + 1, dtype=torch.int32, device=device),
            "delta": torch.zeros((batch,), dtype=torch.int32, device=device),
            "caches": caches,
        }

    return prefill1, splice_row, decode_chunk, decode_chunk_exit, init_state


def continuous_generate(
    model: QwenVLModel,
    pages: Sequence[Optional[Tuple[Any, Any]]],
    batch: int,
    max_new_tokens: int,
    chunk: int = 64,
    stops: Optional[Sequence[int]] = None,
    stats: Optional[Dict[str, Any]] = None,
    early_exit: bool = True,
) -> List[Optional[np.ndarray]]:
    """Parse ``pages`` through a continuously refilled B-row decoder on the
    model's device.

    ``pages`` is a sequence of ``(token_ids, images)`` (numpy arrays or
    tensors; images None for a text-only page) with IDENTICAL shapes
    (bucket by smart-resize grid first, as ``DocumentParser.parse_batch``
    does). Each page is read once, when a row takes it, so a lazy sequence
    keeps only the pages in flight in memory; an item that is None (a lazy
    page that could not be read) takes no row and yields None. ``stops``
    optionally injects a per-page EOS position. Returns one
    ``(max_new_tokens,)`` EOS-padded int32 array per page, in page order:
    the tokens of the one-shot ``build_generate_fns`` decoders under the
    same injection. ``stats`` (optional dict) gets ``decode_steps`` /
    ``chunks`` / ``wall_s`` / ``splice_s`` / ``batch`` / ``chunk`` /
    ``early_exit`` filled in.

    ``early_exit=True`` (default) returns to the host as soon as a row
    finishes, so the refill happens at once instead of after up to
    ``chunk − 1`` idle steps, at one flag read per step.
    ``early_exit=False`` runs fixed chunks of ``chunk`` steps with no read
    inside: fewer host syncs, more tail waste. Tokens are identical either
    way.
    """
    if not len(pages):
        return []
    eos = model.config.eos_id
    device = next(model.parameters()).device
    outputs: List[Optional[np.ndarray]] = [None] * len(pages)
    collected: Dict[int, List[Any]] = {}
    active: Dict[int, int] = {}  # row -> page index
    free = list(range(batch))
    next_page = 0
    n_steps = 0
    n_chunks = 0
    splice_s = 0.0
    fns: Optional[tuple] = None
    state: Optional[dict] = None
    firsts: Optional[torch.Tensor] = None  # each row's first token, on the device
    t0 = time.perf_counter()

    def finalize(row: int) -> None:
        pid = active.pop(row)
        toks = collected.pop(row)[:max_new_tokens]
        out = np.full((max_new_tokens,), eos, np.int32)
        out[: len(toks)] = toks
        outputs[pid] = out
        free.append(row)

    def refill() -> None:
        nonlocal state, next_page, splice_s, fns, firsts
        while free and next_page < len(pages):
            ts = time.perf_counter()
            pid = next_page
            next_page += 1
            page = pages[pid]
            if page is None:
                continue
            toks, imgs = page
            toks = torch.as_tensor(np.asarray(toks), dtype=torch.long).reshape(1, -1).to(device)
            if fns is None:
                fns = build_continuous_fns(model, batch, toks.shape[1], max_new_tokens, chunk)
                state = fns[4]()
                firsts = torch.full((batch,), eos, dtype=torch.int32, device=device)
            row = free.pop()
            if imgs is not None:
                imgs = torch.as_tensor(imgs, dtype=torch.float32).to(device)
                imgs = imgs.reshape((1,) + tuple(imgs.shape[-3:]))
            last, caches_new, delta_new = fns[0](toks, imgs)
            stop = max_new_tokens + 1 if stops is None else int(stops[pid])
            state, first = fns[1](state, row, last, caches_new, delta_new, stop)
            del caches_new
            # ``first`` stays on the device until the next chunk's fetch
            # (a row is refilled only after a fetch); an instant-EOS row
            # resolves there through its done flag
            firsts[row] = first
            collected[row] = []
            active[row] = pid
            splice_s += time.perf_counter() - ts

    refill()
    while active:
        if early_exit:
            state, emitted, steps = fns[3](state, next_page < len(pages))
        else:
            state, emitted, steps = fns[2](state)
        n_chunks += 1
        # ONE host fetch per chunk: the emitted tokens, the per-row clocks,
        # the done flags and the first tokens travel together (``steps`` is
        # a host int)
        fetched = torch.cat([emitted.reshape(-1), state["t"], state["done"].to(torch.int32),
                             firsts]).cpu().numpy()
        em = fetched[: chunk * batch].reshape(chunk, batch)
        t_np, done_np, first_np = fetched[chunk * batch :].reshape(3, batch)
        n_steps += steps
        for row in list(active):
            if not collected[row]:
                collected[row].append(int(first_np[row]))
            collected[row].extend(int(x) for x in em[:steps, row])
            if done_np[row] or t_np[row] >= max_new_tokens - 1:
                finalize(row)
        refill()

    if stats is not None:
        stats["decode_steps"] = n_steps
        stats["chunks"] = n_chunks
        stats["wall_s"] = time.perf_counter() - t0
        stats["splice_s"] = splice_s
        stats["batch"] = batch
        stats["chunk"] = chunk
        stats["early_exit"] = early_exit
    return outputs
