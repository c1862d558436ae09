"""The document parser's driver: pages through the parser's preprocessing
and prompt, then ``models/qwen_serve.py::continuous_generate`` (the decoder
under ``DocumentParser.parse_continuous`` and ``cli/parse.py
--continuous``) with the cell's rows, chunk and early exit, each page
stopped at its drawn output length.

Set-up builds the model at the configuration's widths and draws its float
weights on the card from the seed, a decoder layer at a time: the program
quantizes the int4 sites with its own rule, and the reference later draws
the same floats again and works its int4 weights out itself. The window is
one ``continuous_generate`` call over the cell's queue (a traced run
profiles that call), with a recorder copying what the model computes for
each page. The check runs the plain reference in float32 over a sample of
the served pages, the longest among them, and compares the program's
vision output, prefill and decode logits and cached keys and values with
the reference's, and how far below the reference's best logit each served
token's logit lies.
"""

from __future__ import annotations

import math
import time
from typing import List, Tuple

import numpy as np
import torch

from benchlib.common import Clock, RunResult, span
from benchlib.roofline import bound_s, int4_matmul_work
from benchlib.trace import from_profiler
from reference import page_ref
from reference import qwen_ref as ref


RESIDUAL_STD = 0.002


class Weights:
    """The configuration's weights drawn from the seed on the device, as
    float values of bf16: the token table N(0, 1), every other matrix
    N(0, 0.02) but the two that write into the residual stream in each
    block (the attention's output and the MLP's down projection), N(0,
    0.002 / sqrt(2 · layers)), so that each block adds a few per cent to the
    stream: a deep stack of random layers at full scale is chaotic, and
    bf16's rounding alone would then change which tokens lead; biases 0,
    norm scales 1. One generator a decoder layer, so any layer can be drawn
    again alone. Names are the program's parameter names."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self._globals = None

    def _gen(self, i: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed((self.seed << 8) + i)

    def _draw(self, gen, shapes: dict, fixed: dict, residual=(), layers: int = 1) -> dict:
        total = sum(math.prod(s) for s in shapes.values())
        buf = torch.randn(total, generator=gen, device=self.device)
        out, at = {}, 0
        for name, shape in shapes.items():
            n = math.prod(shape)
            std = RESIDUAL_STD / math.sqrt(2 * layers) if name in residual else 0.02
            std = 1.0 if name == "tok_embed.embedding" else std
            out[name] = (buf[at:at + n].view(shape) * std).to(torch.bfloat16).float()
            at += n
        for name, (shape, value) in fixed.items():
            out[name] = torch.full(shape, value, device=self.device)
        return out

    def layer(self, i: int) -> dict:
        t = self.cfg["text"]
        d, hd = t["hidden"], t["head_dim"]
        q, kv, f = t["heads"] * hd, t["kv_heads"] * hd, t["mlp_hidden"]
        shapes = {"q": (d, q), "k": (d, kv), "v": (d, kv), "o": (q, d),
                  "gate": (d, f), "up": (d, f), "down": (f, d)}
        fixed = {"attn_norm.scale": ((d,), 1.0), "mlp_norm.scale": ((d,), 1.0),
                 "q.bias": ((t["heads"], hd), 0.0), "k.bias": ((t["kv_heads"], hd), 0.0),
                 "v.bias": ((t["kv_heads"], hd), 0.0)}
        return self._draw(self._gen(i), shapes, fixed, ("o", "down"), t["layers"])

    def globals(self) -> dict:
        """The vision tower (its parameters as ``vision.<name>`` drops the
        prefix), the token table, the final norm and the ``lm_head``."""
        if self._globals is None:
            v, t = self.cfg["vision"], self.cfg["text"]
            w, p, heads = v["width"], v["patch_size"], v["heads"]
            hidden = int(w * v["mlp_ratio"])
            m2 = v["merge_size"] ** 2
            shapes = {"patch_embed.weight": (w, 3, p, p)}
            fixed = {}
            for i in range(v["layers"]):
                shapes.update({f"qkv_{i}.weight": (w, 3 * w), f"proj_{i}.weight": (w, w),
                               f"mlp_{i}.fc1.weight": (w, hidden),
                               f"mlp_{i}.fc2.weight": (hidden, w)})
                fixed.update({f"ln1_{i}.scale": ((w,), 1.0), f"ln1_{i}.bias": ((w,), 0.0),
                              f"ln2_{i}.scale": ((w,), 1.0), f"ln2_{i}.bias": ((w,), 0.0),
                              f"qkv_{i}.bias": ((3, heads, w // heads), 0.0),
                              f"proj_{i}.bias": ((w,), 0.0), f"mlp_{i}.fc1.bias": ((hidden,), 0.0),
                              f"mlp_{i}.fc2.bias": ((w,), 0.0)})
            shapes.update({"merger_fc1.weight": (m2 * w, m2 * w),
                           "merger_fc2.weight": (m2 * w, t["hidden"]),
                           "tok_embed.embedding": (t["vocab_size"], t["hidden"]),
                           "lm_head": (t["hidden"], t["vocab_size"])})
            fixed.update({"final_ln.scale": ((w,), 1.0), "final_ln.bias": ((w,), 0.0),
                          "merger_fc1.bias": ((m2 * w,), 0.0),
                          "merger_fc2.bias": ((t["hidden"],), 0.0),
                          "final_norm.scale": ((t["hidden"],), 1.0)})
            residual = {f"{n}_{i}{leaf}" for i in range(v["layers"])
                        for n, leaf in (("proj", ".weight"), ("mlp", ".fc2.weight"))}
            self._globals = self._draw(self._gen(255), shapes, fixed, residual, v["layers"])
        return self._globals

    def release(self) -> None:
        self._globals = None


def program_config(cfg: dict):
    from multimodal_embeddings_tpu_torch.models.qwen_vl import (QwenTextConfig, QwenVisionConfig,
                                                                QwenVLConfig)

    v, t = cfg["vision"], cfg["text"]
    return QwenVLConfig(
        vision=QwenVisionConfig(patch_size=v["patch_size"], merge_size=v["merge_size"],
                                width=v["width"], layers=v["layers"], heads=v["heads"],
                                mlp_ratio=v["mlp_ratio"], window_size=v["window_size"],
                                fullatt_block_indexes=tuple(v["fullatt_block_indexes"]),
                                rope_theta=v["rope_theta"]),
        text=QwenTextConfig(vocab_size=t["vocab_size"], hidden=t["hidden"], layers=t["layers"],
                            heads=t["heads"], kv_heads=t["kv_heads"], head_dim=t["head_dim"],
                            mlp_hidden=t["mlp_hidden"], max_len=t["max_len"],
                            rope_theta=t["rope_theta"], mrope_section=tuple(t["mrope_section"])),
        image_pad_id=cfg["image_pad_id"], eos_id=cfg["eos_id"], quantize=cfg["quantize"])


@torch.no_grad()
def build_program(cfg: dict, weights: Weights, device):
    """The program's model on ``device`` holding the drawn weights: float
    leaves copied, int4 sites quantized by the program's own rule."""
    from multimodal_embeddings_tpu_torch.kernels.quantization_int4 import quantize_tensor_int4
    from multimodal_embeddings_tpu_torch.models.weights import build_qwen

    model = build_qwen(program_config(cfg), getattr(torch, cfg["dtype"]), device, seed=0)

    def put_int4(site, w, bias=None):
        qt = quantize_tensor_int4(w, cfg["group_size"])
        site.kernel_q4.copy_(qt.packed)
        site.kernel_scale.copy_(qt.scale)
        if bias is not None:
            site.bias.copy_(bias)

    g = weights.globals()
    model.vision.load_state_dict({k: v for k, v in g.items()
                                  if k not in ("tok_embed.embedding", "lm_head",
                                               "final_norm.scale")})
    model.tok_embed.embedding.copy_(g["tok_embed.embedding"])
    model.final_norm.scale.copy_(g["final_norm.scale"])
    put_int4(model.lm_head, g["lm_head"])
    for i, block in enumerate(model.blocks):
        w = weights.layer(i)
        block.attn_norm.scale.copy_(w["attn_norm.scale"])
        block.mlp_norm.scale.copy_(w["mlp_norm.scale"])
        for name in ("q", "k", "v", "o"):
            put_int4(getattr(block, name), w[name], w.get(name + ".bias"))
        for name in ("gate", "up", "down"):
            put_int4(getattr(block.mlp, name), w[name])
    weights.release()
    return model


def step_flops(cfg: dict, rows: int, cache_len: int) -> float:
    """Operations of one decode step over ``rows`` rows from the published
    widths: every projection and the ``lm_head`` at one token a row, and
    attention over ``cache_len`` cached keys."""
    t = cfg["text"]
    d, hd = t["hidden"], t["head_dim"]
    proj = d * (t["heads"] * hd + 2 * t["kv_heads"] * hd) + t["heads"] * hd * d \
        + 3 * d * t["mlp_hidden"]
    attn = 4 * t["heads"] * hd * cache_len
    return rows * (2.0 * t["layers"] * proj + t["layers"] * attn + 2.0 * d * t["vocab_size"])


def prefill_flops(cfg: dict, prompt_len: int, grid_hw) -> float:
    """Operations of one page's prefill from the published widths: the
    vision tower over the page's patches (window attention over 64-patch
    windows, full attention in its full-attention blocks) and merger, and
    the decoder over the prompt, causal, with the ``lm_head`` at the last
    position."""
    v, t = cfg["vision"], cfg["text"]
    gh, gw = grid_hw
    n = gh * gw
    w, hidden = v["width"], int(v["width"] * v["mlp_ratio"])
    m2 = v["merge_size"] ** 2
    win = (v["window_size"] // v["patch_size"]) ** 2
    vis = 0.0
    for i in range(v["layers"]):
        keys = n if i in v["fullatt_block_indexes"] else win
        vis += 2.0 * n * (w * 3 * w + w * w + 2 * w * hidden) + 4.0 * n * keys * w
    vis += 2.0 * (n / m2) * (m2 * w * m2 * w + m2 * w * t["hidden"])
    d, hd = t["hidden"], t["head_dim"]
    proj = d * (t["heads"] * hd + 2 * t["kv_heads"] * hd) + t["heads"] * hd * d \
        + 3 * d * t["mlp_hidden"]
    dec = t["layers"] * (2.0 * prompt_len * proj + 2.0 * t["heads"] * hd * prompt_len ** 2)
    return vis + dec + 2.0 * d * t["vocab_size"] + 2.0 * v["patch_size"] ** 2 * 3 * w * n


def k3_bound_s(cfg: dict, m: int, lm_rows: int) -> float:
    """The least time for one pass of K3's 449 launches: the seven int4
    projections of every layer at ``m`` rows and the ``lm_head`` at
    ``lm_rows`` (each weight byte read once; operations or bytes, whichever
    bounds)."""
    t = cfg["text"]
    d, hd, g = t["hidden"], t["head_dim"], cfg["group_size"]
    shapes = [(d, t["heads"] * hd), (d, t["kv_heads"] * hd), (d, t["kv_heads"] * hd),
              (t["heads"] * hd, d), (d, t["mlp_hidden"]), (d, t["mlp_hidden"]),
              (t["mlp_hidden"], d)]
    layer = sum(bound_s(*int4_matmul_work(m, k, n, g)) for k, n in shapes)
    return t["layers"] * layer + bound_s(*int4_matmul_work(lm_rows, d, t["vocab_size"], g))


def gaps(logits, picks) -> dict:
    """``logit_gap``: the widest gap, over every position, by which the
    picked token's logit lies below the best; ``flip_share``: the share of
    positions whose pick is not the best."""
    gap, flips, n = 0.0, 0, 0
    for lg, t in zip(logits, picks):
        d = lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
        gap = max(gap, float(d.max()))
        flips += int((d > 0).sum())
        n += len(t)
    return {"logit_gap": gap, "flip_share": flips / max(1, n)}


def served_tokens(out: np.ndarray, stop: int, eos: int) -> np.ndarray:
    """The greedy tokens a page was served: those before its forced stop,
    cut after an EOS the model emitted itself."""
    toks = out[:stop]
    hits = np.nonzero(toks == eos)[0]
    return toks[: hits[0] + 1] if len(hits) else toks


def rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row of the last axis' vectors: the root mean square of
    ``got − want`` over the spread (standard deviation) of ``want``."""
    got, want = got.float(), want.float()
    return (got - want).pow(2).mean(-1).sqrt() / want.std(-1).clamp_min(1e-12)


class Recorder:
    """What the program's model computes in one ``continuous_generate``
    call, copied on the card as the call runs, for the check to judge once
    the window has closed. Per prefill: a sample of the page's pixels (to
    tell which page it was), the vision tower's output, the last position's
    logits and the last layer's cached key and value there, and how many
    decode steps ran before it. Per decode step: each row's fed token, cache
    depth and logits, the key and value that the step left in the last
    layer's cache at that depth, and the row's cached key and value at the
    prompt's first image slot (which only a splice writes; the prefill's
    is kept beside it). Its buffers are allocated before the call
    and hold ``nbytes`` throughout; the hooks sit on the model object that
    the call drives (a forward hook on the vision tower and one on the
    model, whose forward is the prefill, and its ``decode_step`` wrapped on
    the instance)."""

    PIXEL_SAMPLES = 4096

    def __init__(self, model, pages: int, steps: int, rows: int, splice_slot: int,
                 image_tokens: int, image_hw, dtype, device):
        t = model.config.text
        self.model, self.splice_slot = model, splice_slot
        self.vis = torch.empty(pages, image_tokens, t.hidden, dtype=dtype, device=device)
        self.first = torch.empty(pages, t.vocab_size, dtype=dtype, device=device)
        self.first_kv = torch.empty(pages, 2, t.kv_heads, t.head_dim, device=device)
        self.first_slot = torch.empty(pages, 2, t.kv_heads, t.head_dim, device=device)
        self.kv = torch.empty(steps, rows, 2, t.kv_heads, t.head_dim, device=device)
        self.spliced = torch.empty(steps, rows, 2, t.kv_heads, t.head_dim, device=device)
        self.row_ids = torch.arange(rows, device=device)
        self.pixels = torch.empty(pages, self.pixel_sample(torch.zeros(1, *image_hw, 3)).numel(),
                                  device=device)
        self.logits = torch.empty(steps, rows, t.vocab_size, dtype=dtype, device=device)
        self.tokens = torch.empty(steps, rows, dtype=torch.long, device=device)
        self.depth = torch.empty(steps, rows, dtype=torch.long, device=device)
        self.nbytes = sum(b.numel() * b.element_size() for b in
                          (self.vis, self.first, self.first_kv, self.first_slot, self.kv,
                           self.spliced,
                           self.pixels, self.logits, self.tokens, self.depth))
        self.handles = []

    @classmethod
    def pixel_sample(cls, images: torch.Tensor) -> torch.Tensor:
        """About ``PIXEL_SAMPLES`` values spread over the whole page, every
        channel (an odd stride through the flat pixels)."""
        flat = images[0].reshape(-1)
        return flat[:: (flat.numel() // cls.PIXEL_SAMPLES) | 1].float()

    def install(self) -> None:
        model = self.model
        self.n_prefill, self.n_steps, self.steps_before, self.overflow = 0, 0, [], 0
        self.handles = [model.vision.register_forward_hook(self._on_vision),
                        model.register_forward_hook(self._on_prefill, with_kwargs=True)]
        self.own_step = model.__dict__.get("decode_step")
        step = model.decode_step

        def decode_step(token_ids, caches, position, mrope_delta=None):
            logits, caches = step(token_ids, caches, position, mrope_delta)
            self._on_step(token_ids, position, logits, caches[-1])
            return logits, caches

        model.decode_step = decode_step

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []
        if self.own_step is None:
            del self.model.decode_step
        else:
            self.model.decode_step = self.own_step

    def _on_vision(self, module, args, out):
        if self.n_prefill < self.vis.shape[0]:
            self.vis[self.n_prefill].copy_(out[0])

    def _on_prefill(self, module, args, kwargs, out):
        k = self.n_prefill
        if k < self.first.shape[0]:
            images = args[1] if len(args) > 1 else kwargs["images"]
            last = args[0].shape[1] - 1
            self.first[k].copy_(out[0][0, -1])
            self.first_kv[k].copy_(torch.stack([c[0, last] for c in out[1][-1]]))
            self.first_slot[k].copy_(torch.stack([c[0, self.splice_slot] for c in out[1][-1]]))
            self.pixels[k].copy_(self.pixel_sample(images))
            self.steps_before.append(self.n_steps)
        self.n_prefill += 1

    def _on_step(self, token_ids, position, logits, last_cache):
        k = self.n_steps
        if k < self.logits.shape[0]:
            depth = torch.as_tensor(position, device=self.depth.device).long()
            depth = depth.expand(token_ids.shape[0])
            self.tokens[k].copy_(token_ids[:, 0])
            self.depth[k].copy_(depth)
            self.logits[k].copy_(logits[:, -1])
            self.kv[k].copy_(torch.stack([c[self.row_ids, depth] for c in last_cache], 1))
            self.spliced[k].copy_(torch.stack([c[:, self.splice_slot] for c in last_cache], 1))
        else:
            self.overflow += 1
        self.n_steps += 1

    def prefills_of(self, image: np.ndarray) -> List[int]:
        """The prefills whose page had these pixels."""
        want = self.pixel_sample(torch.from_numpy(image)).to(self.pixels.device)
        n = min(self.n_prefill, self.pixels.shape[0])
        return (self.pixels[:n] == want).all(1).nonzero().flatten().tolist()

    def rows_of(self, prefill: int, tokens: np.ndarray, prompt_len: int) -> List[Tuple[int, int]]:
        """``(first step, row)`` of each row that took this prefill's page
        and fed exactly ``tokens`` from its splice on: the row's cache depth
        starts at the prompt's end and grows by one a step."""
        s0, n = self.steps_before[prefill], len(tokens)
        if s0 + n > min(self.n_steps, self.tokens.shape[0]):
            return []
        fed = self.tokens[s0:s0 + n].cpu().numpy()
        depth = self.depth[s0:s0 + n].cpu().numpy()
        want = prompt_len + np.arange(n)[:, None]
        ok = (fed == np.asarray(tokens)[:, None]).all(0) & (depth == want).all(0)
        return [(s0, int(r)) for r in np.nonzero(ok)[0]]

    def holds(self, prefill: int, step: int, row: int) -> bool:
        """Whether ``row`` held, at ``step``, this prefill's last-layer key
        and value at the first image slot (a splice copies them bit for
        bit)."""
        return torch.equal(self.spliced[step, row], self.first_slot[prefill])

    def unspliced(self, prompt_len: int) -> int:
        """Prefills of the call that no row took: each prefill against the
        rows that start at the prompt's end in the step after it, each row
        matched once. Rows of other pages admitted in the same step may
        feed the same tokens, so only the cached bits tell them apart."""
        steps = min(self.n_steps, self.tokens.shape[0])
        fresh, missing = {}, 0
        for k, s0 in enumerate(self.steps_before):
            if s0 >= steps:
                missing += 1
                continue
            if s0 not in fresh:
                fresh[s0] = (self.depth[s0] == prompt_len).nonzero().flatten().tolist()
            hit = next((r for r in fresh[s0] if self.holds(k, s0, r)), None)
            if hit is None:
                missing += 1
            else:
                fresh[s0].remove(hit)
        return missing


class Session:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.cfg = cell.config
        self.model = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def setup(self) -> None:
        from multimodal_embeddings_tpu_torch.analysis.doc_parser import (DocumentParser,
                                                                         preprocess_page,
                                                                         smart_resize)
        from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer

        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        cfg, wl = self.cfg, self.cell.workload
        clock = Clock(self.sync)
        self.queue = self.cell.generator().make(self.cell.traffic, self.seed)
        clock("pages")
        self.weights = Weights(cfg, self.seed, self.device)
        self.model = build_program(cfg, self.weights, self.device)
        clock("program")
        unit = cfg["vision"]["patch_size"] * cfg["vision"]["merge_size"]
        h, w = self.queue.pool[0].shape[:2]
        self.input_hw = smart_resize(h, w, factor=unit, min_pixels=unit * unit,
                                     max_pixels=cfg["max_pixels"])
        from PIL import Image

        self.images = [preprocess_page(Image.fromarray(p), self.input_hw[1], self.input_hw[0])
                       for p in self.queue.pool]
        n_tokens = (self.input_hw[0] // unit) * (self.input_hw[1] // unit)
        parser = DocumentParser(self.model, ByteTokenizer(), device=self.device)
        self.prompt = parser.build_prompt_ids(n_tokens, cfg["text"]["max_len"] - wl["max_new_tokens"])
        clock("preprocess")
        self.warm()
        clock("warmup")
        # every decode step serves a token of some page, so the queue's
        # tokens bound its steps
        self.recorder = Recorder(self.model, len(self.queue.pages), int(self.queue.stops.sum()),
                                 wl["rows"], int(np.argmax(self.prompt[0] == cfg["image_pad_id"])),
                                 n_tokens, self.input_hw,
                                 getattr(torch, cfg["dtype"]), self.device)
        self.memory_offset = self.recorder.nbytes
        clock("recorder")
        self.setup_notes = clock.notes

    def generate(self, page_ids, stops, stats=None):
        from multimodal_embeddings_tpu_torch.models.qwen_serve import continuous_generate

        wl = self.cell.workload
        pages = [(self.prompt, self.images[int(i)]) for i in page_ids]
        return continuous_generate(self.model, pages, wl["rows"], wl["max_new_tokens"],
                                   chunk=wl["chunk"], stops=list(stops), stats=stats,
                                   early_exit=wl["early_exit"])

    def warm(self) -> None:
        """The cell's shapes once: a prefill and splice at the prompt's
        length, both chunk forms' steps at the cell's rows."""
        self.generate(self.queue.pages[:1], [self.cell.workload["chunk"] + 2])
        self.sync()

    def recorded_call(self, n: int, stats=None, prof=None):
        """One ``continuous_generate`` call over the queue's first ``n``
        pages with the recorder on (and ``prof`` started around it);
        returns the call's wall seconds and its outputs."""
        ids, stops = self.queue.pages[:n], self.queue.stops[:n]
        self.recorder.install()
        self.sync()
        t0 = time.perf_counter()
        if prof is not None:
            prof.start()
        with span("parse.window", prof is not None):
            outs = self.generate(ids, stops, stats)
        self.sync()
        wall = time.perf_counter() - t0
        if prof is not None:
            t_stop = time.perf_counter()
            prof.stop()
            self.trace_stop_s = time.perf_counter() - t_stop
        self.recorder.remove()
        self.served = [(q, int(i), served_tokens(out, s, self.cfg["eos_id"]))
                       for q, (i, out, s) in enumerate(zip(ids, outs, stops)) if out is not None]
        self.unserved = sum(o is None for o in outs)
        return wall, outs

    def run(self, seconds: float, trace: bool) -> RunResult:
        wl = self.cell.workload
        n = len(self.queue.pages)
        stats, prof = {}, None
        if trace:
            # the window launches some 500,000 kernels: the card's activity
            # alone (kernels, copies, the runtime calls that launch them)
            # keeps the profiler's own cost, and its reduction, in bounds;
            # the host's ATen operations would triple both
            act = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(
                activities=[act.CUDA if self.device.type == "cuda" else act.CPU])
        wall, outs = self.recorded_call(n, stats, prof)
        tokens = sum(len(t) for _, _, t in self.served)
        res = RunResult(attempted=n, failed=self.unserved)
        res.end_to_end = {"parse_tokens_per_s": tokens / wall}
        cache_len = min(self.cfg["text"]["max_len"],
                        -(-(self.prompt.shape[1] + wl["max_new_tokens"]) // 128) * 128)
        unit = self.cfg["vision"]["patch_size"] * self.cfg["vision"]["merge_size"]
        grid = (self.input_hw[0] // unit, self.input_hw[1] // unit)
        plen = self.prompt.shape[1]
        res.counters = dict(stats, pages=n, tokens=tokens)
        res.work = {
            "window_flops": n * prefill_flops(self.cfg, plen, grid)
            + stats["decode_steps"] * step_flops(self.cfg, wl["rows"], cache_len),
            "window_s": wall,
            "prefill_k3_bound_s": k3_bound_s(self.cfg, plen, 1),
            "step_k3_bound_s": k3_bound_s(self.cfg, wl["rows"], wl["rows"]),
        }
        res.notes = {**self.setup_notes, "window_s": wall, "tokens": tokens, "pages": n,
                     "decode_steps": stats["decode_steps"], "chunks": stats["chunks"],
                     "splice_s": stats["splice_s"]}
        if trace:
            t_reduce = time.perf_counter()
            res.trace = from_profiler(prof)  # not exported: hundreds of MB
            res.work["trace_pages"], res.work["trace_steps"] = n, stats["decode_steps"]
            res.notes["trace_reduce_s"] = time.perf_counter() - t_reduce
            res.notes["trace_stop_s"] = self.trace_stop_s
        return res

    def release(self) -> None:
        """Frees the program's state (the recorder's copies stay for the
        check)."""
        self.model = self.recorder.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------

    def sample(self):
        """The served pages to judge: the longest, and others drawn from the
        seed, ``check_pages`` in all."""
        k = min(self.cell.workload["check_pages"], len(self.served))
        longest = max(range(len(self.served)), key=lambda j: len(self.served[j][2]))
        rest = [j for j in range(len(self.served)) if j != longest]
        rng = np.random.default_rng([self.seed, 5])
        picks = [longest] + list(rng.choice(rest, k - 1, replace=False)) if k > 1 else [longest]
        return [self.served[j] for j in picks]

    def check(self):
        limits = self.cell.workload["limits"]
        readings = self.judge(self.sample())
        self.check_notes = {f"reading.{k}": v for k, v in readings.items() if k not in limits}
        return [(name, readings[name], limits[name]) for name in limits]

    def reference(self, served):
        """The reference's vision output and logits for each served page
        ``(queue position, pool page, tokens)``, ``ref_batch`` pages a pass,
        and the largest difference between its own prompt and image and the
        program's (compared exactly)."""
        cfg = self.cfg
        unit = cfg["vision"]["patch_size"] * cfg["vision"]["merge_size"]
        h, w = self.queue.pool[0].shape[:2]
        ih, iw = ref.smart_resize(h, w, factor=unit, max_pixels=cfg["max_pixels"],
                                  min_pixels=unit * unit)
        prompt = ref.prompt_ids((ih // unit) * (iw // unit), cfg["image_pad_id"])
        mismatch = float(prompt.shape != self.prompt.shape or (prompt != self.prompt).any())
        rows = []
        for _, idx, toks in served:
            image = ref.page_input(self.queue.pool[idx], ih, iw)
            mismatch = max(mismatch, float(np.abs(image - self.images[idx]).max()))
            rows.append((np.concatenate([prompt[0], np.asarray(toks[:-1], np.int64)]), image))
        per = self.cell.workload["ref_batch"]
        out = []
        for i in range(0, len(rows), per):
            out += ref.served_logits(self.weights, cfg, rows[i:i + per], prompt.shape[1])
        return out, mismatch

    @torch.no_grad()
    def judge(self, served) -> dict:
        """The program's recorded answers for the sampled pages against the
        reference's: ``vision_err`` (the vision tower's output, over the
        norm of the reference's), ``prefill_err`` (the prefill's logits) and
        ``decode_err`` (each decode step's logits through the cache, of every
        row that served the page's tokens) and ``cache_err`` (the last
        layer's key and value that the prefill and each of those steps left
        in the cache), each the worst relative root mean square error; ``logit_gap``, how far below the reference's best
        logit each served token's reference logit lies. Exact:
        ``input_mismatch`` (prompt and image against the reference's own
        preprocessing), ``unmatched`` (sampled pages that no prefill, or no
        row holding that prefill's cache, served as the program says it
        did), ``splice_mismatch`` (prefills of the whole call that no row
        took, ``Recorder.unspliced``) and ``unserved`` (pages of the call
        that never came back)."""
        rec, plen = self.recorder, self.prompt.shape[1]
        refs, mismatch = self.reference(served)
        vis_err = pre_err = dec_err = kv_err = 0.0
        unmatched = 0
        for (_, idx, toks), (vis, logits, kv) in zip(served, refs):
            prefills = rec.prefills_of(self.images[idx])
            # rows admitted together may serve the same tokens: only a row
            # that holds this prefill's cache is the page's
            rows = [(s0, r) for k in prefills for s0, r in rec.rows_of(k, toks, plen)
                    if rec.holds(k, s0, r)]
            if not rows:
                unmatched += 1
            for k in prefills:
                vis_err = max(vis_err, float((rec.vis[k].float() - vis).norm() / vis.norm()))
                pre_err = max(pre_err, float(rel_err(rec.first[k], logits[0])))
                kv_err = max(kv_err, float(rel_err(rec.first_kv[k].flatten(), kv[0].flatten())))
            n = len(toks) - 1  # steps whose token and cached key the reference holds
            for s0, r in rows:
                if n:
                    got = rec.logits[s0:s0 + n, r]
                    dec_err = max(dec_err, float(rel_err(got, logits[1:n + 1]).max()))
                    got = rec.kv[s0:s0 + n, r].flatten(1)
                    kv_err = max(kv_err, float(rel_err(got, kv[1:n + 1].flatten(1)).max()))
        picks = [torch.as_tensor(np.asarray(toks, np.int64), device=lg.device)
                 for (_, lg, _), (_, _, toks) in zip(refs, served)]
        return {"vision_err": vis_err, "prefill_err": pre_err, "decode_err": dec_err,
                "cache_err": kv_err, **gaps([lg for _, lg, _ in refs], picks),
                "input_mismatch": mismatch, "unmatched": float(unmatched),
                "splice_mismatch": float(rec.unspliced(plen)), "unserved": float(self.unserved),
                "steps_overflow": float(rec.overflow)}

    # -- the control ----------------------------------------------------

    def control_readings(self, n: int = 0) -> dict:
        """The program's numbers on a recorded call over the queue's first
        ``n`` pages (0: the workload's ``control_queue``) at the cell's rows,
        judged on a run's sample, and the control's on the same prompts and
        served tokens."""
        self.recorded_call(n or self.cell.workload["control_queue"])
        sample = self.sample()
        program = self.judge(sample)
        self.release()
        return {"program": program, "control": self.control_gap(sample)}

    @torch.no_grad()
    def control_gap(self, served) -> dict:
        """The control: the reference at float8 e4m3 in the program's place,
        on the same prompts and served tokens: its vision output and logits
        against the float32 reference's as ``judge`` reads the program's,
        and the float32 logit of the token it puts first at each position."""
        base, _ = self.reference(served)
        page_ref.set_precision("fp8")
        try:
            low, _ = self.reference(served)
        finally:
            page_ref.set_precision("float32")
        pairs = list(zip(low, base))
        return {
            "vision_err": max(float((lo[0] - b[0]).norm() / b[0].norm()) for lo, b in pairs),
            "prefill_err": max(float(rel_err(lo[1][0], b[1][0])) for lo, b in pairs),
            "decode_err": max(float(rel_err(lo[1][1:], b[1][1:]).max()) for lo, b in pairs),
            "cache_err": max(float(rel_err(lo[2].flatten(1), b[2].flatten(1)).max())
                             for lo, b in pairs),
            **gaps([b[1] for b in base], [lo[1].argmax(-1) for lo in low])}
