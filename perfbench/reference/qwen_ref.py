"""The plain reference of the Qwen2.5-VL parse as the program builds it:
the vision tower (14-px patches, 2-D rotary, window attention over 8×8
patches but in the full-attention blocks, LayerNorm and a GELU MLP, the 2×2
merger), the decoder (RMSNorm, q/k/v with bias, GQA, M-RoPE, SwiGLU), the
image tokens spliced into the image-pad slots, and the prompt the parser
builds.

Plain PyTorch in float32 (TF32 off), no kernel and no cache: the whole
sequence (prompt and served tokens) runs causally in one pass, a decoder
layer at a time. It imports nothing of the program. The int4 sites' weights
are worked out here from the float weights the benchmark draws: symmetric
groups of 128 along the input, scale = max|w| / 7, round half to even,
clip to [-8, 7]. ``page_ref.set_precision("fp8")`` rounds the inputs of
every product, and the residual stream after every block, to float8 e4m3:
the control, whose activations live in the lower precision as the
program's live in bf16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.page_ref import rq

IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
SYSTEM_PROMPT = (
    "You are an AI specialized in recognizing and extracting text from "
    "images. Your mission is to analyze the image document and generate the "
    "result in QwenVL Document Parser HTML format using specified tags "
    "while maintaining user privacy and data integrity."
)
USER_PROMPT = "QwenVL HTML "
BOS, EOS, BYTE_OFFSET = 1, 2, 4  # the parser's byte tokenizer


def smart_resize(height, width, factor=28, max_pixels=1280 * 28 * 28, min_pixels=56 * 56):
    """Each side rounded to the merged-patch factor, scaled into the pixel
    budget, aspect kept. Returns (height, width)."""
    h = max(factor, round(height / factor) * factor)
    w = max(factor, round(width / factor) * factor)
    if h * w > max_pixels:
        beta = math.sqrt(height * width / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h, w = math.ceil(height * beta / factor) * factor, math.ceil(width * beta / factor) * factor
    return h, w


def page_input(page: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, 3) uint8 page → (1, height, width, 3) float32: PIL bilinear
    resize, 1/255, CLIP mean and std."""
    from PIL import Image

    arr = np.asarray(Image.fromarray(page).resize((width, height), Image.BILINEAR),
                     np.float32) / 255.0
    return ((arr - np.asarray(IMAGE_MEAN, np.float32)) / np.asarray(IMAGE_STD, np.float32))[None]


def prompt_ids(n_image_tokens: int, image_pad_id: int) -> np.ndarray:
    """The chat prompt: the byte-encoded system and user turns, the image
    pads, the assistant turn."""
    def enc(text):
        return [BOS] + [BYTE_OFFSET + b for b in text.encode("utf-8")] + [EOS]

    ids = (enc(f"system: {SYSTEM_PROMPT}\nuser: {USER_PROMPT}")
           + [image_pad_id] * n_image_tokens + enc("\nassistant:"))
    return np.asarray(ids, np.int32)[None]


def int4_dequant(w: torch.Tensor, group: int = 128) -> torch.Tensor:
    """A ``(K, N)`` float weight as its int4 storage holds it."""
    k, n = w.shape
    g = group if (k >= group and k % group == 0) else k
    wg = w.float().reshape(k // g, g, n)
    scale = wg.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 7.0
    return (torch.round(wg / scale).clamp(-8, 7) * scale).reshape(k, n)


def linear(x, w, b=None):
    y = torch.matmul(rq(x), rq(w))
    return y if b is None else y + b


def layer_norm(x, scale, bias, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def rms_norm(x, scale, eps=1e-5):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rotate(x, cos, sin):
    """Rotate-half rotary embedding: x (..., L, H, D), cos/sin broadcast to
    (..., L, 1, D/2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attend(q, k, v, mask=None, causal=False):
    """(B, L, H, D) × (B, M, KVH, D): softmax attention in float32, KV head
    i serving query heads i·r … i·r+r−1."""
    h, kvh = q.shape[2], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.matmul(rq(q.transpose(1, 2)), rq(k.permute(0, 2, 3, 1))) / math.sqrt(q.shape[-1])
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        logits = logits.masked_fill(~torch.ones(lq, lk, dtype=torch.bool,
                                                device=q.device).tril(), float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.matmul(rq(torch.softmax(logits, -1)), rq(v.transpose(1, 2))).transpose(1, 2)


def vision_rope(gh, gw, head_dim, theta, device):
    dim = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    hf = np.outer(np.arange(gh, dtype=np.float64), inv)
    wf = np.outer(np.arange(gw, dtype=np.float64), inv)
    ang = np.concatenate([np.broadcast_to(hf[:, None], (gh, gw, hf.shape[1])),
                          np.broadcast_to(wf[None], (gh, gw, wf.shape[1]))], -1)
    ang = torch.from_numpy(ang.reshape(gh * gw, dim).astype(np.float32)).to(device)
    return torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]


def windows(x, gh, gw, win):
    """(1, gh·gw, H, D) → (n_windows, win², H, D), the grid zero-padded to
    whole windows, and the windows' valid-key mask."""
    b, _, h, d = x.shape
    nh, nw = -(-gh // win), -(-gw // win)
    x = F.pad(x.reshape(b, gh, gw, h, d), (0, 0, 0, 0, 0, nw * win - gw, 0, nh * win - gh))
    x = x.reshape(b, nh, win, nw, win, h, d).permute(0, 1, 3, 2, 4, 5, 6)
    valid = F.pad(torch.ones(gh, gw, dtype=torch.bool, device=x.device),
                  (0, nw * win - gw, 0, nh * win - gh))
    valid = valid.reshape(nh, win, nw, win).transpose(1, 2).reshape(nh * nw, 1, 1, win * win)
    return x.reshape(b * nh * nw, win * win, h, d), valid


def unwindow(x, gh, gw, win):
    nh, nw = -(-gh // win), -(-gw // win)
    h, d = x.shape[-2:]
    x = x.reshape(1, nh, nw, win, win, h, d).permute(0, 1, 3, 2, 4, 5, 6)
    return x.reshape(1, nh * win, nw * win, h, d)[:, :gh, :gw].reshape(1, gh * gw, h, d)


def vision_tower(p: dict, vcfg: dict, image: torch.Tensor) -> torch.Tensor:
    """(1, H, W, 3) normalised pixels → (1, (H/28)·(W/28), hidden) image
    tokens; ``p`` holds the tower's parameters under the program's names."""
    ps, width, heads = vcfg["patch_size"], vcfg["width"], vcfg["heads"]
    x = F.conv2d(rq(image.permute(0, 3, 1, 2)), rq(p["patch_embed.weight"]), stride=ps)
    _, _, gh, gw = x.shape
    x = x.flatten(2).transpose(1, 2)
    hd = width // heads
    cos, sin = vision_rope(gh, gw, hd, vcfg["rope_theta"], x.device)
    win = vcfg["window_size"] // ps
    length = gh * gw
    for i in range(vcfg["layers"]):
        h = layer_norm(x, p[f"ln1_{i}.scale"], p[f"ln1_{i}.bias"])
        qkv = linear(h, p[f"qkv_{i}.weight"], p[f"qkv_{i}.bias"].reshape(-1))
        qkv = qkv.view(1, length, 3, heads, hd)
        q, k, v = rotate(qkv[:, :, 0], cos, sin), rotate(qkv[:, :, 1], cos, sin), qkv[:, :, 2]
        if i in vcfg["fullatt_block_indexes"] or win >= max(gh, gw):
            a = attend(q, k, v)
        else:
            (qw, mask), (kw, _), (vw, _) = (windows(t, gh, gw, win) for t in (q, k, v))
            a = unwindow(attend(qw, kw, vw, mask=mask), gh, gw, win)
        x = rq(x + linear(a.reshape(1, length, width), p[f"proj_{i}.weight"],
                          p[f"proj_{i}.bias"]))
        h = layer_norm(x, p[f"ln2_{i}.scale"], p[f"ln2_{i}.bias"])
        h = F.gelu(linear(h, p[f"mlp_{i}.fc1.weight"], p[f"mlp_{i}.fc1.bias"]), approximate="tanh")
        x = rq(x + linear(h, p[f"mlp_{i}.fc2.weight"], p[f"mlp_{i}.fc2.bias"]))
    x = layer_norm(x, p["final_ln.scale"], p["final_ln.bias"])
    m = vcfg["merge_size"]
    x = x.reshape(1, gh // m, m, gw // m, m, width).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(1, (gh // m) * (gw // m), m * m * width)
    x = F.gelu(linear(x, p["merger_fc1.weight"], p["merger_fc1.bias"]), approximate="tanh")
    return linear(x, p["merger_fc2.weight"], p["merger_fc2.bias"])


def mrope_positions(ids: torch.Tensor, image_pad_id: int, gh: int, gw: int,
                    prompt_len: int = None) -> torch.Tensor:
    """(3, B, L) t/h/w positions for rows with one contiguous image span in
    their first ``prompt_len`` tokens (served tokens that happen to be the
    pad id are text): text advances all three, image tokens keep t at the
    span's start and spread h and w over the merged grid, text after the
    span resumes at start + max(gh, gw)."""
    is_pad = ids[:, :prompt_len] == image_pad_id
    first = is_pad.int().argmax(1)[:, None]
    n = is_pad.sum(1)[:, None]
    j = torch.arange(ids.shape[1], device=ids.device)[None]
    k = j - first
    before, inside = j < first, (k >= 0) & (k < n)
    after = first + max(gh, gw) + (k - n)

    def axis(image_pos):
        return torch.where(before, j, torch.where(inside, image_pos, after))

    return torch.stack([axis(first.expand_as(k)), axis(first + k // gw), axis(first + k % gw)])


def mrope_tables(pos, head_dim, theta, sections):
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    axis = np.concatenate([np.full(s, i, np.int64) for i, s in enumerate(sections)])
    p = pos[torch.from_numpy(axis).to(pos.device)]  # (D/2, B, L)
    ang = p.permute(1, 2, 0).double() * torch.from_numpy(inv).to(pos.device)
    return torch.cos(ang).float()[:, :, None], torch.sin(ang).float()[:, :, None]


def decoder_layer(x, w: dict, tcfg: dict, cos, sin, kv: list = None):
    """One decoder layer over the whole sequence, causal; ``w`` holds the
    layer's float weights as drawn (int4 sites dequantized here). With
    ``kv``, the layer's rotated keys and values (B, L, 2, KVH, D) are
    appended to it, as a cache holds them."""
    b, length, d = x.shape
    hd, heads, kvh = tcfg["head_dim"], tcfg["heads"], tcfg["kv_heads"]
    h = rms_norm(x, w["attn_norm.scale"])
    q = linear(h, int4_dequant(w["q"]), w["q.bias"].reshape(-1)).view(b, length, heads, hd)
    k = linear(h, int4_dequant(w["k"]), w["k.bias"].reshape(-1)).view(b, length, kvh, hd)
    v = linear(h, int4_dequant(w["v"]), w["v.bias"].reshape(-1)).view(b, length, kvh, hd)
    k = rotate(k, cos, sin)
    if kv is not None:
        kv.append(torch.stack([k, v], 2))
    a = attend(rotate(q, cos, sin), k, v, causal=True)
    x = rq(x + linear(a.reshape(b, length, heads * hd), int4_dequant(w["o"])))
    h = rms_norm(x, w["mlp_norm.scale"])
    g = F.silu(linear(h, int4_dequant(w["gate"]))) * linear(h, int4_dequant(w["up"]))
    return rq(x + linear(g, int4_dequant(w["down"])))


@torch.no_grad()
def served_logits(weights, cfg: dict, rows, prompt_len: int,
                  chunk: int = 512):
    """For each row ``(ids, image)`` (``ids`` (L,) the prompt and the served
    tokens but the last, ``image`` (1, H, W, 3) normalised pixels): the
    vision tower's output (T, hidden), the logits that predict each served
    token (L − prompt_len + 1, vocab), and the last layer's cached keys and
    values at the same positions (L − prompt_len + 1, 2, KVH, D), from one
    causal pass over all rows, a decoder layer at a time (rows padded at
    their end). ``weights`` gives ``globals()`` and ``layer(i)`` (float, as
    drawn)."""
    tcfg, vcfg = cfg["text"], cfg["vision"]
    g = weights.globals()
    device = g["lm_head"].device
    length = max(len(ids) for ids, _ in rows)
    ids = torch.zeros(len(rows), length, dtype=torch.long, device=device)
    for r, (row_ids, _) in enumerate(rows):
        ids[r, : len(row_ids)] = torch.as_tensor(row_ids, device=device)
    vis = [vision_tower(g, vcfg, torch.as_tensor(image, device=device))[0]
           for _, image in rows]
    x = rq(g["tok_embed.embedding"][ids])
    is_pad = ids[:, :prompt_len] == cfg["image_pad_id"]
    for r in range(len(rows)):
        x[r, :prompt_len][is_pad[r]] = vis[r][: int(is_pad[r].sum())]
    unit = vcfg["patch_size"] * vcfg["merge_size"]
    gh, gw = rows[0][1].shape[1] // unit, rows[0][1].shape[2] // unit
    cos, sin = mrope_tables(mrope_positions(ids, cfg["image_pad_id"], gh, gw, prompt_len),
                            tcfg["head_dim"], tcfg["rope_theta"], tcfg["mrope_section"])
    kv = []
    for i in range(tcfg["layers"]):
        x = decoder_layer(x, weights.layer(i), tcfg, cos, sin,
                          kv if i == tcfg["layers"] - 1 else None)
    x = rms_norm(x[:, prompt_len - 1:], g["final_norm.scale"])
    head = int4_dequant(g["lm_head"])
    logits = torch.cat([linear(x[:, j:j + chunk], head) for j in range(0, x.shape[1], chunk)], 1)
    kv = kv[0][:, prompt_len - 1:]
    return [(v, logits[r, : len(row_ids) - prompt_len + 1], kv[r, : len(row_ids) - prompt_len + 1])
            for r, ((row_ids, _), v) in enumerate(zip(rows, vis))]
