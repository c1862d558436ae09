"""Document-to-HTML parsing (the Qwen2.5-VL notebook's workflow), in PyTorch.

Port of ``multimodal_embeddings_tpu/analysis/doc_parser.py``. The host code
is copied verbatim (``tests/test_torch_doc_parser.py`` holds each copy equal
to the original): ``IMAGE_MEAN``/``IMAGE_STD``, ``preprocess_page``, the
prompts, ``BBoxElement``, ``extract_bbox_elements``, ``draw_bbox``,
``clean_and_format_html``, ``round_to_patch_grid`` and ``smart_resize``.
``DocumentParser`` builds the chat prompt with the image-pad placeholders,
runs ``models/qwen_vl.py::greedy_generate`` on its device and decodes the
byte tokens; pages whose model-input grids match run as one batch in
``parse_batch``, or through the continuously refilled decoder of
``models/qwen_serve.py`` in ``parse_continuous``.

PIL is imported only inside the functions that open, resize or draw an
image, so the module imports without it.

``pp_mesh``/``pp_stages`` pipeline the decoder stack over the stage ranks
(``models/qwen_pp.py::pp_greedy_generate``); ``dp_mesh`` shards
``parse_batch``'s pages over the data ranks (``core/mesh.py``), each rank
generating its rows with its own copy of the weights and the tokens
all-gathered, so every rank of the mesh returns every page's result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from collections.abc import Sequence
from html.parser import HTMLParser
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.core.mesh import DATA_AXIS, pad_to_multiple, shard_batch
from multimodal_embeddings_tpu_torch.models.qwen_pp import pp_greedy_generate
from multimodal_embeddings_tpu_torch.models.qwen_serve import continuous_generate
from multimodal_embeddings_tpu_torch.models.qwen_vl import greedy_generate
from multimodal_embeddings_tpu_torch.models.tokenizer import BYTE_OFFSET, EOS_ID
from multimodal_embeddings_tpu_torch.models.weights import resolve_device

# CLIP normalisation constants of the notebook's Qwen2VLImageProcessor
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_page(image, input_w: int, input_h: int) -> np.ndarray:
    """PIL page → (1, H, W, 3) float32 model input: bilinear resize, 1/255
    rescale, CLIP mean/std normalization."""
    from PIL import Image

    arr = (
        np.asarray(image.resize((input_w, input_h), Image.BILINEAR), np.float32)
        / 255.0
    )
    arr = (arr - np.asarray(IMAGE_MEAN, np.float32)) / np.asarray(
        IMAGE_STD, np.float32
    )
    return arr[None]


SYSTEM_PROMPT = (
    "You are an AI specialized in recognizing and extracting text from "
    "images. Your mission is to analyze the image document and generate the "
    "result in QwenVL Document Parser HTML format using specified tags "
    "while maintaining user privacy and data integrity."
)
USER_PROMPT = "QwenVL HTML "


@dataclasses.dataclass
class BBoxElement:
    tag: str
    bbox: Tuple[int, int, int, int]
    text: str


class _BBoxExtractor(HTMLParser):
    """Collect elements carrying a data-bbox attribute with their text,
    reproducing the notebook's filtering (skip <ol> containers, keep <li>
    children and everything else)."""

    def __init__(self):
        super().__init__()
        self._stack: List[Tuple[str, Optional[str]]] = []
        self._open: List[Tuple[str, Tuple[int, int, int, int], List[str]]] = []
        self.elements: List[BBoxElement] = []

    def handle_starttag(self, tag, attrs):
        attrs = dict(attrs)
        parent = self._stack[-1][0] if self._stack else None
        self._stack.append((tag, parent))
        bbox_str = attrs.get("data-bbox")
        if not bbox_str:
            return
        if tag == "ol":
            return  # containers are skipped
        coords = _parse_bbox(bbox_str)
        if coords is None:
            return
        self._open.append((tag, coords, []))

    def handle_data(self, data):
        for entry in self._open:
            entry[2].append(data)

    def handle_endtag(self, tag):
        if self._stack and self._stack[-1][0] == tag:
            self._stack.pop()
        if self._open and self._open[-1][0] == tag:
            name, coords, chunks = self._open.pop()
            self.elements.append(BBoxElement(name, coords, "".join(chunks).strip()))


def _parse_bbox(bbox_str: str) -> Optional[Tuple[int, ...]]:
    """Four integer coordinates, or None (the original's ``int`` parse,
    whose ``ValueError`` drops the element)."""
    parts = bbox_str.split()
    if not all(re.fullmatch(r"\s*[+-]?\d+(_\d+)*\s*", p) for p in parts):
        return None
    coords = tuple(int(v) for v in parts)
    return coords if len(coords) == 4 else None


def extract_bbox_elements(html: str) -> List[BBoxElement]:
    parser = _BBoxExtractor()
    parser.feed(html)
    # close any unterminated elements
    while parser._open:
        name, coords, chunks = parser._open.pop()
        parser.elements.append(BBoxElement(name, coords, "".join(chunks).strip()))
    return parser.elements


def draw_bbox(
    image_path: str,
    resized_width: int,
    resized_height: int,
    html: str,
    output_path: Optional[str] = None,
):
    """Draw the parsed boxes back onto the original image, undoing the
    model-input rescale (model bbox coords are in resized space; divide by
    resized/original scale)."""
    from PIL import Image, ImageDraw

    image = Image.open(image_path).convert("RGB")
    scale_x = resized_width / image.width
    scale_y = resized_height / image.height
    draw = ImageDraw.Draw(image)
    for el in extract_bbox_elements(html):
        x1, y1, x2, y2 = el.bbox
        x1, x2 = sorted((int(x1 / scale_x), int(x2 / scale_x)))
        y1, y2 = sorted((int(y1 / scale_y), int(y2 / scale_y)))
        draw.rectangle([x1, y1, x2, y2], outline="red", width=2)
        if el.text:
            draw.text((x1, y2), el.text[:80], fill="black")
    if output_path:
        image.save(output_path)
    return image


_COLOR_STYLE = re.compile(r"\bcolor:[^;\"']+;?")
_DATA_ATTR = re.compile(r"\s+data-(?:bbox|polygon)=(\"[^\"]*\"|'[^']*')")
_STYLE_ATTR = re.compile(r"(\sstyle=)(\"[^\"]*\"|'[^']*')")


def clean_and_format_html(html: str) -> str:
    """Strip data-bbox/data-polygon attributes and color styles, producing
    ordinary HTML."""

    def clean_style(match):
        quote = match.group(2)[0]
        inner = match.group(2)[1:-1]
        cleaned = _COLOR_STYLE.sub("", inner).strip().rstrip(";")
        if not cleaned:
            return ""
        return f"{match.group(1)}{quote}{cleaned}{quote}"

    html = _STYLE_ATTR.sub(clean_style, html)
    return _DATA_ATTR.sub("", html)


def round_to_patch_grid(width: int, height: int, patch: int = 14, merge: int = 2) -> Tuple[int, int]:
    """Effective model-input resolution: dims rounded to the merged patch
    grid."""
    unit = patch * merge
    return (max(unit, round(width / unit) * unit), max(unit, round(height / unit) * unit))


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = 56 * 56,
    max_pixels: int = 1280 * 28 * 28,
) -> Tuple[int, int]:
    """Qwen2.5-VL native-resolution sizing: round each side to the
    merged-patch factor preserving aspect ratio, then scale into the
    [min_pixels, max_pixels] budget. Returns (height, width)."""
    import math

    if max(height, width) / min(height, width) > 200:
        raise ValueError("absurd aspect ratio")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def _open_rgb(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


@dataclasses.dataclass(frozen=True)
class _PageSize:
    width: int
    height: int


def _header_size(path: str) -> _PageSize:
    """A page's size from its header: the pixels are not decoded."""
    from PIL import Image

    with Image.open(path) as image:
        return _PageSize(*image.size)


def _or_none(fn: Callable, skip_errors: bool):
    """``fn()``; under ``skip_errors`` None when it raises (an unreadable
    page yields no output and the rest go on)."""
    if not skip_errors:
        return fn()
    result = [None]
    with contextlib.suppress(Exception):
        result[0] = fn()
    return result[0]


class _LazyPages(Sequence):
    """One bucket's pages for ``continuous_generate``: page i is opened,
    decoded and preprocessed only when it is read, which the decoder does
    once, when a row takes the page; under ``skip_errors`` a page that
    cannot be opened or decoded reads as None."""

    def __init__(self, paths: List[str], ids: np.ndarray, input_w: int, input_h: int,
                 skip_errors: bool):
        self.paths, self.ids, self.size = paths, ids, (input_w, input_h)
        self.skip_errors = skip_errors

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int):
        def load():
            return self.ids, preprocess_page(_open_rgb(self.paths[i]), *self.size)[0]

        return _or_none(load, self.skip_errors)


class DocumentParser:
    """End-to-end page → HTML parser driving a ``QwenVLModel`` on
    ``device`` (the card unless asked for the CPU; asking for the card
    where there is none raises). The model must already be on that
    device."""

    def __init__(
        self,
        model,
        tokenizer,
        image_size: int = 448,
        dynamic_resolution: bool = False,
        max_pixels: Optional[int] = None,
        pp_mesh=None,
        pp_stages: Optional[int] = None,
        dp_mesh=None,
        prefill_chunk: int = 0,
        device="cuda",
    ):
        """``dynamic_resolution=True`` smart-resizes each page onto its own
        merged-patch grid (aspect kept, pixel budget ``max_pixels``, default
        image_size²) instead of a fixed square. ``prefill_chunk=C`` prefills
        ``parse_batch`` C pages at a time (token-identical).

        ``pp_stages``/``pp_mesh`` (``parallel/pipeline.py::make_pp_mesh``)
        pipeline the decoder stack over a ``stage`` mesh axis
        (``models/qwen_pp.py``) — the serving shape for the notebook's 32B
        flagship. Token output equals the single-device decode.

        ``dp_mesh`` data-parallels ``parse_batch`` over the mesh's ``data``
        axis: pages shard on the batch dim (the batch padded by repeating
        its last page), every rank holds the whole model, and the tokens are
        all-gathered. Artifacts equal the single-device parse. Mutually
        exclusive with the PP ring. ``prefill_chunk`` is ignored under
        ``dp_mesh``, as in JAX. Every rank of a mesh makes the same calls."""
        if (pp_mesh is None) != (pp_stages is None):
            raise ValueError("pp_mesh and pp_stages must be set together")
        if dp_mesh is not None and pp_mesh is not None:
            raise ValueError("dp_mesh and pp_mesh are mutually exclusive")
        self.pp_mesh = pp_mesh
        self.pp_stages = pp_stages
        self.dp_mesh = dp_mesh
        self.device = resolve_device(device)
        self.model = model
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.dynamic_resolution = dynamic_resolution
        self.max_pixels = max_pixels or image_size * image_size
        self.prefill_chunk = prefill_chunk

    def build_prompt_ids(self, n_image_tokens: int, max_len: int) -> np.ndarray:
        """Chat-template prompt with image-pad placeholders spliced in."""
        cfg = self.model.config
        prefix, _ = self.tokenizer.encode(f"system: {SYSTEM_PROMPT}\nuser: {USER_PROMPT}", max_len)
        prefix = prefix[np.nonzero(prefix)[0]]  # strip padding
        pads = np.full(n_image_tokens, cfg.image_pad_id, np.int32)
        suffix, _ = self.tokenizer.encode("\nassistant:", 16)
        suffix = suffix[np.nonzero(suffix)[0]]
        ids = np.concatenate([prefix, pads, suffix])[:max_len]
        return ids[None].astype(np.int32)

    def _input_size(self, image) -> Tuple[int, int]:
        """Model-input (width, height) for a page (anything with ``width``
        and ``height``): its own smart-resized merged-patch grid under
        dynamic resolution, else the fixed square."""
        unit = self.model.config.vision.patch_size * self.model.config.vision.merge_size
        if self.dynamic_resolution:
            input_h, input_w = smart_resize(
                image.height, image.width, factor=unit, min_pixels=unit * unit,
                max_pixels=self.max_pixels,
            )
        else:
            input_w, input_h = round_to_patch_grid(
                self.image_size, self.image_size,
                self.model.config.vision.patch_size, self.model.config.vision.merge_size,
            )
        return input_w, input_h

    def _prompt_ids(self, input_w: int, input_h: int, max_new_tokens: int) -> np.ndarray:
        unit = self.model.config.vision.patch_size * self.model.config.vision.merge_size
        n_tokens = (input_h // unit) * (input_w // unit)
        # leave generation headroom inside the static KV cache
        prompt_budget = self.model.config.text.max_len - max_new_tokens
        if prompt_budget < n_tokens + 4:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} leaves no prompt room within "
                f"max_len={self.model.config.text.max_len}"
            )
        return self.build_prompt_ids(n_tokens, prompt_budget)

    def parse_batch(self, image_paths: List[str], max_new_tokens: int = 256
                    ) -> List[Tuple[str, int, int]]:
        """Pages whose model-input grids match run as one batch; results in
        input order, the same tokens as per-page ``parse``. Under the PP ring
        the pages run one by one (its microbatching is its own schedule)."""
        if self.pp_stages:
            return [self.parse(p, max_new_tokens) for p in image_paths]
        buckets: dict = {}
        for i, path in enumerate(image_paths):
            image = _open_rgb(path)
            buckets.setdefault(self._input_size(image), []).append((i, image))
        results: List[Optional[Tuple[str, int, int]]] = [None] * len(image_paths)
        for (input_w, input_h), items in buckets.items():
            ids1 = self._prompt_ids(input_w, input_h, max_new_tokens)
            arr = np.concatenate([preprocess_page(img, input_w, input_h) for _, img in items])
            ids = np.tile(ids1, (len(items), 1))
            if self.dp_mesh is not None:
                out_tokens = self._dp_generate(ids, arr, max_new_tokens)
            else:
                out_tokens = greedy_generate(self.model, ids, arr, max_new_tokens=max_new_tokens,
                                             prefill_chunk=self.prefill_chunk)
            for row, (i, _) in zip(out_tokens, items):
                results[i] = (self.decode_tokens(row), input_h, input_w)
        return results  # type: ignore[return-value]

    def _dp_generate(self, ids: np.ndarray, arr: np.ndarray, max_new_tokens: int) -> np.ndarray:
        """``greedy_generate`` of a page batch over ``dp_mesh``'s data axis:
        the batch padded to the axis by repeating its last page, this rank's
        rows generated, every rank's tokens gathered, the surplus dropped."""
        n = ids.shape[0]
        padded = pad_to_multiple(n, self.dp_mesh.shape[DATA_AXIS])
        if padded != n:
            # repeat the last page so the batch divides the data axis
            ids = np.concatenate([ids, np.repeat(ids[-1:], padded - n, axis=0)])
            arr = np.concatenate([arr, np.repeat(arr[-1:], padded - n, axis=0)])
        local = greedy_generate(self.model, shard_batch(self.dp_mesh, ids),
                                shard_batch(self.dp_mesh, arr), max_new_tokens=max_new_tokens)
        tokens = torch.from_numpy(np.ascontiguousarray(local)).to(self.device)
        return self.dp_mesh.all_gather(tokens, DATA_AXIS).cpu().numpy()[:n]

    def parse_continuous(
        self,
        image_paths: List[str],
        max_new_tokens: int = 256,
        batch: int = 8,
        chunk: int = 64,
        skip_errors: bool = False,
    ) -> List[Optional[Tuple[str, int, int]]]:
        """Continuous-batching bulk parse (``models/qwen_serve.py``): a fixed
        ``batch``-row decoder with per-row cache depths serves the page
        queue, retiring each row at its own EOS and splicing the next page
        in at chunk boundaries. Pages bucket by model-input grid, as in
        ``parse_batch``; results come in input order, with the tokens of
        per-page ``parse``.

        Each page's size is read from its header for the bucketing; its
        pixels are decoded and preprocessed only when a row takes it, so
        the host holds one preprocessed page at a time, not the queue.
        ``skip_errors=True`` gives None for a page that cannot be opened or
        decoded, and the other pages stay in the decoder. The loop runs on
        this rank's device alone, whatever the meshes (as in JAX; the CLI
        refuses ``--continuous`` with either)."""
        buckets: dict = {}
        results: List[Optional[Tuple[str, int, int]]] = [None] * len(image_paths)
        for i, path in enumerate(image_paths):
            size = _or_none(lambda: self._input_size(_header_size(path)), skip_errors)
            if size is not None:
                buckets.setdefault(size, []).append(i)
        for (input_w, input_h), items in buckets.items():
            ids1 = self._prompt_ids(input_w, input_h, max_new_tokens)
            pages = _LazyPages([image_paths[i] for i in items], ids1[0], input_w, input_h,
                               skip_errors)
            outs = continuous_generate(self.model, pages, batch=min(batch, len(pages)),
                                       max_new_tokens=max_new_tokens, chunk=chunk)
            for row, i in zip(outs, items):
                if row is not None:
                    results[i] = (self.decode_tokens(row), input_h, input_w)
        return results

    def parse(self, image_path: str, max_new_tokens: int = 256) -> Tuple[str, int, int]:
        """Returns (html, input_height, input_width) like the notebook's
        ``inference``."""
        image = _open_rgb(image_path)
        input_w, input_h = self._input_size(image)
        arr = preprocess_page(image, input_w, input_h)
        ids = self._prompt_ids(input_w, input_h, max_new_tokens)
        if self.pp_stages:
            out_tokens = pp_greedy_generate(self.model.config, self.model, ids,
                                            mesh=self.pp_mesh, n_stages=self.pp_stages,
                                            max_new_tokens=max_new_tokens, images=arr)
        else:
            out_tokens = greedy_generate(self.model, ids, arr, max_new_tokens=max_new_tokens)
        return self.decode_tokens(out_tokens[0]), input_h, input_w

    def decode_tokens(self, tokens: np.ndarray) -> str:
        """Byte-tokenizer decode."""
        chars = []
        for t in tokens:
            if t == EOS_ID:
                break
            byte = int(t) - BYTE_OFFSET
            if 0 <= byte < 256:  # skip specials and (random-weight) overflow ids
                chars.append(byte)
        return bytes(chars).decode("utf-8", errors="replace")
