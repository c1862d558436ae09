"""Byte-level BPE — the Llama-3 tokenizer algorithm, self-contained.

A jax-free copy of ``multimodal_embeddings_tpu/models/bpe.py``:
``ByteLevelBPE`` (regex pre-split, greedy lowest-rank byte-pair merging,
special-token parsing, decode), ``byte_pair_merge``, the GPT-2 byte remap,
the loaders of both vocabulary formats the published checkpoints ship
(``tokenizer.model``, a tiktoken dump of ``<base64 token> <rank>`` lines;
``tokenizer.json``, the HF fast-tokenizer JSON whose GPT-2
unicode-remapped vocabulary is converted back to byte ranks here),
``mllama_prompt_ids`` and ``synthetic_ranks``. ``tests/test_torch_bpe.py``
holds each copy to the original's source and results. One line differs:
``load_tokenizer_json`` skips a vocabulary entry that is not byte-level by
testing its characters instead of catching the ``KeyError`` (the package
keeps no ``try``). ``regex`` is imported only when a ``ByteLevelBPE`` is
built.
"""

from __future__ import annotations

import base64
import functools
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Llama-3's pre-tokenization pattern (contractions, letter runs with one
# optional leading non-letter, 1-3 digit runs, punctuation with trailing
# newlines, newline runs, trailing-whitespace lookahead, whitespace).
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+"
    r"|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)

# Llama-3 / Mllama special tokens (Mllama appends <|image|> at 128256)
LLAMA3_SPECIAL_TOKENS: Dict[str, int] = {
    "<|begin_of_text|>": 128000,
    "<|end_of_text|>": 128001,
    "<|finetune_right_pad_id|>": 128004,
    "<|start_header_id|>": 128006,
    "<|end_header_id|>": 128007,
    "<|eom_id|>": 128008,
    "<|eot_id|>": 128009,
    "<|python_tag|>": 128010,
    "<|image|>": 128256,
}


def byte_pair_merge(piece: bytes, ranks: Dict[bytes, int]) -> List[bytes]:
    """Greedy BPE: repeatedly merge the adjacent pair whose concatenation
    has the LOWEST rank (tiktoken semantics — merge order is rank order,
    not left-to-right)."""
    parts = [piece[i : i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best_rank: Optional[int] = None
        best_i = -1
        for i in range(len(parts) - 1):
            rank = ranks.get(parts[i] + parts[i + 1])
            if rank is not None and (best_rank is None or rank < best_rank):
                best_rank, best_i = rank, i
        if best_rank is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return parts


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's printable-unicode byte remap (needed to read HF
    ``tokenizer.json`` vocabularies back into raw bytes)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> Dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


def _token_str_to_bytes(token: str) -> bytes:
    u2b = unicode_to_bytes()
    return bytes(u2b[ch] for ch in token)


class ByteLevelBPE:
    """The full tokenizer: regex pre-split → byte-pair merge → ranks.

    ``ranks``: token bytes → id. Must contain every single byte (Llama-3's
    vocab does; a synthetic test vocab must too, or encoding raises).
    """

    def __init__(
        self,
        ranks: Dict[bytes, int],
        special_tokens: Optional[Dict[str, int]] = None,
        pattern: str = LLAMA3_PATTERN,
    ):
        import regex

        self.ranks = dict(ranks)
        self.special_tokens = dict(special_tokens or {})
        self._pat = regex.compile(pattern)
        if self.special_tokens:
            self._special_pat = regex.compile(
                "|".join(regex.escape(t) for t in sorted(self.special_tokens, key=len, reverse=True))
            )
        else:
            self._special_pat = None
        self._decoder = {v: k for k, v in self.ranks.items()}
        self._special_decoder = {
            v: k.encode("utf-8") for k, v in self.special_tokens.items()
        }
        missing = [b for b in range(256) if bytes([b]) not in self.ranks]
        if missing:
            raise ValueError(
                f"vocab is missing {len(missing)} single-byte tokens "
                f"(first: {missing[:5]}) — cannot encode arbitrary text"
            )

    @property
    def vocab_size(self) -> int:
        ids = list(self.ranks.values()) + list(self.special_tokens.values())
        return max(ids) + 1

    def encode_ordinary(self, text: str) -> List[int]:
        """Encode with NO special-token handling."""
        out: List[int] = []
        for match in self._pat.finditer(text):
            piece = match.group().encode("utf-8")
            if piece in self.ranks:
                out.append(self.ranks[piece])
                continue
            out.extend(self.ranks[part] for part in byte_pair_merge(piece, self.ranks))
        return out

    def encode(self, text: str, parse_special: bool = True) -> List[int]:
        """Encode; occurrences of special tokens in the text map to their
        ids (the Mllama prompt template embeds them literally)."""
        if not parse_special or self._special_pat is None:
            return self.encode_ordinary(text)
        out: List[int] = []
        pos = 0
        for match in self._special_pat.finditer(text):
            if match.start() > pos:
                out.extend(self.encode_ordinary(text[pos : match.start()]))
            out.append(self.special_tokens[match.group()])
            pos = match.end()
        if pos < len(text):
            out.extend(self.encode_ordinary(text[pos:]))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        parts: List[bytes] = []
        for i in ids:
            if i in self._special_decoder:
                parts.append(self._special_decoder[i])
            else:
                parts.append(self._decoder[i])
        return b"".join(parts).decode("utf-8", errors="replace")


def load_tiktoken_model(path: str) -> Dict[bytes, int]:
    """Load a tiktoken dump (``<base64> <rank>`` per line) into ranks."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def load_tokenizer_json(path: str) -> Tuple[Dict[bytes, int], Dict[str, int]]:
    """Load an HF fast-tokenizer JSON: vocab entries are GPT-2
    unicode-remapped strings → convert back to bytes; added_tokens become
    special tokens."""
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    vocab = data["model"]["vocab"]
    ranks: Dict[bytes, int] = {}
    u2b = unicode_to_bytes()
    for token, idx in vocab.items():
        # non-byte-level entries (shouldn't exist in Llama-3 vocabs) are skipped
        if all(ch in u2b for ch in token):
            ranks[_token_str_to_bytes(token)] = int(idx)
    special = {
        t["content"]: int(t["id"])
        for t in data.get("added_tokens", [])
    }
    return ranks, special


def mllama_prompt_ids(
    bpe: ByteLevelBPE,
    text: str = " Represent the given image.",
) -> List[int]:
    """The reference's image-embedding prompt
    ``"<|image|><|begin_of_text|> Represent the given image."``
    (``embedder.py:117-121``) as token ids."""
    return bpe.encode("<|image|><|begin_of_text|>" + text, parse_special=True)


def synthetic_ranks(words: Sequence[str] = ()) -> Dict[bytes, int]:
    """A minimal complete vocab for tests: all 256 bytes, then merges built
    from the given words' prefixes (deterministic rank order)."""
    ranks: Dict[bytes, int] = {bytes([b]): b for b in range(256)}
    next_rank = 256
    for word in words:
        data = word.encode("utf-8")
        for end in range(2, len(data) + 1):
            piece = data[:end]
            if piece not in ranks:
                ranks[piece] = next_rank
                next_rank += 1
    return ranks
