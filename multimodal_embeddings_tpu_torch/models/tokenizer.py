"""Tokenization for the embedding models: ``ByteTokenizer`` and
``HFTokenizer``.

Verbatim copies of ``multimodal_embeddings_tpu/models/tokenizer.py``'s two
backends, so that the port imports nothing of the JAX package:

* ``ByteTokenizer`` — a deterministic, dependency-free byte-level tokenizer
  (UTF-8 bytes plus special tokens); ``tests/test_torch_mme5.py`` holds the
  two equal;
* ``HFTokenizer`` — the checkpoint-parity Llama-3 tokenizer: the byte-level
  BPE of ``models/bpe.py`` on a local vocabulary file, else a local
  ``transformers`` tokenizer directory (imported only then; nothing is
  downloaded); ``tests/test_torch_bpe.py`` holds it to the original.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
IMAGE_ID = 3
BYTE_OFFSET = 4
BYTE_VOCAB = 256 + BYTE_OFFSET


class ByteTokenizer:
    vocab_size = BYTE_VOCAB

    def encode(
        self, text: str, max_len: int, add_image_token: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        ids: List[int] = [BOS_ID]
        if add_image_token:
            ids.append(IMAGE_ID)
        ids.extend(BYTE_OFFSET + b for b in text.encode("utf-8"))
        ids.append(EOS_ID)
        ids = ids[:max_len]
        mask = np.zeros(max_len, np.int32)
        mask[: len(ids)] = 1
        out = np.full(max_len, PAD_ID, np.int32)
        out[: len(ids)] = ids
        return out, mask

    def encode_batch(
        self, texts: List[str], max_len: int, add_image_token: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), max_len), np.int32)
        masks = np.zeros((len(texts), max_len), np.int32)
        for i, text in enumerate(texts):
            ids[i], masks[i] = self.encode(text, max_len, add_image_token)
        return ids, masks


class HFTokenizer:
    """Checkpoint-parity tokenizer: the self-contained Llama-3 byte-level
    BPE (``models/bpe.py``) loaded from local vocabulary files.

    ``path`` may be a directory containing ``tokenizer.model`` (tiktoken
    dump) or ``tokenizer.json`` (HF fast format), or one of those files
    directly. Only the vocabulary *data* is environment-dependent — the
    regex pre-split, merge algorithm, special-token parsing and the
    Mllama prompt handling are implemented here. Matches AutoTokenizer
    behavior: a BOS ``<|begin_of_text|>`` is prepended to every sequence
    (so the reference prompt, which embeds ``<|begin_of_text|>``
    literally, yields a doubled BOS exactly as ``AutoProcessor`` produces
    — ``embedder.py:117-121``). Falls back to a local ``transformers``
    tokenizer directory when no vocab file is recognized.
    """

    def __init__(self, path: str):
        import os

        from multimodal_embeddings_tpu_torch.models.bpe import (
            LLAMA3_SPECIAL_TOKENS,
            ByteLevelBPE,
            load_tiktoken_model,
            load_tokenizer_json,
        )

        candidates = (
            [path]
            if os.path.isfile(path)
            else [
                os.path.join(path, "tokenizer.model"),
                os.path.join(path, "tokenizer.json"),
            ]
        )
        self.bpe = None
        for cand in candidates:
            if not os.path.isfile(cand):
                continue
            if cand.endswith(".json"):
                ranks, special = load_tokenizer_json(cand)
                special = special or LLAMA3_SPECIAL_TOKENS
            else:
                ranks = load_tiktoken_model(cand)
                special = LLAMA3_SPECIAL_TOKENS
            self.bpe = ByteLevelBPE(ranks, special)
            break
        if self.bpe is not None:
            self.vocab_size = self.bpe.vocab_size
            self.bos_id = self.bpe.special_tokens.get("<|begin_of_text|>")
            self.image_id = self.bpe.special_tokens.get("<|image|>")
            self.pad_id = self.bpe.special_tokens.get(
                "<|finetune_right_pad_id|>", 0
            )
            self.tok = None
        else:
            from transformers import AutoTokenizer

            self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
            self.vocab_size = len(self.tok)

    def encode_batch(
        self, texts: List[str], max_len: int, add_image_token: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self.bpe is None:
            if add_image_token:
                texts = ["<|image|>" + t for t in texts]
            enc = self.tok(
                texts,
                padding="max_length",
                truncation=True,
                max_length=max_len,
                return_tensors="np",
            )
            return (
                enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(np.int32),
            )
        ids = np.full((len(texts), max_len), self.pad_id, np.int32)
        masks = np.zeros((len(texts), max_len), np.int32)
        for i, text in enumerate(texts):
            row: List[int] = []
            if self.bos_id is not None:
                row.append(self.bos_id)
            if add_image_token and self.image_id is not None:
                row.append(self.image_id)
            row.extend(self.bpe.encode(text, parse_special=True))
            row = row[:max_len]
            ids[i, : len(row)] = row
            masks[i, : len(row)] = 1
        return ids, masks
