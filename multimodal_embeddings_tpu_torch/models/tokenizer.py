"""Tokenization for the embedding models: ``ByteTokenizer``.

Verbatim copy of ``multimodal_embeddings_tpu/models/tokenizer.py``'s
``ByteTokenizer`` (a deterministic, dependency-free byte-level tokenizer:
UTF-8 bytes plus special tokens), so that the port imports nothing of the
JAX package; ``tests/test_torch_mme5.py`` holds the two equal. The
``HFTokenizer`` (a local Llama-3 vocabulary) is not ported yet.
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
