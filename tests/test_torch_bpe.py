"""The port's Llama-3 byte-level BPE (``models/bpe.py``) and ``HFTokenizer``
against the JAX package's, on vocabularies the tests build and write.

Both are verbatim copies: each copied function's source must equal the
original's (``load_tokenizer_json`` apart, which tests a vocabulary entry's
characters instead of catching a ``KeyError``; ``HFTokenizer`` apart from
the package it imports ``bpe`` from), and every result must be equal."""

import base64
import inspect
import json

import pytest

from multimodal_embeddings_tpu.models import bpe as jbpe
from multimodal_embeddings_tpu.models import tokenizer as jtok
from multimodal_embeddings_tpu_torch.models import bpe as tbpe
from multimodal_embeddings_tpu_torch.models import tokenizer as ttok

WORDS = ["the", "ing", "Represent", " given", " image", "newspaper", "café"]
TEXTS = [
    "The quick brown fox! 123 jumping...",
    "  leading spaces\nand newlines\r\n",
    "unicode: café — naïve 中文",
    "I'll don't we've 'd 12345 hello, world!",
    "<|image|><|begin_of_text|> Represent the given image.",
    "",
]


@pytest.mark.parametrize("name", ["LLAMA3_PATTERN", "LLAMA3_SPECIAL_TOKENS"])
def test_constants_equal(name):
    assert getattr(tbpe, name) == getattr(jbpe, name)


@pytest.mark.parametrize("name", ["byte_pair_merge", "bytes_to_unicode", "unicode_to_bytes",
                                  "_token_str_to_bytes", "ByteLevelBPE", "load_tiktoken_model",
                                  "mllama_prompt_ids", "synthetic_ranks"])
def test_verbatim_copies(name):
    assert inspect.getsource(getattr(tbpe, name)) == inspect.getsource(getattr(jbpe, name))


def test_hf_tokenizer_is_a_verbatim_copy():
    port = inspect.getsource(ttok.HFTokenizer).replace("multimodal_embeddings_tpu_torch.",
                                                       "multimodal_embeddings_tpu.")
    assert port == inspect.getsource(jtok.HFTokenizer)


def test_merge_and_byte_maps_equal():
    ranks = {bytes([b]): b for b in range(256)}
    ranks.update({b"ab": 256, b"bc": 257, b"abc": 258, b"xy": 300, b"yz": 259})
    for piece in (b"abc", b"xyz", b"abcabc", b"a", b"zzxyab"):
        assert tbpe.byte_pair_merge(piece, ranks) == jbpe.byte_pair_merge(piece, ranks)
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    assert tbpe.unicode_to_bytes() == jbpe.unicode_to_bytes()
    assert tbpe.synthetic_ranks(WORDS) == jbpe.synthetic_ranks(WORDS)


@pytest.mark.parametrize("special", [True, False])
def test_encode_decode_equal(special):
    ranks = tbpe.synthetic_ranks(WORDS)
    specials = tbpe.LLAMA3_SPECIAL_TOKENS if special else None
    port, ref = tbpe.ByteLevelBPE(ranks, specials), jbpe.ByteLevelBPE(ranks, specials)
    assert port.vocab_size == ref.vocab_size
    for text in TEXTS:
        for parse in (True, False):
            ids = port.encode(text, parse_special=parse)
            assert ids == ref.encode(text, parse_special=parse)
            assert port.decode(ids) == ref.decode(ids)
        assert port.encode_ordinary(text) == ref.encode_ordinary(text)
    assert tbpe.mllama_prompt_ids(port) == jbpe.mllama_prompt_ids(ref)
    assert tbpe.mllama_prompt_ids(port, " x") == jbpe.mllama_prompt_ids(ref, " x")
    with pytest.raises(ValueError, match="single-byte"):
        tbpe.ByteLevelBPE({b"a": 0})


def _write_vocab(tmp_path):
    """A tiktoken dump and an HF tokenizer.json of the same vocabulary; the
    JSON also holds an entry that is not byte-level ('€' is outside the GPT-2
    remap)."""
    ranks = tbpe.synthetic_ranks(WORDS)
    model = tmp_path / "tokenizer.model"
    model.write_bytes(b"".join(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n"
                               for tok, rank in ranks.items()) + b"\n")
    b2u = tbpe.bytes_to_unicode()
    vocab = {"".join(b2u[b] for b in tok): rank for tok, rank in ranks.items()}
    vocab["€uro"] = 9999
    added = [{"content": "<|begin_of_text|>", "id": 128000}, {"content": "<|image|>", "id": 128256},
             {"content": "<|finetune_right_pad_id|>", "id": 128004}]
    js = tmp_path / "json" / "tokenizer.json"
    js.parent.mkdir()
    js.write_text(json.dumps({"model": {"vocab": vocab, "merges": []}, "added_tokens": added}),
                  encoding="utf-8")
    return ranks, model, js


def test_loaders_equal(tmp_path):
    ranks, model, js = _write_vocab(tmp_path)
    assert tbpe.load_tiktoken_model(str(model)) == jbpe.load_tiktoken_model(str(model)) == ranks
    got, want = tbpe.load_tokenizer_json(str(js)), jbpe.load_tokenizer_json(str(js))
    assert got == want
    assert got[0] == ranks and got[1]["<|image|>"] == 128256


@pytest.mark.parametrize("which", ["model_file", "json_file", "directory"])
@pytest.mark.parametrize("add_image", [False, True])
def test_hf_tokenizer_encode_batch_equal(tmp_path, which, add_image):
    _, model, js = _write_vocab(tmp_path)
    path = {"model_file": model, "json_file": js, "directory": tmp_path}[which]
    port, ref = ttok.HFTokenizer(str(path)), jtok.HFTokenizer(str(path))
    assert (port.vocab_size, port.bos_id, port.image_id, port.pad_id) == (
        ref.vocab_size, ref.bos_id, ref.image_id, ref.pad_id)
    for max_len in (8, 40):
        got = port.encode_batch(TEXTS, max_len, add_image_token=add_image)
        want = ref.encode_batch(TEXTS, max_len, add_image_token=add_image)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and (g == w).all()
