"""Continuous batching in the port (``models/qwen_serve.py``, the per-row
decode depths of ``models/qwen_vl.py``, ``DocumentParser.parse_continuous``
and ``cli.parse --continuous``) against the JAX package's, in f32 on the CPU
on the same weights (the JAX tree through the bridge).

Tolerances are those of ``tests/test_torch_qwen_vl.py``: logits 1e-4
absolute, a bf16 cache slot to one bf16 step of its magnitude. Tokens, step
and chunk counts, HTML and ``parse_index.json`` must be equal."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import weakref

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox
from PIL import Image

import jax.numpy as jnp

from multimodal_embeddings_tpu.analysis import doc_parser as jd
from multimodal_embeddings_tpu.cli import parse as jcli
from multimodal_embeddings_tpu.models import qwen_serve as jserve
from multimodal_embeddings_tpu.models import qwen_vl as jq
from multimodal_embeddings_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.analysis import doc_parser as td
from multimodal_embeddings_tpu_torch.cli import parse as tcli
from multimodal_embeddings_tpu_torch.models import qwen_serve as tserve
from multimodal_embeddings_tpu_torch.models import qwen_vl as tq
from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
from multimodal_embeddings_tpu_torch.models.weights import build_qwen

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
# a 12x10-patch page: the merged grid is 6x5, 30 image pads
IMG_HW = (168, 140)
N_PAD = 30
PROMPT = N_PAD + 5


def _randomize(flat, seed):
    """Random norm scales and biases, so the logits are decisive."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
            if k.endswith(("/scale", "/bias")) else np.asarray(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def pair():
    """The tiny config of both packages (vision block 1 full attention), the
    same weights."""
    def cut(cfg):
        return dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, fullatt_block_indexes=(1,)))

    jmodel = jq.QwenVLModel(cut(jq.QwenVLConfig.tiny()))
    ids, imgs = _prompt(1)
    flat = _randomize(flatten_params(unbox(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(imgs)))), 0)
    variables = {"params": unflatten_params({k[len("params/"):]: v for k, v in flat.items()})}
    port = build_qwen(cut(tq.QwenVLConfig.tiny()), torch.float32, "cpu", params=flat)
    return jmodel, variables, port


def _prompt(b, seed=4):
    rng = np.random.default_rng(seed)
    ids = np.full((b, PROMPT), 1, np.int32)
    ids[:, 1:3] = rng.integers(6, 500, size=(b, 2))
    ids[:, 3 : 3 + N_PAD] = 5  # image_pad_id of the tiny config
    ids[:, 3 + N_PAD :] = rng.integers(6, 500, size=(b, 2))
    imgs = rng.normal(size=(b, *IMG_HW, 3)).astype(np.float32)
    return ids, imgs


def _pages(n, seed, text_only=False):
    ids, imgs = _prompt(n, seed)
    if text_only:
        return [(row, None) for row in ids]
    return list(zip(ids, imgs))


def _to_torch_caches(caches):
    return [(torch.from_numpy(np.array(k.astype(jnp.float32))).bfloat16(),
             torch.from_numpy(np.array(v.astype(jnp.float32))).bfloat16()) for k, v in caches]


def _close_bf16(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2**-7, atol=1e-6)


# ---------------------------------------------------------------------------
# the per-row decode step
# ---------------------------------------------------------------------------


def test_decode_step_per_row_depths_equal_jax(pair):
    """Rows at different depths ((B,) position): logits 1e-4 and every slot
    of every cache to one bf16 step, against JAX's per-row branch."""
    jmodel, variables, port = pair
    ids, imgs = _prompt(3)
    _, caches, delta = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(imgs), cache_len=64)
    # give the slots past the prompt values, so the mask matters
    rng = np.random.default_rng(1)
    caches = [(k.at[:, PROMPT:].set(jnp.asarray(rng.normal(size=k[:, PROMPT:].shape),
                                                k.dtype)), v) for k, v in caches]
    tok = np.asarray([[17], [230], [41]], np.int32)
    pos = np.asarray([PROMPT, PROMPT + 7, PROMPT + 2], np.int32)
    want, new = jmodel.apply(variables, jnp.asarray(tok), caches, jnp.asarray(pos), delta,
                             method=jmodel.decode_step)
    tcaches = _to_torch_caches(caches)
    with torch.no_grad():
        got, tnew = port.decode_step(torch.from_numpy(tok), tcaches, torch.from_numpy(pos),
                                     torch.from_numpy(np.array(delta)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert all(t is c for (t, _), (c, _) in zip(tnew, tcaches))  # written in place
    for (tk, tv), (jk, jv) in zip(tnew, new):
        _close_bf16(tk, jk)
        _close_bf16(tv, jv)
    # each row wrote its own slot only
    first = _to_torch_caches(caches)[0][0]
    for r, p in enumerate(pos):
        changed = (tnew[0][0][r] != first[r]).any(dim=(1, 2)).nonzero().flatten().tolist()
        assert changed == [p]


def test_position_forms_agree(pair):
    """At one depth the int, 0-d and (B,) positions give equal logits and
    caches (bit for bit), and equal JAX's scalar form."""
    jmodel, variables, port = pair
    ids, imgs = _prompt(2)
    _, caches, delta = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(imgs), cache_len=64)
    tok = np.asarray([[17], [230]], np.int32)
    want, _ = jmodel.apply(variables, jnp.asarray(tok), caches, PROMPT, delta,
                           method=jmodel.decode_step)
    outs = []
    for position in (PROMPT, torch.tensor(PROMPT, dtype=torch.int32),
                     torch.tensor([PROMPT, PROMPT], dtype=torch.int32)):
        with torch.no_grad():
            logits, tnew = port.decode_step(torch.from_numpy(tok), _to_torch_caches(caches),
                                            position, torch.from_numpy(np.array(delta)))
        outs.append((logits, tnew))
    np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(want), atol=1e-4)
    for logits, tnew in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        for (a, b), (c, d) in zip(tnew, outs[0][1]):
            assert torch.equal(a, c) and torch.equal(b, d)


# ---------------------------------------------------------------------------
# continuous_generate
# ---------------------------------------------------------------------------

# (pages, batch, chunk, max_new, stops, text-only): refills with stops from
# an instant EOS (0) to never (99); no injection (every row runs to the
# maximum); text-only pages
SCENARIOS = {
    "refills": (7, 3, 4, 8, [2, 5, 8, 1, 0, 3, 99], False),
    "no_injection": (5, 3, 4, 8, None, False),
    "text_only": (3, 2, 2, 5, [3, 99, 0], True),
}


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_continuous_generate_equal_jax(pair, scenario, early_exit):
    """Tokens of every page, ``decode_steps`` and ``chunks`` equal to JAX's
    ``continuous_generate``; the tokens also equal the port's one-shot
    decode of each page alone under the same stop."""
    jmodel, variables, port = pair
    n, batch, chunk, max_new, stops, text_only = SCENARIOS[scenario]
    pages = _pages(n, seed=11, text_only=text_only)
    jstats, tstats = {}, {}
    want = jserve.continuous_generate(jmodel, variables, pages, batch=batch,
                                      max_new_tokens=max_new, chunk=chunk, stops=stops,
                                      stats=jstats, early_exit=early_exit)
    got = tserve.continuous_generate(port, pages, batch=batch, max_new_tokens=max_new,
                                     chunk=chunk, stops=stops, stats=tstats,
                                     early_exit=early_exit)
    assert len(got) == n
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.shape == (max_new,)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"page {i}")
    assert (tstats["decode_steps"], tstats["chunks"]) == (jstats["decode_steps"],
                                                         jstats["chunks"])
    assert {k: tstats[k] for k in ("batch", "chunk", "early_exit")} == {
        k: jstats[k] for k in ("batch", "chunk", "early_exit")}
    assert tstats["wall_s"] > 0 and tstats["splice_s"] >= 0
    assert len(np.unique(np.concatenate(got))) > 3
    # the contract: each page's tokens are the one-shot decoders'
    prefill, decode = tq.build_generate_fns(port, PROMPT, max_new, early_stop=False)
    for i, (ids, img) in enumerate(pages):
        force = None if stops is None else torch.tensor([min(stops[i], max_new)],
                                                        dtype=torch.int32)
        last, caches, delta = prefill(torch.from_numpy(ids[None]).long(),
                                      None if img is None else torch.from_numpy(img[None]))
        np.testing.assert_array_equal(got[i], decode(last, caches, delta, force)[0].numpy())


def test_continuous_generate_skips_unreadable_pages(pair):
    """A page given as None (a lazy page that could not be read) takes no
    row and yields None; the others equal their run without it."""
    _, _, port = pair
    pages = _pages(4, seed=3)
    got = tserve.continuous_generate(port, [pages[0], None, pages[1], pages[2], None],
                                     batch=2, max_new_tokens=6, chunk=3, stops=[2, 0, 6, 1, 3])
    want = tserve.continuous_generate(port, pages[:3], batch=2, max_new_tokens=6, chunk=3,
                                      stops=[2, 6, 1])
    assert got[1] is None and got[4] is None
    for g, w in zip([got[0], got[2], got[3]], want):
        np.testing.assert_array_equal(g, w)
    assert tserve.continuous_generate(port, [None], batch=2, max_new_tokens=4) == [None]
    assert tserve.continuous_generate(port, [], batch=2, max_new_tokens=4) == []


def test_splice_copies_one_row_and_leaves_the_rest(pair):
    """The splice writes the page's caches, token, clock, stop and delta into
    its row, copies rather than aliases them, and leaves every other row's
    caches equal bit for bit; ``cache_len`` is JAX's."""
    _, _, port = pair
    max_new = 8
    fns = tserve.build_continuous_fns(port, 3, PROMPT, max_new, 4)
    prefill1, splice_row, _, _, init_state = fns
    state = init_state()
    cache_len = min(port.config.text.max_len, -(-(PROMPT + max_new) // 128) * 128)
    assert state["caches"][0][0].shape == (3, cache_len, 2, 16)
    assert set(state) == {"token", "t", "done", "stops", "delta", "caches"}
    # the state is made of inference tensors: edit them in inference mode
    with torch.inference_mode():
        gen = torch.Generator().manual_seed(0)
        for k, v in state["caches"]:
            k.copy_(torch.randn(k.shape, generator=gen))
            v.copy_(torch.randn(v.shape, generator=gen))
        before = [(k.clone(), v.clone()) for k, v in state["caches"]]
        ids, imgs = _prompt(1)
        last, caches, delta = prefill1(torch.from_numpy(ids).long(), torch.from_numpy(imgs))
        state, first = splice_row(state, 1, last, caches, delta, 5)
        assert int(first) == int(last[0].argmax())
        for (k, v), (k0, v0), (nk, nv) in zip(state["caches"], before, caches):
            for got, old, new in ((k, k0, nk), (v, v0, nv)):
                assert torch.equal(got[0], old[0]) and torch.equal(got[2], old[2])
                assert torch.equal(got[1], new[0])
                assert got.data_ptr() != new.data_ptr()
            nk.fill_(7.0)  # the prefill's tensors are not the state's
            assert not torch.equal(k[1], nk[0])
        assert state["token"].tolist()[1] == int(first) and state["t"].tolist()[1] == 0
        assert state["stops"].tolist() == [max_new + 1, 5, max_new + 1]
        assert state["delta"].tolist()[1] == int(delta[0])
        assert state["done"].tolist() == [True, False, True]
        state, first = splice_row(state, 2, last, caches, delta, 0)
        assert int(first) == port.config.eos_id and state["done"].tolist()[2]


# ---------------------------------------------------------------------------
# parse_continuous and the CLI
# ---------------------------------------------------------------------------


def _parser_weights(seed=0):
    model = jq.QwenVLModel(jq.QwenVLConfig.tiny())
    flat = flatten_params(unbox(model.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32),
                                           jnp.zeros((1, 56, 56, 3)))))
    rng = np.random.default_rng(seed)
    for key, val in flat.items():
        scale = 0.5 if key.endswith(("/scale", "/bias")) else 0.1
        flat[key] = (np.asarray(val) + rng.normal(scale=scale, size=val.shape)).astype(np.float32)
    return model, flat


def _page_files(folder, sizes, seed=3):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, (w, h) in enumerate(sizes):
        path = os.path.join(folder, f"doc{i}.png")
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    return paths


def test_parse_continuous_equal_jax(tmp_path):
    """Two dynamic-resolution buckets: results in input order, equal to
    JAX's ``parse_continuous`` and to the port's ``parse_batch``."""
    jmodel, flat = _parser_weights()
    variables = {"params": unflatten_params({k[len("params/"):]: v for k, v in flat.items()})}
    port = build_qwen(tq.QwenVLConfig.tiny(), torch.float32, "cpu", params=flat)
    kw = dict(image_size=56, dynamic_resolution=True, max_pixels=6 * 28 * 28)
    jparser = jd.DocumentParser(jmodel, variables, JByteTokenizer(), **kw)
    tparser = td.DocumentParser(port, ByteTokenizer(), device="cpu", **kw)
    paths = _page_files(str(tmp_path), [(120, 90), (60, 150), (120, 90), (60, 150), (120, 90)])
    sizes = {tparser._input_size(Image.open(p)) for p in paths}
    assert len(sizes) == 2
    want = jparser.parse_continuous(paths, max_new_tokens=6, batch=2, chunk=3)
    got = tparser.parse_continuous(paths, max_new_tokens=6, batch=2, chunk=3)
    assert got == want and any(html for html, _, _ in want)
    assert got == tparser.parse_batch(paths, max_new_tokens=6)


def test_parse_continuous_holds_few_pages(tmp_path, monkeypatch):
    """Pages are preprocessed when a row takes them, once each: no more than
    2 x batch preprocessed pages are alive at once."""
    _, flat = _parser_weights()
    port = build_qwen(tq.QwenVLConfig.tiny(), torch.float32, "cpu", params=flat)
    tparser = td.DocumentParser(port, ByteTokenizer(), image_size=56, device="cpu")
    paths = _page_files(str(tmp_path), [(90, 70)] * 7)
    live, calls, peak = set(), [], [0]
    real = td.preprocess_page

    def tracked(image, w, h):
        out = real(image, w, h)
        owner = out.base if out.base is not None else out
        calls.append(id(owner))
        live.add(id(owner))
        weakref.finalize(owner, live.discard, id(owner))
        peak[0] = max(peak[0], len(live))
        return out

    monkeypatch.setattr(td, "preprocess_page", tracked)
    got = tparser.parse_continuous(paths, max_new_tokens=4, batch=2, chunk=2)
    assert len(got) == 7 and all(r is not None for r in got)
    assert len(calls) == 7
    assert 1 <= peak[0] <= 2 * 2, peak[0]


def _cli_base(tmp_path, monkeypatch, sizes):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax, "eval_shape", lambda fn, *args: fn(*args))
    _, flat = _parser_weights(1)
    np.savez("tiny.npz", **flat)
    _page_files("pages", sizes, seed=5)
    return ["--input_folder", "pages", "--size", "tiny", "--weights", "tiny.npz",
            "--max_new_tokens", "8", "--continuous", "--batch_size", "2", "--chunk", "4"]


def _same_outputs():
    names = sorted(os.listdir("out_jax"))
    assert names == sorted(os.listdir("out_port"))
    for name in names:
        assert open(f"out_port/{name}", "rb").read() == open(f"out_jax/{name}", "rb").read(), name
    return names


def test_cli_continuous_equal_jax_cli(tmp_path, monkeypatch):
    """Both CLIs under ``--continuous`` on the same ``.npz`` write
    byte-identical ``.qwen.html``, ``.clean.html`` and
    ``parse_index.json`` (the JAX CLI's ``--weights`` needs the concrete
    init of ``tests/test_torch_doc_parser.py``)."""
    base = _cli_base(tmp_path, monkeypatch, [(120, 90), (90, 120), (140, 100)])
    assert jcli.main([*base, "--output_folder", "out_jax"]) == 0
    assert tcli.main([*base, "--output_folder", "out_port", "--device", "cpu"]) == 0
    assert len(_same_outputs()) == 7
    index = json.load(open("out_port/parse_index.json"))
    assert [e["html"] for e in index] == ["doc0.qwen.html", "doc1.qwen.html", "doc2.qwen.html"]


def test_cli_continuous_skip_errors(tmp_path, monkeypatch):
    """``--skip_errors`` with a page that cannot be opened and one that
    cannot be decoded: they yield no output, the others equal JAX's output
    for them (JAX re-parses every page at batch 1), and the port never
    falls back to per-page parsing."""
    base = _cli_base(tmp_path, monkeypatch, [(120, 90), (90, 120), (140, 100)])
    open("pages/bad.png", "wb").write(b"not an image")
    good = open("pages/doc1.png", "rb").read()
    open("pages/cut.png", "wb").write(good[: len(good) // 2])
    with pytest.raises(Exception):
        tcli.main([*base, "--output_folder", "out_raise", "--device", "cpu"])
    assert jcli.main([*base, "--output_folder", "out_jax", "--skip_errors"]) == 0
    fallback = []
    monkeypatch.setattr(td.DocumentParser, "parse",
                        lambda self, *a, **k: fallback.append(a) or pytest.fail("b1 fallback"))
    assert tcli.main([*base, "--output_folder", "out_port", "--device", "cpu",
                      "--skip_errors"]) == 0
    assert not fallback
    assert len(_same_outputs()) == 7
    index = json.load(open("out_port/parse_index.json"))
    assert [e["html"] for e in index] == ["doc0.qwen.html", "doc1.qwen.html", "doc2.qwen.html"]


@pytest.mark.parametrize("flag", ["--pipeline_parallel", "--data_parallel"])
def test_cli_continuous_refuses_pp_and_dp(tmp_path, flag):
    _page_files(str(tmp_path / "pages"), [(60, 60)])
    with pytest.raises(SystemExit, match="--continuous schedules one device's rows"):
        tcli.main(["--input_folder", str(tmp_path / "pages"), "--size", "tiny", "--device",
                   "cpu", "--continuous", flag, "2"])


# ---------------------------------------------------------------------------
# the parse bench's twin
# ---------------------------------------------------------------------------


def test_parse_bench_twin_continuous_on_the_cpu(tmp_path):
    """``scripts/torch_parse_bench.py --continuous`` at the tiny size prints
    one JSON line with the JAX script's continuous keys and writes no
    file."""
    record = (REPO / "BENCH_PARSE.json").read_bytes()
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_parse_bench.py"), "--size", "tiny",
         "--device", "cpu", "--continuous", "4", "--batch", "2", "--eos_ragged", "1,3"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    for key in ("metric", "size", "mode", "pages", "batch", "chunk", "early_exit", "input_wh",
                "prompt_len", "max_new_tokens", "wall_s", "pages_per_hour",
                "useful_tokens_per_sec", "decode_steps_executed", "ideal_row_steps",
                "splice_s", "chunks", "warm_pass_s", "init_s", "weights_upload_s",
                "eos_ragged"):
        assert key in result, key
    assert result["mode"] == "continuous" and result["pages"] == 4 and result["batch"] == 2
    assert result["eos_ragged"]["stops_cycle"] == [1, 3]
    assert os.listdir(tmp_path) == []
    assert (REPO / "BENCH_PARSE.json").read_bytes() == record


def test_continuous_ab_script_on_the_cpu(tmp_path):
    """``scripts/torch_parse_bench.py --continuous --ab`` at the tiny size:
    every schedule's tokens equal the waves' (it exits otherwise), one JSON
    line with each schedule's runs and median under ``ab``, no file
    written."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_parse_bench.py"), "--size", "tiny",
         "--device", "cpu", "--continuous", "5", "--batch", "2", "--chunk", "3",
         "--max_new_tokens", "8", "--eos_ragged", "2,7", "--ab", "--iters", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    ab = json.loads(lines[0])["ab"]
    assert set(ab) == {"waves", "early_exit", "fixed"}
    assert all(len(s["runs_s"]) == 1 for s in ab.values())
    assert ab["waves"]["decode_steps"] is None and ab["fixed"]["decode_steps"] % 3 == 0
    assert os.listdir(tmp_path) == []
