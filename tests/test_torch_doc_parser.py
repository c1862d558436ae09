"""The port's document parser and parse CLI against the JAX package's, on
the CPU in f32.

The host helpers are verbatim copies and must give equal results. The
parser runs the tiny Qwen model on the same weights in both packages (JAX
tree → port through the bridge); tokens and HTML must be equal, and the two
CLIs, reading the same exported ``.npz``, must write byte-identical
artifacts."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox
from PIL import Image

import jax.numpy as jnp

from multimodal_embeddings_tpu.analysis import doc_parser as jd
from multimodal_embeddings_tpu.cli import parse as jcli
from multimodal_embeddings_tpu.models import qwen_vl as jq
from multimodal_embeddings_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.analysis import doc_parser as td
from multimodal_embeddings_tpu_torch.cli import parse as tcli
from multimodal_embeddings_tpu_torch.models import qwen_vl as tq
from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
from multimodal_embeddings_tpu_torch.models.weights import build_qwen

torch.set_num_threads(2)

HTML = (
    '<html><body><h1 data-bbox="10 20 110 40" style="color:red;font-size:3px">Title</h1>'
    '<ol data-bbox="0 0 5 5"><li data-bbox="1 2 3 4">one <b>bold</b></li></ol>'
    "<p data-bbox='5 6 7' style='color: blue;'>bad box</p>"
    '<p data-bbox="x 1 2 3">not ints</p><p data-bbox="+1 02 3_0 4">signs</p>'
    '<div data-polygon="1 2 3 4" style="margin:0">open <span data-bbox="9 9 19 19">'
    "nested</span>"
)


def test_constants_and_prompts_equal():
    assert td.IMAGE_MEAN == jd.IMAGE_MEAN and td.IMAGE_STD == jd.IMAGE_STD
    assert td.SYSTEM_PROMPT == jd.SYSTEM_PROMPT and td.USER_PROMPT == jd.USER_PROMPT


@pytest.mark.parametrize("html", [HTML, "", "<p>no boxes</p>", '<p data-bbox="1 2 3 4">a'])
def test_html_helpers_equal(html):
    got = td.extract_bbox_elements(html)
    want = jd.extract_bbox_elements(html)
    assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    assert td.clean_and_format_html(html) == jd.clean_and_format_html(html)


@pytest.mark.parametrize("w,h", [(300, 200), (1700, 2200), (40, 5000), (28, 28), (9000, 60)])
def test_sizing_helpers_equal(w, h):
    assert td.round_to_patch_grid(w, h) == jd.round_to_patch_grid(w, h)
    with pytest.raises(ValueError, match="aspect"):
        td.smart_resize(20, 5000)
    for max_pixels in (1280 * 28 * 28, 4 * 28 * 28):
        assert td.smart_resize(h, w, max_pixels=max_pixels) == jd.smart_resize(
            h, w, max_pixels=max_pixels)
    assert td.smart_resize(2200, 1700) == (1120, 868)


def test_preprocess_and_draw_equal(tmp_path):
    arr = np.random.default_rng(0).integers(0, 256, size=(90, 120, 3), dtype=np.uint8)
    image = Image.fromarray(arr)
    np.testing.assert_array_equal(td.preprocess_page(image, 56, 84),
                                  jd.preprocess_page(image, 56, 84))
    path = str(tmp_path / "page.png")
    image.save(path)
    a = td.draw_bbox(path, 56, 84, HTML, str(tmp_path / "a.png"))
    b = jd.draw_bbox(path, 56, 84, HTML, str(tmp_path / "b.png"))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert open(tmp_path / "a.png", "rb").read() == open(tmp_path / "b.png", "rb").read()


def test_decode_tokens_equal():
    tokens = np.asarray([4 + ord("<"), 4 + ord("p"), 4 + ord(">"), 9000, 1, 4 + 0xC3, 4 + 0xA9,
                         2, 4 + ord("x")])
    jp = jd.DocumentParser(None, None, JByteTokenizer())
    tp = td.DocumentParser(None, ByteTokenizer(), device="cpu")
    assert tp.decode_tokens(tokens) == jp.decode_tokens(tokens) == "<p>é"


def _weights(seed=0):
    """A tiny JAX tree with decisive logits (random norm scales, biases)."""
    model = jq.QwenVLModel(jq.QwenVLConfig.tiny())
    flat = flatten_params(unbox(model.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32),
                                           jnp.zeros((1, 56, 56, 3)))))
    rng = np.random.default_rng(seed)
    for key, val in flat.items():
        scale = 0.5 if key.endswith(("/scale", "/bias")) else 0.1
        flat[key] = (np.asarray(val) + rng.normal(scale=scale, size=val.shape)).astype(np.float32)
    return model, flat


def _pages(folder, sizes, seed=3):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, (w, h) in enumerate(sizes):
        path = os.path.join(folder, f"doc{i}.png")
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("dynamic", [False, True])
def test_parse_and_parse_batch_equal_jax(tmp_path, dynamic):
    """Tokens and HTML equal to the JAX parser, per page and batched, fixed
    square or native resolution (two grid buckets)."""
    jmodel, flat = _weights()
    variables = {"params": unflatten_params({k[len("params/"):]: v for k, v in flat.items()})}
    port = build_qwen(tq.QwenVLConfig.tiny(), torch.float32, "cpu", params=flat)
    kw = dict(image_size=56, dynamic_resolution=dynamic, max_pixels=6 * 28 * 28)
    jparser = jd.DocumentParser(jmodel, variables, JByteTokenizer(), **kw)
    tparser = td.DocumentParser(port, ByteTokenizer(), device="cpu", **kw)
    paths = _pages(str(tmp_path), [(120, 90), (60, 150), (120, 90)])
    want = [jparser.parse(p, max_new_tokens=8) for p in paths]
    got = [tparser.parse(p, max_new_tokens=8) for p in paths]
    assert got == want and any(html for html, _, _ in want)
    assert tparser.parse_batch(paths, max_new_tokens=8) == jparser.parse_batch(
        paths, max_new_tokens=8) == want
    size = tparser._input_size(Image.open(paths[1]))
    assert size == jparser._input_size(Image.open(paths[1]))
    ids = tparser._prompt_ids(*size, max_new_tokens=8)
    np.testing.assert_array_equal(ids, jparser._prompt_ids(*size, max_new_tokens=8))
    # the decoded tokens themselves, before the byte decode drops specials
    ids, arr = ids, td.preprocess_page(Image.open(paths[1]).convert("RGB"), *size)
    np.testing.assert_array_equal(
        tq.greedy_generate(port, ids, arr, 8), jq.greedy_generate(jmodel, variables, ids, arr, 8))


def test_parser_options_not_ported_raise():
    """The mesh options are ported; JAX's checks of them raise as in JAX."""
    for kwargs in (dict(pp_stages=2), dict(pp_mesh=object())):
        with pytest.raises(ValueError, match="pp_mesh and pp_stages must be set together"):
            td.DocumentParser(None, ByteTokenizer(), device="cpu", **kwargs)
    with pytest.raises(ValueError, match="dp_mesh and pp_mesh are mutually exclusive"):
        td.DocumentParser(None, ByteTokenizer(), pp_stages=2, pp_mesh=object(),
                          dp_mesh=object(), device="cpu")
    # continuous batching is ported (tests/test_torch_qwen_serve.py): an
    # empty queue gives no results
    assert td.DocumentParser(None, ByteTokenizer(), device="cpu").parse_continuous([]) == []


@pytest.mark.parametrize("extra", [[], ["--batch_size", "2", "--dynamic_resolution",
                                        "--max_pixels", "6272"]])
def test_cli_artifacts_equal_jax_cli(tmp_path, monkeypatch, extra):
    """Both CLIs on the same exported .npz write byte-identical
    ``.qwen.html``, ``.clean.html`` and ``parse_index.json``.

    The JAX CLI's ``--weights`` builds its shape target with
    ``jax.eval_shape`` and ``load_checkpoint`` flattens that target with
    ``np.asarray``, which turns every abstract leaf into a 0-d object array,
    so an ``.npz`` never matches; the test hands it a concrete init
    instead."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax, "eval_shape", lambda fn, *args: fn(*args))
    _, flat = _weights(1)
    np.savez("tiny.npz", **flat)
    _pages("pages", [(120, 90), (90, 120), (140, 100)], seed=5)
    base = ["--input_folder", "pages", "--size", "tiny", "--weights", "tiny.npz",
            "--max_new_tokens", "8", *extra]
    assert jcli.main([*base, "--output_folder", "out_jax"]) == 0
    assert tcli.main([*base, "--output_folder", "out_port", "--device", "cpu",
                      "--draw_bbox"]) == 0
    names = sorted(os.listdir("out_jax"))
    assert names == sorted(n for n in os.listdir("out_port") if not n.endswith(".jpg"))
    assert len(names) == 7
    for name in names:
        assert open(f"out_port/{name}", "rb").read() == open(f"out_jax/{name}", "rb").read(), name
    index = json.load(open("out_port/parse_index.json"))
    assert [e["html"] for e in index] == ["doc0.qwen.html", "doc1.qwen.html", "doc2.qwen.html"]
    assert os.path.exists("out_port/doc0_bbox.jpg")


# JAX's refusals of the parse meshes (cli/parse.py:178-225, :247-252), with
# its words, before any rank is spawned
PARSE_REFUSALS = [
    (["--pipeline_parallel", "2", "--data_parallel", "2"],
     "--data_parallel and --pipeline_parallel are mutually exclusive (dp replicates the "
     "weight tree; pp exists because it does not fit)"),
    (["--pipeline_parallel", "3"],
     "--pipeline_parallel 3 must divide the 2-layer decoder evenly"),
    (["--continuous", "--data_parallel", "2"],
     "--continuous schedules one device's rows; compose scale-out by sharding the page "
     "list across chips instead"),
    (["--data_parallel", "4096"], f"--data_parallel 4096: only {os.cpu_count()} devices visible"),
]


def test_cli_refuses_what_is_not_ported(tmp_path):
    """The flags are ported; what JAX refuses is refused, in its words."""
    for flags, words in PARSE_REFUSALS:
        with pytest.raises(SystemExit) as err:
            tcli.main(["--input_folder", str(tmp_path), "--size", "tiny", "--device", "cpu",
                       *flags])
        assert str(err.value) == words


def test_cli_refusals_are_jax_words(tmp_path, monkeypatch):
    """JAX's CLI on the same flags (its model built first, as it does)
    refuses with the same words; the 8 virtual devices stand for the
    cores."""
    monkeypatch.chdir(tmp_path)
    _pages("pages", [(60, 60)])
    monkeypatch.setattr(tcli, "visible_devices", lambda device: 8)
    for flags, words in PARSE_REFUSALS[:3]:
        argv = ["--input_folder", "pages", "--size", "tiny", *flags]
        with pytest.raises(SystemExit) as jerr:
            jcli.main(argv)
        with pytest.raises(SystemExit) as terr:
            tcli.main(argv + ["--device", "cpu"])
        assert str(terr.value) == str(jerr.value) == words


# -- --data_parallel 2 and --pipeline_parallel 2 over gloo ranks --------------
#
# JAX's tests/test_qwen_vl.py:719 and :743: each a ``main`` call that spawns
# its 2 ranks, on 3 pages; the output tree byte-identical to the port's
# single-device run and to JAX's CLI on the same .npz.


@pytest.fixture(scope="module")
def parse_scaleout(tmp_path_factory):
    root = tmp_path_factory.mktemp("parse_scaleout")
    _, flat = _weights(1)
    np.savez(str(root / "tiny.npz"), **flat)
    _pages(str(root / "pages"), [(120, 90), (90, 120), (140, 100)], seed=5)
    base = ["--input_folder", str(root / "pages"), "--size", "tiny", "--weights",
            str(root / "tiny.npz"), "--max_new_tokens", "8"]
    runs = {"single": ["--batch_size", "2"], "dp2": ["--data_parallel", "2"],
            "pp2": ["--pipeline_parallel", "2"]}
    for name, flags in runs.items():
        assert tcli.main([*base, *flags, "--output_folder", str(root / name), "--device",
                          "cpu", "--draw_bbox"]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "eval_shape", lambda fn, *args: fn(*args))
        assert jcli.main([*base, "--batch_size", "2", "--output_folder",
                          str(root / "jax")]) == 0
    return root


@pytest.mark.parametrize("run", ["dp2", "pp2"])
def test_scaleout_cli_outputs_byte_identical(parse_scaleout, run):
    root = parse_scaleout
    names = sorted(os.listdir(root / "single"))
    assert names == sorted(os.listdir(root / run)) and len(names) == 10
    for name in names:
        assert (root / run / name).read_bytes() == (root / "single" / name).read_bytes(), name
    for name in os.listdir(root / "jax"):
        assert (root / run / name).read_bytes() == (root / "jax" / name).read_bytes(), name


def test_cli_synthetic_weights_run(tmp_path, monkeypatch):
    """Without --weights the model runs seeded synthetic weights (int8 too)."""
    monkeypatch.chdir(tmp_path)
    _pages("pages", [(100, 80)])
    for size in ("tiny", "tiny-int8"):
        out = f"out_{size}"
        assert tcli.main(["--input_folder", "pages", "--output_folder", out, "--size", size,
                          "--device", "cpu", "--max_new_tokens", "4"]) == 0
        assert os.path.exists(f"{out}/doc0.qwen.html")
    assert tcli.make_config("32b-int4") == tq.QwenVLConfig.qwen25_vl_32b_int4()
    assert tcli.get_image_paths("pages") == ["pages/doc0.png"]


@pytest.mark.parametrize("entry", ["parser", "cli"])
def test_parse_defaults_to_the_card(entry, tmp_path):
    """Built without a device, the parser and the CLI go to CUDA; where
    there is none they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "parser":
            td.DocumentParser(None, ByteTokenizer())
        else:
            _pages(str(tmp_path), [(60, 60)])
            tcli.main(["--input_folder", str(tmp_path), "--size", "tiny",
                       "--output_folder", str(tmp_path / "out")])
