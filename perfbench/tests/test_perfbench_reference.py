"""The frozen reference against itself at tiny sizes: its pieces agree
with plainer forms of the same arithmetic, and the float8 control changes
what it computes."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reference import page_ref, qwen_ref


def test_attention_is_softmax_attention():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 20, 3, 8, generator=g) for _ in range(3))
    want = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(page_ref.attention(q, k, v), want, atol=1e-5, rtol=1e-5)


def test_gqa_causal_attention():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 9, 4, 8, generator=g)
    k, v = torch.randn(1, 9, 2, 8, generator=g), torch.randn(1, 9, 2, 8, generator=g)
    want = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.repeat_interleave(2, 2).transpose(1, 2),
        v.repeat_interleave(2, 2).transpose(1, 2), is_causal=True).transpose(1, 2)
    torch.testing.assert_close(qwen_ref.attend(q, k, v, causal=True), want, atol=1e-5, rtol=1e-5)


def test_windows_round_trip():
    x = torch.randn(1, 5 * 7, 2, 4)
    w, mask = qwen_ref.windows(x, 5, 7, 4)
    assert w.shape == (4, 16, 2, 4) and int(mask.sum()) == 35
    torch.testing.assert_close(qwen_ref.unwindow(w, 5, 7, 4), x)


def test_int4_dequant_is_symmetric_groups():
    w = torch.randn(256, 3)
    d = qwen_ref.int4_dequant(w)
    for grp in range(2):
        blk, got = w[grp * 128:(grp + 1) * 128], d[grp * 128:(grp + 1) * 128]
        scale = blk.abs().amax(0) / 7
        q = got / scale
        torch.testing.assert_close(q, q.round())
        assert float((got - blk).abs().max()) <= float(scale.max()) / 2 + 1e-6


def test_letterbox_of_a_flat_page_is_flat_and_gray():
    page = torch.full((40, 30, 3), 200, dtype=torch.uint8)
    views, affine = page_ref.letterbox_views(page, [(0, 0, 30, 40)], 16)
    assert views.shape == (1, 16, 16, 3)
    s, ox, oy = affine[0]
    left = int(round(-ox / s))
    assert torch.all(views[0, :, left:left + 12] == 200) and torch.all(views[0, :, 0] == 114)


def test_crop_of_the_whole_page_is_a_resize():
    page = torch.arange(16 * 16 * 3, dtype=torch.float32).reshape(16, 16, 3)
    crops = page_ref.crop_resize(page, torch.tensor([[0.0, 0.0, 16.0, 16.0]]), 16)
    torch.testing.assert_close(crops[0], page)


def test_greedy_nms_keeps_the_best_of_overlapping_boxes():
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 10, 10], [20, 20, 30, 30.0]])
    keep = page_ref.greedy_nms(boxes, torch.tensor([0.5, 0.9, 0.1]), torch.zeros(3), 0.5, False)
    assert keep.tolist() == [1, 2]


def test_mrope_positions_of_one_image_span():
    ids = torch.tensor([[7, 7, 5, 5, 5, 5, 5, 5, 8]])
    pos = qwen_ref.mrope_positions(ids, 5, 2, 3)
    assert pos[:, 0].tolist() == [[0, 1, 2, 2, 2, 2, 2, 2, 5],
                                  [0, 1, 2, 2, 2, 3, 3, 3, 5],
                                  [0, 1, 2, 3, 4, 2, 3, 4, 5]]


@pytest.mark.parametrize("mode", ["float32", "fp8"])
def test_the_precision_switch(mode):
    x = torch.linspace(-3, 3, 101)
    page_ref.set_precision(mode)
    try:
        y = page_ref.rq(x)
    finally:
        page_ref.set_precision("float32")
    changed = bool((y != x).any())
    assert changed == (mode == "fp8")
    assert float((y - x).abs().max()) <= 3 * 2.0**-4


def test_prompt_shape():
    ids = qwen_ref.prompt_ids(1240, 151655)
    assert ids.shape == (1, 1535) and int((ids == 151655).sum()) == 1240
    assert qwen_ref.smart_resize(2200, 1700) == (1120, 868)


def test_page_input_normalises():
    page = np.full((56, 56, 3), 255, np.uint8)
    x = qwen_ref.page_input(page, 28, 28)
    want = (1 - np.asarray(qwen_ref.IMAGE_MEAN)) / np.asarray(qwen_ref.IMAGE_STD)
    np.testing.assert_allclose(x[0, 3, 3], want, rtol=1e-6)
