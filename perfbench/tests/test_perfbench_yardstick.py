"""The yardstick's arithmetic at known shapes: the union of intervals and
the idle gaps, K1's and K3's bounds against the kernel table's, and the
operation counts."""

import pytest
import torch

from benchlib.roofline import attention_work, bound_s, idle_gaps, int4_matmul_work, union_seconds


def test_union_counts_overlap_once():
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert union_seconds([(0, 10), (2, 3)]) == 10
    assert union_seconds([]) == 0


def test_idle_gaps_longest_first():
    gaps = idle_gaps([(1, 2), (2.5, 3), (6, 7)], 0, 8)
    assert gaps[0] == (3, 6) and set(gaps) == {(0, 1), (2, 2.5), (3, 6), (7, 8)}


@pytest.mark.parametrize("shape,ms", [
    ((48, 12, 784, 784, 64, 64), 0.0916),  # the ViT tower's layer
    ((30, 4, 1024, 1024, 36, 72), 0.0275),  # the detector's PSA block
])
def test_k1_bounds_match_the_kernel_table(shape, ms):
    assert bound_s(*attention_work(*shape)) * 1e3 == pytest.approx(ms, rel=0.01)


@pytest.mark.parametrize("m,k,n,ms", [
    (1, 5120, 27648, 0.0225),  # decode gate, up: bytes bound it
    (1535, 5120, 27648, 0.4394),  # prefill gate, up: operations bound it
])
def test_k3_bounds_match_the_kernel_table(m, k, n, ms):
    assert bound_s(*int4_matmul_work(m, k, n)) * 1e3 == pytest.approx(ms, rel=0.02)


def test_flop_count_of_a_product():
    from benchlib.common import count_flops

    a, b = torch.empty(8, 16, device="meta"), torch.empty(16, 4, device="meta")
    assert count_flops(torch.matmul, a, b) == 2 * 8 * 16 * 4


def test_parse_flops_from_the_published_widths():
    from drivers.parse import k3_bound_s, prefill_flops, step_flops
    from benchlib.cells import load_cell

    cfg = load_cell("qwen25vl_32b_int4.parse_short").config
    # 487.6e6 projection weights a layer and a 778.6e6 lm_head, 2 operations each
    assert step_flops(cfg, 1, 0) == pytest.approx(2 * 64 * 487.6e6 + 2 * 778.6e6, rel=0.01)
    assert 90e12 < prefill_flops(cfg, 1535, (40, 31)) < 130e12
    # K3's decode step at M = 1 (the kernel table: 5.08 ms)
    assert k3_bound_s(cfg, 1, 1) * 1e3 == pytest.approx(5.08, rel=0.03)


def test_page_flops_at_the_configuration():
    from drivers.page import Session
    from benchlib.cells import load_cell

    cell = load_cell("vitb16_doclayout_m.stream")
    work = Session(cell, 0, "cpu").page_flops()
    assert work["views"] == 30
    assert 9e12 < work["flops_per_page"] < 16e12
    assert work["k1_bound_s_per_page"] * 1e3 == pytest.approx(12 * 0.0916 + 0.0275, rel=0.02)
