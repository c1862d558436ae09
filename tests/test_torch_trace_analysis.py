"""``utils/trace_analysis.py``: kernel attribution from ``torch.profiler``
Chrome traces.

A synthetic trace with every category's kernel names (the port's K1-K8
symbols from ``csrc/*.cu``, cuDNN, cuBLAS/CUTLASS, memset, sort, reduce,
elementwise, other), host events and a memcpy that must be left out gives
the stated totals (µs), counts and categories; a folder resolves to its last
trace; a real CPU trace written by ``utils/profiling.py::trace`` parses (no
device kernels on the CPU) and the report prints.
"""

import json
import re

import pytest
import torch

from multimodal_embeddings_tpu_torch.utils import profiling, trace_analysis as tra

# (kernel name, category, duration µs, launches)
KERNELS = [
    ("void enc_attn_tc_kernel<4, 4>(TcArgs)", "K1 enc_attn", 40.0, 12),
    ("void int8_mm_wgmma_kernel<256>(Params)", "K2 int8_mm", 25.5, 3),
    ("void int4_gemv_kernel<1, __nv_bfloat16>(GemvArgs, __nv_bfloat16*)", "K3 int4", 7.25, 4),
    ("int4_mm_wgmma_kernel", "K3 int4", 2.0, 1),
    ("void flash_wgmma_kernel<80>(Params)", "K4 flash", 30.0, 2),
    ("conv3x3_bf16_kernel<2>", "K5 conv3x3", 11.0, 12),
    ("ln_mm_wgmma_kernel", "K6 ln_mm", 9.0, 24),
    ("void ln_stats_kernel<__nv_bfloat16>(LnArgs)", "K7 ln_stats", 1.5, 1),
    ("sr_quantize_vec_kernel", "K8 sr_quantize", 3.0, 1),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv (cuDNN)", 50.0, 6),
    ("cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8>",
     "GEMM (cuBLAS)", 20.0, 5),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopB_TNT", "GEMM (cuBLAS)", 10.0, 2),
    ("void at::native::(anonymous namespace)::memset_kernel", "memcpy/memset", 0.5, 1),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>", "sort", 4.0, 2),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>(...)", "reduce", 6.0, 3),
    ("void at::native::vectorized_elementwise_kernel<4, SiluFunctor>(...)", "elementwise", 8.0, 10),
    ("void some_unknown_kernel()", "other", 1.25, 1),
]


def _synthetic_trace(path):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 999},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
               "ts": 1, "dur": 500},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 3}]
    for name, _, dur, n in KERNELS:
        for i in range(n):
            events.append({"ph": "X", "cat": "kernel", "name": name, "ts": 10 + i,
                           "dur": dur / n, "args": {"stream": 7}})
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


@pytest.fixture
def trace_file(tmp_path):
    path = str(tmp_path / "trace_a.json")
    _synthetic_trace(path)
    return path


def test_kernels_categories_totals_and_counts(trace_file):
    stats = tra.aggregate_kernels(trace_file)
    by_name = {s.name: s for s in stats}
    assert set(by_name) == {name for name, *_ in KERNELS}
    for name, category, dur, n in KERNELS:
        assert by_name[name].category == category == tra.category_of(name)
        assert by_name[name].count == n
        assert by_name[name].total_us == pytest.approx(dur, rel=1e-12)
    assert [s.total_us for s in stats] == sorted((s.total_us for s in stats), reverse=True)
    summary = tra.category_summary(stats)
    want = {}
    for _, category, dur, _ in KERNELS:
        want[category] = want.get(category, 0.0) + dur
    assert summary.keys() == want.keys()
    for category, total in want.items():
        assert summary[category] == pytest.approx(total, rel=1e-12)
    assert list(summary) == sorted(summary, key=lambda c: -summary[c])
    total = sum(dur for _, _, dur, _ in KERNELS)  # the memcpy and host events left out
    assert sum(summary.values()) == pytest.approx(total, rel=1e-12)
    assert sum(s.count for s in stats) == sum(n for *_, n in KERNELS)


def test_folder_resolves_to_its_last_trace(trace_file, tmp_path):
    later = str(tmp_path / "trace_b.json")
    with open(later, "w") as f:
        json.dump({"traceEvents": [{"cat": "kernel", "name": "ln_stats_kernel", "dur": 2.0}]}, f)
    stats = tra.aggregate_kernels(str(tmp_path))
    assert [(s.name, s.category, s.total_us, s.count) for s in stats] == [
        ("ln_stats_kernel", "K7 ln_stats", 2.0, 1)]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tra.aggregate_kernels(str(tmp_path / "empty"))


def test_report_prints(trace_file, capsys):
    tra.print_report(trace_file, top=3)
    out = capsys.readouterr().out
    total = sum(dur for _, _, dur, _ in KERNELS)
    launches = sum(n for *_, n in KERNELS)
    assert f"device kernel time: {total / 1e3:.2f} ms over {launches} launches" in out
    assert re.search(r"conv \(cuDNN\)\s+0\.05 ms", out)
    assert len(re.findall(r"^\s+[\d.]+ ms\s+x\d+", out, re.M)) == 3
    tra.print_report(trace_file, category="K3")
    out = capsys.readouterr().out
    assert "int4_gemv_kernel" in out and "enc_attn" not in out.split("category 'K3'")[1]


def test_real_cpu_trace_parses(tmp_path, capsys):
    """``profiling.trace`` writes a Chrome trace on the CPU; it holds host
    events and no device kernels, and the report says so."""
    with profiling.trace(str(tmp_path)) as t:
        x = torch.ones(64, 64)
        (x @ x).sum()
    stats = tra.aggregate_kernels(t.path)
    assert stats == [] and tra.category_summary(stats) == {}
    assert tra.aggregate_kernels(str(tmp_path)) == []  # the folder form
    tra.print_report(str(tmp_path))
    assert "device kernel time: 0.00 ms over 0 launches" in capsys.readouterr().out
