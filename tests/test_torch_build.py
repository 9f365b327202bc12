"""The kernel build's bookkeeping on the CPU (no nvcc, no card): a
library's name hashes its source and every csrc/ header the source
includes, so an edited header rebuilds; and chip_smoke's [build] lines
name the tensor-core kernels from their mangled names."""

import pytest

import chip_smoke
from dnn_tpu_torch.ops.cuda import _build


def test_lib_path_hashes_the_headers_a_source_includes(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setitem(_build.KERNELS, "probe", ("probe.cu", "probe", []))
    (tmp_path / "probe.cu").write_text(
        '#include <cuda_runtime.h>\n#include "probe.cuh"\nint x;\n')
    (tmp_path / "probe.cuh").write_text('#include "inner.cuh"\nint y;\n')
    (tmp_path / "inner.cuh").write_text("int z;\n")
    (tmp_path / "other.cuh").write_text("int w;\n")
    first = _build.lib_path("probe")
    assert first.name.startswith("libprobe-")
    assert _build._inputs("probe.cu") == ["probe.cu", "probe.cuh",
                                          "inner.cuh"]
    (tmp_path / "other.cuh").write_text("int w2;\n")  # not included
    assert _build.lib_path("probe") == first
    (tmp_path / "probe.cuh").write_text('#include "inner.cuh"\nint y2;\n')
    second = _build.lib_path("probe")
    assert second != first
    (tmp_path / "inner.cuh").write_text("int z2;\n")  # included by a header
    assert _build.lib_path("probe") not in (first, second)


def test_both_flash_sources_include_the_tensor_core_header():
    for src in ("flash_attention.cu", "flash_backward.cu"):
        assert _build._inputs(src) == [src, "hopper_tc.cuh"]


def test_k5_source_includes_the_tensor_core_header():
    """K5 runs on the tensor cores too: its library rebuilds when the
    shared header changes."""
    assert _build._inputs("cached_attention.cu") == ["cached_attention.cu",
                                                     "hopper_tc.cuh"]


@pytest.mark.parametrize("mangled,label", [
    ("_ZN12_GLOBAL__N_12tc22flash_bwd_dq_tc_kernelILi64EEEvPK13__nv_"
     "bfloat16S4_S4_S4_PKfS6_PS2_iiif", "flash_bwd_dq_tc_kernel<64>"),
    ("_ZN12_GLOBAL__N_12tc23flash_bwd_dkv_tc_kernelILi128EEEvPK13__nv_"
     "bfloat16S4_S4_S4_PKfS6_PS2_S7_iiif", "flash_bwd_dkv_tc_kernel<128>"),
    ("_ZN12_GLOBAL__N_12tc19flash_fwd_tc_kernelILi32EEEvPK13__nv_"
     "bfloat16S4_S4_PS2_Pfiiif", "flash_fwd_tc_kernel<32>"),
    ("_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64EEEvPKT_S4_S4_S4_PKfS6_"
     "PS2_iiif", "flash_bwd_dq_kernel<f32, 64>"),
    ("_ZN12_GLOBAL__N_12tc21cached_attn_tc_kernelI13__nv_bfloat16Li64EEEvPK"
     "fPKT_S7_S4_S4_PKiPfSA_iiiif", "cached_attn_tc_kernel<bf16, 64>"),
    ("_ZN12_GLOBAL__N_12tc21cached_attn_tc_kernelIaLi128EEEvPKfPKT_S6_S4_"
     "S4_PKiPfS9_iiiif", "cached_attn_tc_kernel<int8, 128>"),
    ("_ZN12_GLOBAL__N_12tc24cached_attn_merge_kernelILi32EEEvPKfPKiPfiiiiii",
     "cached_attn_merge_kernel<32>"),
])
def test_build_lines_name_the_kernels(mangled, label):
    assert chip_smoke.kernel_label(mangled) == label
