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


def test_both_decode_sources_include_the_split_header():
    """K6 and K7 are one body (csrc/decode_split.cuh, which takes its
    cp.async helpers from the tensor-core header): both libraries rebuild
    when either header changes."""
    for src in ("decode_attention.cu", "paged_decode.cu"):
        assert _build._inputs(src) == [src, "decode_split.cuh",
                                       "hopper_tc.cuh"]


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
    # the f32 backward on the tensor cores, as nvcc names them (an
    # anonymous namespace that carries the file's name and a hash)
    ("_ZN50_GLOBAL__N__eef1f944_17_flash_backward_cu_80fae4692tc26flash_bwd_"
     "dq_f32_tc_kernelILi64EEEvPKfS3_S3_S3_S3_S3_Pfiiif",
     "flash_bwd_dq_f32_tc_kernel<64>"),
    ("_ZN50_GLOBAL__N__eef1f944_17_flash_backward_cu_80fae4692tc27flash_bwd_"
     "dkv_f32_tc_kernelILi128EEEvPKfS3_S3_S3_S3_S3_PfS4_iiif",
     "flash_bwd_dkv_f32_tc_kernel<128>"),
    ("_ZN50_GLOBAL__N__eef1f944_17_flash_backward_cu_80fae4692tc27flash_bwd_"
     "dkv_f32_tc_kernelILi32EEEvPKfS3_S3_S3_S3_S3_PfS4_iiif",
     "flash_bwd_dkv_f32_tc_kernel<32>"),
    # the f32 forward on the tensor cores
    ("_ZN51_GLOBAL__N__eef1f944_18_flash_attention_cu_80fae4692tc23flash_"
     "fwd_f32_tc_kernelILi64EEEvPKfS3_S3_PfS4_iiif",
     "flash_fwd_f32_tc_kernel<64>"),
    # the split-KV decode kernels (K6, K7; the cache type, the head dim,
    # the rows a KV head compiled for) and their merge
    ("_ZN52_GLOBAL__N__38fd6590_19_decode_attention_cu_0aaa63fc18decode_"
     "attn_kernelIfLi128ELi1EEEvPKfPKT_S5_S2_S2_PKiPfS8_iiiif",
     "decode_attn_kernel<f32, 128, 1>"),
    ("_ZN48_GLOBAL__N__78e4dd39_15_paged_decode_cu_4f57007519paged_decode_"
     "kernelI13__nv_bfloat16Li128ELi8EEEvPKfPKT_S6_S3_S3_PKiS8_PfS9_iiiiif",
     "paged_decode_kernel<bf16, 128, 8>"),
    ("_ZN48_GLOBAL__N__78e4dd39_15_paged_decode_cu_4f57007519paged_decode_"
     "kernelIaLi32ELi2EEEvPKfPKT_S5_S2_S2_PKiS7_PfS8_iiiiif",
     "paged_decode_kernel<int8, 32, 2>"),
    ("_ZN52_GLOBAL__N__38fd6590_19_decode_attention_cu_0aaa63fc3dec19decode_"
     "merge_kernelILi64EEEvPKfPKiPfiiiiii", "decode_merge_kernel<64>"),
    # a file hash whose last digits (53) also prefix a run ending in
    # "kernel": the identifier is the shortest one
    ("_ZN48_GLOBAL__N__78e4dd53_15_paged_decode_cu_4f5700753dec19decode_"
     "merge_kernelILi64EEEvPKfPKiPfiiiiii", "decode_merge_kernel<64>"),
])
def test_build_lines_name_the_kernels(mangled, label):
    assert chip_smoke.kernel_label(mangled) == label
