"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc; on other hosts they skip. They
import no JAX, so the card machine runs them without the repo's JAX
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Shapes here are deliberately ragged (T not a multiple of the 8-row
query tile, S not a multiple of the 64-key step, block_len 8, two query
rows per KV head) — the serving shapes are covered by chip_smoke.py.
Tolerance: atol 1e-4 for f32 and bf16 caches alike (both sides read the
same rounded values and accumulate in f32)."""

import pytest
import torch

from dnn_tpu_torch.ops.cuda import cached_attention as tca

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64])
def test_cached_attention_kernel(dev, dtype, d):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 3, 40, d, generator=g, device=dev)
    k = torch.randn(2, 3, 200, d, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 3, 200, d, generator=g, device=dev).to(dtype)
    for base in ([0, 160], [7, 100], [199, 0]):
        pos = torch.tensor(base, dtype=torch.int32, device=dev)
        before = tca.cached_attention.launches
        got = tca.cached_attention(q, k, v, pos)
        want = tca.reference_cached_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert tca.cached_attention.launches == before + 1
        assert (got - want).abs().max().item() <= ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_decode_kernel(dev, dtype, d):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(3, 2, 2, d, generator=g, device=dev)
    kp = torch.randn(40, 2, 8, d, generator=g, device=dev).to(dtype)
    vp = torch.randn(40, 2, 8, d, generator=g, device=dev).to(dtype)
    perm = torch.randperm(39, generator=torch.Generator().manual_seed(2)) + 1
    tables = perm[:36].reshape(3, 12).to(torch.int32).to(dev)
    pos = torch.tensor([0, 57, 95], dtype=torch.int32, device=dev)
    before = tca.paged_decode_attention.launches
    got = tca.paged_decode_attention(q, kp, vp, tables, pos)
    want = tca.reference_paged_decode_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    assert tca.paged_decode_attention.launches == before + 1
    assert (got - want).abs().max().item() <= ATOL


def test_kernels_refuse_what_they_do_not_take(dev):
    """A non-contiguous or unsupported-dim CUDA tensor raises; it never
    falls back to the plain version."""
    q = torch.randn(1, 2, 8, 64, device=dev).transpose(2, 3).contiguous()
    k = torch.randn(1, 2, 64, 64, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tca.cached_attention(q.transpose(2, 3), k, k, pos)
    q16 = torch.randn(1, 2, 8, 16, device=dev)
    k16 = torch.randn(1, 2, 64, 16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tca.cached_attention(q16, k16, k16, pos)
