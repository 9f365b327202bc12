"""The port's native CRC-32C against the JAX package's: equal on every
length 0..4097, with seeds, on non-contiguous arrays and on an 8 MB
buffer, through the crc32 instruction and through the slice-by-8 tables; a checksummed Tensor written by either package is verified by
the other, and a flipped byte is refused by both; a 64 MiB verify takes
the native path (the per-byte loop would take about 16 s on this CPU);
a build that fails raises with the compiler's output."""

import ast
import pathlib
import platform
import time

import numpy as np
import pytest

from dnn_tpu import native as jnative
from dnn_tpu.comm import wirecodec as jwc
from dnn_tpu.io.serialization import PayloadCorruptError as JaxCorrupt
from dnn_tpu_torch import native
from dnn_tpu_torch.comm import wirecodec as wc

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def buf():
    assert jnative.native_available()  # the JAX reference is native too
    return np.random.default_rng(0).integers(0, 256, 8 << 20, np.uint8)


def test_every_length_up_to_4097_equals_jax(buf):
    data = buf[:4097].tobytes()
    for n in range(4098):
        assert native.crc32c(data[:n]) == jnative.crc32c(data[:n]), n
    for n in range(0, 4098, 97):  # the per-byte reference, sampled
        assert native.crc32c_plain(data[:n]) == native.crc32c(data[:n]), n


@pytest.mark.parametrize("seed", [0, 1, 0x82F63B78, 0xFFFFFFFF, 12345])
def test_seeds_and_continuation_equal_jax(buf, seed):
    a, b = buf[:1000].tobytes(), buf[1000:3001].tobytes()
    assert native.crc32c(a, seed) == jnative.crc32c(a, seed)
    assert native.crc32c(a, seed) == native.crc32c_plain(a, seed)
    assert native.crc32c(b, native.crc32c(a, seed)) == native.crc32c(
        a + b, seed)


def test_unaligned_views_and_non_contiguous_arrays(buf):
    for off in range(9):
        view = memoryview(buf)[off:off + 1001]
        assert native.crc32c(view) == jnative.crc32c(view)
    grid = np.random.default_rng(1).standard_normal((64, 48)).astype(
        np.float32)
    for arr in (grid[:, ::2], grid.T, grid[::3, 5:]):
        assert not arr.flags.c_contiguous
        assert native.crc32c(arr) == jnative.crc32c(arr) == native.crc32c(
            np.ascontiguousarray(arr).tobytes())
    assert native.crc32c(grid) == jnative.crc32c(grid.tobytes())


def test_eight_megabytes_equal_jax(buf):
    assert native.crc32c(buf) == jnative.crc32c(buf)


@pytest.mark.parametrize("seed", [0, 0x82F63B78, 0xFFFFFFFF])
def test_the_table_route_equals_jax_and_the_instruction(buf, seed):
    """crc32c takes the crc32 instruction on an x86-64 CPU with SSE4.2;
    its slice-by-8 route (every other CPU) gives the same checksums, at
    every length 0..4097, every start alignment and on 8 MB."""
    if platform.machine() == "x86_64":
        assert native.hardware()
    data = buf[:4097].tobytes()
    for n in range(4098):
        want = jnative.crc32c(data[:n], seed)
        assert native.crc32c_sliced(data[:n], seed) == want, n
        assert native.crc32c(data[:n], seed) == want, n
    for off in range(9):
        view = memoryview(buf)[off:off + 70001]
        assert native.crc32c_sliced(view, seed) == native.crc32c(
            view, seed) == jnative.crc32c(view, seed)
    assert native.crc32c_sliced(buf, seed) == jnative.crc32c(buf, seed)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checksummed_tensors_cross_packages(writer):
    """A Tensor checksummed by one package decodes in the other; a flipped
    byte is refused by both."""
    x = np.random.default_rng(2).standard_normal((256, 1024)).astype(
        np.float32)
    if writer == "jax":
        raw = jwc.serialize_request(jwc.TensorRequest("r", jwc.make_tensor(x)))
    else:
        raw = wc.serialize_request(wc.TensorRequest("r", wc.make_tensor(x)))
    mine, theirs = wc.parse_request(raw), jwc.parse_request(raw)
    assert mine.tensor.crc32c == theirs.tensor.crc32c == native.crc32c(x)
    np.testing.assert_array_equal(wc.tensor_view(mine.tensor), x)
    np.testing.assert_array_equal(jwc.tensor_view(theirs.tensor), x)
    bad = bytearray(raw)
    bad[len(bad) // 2] ^= 0x10  # inside the payload
    with pytest.raises(wc.PayloadCorruptError, match="corrupt"):
        wc.tensor_view(wc.parse_request(bytes(bad)).tensor)
    with pytest.raises(JaxCorrupt):
        jwc.tensor_view(jwc.parse_request(bytes(bad)).tensor)


def test_64_mib_verify_is_native():
    x = np.random.default_rng(3).integers(0, 256, 64 << 20, np.uint8)
    msg = wc.parse_request(wc.serialize_request(
        wc.TensorRequest("r", wc.make_tensor(x)))).tensor
    t0 = time.perf_counter()
    view = wc.tensor_view(msg)
    assert time.perf_counter() - t0 < 5.0
    assert view.shape == x.shape and msg.crc32c == jnative.crc32c(x)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "crc32c.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed") as e:
        native.crc32c(b"abc")
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_is_keyed_on_its_source(tmp_path, monkeypatch):
    """An edited source names a new library, so it rebuilds."""
    before = native.lib_path()
    src = tmp_path / "crc32c.cpp"
    src.write_text(native.SRC.read_text() + "// edited\n")
    monkeypatch.setattr(native, "SRC", src)
    assert native.lib_path() != before
    assert before.name.startswith("libcrc32c-")


def test_no_port_module_checksums_with_the_per_byte_loop():
    """crc32c_plain is the tests' reference: no module of the port
    outside dnn_tpu_torch/native names it."""
    for path in (ROOT / "dnn_tpu_torch").rglob("*.py"):
        if path.parent.name == "native":
            continue
        names = {n.id for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, ast.Name)}
        names |= {n.attr for n in ast.walk(ast.parse(path.read_text()))
                  if isinstance(n, ast.Attribute)}
        assert "crc32c_plain" not in names, path
