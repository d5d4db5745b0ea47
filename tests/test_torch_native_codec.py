"""mxx_tpu_torch's host codec and writer (C++ built with g++ at first use)
against mxx_tpu's and the plain numpy versions: packed bytes equal at 17, 28
and 32 bits, the writer's files and error count, storage splitting through
the native writer, and `PolyMatrix` packed bytes equal across the packages,
each loading the other's."""

import numpy as np
import pytest

import mxx_tpu  # noqa: F401
import jax.numpy as jnp

from mxx_tpu.matrix import PolyMatrix as JaxPolyMatrix
from mxx_tpu.native import pack_u32 as jax_pack_u32
from mxx_tpu.native import unpack_u32 as jax_unpack_u32
from mxx_tpu.ring.params import RingParams as JaxRingParams

from mxx_tpu_torch import convert
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.native import codec, writer
from mxx_tpu_torch.ops import cuda_build
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.storage import BatchLookupBuffer, StorageSystem


@pytest.mark.parametrize("bits", [17, 28, 32])
def test_pack_equals_jax_and_plain(bits):
    rng = np.random.default_rng(bits)
    vals = rng.integers(0, 1 << bits, size=1001, dtype=np.uint64).astype(np.uint32)
    raw = codec.pack_u32(vals, bits)
    assert len(raw) == codec.packed_size(1001, bits)
    assert raw == jax_pack_u32(vals, bits)
    assert raw == codec.pack_u32_plain(vals, bits)
    for back in (codec.unpack_u32(raw, 1001, bits), codec.unpack_u32_plain(raw, 1001, bits),
                 jax_unpack_u32(raw, 1001, bits)):
        np.testing.assert_array_equal(back, vals)


def test_unpack_rejects_short_input():
    with pytest.raises(ValueError, match="fewer"):
        codec.unpack_u32(b"\x00" * 3, 2, 17)


def test_writer_writes_parts_in_order(tmp_path):
    base_errors = writer.write_errors()
    want = {}
    for i in range(32):
        parts = [bytes([i]) * 7, bytearray(b"mid"), np.arange(i, dtype=np.uint8), b""]
        want[i] = b"".join(bytes(p) for p in parts)
        writer.submit_write(tmp_path / f"f{i}.bin", parts)
    writer.wait_all_writes()
    assert writer.write_errors() == base_errors
    for i in range(32):
        assert (tmp_path / f"f{i}.bin").read_bytes() == want[i]
    assert not list(tmp_path.glob("*.tmp"))
    assert writer.held_files() == 0


def test_writer_releases_each_file_once_written(tmp_path):
    """A written file's buffers go at the next submit, with no barrier from
    the Python side in between; the unwritten file's stay held."""
    writer.wait_all_writes()
    writer.submit_write(tmp_path / "a.bin", [b"a" * 1000])
    writer._lib().mxx_writer_wait_all()  # the C++ barrier alone releases nothing
    assert writer.held_files() == 1
    writer.submit_write(tmp_path / "b.bin", [b"b" * 1000])
    assert writer.held_files() == 1  # b.bin
    writer.wait_all_writes()
    assert writer.held_files() == 0
    assert (tmp_path / "a.bin").read_bytes() == b"a" * 1000
    assert (tmp_path / "b.bin").read_bytes() == b"b" * 1000


def test_storage_buffer_splitting(tmp_path, monkeypatch):
    monkeypatch.setenv("LUT_BYTES_LIMIT", "100")
    sys_ = StorageSystem(tmp_path)
    payloads = [(i, bytes([i]) * 60) for i in range(5)]  # 300 B > 100 B limit
    sys_.add_buffer(BatchLookupBuffer("split_test", payloads))
    sys_.wait_for_all_writes()
    assert sys_._index["split_test"]["parts"] >= 3
    for i in range(5):
        assert sys_.read_bytes("split_test", i) == bytes([i]) * 60


def test_storage_reports_a_failed_write(tmp_path):
    sys_ = StorageSystem(tmp_path / "store")
    (tmp_path / "store").rename(tmp_path / "gone")  # the batch file cannot be opened
    sys_.add_buffer(BatchLookupBuffer("lost", [(0, b"x" * 10)]))
    with pytest.raises(IOError, match="failed 1 writes"):
        sys_.wait_for_all_writes()


@pytest.mark.parametrize("broken", ["source", "compiler"])
def test_a_failed_build_raises(tmp_path, monkeypatch, broken):
    (tmp_path / "host").mkdir()
    (tmp_path / "host" / "bad.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    if broken == "compiler":
        monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        cuda_build.load("host/bad.cpp")
    assert not list(tmp_path.rglob("*.so"))  # nothing half-built is left to load


@pytest.mark.parametrize("args", [(16, 2, 17, 1), (16, 3, 28, 14)])
def test_packed_bytes_equal_and_cross_load(args):
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    rng = np.random.default_rng(5)
    arr = np.empty((p.crt_depth, 3, 4, p.n), dtype=np.uint32)
    for t, q in enumerate(p.moduli):
        arr[t] = rng.integers(0, q, size=arr.shape[1:], dtype=np.uint64)
    for fmt in ("coeff", "eval"):
        mine = convert.poly_matrix_from_numpy(p, arr, fmt, device="cpu")
        theirs = JaxPolyMatrix(jnp.asarray(arr), fmt, jp)
        raw = mine.to_packed_bytes()
        assert raw == theirs.to_packed_bytes()
        assert len(raw) < len(mine.to_compact_bytes()) * p.crt_bits / 32 + 25
        back = PolyMatrix.from_packed_bytes(p, raw, device="cpu")
        assert back == mine and back.fmt == fmt
        jback = JaxPolyMatrix.from_packed_bytes(jp, raw)
        np.testing.assert_array_equal(np.asarray(jback.data), arr)
        assert jback.fmt == fmt
