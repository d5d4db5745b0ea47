"""mxx_tpu_torch artifact store and out-of-core matrices against mxx_tpu:
the same buffers become the same batch files and the same JSON index, byte
for byte, split into parts under a small LUT_BYTES_LIMIT and flushed every
LUT_INDEX_SYNC_EVERY writes; each package reads a directory the other
wrote (a reader only calls `init_storage_system(dir)`); memmap files of
offloaded matrices are shared too, and the streamed products equal the
in-memory ones (tests/test_offload.py's checks)."""

import importlib
import struct

import numpy as np
import pytest
import torch

from mxx_tpu_torch import convert
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.matrix.offload import (
    OffloadedMatrix,
    matmul_offloaded_lhs,
    matmul_streamed,
    offload_matrix,
)
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.sampler import FinRingDist, UniformSampler
from mxx_tpu_torch.storage import (
    BatchLookupBuffer,
    add_lookup_buffer,
    get_lookup_buffer,
    get_storage_system,
    init_storage_system,
    read_bytes_from_multi_batch,
    read_matrices_from_multi_batch,
    read_matrix_from_multi_batch,
    wait_for_all_writes,
)

ARGS = (16, 4, 28, 7)
CPU = torch.device("cpu")


@pytest.fixture
def jx():
    """The JAX package's storage, matrix and offload modules."""
    return (importlib.import_module("mxx_tpu.storage"),
            importlib.import_module("mxx_tpu.matrix"),
            importlib.import_module("mxx_tpu.ring.params"),
            importlib.import_module("mxx_tpu.matrix.offload"))


def _matrices(p, count, seed, shape=(1, 16)):
    us = UniformSampler(seed=seed, device="cpu")
    return [us.sample_uniform(p, *shape, FinRingDist()).to_eval() for _ in range(count)]


def _buffers(p):
    """Two prefixes, as two LUT gates give them: rows 0..6 and 10..14."""
    return [(f"LWE_K_H_{g}_0_slot0", list(zip(rows, _matrices(p, len(rows), seed))))
            for g, rows, seed in [(2, range(7), 1), (4, range(10, 15), 2)]]


def _files(path):
    return {f.name: f.read_bytes() for f in sorted(path.iterdir())}


def test_batch_files_and_index_equal_jax_and_read_across(jx, tmp_path, monkeypatch):
    jstorage, jmatrix, jparams, _ = jx
    p, jp = RingParams.new(*ARGS), jparams.RingParams.new(*ARGS)
    one = len(_matrices(p, 1, 0)[0].to_compact_bytes())
    monkeypatch.setenv("LUT_BYTES_LIMIT", str(3 * one))  # three matrices per part
    monkeypatch.setenv("LUT_INDEX_SYNC_EVERY", "2")
    buffers = _buffers(p)

    init_storage_system(tmp_path / "port")
    for prefix, rows in buffers:
        add_lookup_buffer(get_lookup_buffer(rows, prefix))
    wait_for_all_writes()

    jstorage.init_storage_system(tmp_path / "jax")
    for prefix, rows in buffers:
        jrows = [(i, jmatrix.PolyMatrix(convert.to_numpy(m), m.fmt, jp)) for i, m in rows]
        jstorage.add_lookup_buffer(jstorage.get_lookup_buffer(jrows, prefix))
    jstorage.wait_for_all_writes()

    files, jfiles = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(files) == sorted(jfiles)
    assert sum(name.endswith(".bin") for name in files) == 3 + 2  # 7 rows -> 3 parts, 5 -> 2
    assert files == jfiles

    # a reader that only attaches to the other package's directory
    init_storage_system(tmp_path / "jax")
    jstorage.init_storage_system(tmp_path / "port")
    for prefix, rows in buffers:
        for idx, m in rows:
            got = read_matrix_from_multi_batch(p, tmp_path / "jax", prefix, idx, CPU)
            assert got.fmt == m.fmt and got == m
            jgot = jstorage.read_matrix_from_multi_batch(jp, tmp_path / "port", prefix, idx)
            np.testing.assert_array_equal(np.asarray(jgot.data), convert.to_numpy(m))
        assert get_storage_system().has_index(prefix, rows[-1][0])
        every = dict(read_matrices_from_multi_batch(p, tmp_path / "jax", prefix, CPU))
        assert sorted(every) == [i for i, _ in rows]
        assert all(every[i] == m for i, m in rows)
    assert read_bytes_from_multi_batch(tmp_path / "jax", buffers[0][0], 99) is None


def test_get_lookup_buffer_equals_jax_and_takes_one_shape(jx):
    jstorage, jmatrix, jparams, _ = jx
    p, jp = RingParams.new(*ARGS), jparams.RingParams.new(*ARGS)
    rows = list(zip([3, 1, 2], _matrices(p, 3, 5)))
    rows.append((7, _matrices(p, 1, 6)[0].to_coeff()))  # a COEFF matrix keeps its flag
    buf = get_lookup_buffer(rows, "pfx")
    jbuf = jstorage.get_lookup_buffer(
        [(i, jmatrix.PolyMatrix(convert.to_numpy(m), m.fmt, jp)) for i, m in rows], "pfx")
    assert buf.serialize() == jbuf.serialize()
    assert [raw for _, raw in buf.payloads] == [m.to_compact_bytes() for _, m in rows]
    with pytest.raises(ValueError, match="one shape"):
        get_lookup_buffer(rows + [(9, _matrices(p, 1, 7, shape=(1, 3))[0])], "pfx")


def test_periodic_index_flush_names_only_written_parts(tmp_path, monkeypatch):
    """With LUT_INDEX_SYNC_EVERY=2 the index reaches the disk after the
    second write, behind a barrier on both, before any wait_for_all_writes."""
    p = RingParams.new(*ARGS)
    monkeypatch.setenv("LUT_INDEX_SYNC_EVERY", "2")
    store = init_storage_system(tmp_path)
    mats = _matrices(p, 3, 9)
    for i, m in enumerate(mats):
        add_lookup_buffer(get_lookup_buffer([(i, m)], f"p{i}"))
    for f in list(store._futures):
        f.result()
    index = (tmp_path / "lookup_tables.index").read_text()
    assert '"p0"' in index and '"p1"' in index and '"p2"' not in index
    wait_for_all_writes()
    assert '"p2"' in (tmp_path / "lookup_tables.index").read_text()


def test_read_rejects_bad_and_truncated_files(tmp_path):
    p = RingParams.new(*ARGS)
    init_storage_system(tmp_path)
    (m,) = _matrices(p, 1, 3)
    add_lookup_buffer(get_lookup_buffer([(0, m)], "ok"))
    wait_for_all_writes()
    path = tmp_path / "ok_batch0.bin"
    raw = path.read_bytes()
    path.write_bytes(raw[:-10])
    with pytest.raises(IOError, match="truncated"):
        read_bytes_from_multi_batch(tmp_path, "ok", 0)
    path.write_bytes(b"NOPE" + raw[4:])
    with pytest.raises(IOError, match="magic"):
        read_bytes_from_multi_batch(tmp_path, "ok", 0)
    table = BatchLookupBuffer("x", [(5, b"abc"), (6, b"de")])
    assert table.serialize() == (b"MXBT" + struct.pack("<I", 2) + struct.pack("<QQQ", 5, 0, 3)
                                 + struct.pack("<QQQ", 6, 3, 2) + b"abcde")
    assert table.nbytes() == len(table.serialize())


def test_offload_roundtrip_streamed_matmul_and_jax_memmaps(jx, tmp_path):
    _, _, jparams, joffload = jx
    p, jp = RingParams.new(16, 2, 20, 5), jparams.RingParams.new(16, 2, 20, 5)
    us = UniformSampler(seed=41, device="cpu")
    a = us.sample_uniform(p, 2, 7, FinRingDist())
    b = us.sample_uniform(p, 7, 13, FinRingDist())
    want = a @ b

    off_b = offload_matrix(b, str(tmp_path / "b.mxmm"))
    assert off_b.load(CPU) == b
    assert matmul_streamed(a, off_b, chunk_cols=4) == want
    assert off_b.load_columns(3, 9, CPU) == b.slice_columns(3, 9)

    off_a = offload_matrix(a)  # a temporary file it owns
    assert matmul_offloaded_lhs(off_a, b, chunk_rows=1) == want
    off_a.delete()

    # the JAX package maps the port's memmap, and the port the JAX one's
    jb = joffload.OffloadedMatrix(off_b.path, off_b.shape, off_b.fmt, jp).load()
    np.testing.assert_array_equal(np.asarray(jb.data), convert.to_numpy(b))
    jmine = joffload.offload_matrix(jb, str(tmp_path / "jb.mxmm"))
    back = OffloadedMatrix(jmine.path, tuple(jmine.shape), jmine.fmt, p).load(CPU)
    assert back == b and isinstance(back, PolyMatrix)
