"""Artifact store: batch lookup buffers, a background writer pool and a JSON
index.

The port's counterpart of `mxx_tpu/storage/store.py`, with the same files
byte for byte, so either package reads what the other wrote:
`BatchLookupBuffer`s hold (index -> bytes) payloads under an id prefix and
become batch files `{prefix}_batch{part}.bin`, split into parts under
LUT_BYTES_LIMIT; `lookup_tables.index` is the JSON index of prefixes, parts
and indices, flushed durably every LUT_INDEX_SYNC_EVERY writes (after a
barrier on the writes it names) and by `wait_for_all_writes`.

Batch file format (one file per part): b"MXBT" | u32 count |
count * (u64 idx, u64 offset, u64 length) | payload blobs.

Writes go through a thread pool (the JAX package's native C++ writer is not
ported). `get_lookup_buffer` copies a buffer's matrices to the host with one
device-to-host copy, and the readers load a matrix onto the device the
caller names.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .. import config
from ..utils.tracing import event, span

_MAGIC = b"MXBT"
_INDEX_NAME = "lookup_tables.index"

_lock = threading.Lock()
_system: "StorageSystem | None" = None


@dataclass
class BatchLookupBuffer:
    id_prefix: str
    payloads: list[tuple[int, bytes]] = field(default_factory=list)

    def header(self) -> bytes:
        """Magic, count and the (idx, offset, length) table."""
        table = []
        offset = 0
        for idx, raw in self.payloads:
            table.append(struct.pack("<QQQ", idx, offset, len(raw)))
            offset += len(raw)
        return _MAGIC + struct.pack("<I", len(self.payloads)) + b"".join(table)

    def serialize(self) -> bytes:
        return b"".join([self.header()] + [raw for _, raw in self.payloads])

    def nbytes(self) -> int:
        return 8 + 24 * len(self.payloads) + sum(len(raw) for _, raw in self.payloads)


def _read_table(f, path: Path) -> list[tuple[int, int, int]]:
    """The (idx, offset, length) table of an open batch file; leaves the
    file at the first payload byte."""
    head = f.read(8)
    if len(head) != 8 or head[:4] != _MAGIC:
        raise IOError(f"bad batch magic in {path}")
    (count,) = struct.unpack("<I", head[4:8])
    table = f.read(24 * count)
    if len(table) != 24 * count:
        raise IOError(f"truncated batch table in {path}")
    return [struct.unpack_from("<QQQ", table, 24 * e) for e in range(count)]


class StorageSystem:
    def __init__(self, dir_path: Path, workers: int = 4):
        self.dir_path = Path(dir_path)
        self.dir_path.mkdir(parents=True, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="mxx-storage")
        self._futures: list[Future] = []
        self._index_lock = threading.Lock()
        self._index: dict[str, dict] = {}
        self._writes_since_sync = 0
        self._load_index()

    def _index_path(self) -> Path:
        return self.dir_path / _INDEX_NAME

    def _load_index(self):
        p = self._index_path()
        if p.exists():
            try:
                self._index = json.loads(p.read_text()).get("entries", {})
            except (json.JSONDecodeError, OSError):
                self._index = {}

    def _write_index_atomic(self, entries: dict):
        tmp = self._index_path().with_suffix(".index.tmp")
        tmp.write_text(json.dumps({"entries": entries}))
        os.replace(tmp, self._index_path())

    def _flush_index(self):
        with self._index_lock:
            self._write_index_atomic(self._index)

    def _flush_index_durable(self, snapshot: dict, pending: list):
        """Background periodic flush: barrier on all writes submitted before
        the snapshot, THEN persist it, so the on-disk index never names a
        batch file that is missing or partial."""
        for f in pending:
            try:
                f.result()
            except Exception:
                return  # leave the index un-advanced; wait_for_all_writes reports
        with self._index_lock:
            self._write_index_atomic(snapshot)

    def _batch_file(self, prefix: str, part: int) -> Path:
        return self.dir_path / f"{prefix}_batch{part}.bin"

    def add_buffer(self, buffer: BatchLookupBuffer):
        """Enqueue a buffer; a buffer over LUT_BYTES_LIMIT splits into parts."""
        limit = config.lut_bytes_limit()
        total = sum(len(raw) for _, raw in buffer.payloads)
        if total > limit and len(buffer.payloads) > 1:
            chunk: list = []
            size = 0
            for item in buffer.payloads:
                if chunk and size + len(item[1]) > limit:
                    self._add_one(BatchLookupBuffer(buffer.id_prefix, chunk))
                    chunk, size = [], 0
                chunk.append(item)
                size += len(item[1])
            if chunk:
                self._add_one(BatchLookupBuffer(buffer.id_prefix, chunk))
            return
        self._add_one(buffer)

    def _add_one(self, buffer: BatchLookupBuffer):
        with self._index_lock:
            entry = self._index.setdefault(buffer.id_prefix, {"parts": 0, "indices": []})
            part = entry["parts"]
            entry["parts"] += 1
            entry["indices"] = sorted(set(entry["indices"]) | {i for i, _ in buffer.payloads})
            self._writes_since_sync += 1
            sync_due = self._writes_since_sync >= config.lut_index_sync_every()
            if sync_due:
                self._writes_since_sync = 0
        path = self._batch_file(buffer.id_prefix, part)

        def write():
            # timed by hand, not by a span: a span would synchronize the
            # device from this worker thread
            started = time.monotonic()
            tmp = path.with_suffix(path.suffix + ".tmp")
            with open(tmp, "wb") as f:
                f.write(buffer.header())
                for _, raw in buffer.payloads:
                    f.write(raw)
            os.replace(tmp, path)
            event("storage.write_part", prefix=buffer.id_prefix, part=part,
                  bytes=buffer.nbytes(), elapsed_ms=(time.monotonic() - started) * 1e3)

        self._futures.append(self._pool.submit(write))
        if sync_due:
            # periodic index flush so long offline passes are resumable
            # without a final wait_for_all_writes; it runs after a barrier on
            # everything submitted so far
            with self._index_lock:
                snapshot = json.loads(json.dumps(self._index))
            pending = list(self._futures)
            self._futures.append(self._pool.submit(self._flush_index_durable, snapshot, pending))

    def wait_for_all_writes(self):
        for f in list(self._futures):
            f.result()
        self._futures.clear()
        self._flush_index()

    def _parts(self, prefix: str) -> int:
        entry = self._index.get(prefix)
        return entry["parts"] if entry else self._count_parts(prefix)

    def read_bytes(self, prefix: str, idx: int) -> bytes | None:
        """Payload `idx` under `prefix`: reads the table of each part and
        only the payload it names."""
        for part in range(self._parts(prefix)):
            path = self._batch_file(prefix, part)
            if not path.exists():
                continue
            with open(path, "rb") as f:
                table = _read_table(f, path)
                blobs_start = f.tell()
                for i, off, ln in table:
                    if i == idx:
                        f.seek(blobs_start + off)
                        payload = f.read(ln)
                        if len(payload) != ln:
                            raise IOError(
                                f"truncated batch file {path}: entry {idx} wants {ln} bytes "
                                f"at offset {off}, file has {len(payload)}")
                        return payload
        return None

    def read_all(self, prefix: str):
        """Every (idx, payload) under `prefix`, reading each part file once."""
        for part in range(self._parts(prefix)):
            path = self._batch_file(prefix, part)
            if not path.exists():
                continue
            with open(path, "rb") as f:
                table = _read_table(f, path)
                blobs = memoryview(f.read())
            for i, off, ln in table:
                payload = blobs[off : off + ln]
                if len(payload) != ln:
                    raise IOError(f"truncated batch file {path}: entry {i} wants {ln} bytes "
                                  f"at offset {off}")
                yield i, payload

    def _count_parts(self, prefix: str) -> int:
        part = 0
        while self._batch_file(prefix, part).exists():
            part += 1
        return part

    def has_index(self, prefix: str, idx: int) -> bool:
        entry = self._index.get(prefix)
        return entry is not None and idx in entry["indices"]


# ------------------------------------------------------------------ module API


def init_storage_system(dir_path) -> StorageSystem:
    global _system
    with _lock:
        _system = StorageSystem(Path(dir_path))
        return _system


def get_storage_system() -> StorageSystem:
    if _system is None:
        raise RuntimeError("call init_storage_system(dir) first")
    return _system


def get_lookup_buffer(matrices: list, id_prefix: str) -> BatchLookupBuffer:
    """A buffer of (idx, PolyMatrix) pairs: the compact bytes of each matrix.

    The matrices (of one shape, on one device) are stacked as uint32 planes
    on their device and copied to the host in ONE device-to-host copy; a
    per-matrix copy would synchronize once per matrix."""
    from ..matrix.poly_matrix import compact_header

    if not matrices:
        return BatchLookupBuffer(id_prefix, [])
    first = matrices[0][1]
    with span("storage.device_to_host", prefix=id_prefix, matrices=len(matrices)):
        # residues are below 2^31, so int32 holds them and views as uint32
        stacked = torch.empty((len(matrices),) + tuple(first.data.shape), dtype=torch.int32,
                              device=first.data.device)
        for i, (_, m) in enumerate(matrices):
            if m.data.shape != first.data.shape:
                raise ValueError(f"a lookup buffer holds matrices of one shape: "
                                 f"{tuple(m.data.shape)} != {tuple(first.data.shape)}")
            stacked[i].copy_(m.data)
        host = stacked.cpu().numpy()
    with span("storage.serialize", prefix=id_prefix, matrices=len(matrices)):
        payloads = []
        for (idx, m), planes in zip(matrices, host):
            header = compact_header(first.params, m.fmt, m.nrow, m.ncol)
            payloads.append((idx, b"".join([header, planes.view(np.uint32).data])))
    return BatchLookupBuffer(id_prefix, payloads)


def add_lookup_buffer(buffer: BatchLookupBuffer):
    get_storage_system().add_buffer(buffer)


def wait_for_all_writes(dir_path=None):
    get_storage_system().wait_for_all_writes()


def _reader(dir_path) -> StorageSystem:
    sys_ = _system
    if sys_ is None or Path(dir_path) != sys_.dir_path:
        sys_ = StorageSystem(Path(dir_path))
    return sys_


def read_bytes_from_multi_batch(dir_path, id_prefix: str, idx: int) -> bytes | None:
    return _reader(dir_path).read_bytes(id_prefix, idx)


def read_matrix_from_multi_batch(params, dir_path, id_prefix: str, idx: int, device):
    """The matrix stored as `idx` under `id_prefix`, loaded onto `device`
    (None when absent)."""
    from ..matrix import PolyMatrix

    raw = read_bytes_from_multi_batch(dir_path, id_prefix, idx)
    if raw is None:
        return None
    return PolyMatrix.from_compact_bytes(params, raw, device)


def read_matrices_from_multi_batch(params, dir_path, id_prefix: str, device):
    """Every (idx, matrix) stored under `id_prefix`, loaded onto `device`,
    reading each part file once."""
    from ..matrix import PolyMatrix

    for idx, raw in _reader(dir_path).read_all(id_prefix):
        yield idx, PolyMatrix.from_compact_bytes(params, raw, device)
