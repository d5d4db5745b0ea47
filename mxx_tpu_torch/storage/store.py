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

Batch files are written by the native C++ writer (`native/writer.py`), as
in the JAX package: `add_buffer` queues a file's header and payloads without
copying them, and `wait_for_all_writes` is the barrier that also checks the
writer reported no failed write. `get_lookup_buffer` (or
`get_lookup_buffer_stacked`, for blocks of stacked matrices) copies a buffer's
matrices to the host with one device-to-host copy, and the readers load a
matrix onto the device the caller names.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .. import config
from ..native.writer import submit_write, wait_all_writes, write_errors
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


def _coalesce(parts: list, small: int = 1 << 20) -> list:
    """The parts of a file with each run of parts under `small` bytes joined
    into one: the writer then takes a few pointers per file, not one per
    small payload, and no large payload is copied."""
    out: list = []
    run: list = []
    for part in parts:
        if len(part) < small:
            run.append(part)
            continue
        if run:
            out.append(b"".join(run))
            run = []
        out.append(part)
    if run:
        out.append(b"".join(run))
    return out


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
    def __init__(self, dir_path: Path):
        self.dir_path = Path(dir_path)
        self.dir_path.mkdir(parents=True, exist_ok=True)
        # one thread runs the periodic index flushes, so they land in order
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mxx-storage-index")
        self._futures: list[Future] = []
        self._index_lock = threading.Lock()
        self._index: dict[str, dict] = {}
        self._encoded: dict[str, tuple[int, str]] = {}  # prefix -> (parts, its JSON)
        self._writes_since_sync = 0
        self._write_errors_at_start = write_errors()
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

    def _encode_index(self, entries: dict) -> str:
        """`json.dumps({"entries": entries})`, character for character, from
        a cache of each entry's encoding: an entry changes only when its
        prefix gains a part, so a flush encodes only the entries that did."""
        frags = []
        for prefix, entry in entries.items():
            hit = self._encoded.get(prefix)
            if hit is None or hit[0] != entry["parts"]:
                hit = self._encoded[prefix] = (entry["parts"],
                                               f"{json.dumps(prefix)}: {json.dumps(entry)}")
            frags.append(hit[1])
        return '{"entries": {' + ", ".join(frags) + "}}"

    def _write_index_atomic(self, entries: dict):
        tmp = self._index_path().with_suffix(".index.tmp")
        tmp.write_text(self._encode_index(entries))
        os.replace(tmp, self._index_path())

    def _flush_index(self):
        with self._index_lock:
            self._write_index_atomic(self._index)

    def _flush_index_durable(self, snapshot: dict):
        """Background periodic flush: barrier on all writes submitted before
        the snapshot, THEN persist it, so the on-disk index never names a
        batch file that is missing or partial."""
        wait_all_writes()
        if write_errors() != self._write_errors_at_start:
            return  # a batch file it names may be missing; wait_for_all_writes reports
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
        submit_write(path, _coalesce([buffer.header()] + [raw for _, raw in buffer.payloads]))
        event("storage.write_part", prefix=buffer.id_prefix, part=part, bytes=buffer.nbytes())
        if sync_due:
            # periodic index flush so long offline passes are resumable
            # without a final wait_for_all_writes; it runs after a barrier on
            # everything submitted so far
            with self._index_lock:
                # an entry's index list is replaced, never changed in place,
                # so copying the entries' dicts is enough
                snapshot = {k: dict(v) for k, v in self._index.items()}
            self._futures.append(self._pool.submit(self._flush_index_durable, snapshot))

    def wait_for_all_writes(self):
        for f in list(self._futures):
            f.result()
        self._futures.clear()
        wait_all_writes()
        failed = write_errors() - self._write_errors_at_start
        if failed:
            raise IOError(f"the native artifact writer failed {failed} writes under "
                          f"{self.dir_path}")
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
    if not matrices:
        return BatchLookupBuffer(id_prefix, [])
    first = matrices[0][1]
    for _, m in matrices:
        if m.data.shape != first.data.shape:
            raise ValueError(f"a lookup buffer holds matrices of one shape: "
                             f"{tuple(m.data.shape)} != {tuple(first.data.shape)}")
    return get_lookup_buffer_stacked(first.params, [m.fmt for _, m in matrices],
                                     [i for i, _ in matrices],
                                     [m.data[None] for _, m in matrices], id_prefix)


def get_lookup_buffer_stacked(params, fmts, idxs: list[int], blocks: list,
                              id_prefix: str) -> BatchLookupBuffer:
    """The buffer `get_lookup_buffer` makes, from blocks of the matrices'
    residues stacked on their device (each [count, L, nrow, ncol, n], below
    2^31; in `idxs` order) and their forms (one for all, or one each): the
    blocks are gathered on the device and copied to the host in one copy."""
    from ..matrix.poly_matrix import compact_header

    if isinstance(fmts, str):
        fmts = [fmts] * len(idxs)
    with span("storage.device_to_host", prefix=id_prefix, matrices=len(idxs)):
        # residues are below 2^31, so int32 holds them and views as uint32
        stacked = torch.empty((len(idxs),) + tuple(blocks[0].shape[1:]), dtype=torch.int32,
                              device=blocks[0].device)
        pos = 0
        for block in blocks:
            stacked[pos : pos + len(block)].copy_(block)
            pos += len(block)
        host = stacked.cpu().numpy()
        del stacked
    with span("storage.serialize", prefix=id_prefix, matrices=len(idxs)):
        headers = {f: compact_header(params, f, host.shape[2], host.shape[3]) for f in set(fmts)}
        payloads = [(idx, b"".join([headers[f], planes.view(np.uint32).data]))
                    for idx, f, planes in zip(idxs, fmts, host)]
    return BatchLookupBuffer(id_prefix, payloads)


def get_lookup_buffer_bytes(payloads: list[tuple[int, bytes]], id_prefix: str) -> BatchLookupBuffer:
    """A buffer of (idx, raw bytes) pairs, stored as they are."""
    return BatchLookupBuffer(id_prefix, list(payloads))


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
