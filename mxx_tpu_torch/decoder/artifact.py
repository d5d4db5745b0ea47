"""Decoder artifact sinks/sources: a copy of `mxx_tpu/decoder/artifact.py`
(reference src/decoder/artifact.rs) whose readers take the device to read onto.
The bytes are the JAX package's, so either package reads what the other wrote."""

from __future__ import annotations

from pathlib import Path

from ..matrix import PolyMatrix


class InMemoryDecoderArtifacts:
    def __init__(self):
        self.artifacts: dict[str, bytes] = {}

    def write_artifact(self, art_id: str, raw: bytes):
        self.artifacts[art_id] = raw

    def write_matrix(self, art_id: str, m: PolyMatrix):
        self.write_artifact(art_id, m.to_compact_bytes())

    def read_artifact(self, art_id: str) -> bytes:
        return self.artifacts[art_id]

    def read_matrix(self, params, art_id: str, device="cuda") -> PolyMatrix:
        return PolyMatrix.from_compact_bytes(params, self.read_artifact(art_id), device)


class VecDecoderArtifacts:
    """Compact vector-backed store for AKY24-style functional keys."""

    def __init__(self):
        self.artifacts: list[bytes] = []

    def push_matrix(self, m: PolyMatrix):
        self.artifacts.append(m.to_compact_bytes())

    def matrix(self, params, idx: int, device="cuda") -> PolyMatrix:
        return PolyMatrix.from_compact_bytes(params, self.artifacts[idx], device)


class DirectoryDecoderArtifacts:
    """Directory-backed artifacts for DiamondIO-style persisted state."""

    def __init__(self, dir_path, file_prefix: str):
        self.dir_path = Path(dir_path)
        self.dir_path.mkdir(parents=True, exist_ok=True)
        self.file_prefix = file_prefix

    def _path(self, art_id: str) -> Path:
        return self.dir_path / f"{self.file_prefix}_{art_id}.matrixbin"

    def write_artifact(self, art_id: str, raw: bytes):
        self._path(art_id).write_bytes(raw)

    def write_matrix(self, art_id: str, m: PolyMatrix):
        self.write_artifact(art_id, m.to_compact_bytes())

    def read_artifact(self, art_id: str) -> bytes:
        return self._path(art_id).read_bytes()

    def read_matrix(self, params, art_id: str, device="cuda") -> PolyMatrix:
        return PolyMatrix.from_compact_bytes(params, self.read_artifact(art_id), device)
