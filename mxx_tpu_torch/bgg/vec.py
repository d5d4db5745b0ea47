"""Slot-wise BGG wire vectors + samplers ("naive vec").

A copy of `mxx_tpu/bgg/vec.py` (reference: src/bgg/naive_vec.rs). Each slot
holds an ordinary BggPublicKey/BggEncoding; ops evaluate slot-by-slot. This
is the Evaluable of the Diamond iO circuits. Slots are tensors on the device
of the wires they were made from; the level-batched evaluator
(`circuit/batched_eval.py`) runs a level's slots of one gate kind as one
batched op.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..circuit.poly_vec import PolyVec
from ..ring.poly import Poly
from .encoding import BggEncoding
from .public_key import BggPublicKey
from .sampler import BGGEncodingSampler, BGGPublicKeySampler


def _slot_tag(tag: bytes, output_idx: int, slot_idx: int) -> bytes:
    return (
        tag
        + output_idx.to_bytes(8, "little")
        + slot_idx.to_bytes(8, "little")
    )


@dataclass(frozen=True)
class BGGPublicKeyVec:
    keys: tuple[BggPublicKey, ...]

    @staticmethod
    def new(keys) -> "BGGPublicKeyVec":
        return BGGPublicKeyVec(tuple(keys))

    @property
    def num_slots(self) -> int:
        return len(self.keys)

    def key(self, slot: int) -> BggPublicKey:
        return self.keys[slot]

    def __add__(self, other):
        return BGGPublicKeyVec(tuple(a + b for a, b in zip(self.keys, other.keys, strict=True)))

    def __sub__(self, other):
        return BGGPublicKeyVec(tuple(a - b for a, b in zip(self.keys, other.keys, strict=True)))

    def __mul__(self, other):
        return BGGPublicKeyVec(tuple(a * b for a, b in zip(self.keys, other.keys, strict=True)))

    def small_scalar_mul(self, params, scalar):
        return BGGPublicKeyVec(tuple(k.small_scalar_mul(params, scalar) for k in self.keys))

    def large_scalar_mul(self, params, scalar):
        return BGGPublicKeyVec(tuple(k.large_scalar_mul(params, scalar) for k in self.keys))

    def matrix_mul(self, params, rhs_matrix):
        return BGGPublicKeyVec(tuple(k.matrix_mul(params, rhs_matrix) for k in self.keys))

    def __eq__(self, other):
        if not isinstance(other, BGGPublicKeyVec):
            return NotImplemented
        return len(self.keys) == len(other.keys) and all(
            a == b for a, b in zip(self.keys, other.keys)
        )

    def __hash__(self):
        return id(self)


@dataclass(frozen=True)
class BGGEncodingVec:
    encodings: tuple[BggEncoding, ...]

    @staticmethod
    def new(encodings) -> "BGGEncodingVec":
        return BGGEncodingVec(tuple(encodings))

    @property
    def num_slots(self) -> int:
        return len(self.encodings)

    def encoding(self, slot: int) -> BggEncoding:
        return self.encodings[slot]

    def plaintexts(self) -> PolyVec:
        return PolyVec(tuple(e.plaintext for e in self.encodings))

    def __add__(self, other):
        return BGGEncodingVec(
            tuple(a + b for a, b in zip(self.encodings, other.encodings, strict=True))
        )

    def __sub__(self, other):
        return BGGEncodingVec(
            tuple(a - b for a, b in zip(self.encodings, other.encodings, strict=True))
        )

    def __mul__(self, other):
        return BGGEncodingVec(
            tuple(a * b for a, b in zip(self.encodings, other.encodings, strict=True))
        )

    def small_scalar_mul(self, params, scalar):
        return BGGEncodingVec(tuple(e.small_scalar_mul(params, scalar) for e in self.encodings))

    def large_scalar_mul(self, params, scalar):
        return BGGEncodingVec(tuple(e.large_scalar_mul(params, scalar) for e in self.encodings))

    def matrix_mul(self, params, rhs_matrix):
        return BGGEncodingVec(tuple(e.matrix_mul(params, rhs_matrix) for e in self.encodings))

    def __hash__(self):
        return id(self)


class BGGPublicKeyVecSampler:
    """Per-slot hash-derived pubkey vectors (reference naive_vec.rs:129-167)."""

    def __init__(self, hash_key: bytes, d: int, num_slots: int, device="cuda"):
        assert num_slots > 0
        self.scalar_sampler = BGGPublicKeySampler(hash_key, d, device)
        self.num_slots = num_slots

    def sample(self, params, tag: bytes, reveal_plaintexts: list[bool]) -> list[BGGPublicKeyVec]:
        outputs = []
        for output_idx in range(len(reveal_plaintexts) + 1):
            reveal = True if output_idx == 0 else reveal_plaintexts[output_idx - 1]
            keys = []
            for slot_idx in range(self.num_slots):
                st = _slot_tag(tag, output_idx, slot_idx)
                if output_idx == 0:
                    sampled = self.scalar_sampler.sample(params, st, [])
                else:
                    sampled = self.scalar_sampler.sample(params, st, [reveal])
                keys.append(sampled[-1])
            outputs.append(BGGPublicKeyVec.new(keys))
        return outputs


class BGGEncodingVecSampler:
    """Per-slot encodings under a shared secret (reference naive_vec.rs:169-240),
    on the device of the secrets."""

    def __init__(self, params, secrets: list[Poly], gauss_sigma=None, num_slots=1, seed=None):
        assert num_slots > 0
        self.scalar_sampler = BGGEncodingSampler(params, secrets, gauss_sigma, seed)
        self.num_slots = num_slots

    @property
    def secret_vec(self):
        return self.scalar_sampler.secret_vec

    def sample(
        self, params, public_keys: list[BGGPublicKeyVec], plaintexts: list[PolyVec]
    ) -> list[BGGEncodingVec]:
        assert len(public_keys) == 1 + len(plaintexts)
        one = public_keys[0]
        out = []
        for encoding_idx in range(len(public_keys)):
            encodings = []
            for slot_idx in range(self.num_slots):
                one_key = one.key(slot_idx)
                if encoding_idx == 0:
                    sampled = self.scalar_sampler.sample(params, [one_key], [])
                    encodings.append(sampled[0])
                else:
                    input_key = public_keys[encoding_idx].key(slot_idx)
                    slot_pt = plaintexts[encoding_idx - 1].slots[slot_idx]
                    sampled = self.scalar_sampler.sample(params, [one_key, input_key], [slot_pt])
                    encodings.append(sampled[1])
            out.append(BGGEncodingVec.new(encodings))
        return out
