"""Host-side CSPRNG: a SHA-256 counter-mode DRBG with the random.Random API.

A copy of `mxx_tpu/utils/rng.py`: the same byte stream, so both packages draw
the same integers from the same seed. Host encryption paths must not draw
(a) GSW ciphertext a-vectors from a Mersenne Twister `random.Random`, whose
raw outputs appear unmasked in published ciphertexts (MT state recovery ->
payload recovery), nor (b) error terms from the module-global `random.gauss`,
which ignores the caller's rng (seeded runs would not reproduce). This DRBG
serves both:

- Unseeded: keyed from `os.urandom(32)` — a proper CSPRNG.
- Seeded (tests / reproducible artifacts): keyed from SHA-256 of the seed
  material. Outputs are then a deterministic PRF stream; unlike MT, observing
  outputs does not reveal the generator state without inverting SHA-256.

Subclassing `random.Random` and overriding `random`/`getrandbits` makes the
whole API (`randrange`, `gauss`, `choice`, ...) flow through the DRBG, so
call sites keep the standard interface (reference analog: OpenFHE's
OS-entropy CSPRNG behind its DGG/DUG samplers, src/sampler/uniform.rs).
"""

from __future__ import annotations

import hashlib
import os
import random

_PERSONALIZATION = b"mxx_tpu/drbg/v1"


class Drbg(random.Random):
    """SHA-256 counter-mode DRBG exposing the full random.Random API."""

    def __new__(cls, *args, **kwargs):
        # random.Random.__new__ inspects the seed argument; bypass it.
        return super().__new__(cls, None)

    def __init__(self, seed_material: bytes | int | None = None):
        self._key = b""  # set by .seed(), which Random.__init__ calls
        self._ctr = 0
        self._buf = b""
        super().__init__(seed_material)

    # -- random.Random overrides ------------------------------------------

    def seed(self, a=None, version=2):  # noqa: D102 (Random API)
        if a is None:
            material = os.urandom(32)
        elif isinstance(a, bytes):
            material = a
        elif isinstance(a, int):
            material = a.to_bytes((a.bit_length() + 15) // 8 + 1, "little", signed=True)
        else:
            material = str(a).encode()
        self._key = hashlib.sha256(_PERSONALIZATION + material).digest()
        self._ctr = 0
        self._buf = b""

    def getstate(self):
        return (self._key, self._ctr, self._buf)

    def setstate(self, state):
        self._key, self._ctr, self._buf = state

    def _refill(self) -> None:
        self._buf += hashlib.sha256(
            self._key + self._ctr.to_bytes(8, "little")
        ).digest()
        self._ctr += 1

    def getrandbits(self, k: int) -> int:
        nbytes = (k + 7) // 8
        while len(self._buf) < nbytes:
            self._refill()
        chunk, self._buf = self._buf[:nbytes], self._buf[nbytes:]
        return int.from_bytes(chunk, "little") >> (8 * nbytes - k)

    def random(self) -> float:
        return self.getrandbits(53) / (1 << 53)

    # -- lattice helpers ---------------------------------------------------

    def gauss_int(self, sigma: float) -> int:
        """Rounded continuous Gaussian draw (host-side error sampling)."""
        return round(self.gauss(0.0, sigma)) if sigma > 0 else 0


def secure_rng(seed: int | bytes | None = None) -> Drbg:
    """CSPRNG when seed is None; deterministic DRBG otherwise."""
    return Drbg(seed)
