"""DCRT (RNS) ring parameters, with int64 device tables for PyTorch.

The port's counterpart of `mxx_tpu/ring/params.py`. The host `np_*` tables
are the same as the JAX package's (Montgomery forms included, so the two can
be compared table by table); `tables(device)` replaces `JaxTables` and holds
standard-form int64 tensors, because the port reduces with `% q` in int64
instead of Montgomery multiplies in uint32. Modulus-switch tables are not
ported yet.

A polynomial is a tensor int64[L, n]; a polynomial matrix int64[L, r, c, n].
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import numth

R32 = 1 << 32


@functools.lru_cache(maxsize=None)
def _params_cache(ring_dimension, crt_depth, crt_bits, base_bits):
    return RingParams(
        ring_dimension=ring_dimension,
        crt_depth=crt_depth,
        crt_bits=crt_bits,
        base_bits=base_bits,
    )


@dataclass(frozen=True)
class TorchTables:
    """Standard-form int64 tables of one `RingParams` on one device."""

    moduli: torch.Tensor  # [L]
    psi_rev: torch.Tensor  # [L, n] psi^bitrev(i), merged-twist forward twiddles
    psi_inv_rev: torch.Tensor  # [L, n]
    n_inv: torch.Tensor  # [L]
    gadget_res: torch.Tensor  # [k, L]
    digit_masks: torch.Tensor  # [dpt]


@dataclass(frozen=True, eq=False)
class RingParams:
    """Static ring parameters + cached host/device tables.

    Instances are interned by `RingParams.new(...)`; identity equality is
    intentional so table caches key on the object.
    """

    ring_dimension: int
    crt_depth: int
    crt_bits: int
    base_bits: int
    _tables: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def new(ring_dimension: int, crt_depth: int, crt_bits: int, base_bits: int) -> "RingParams":
        if ring_dimension < 2 or ring_dimension & (ring_dimension - 1):
            raise ValueError("ring_dimension must be a power of 2")
        if not 1 <= base_bits <= crt_bits:
            raise ValueError("base_bits must be in [1, crt_bits]")
        return _params_cache(ring_dimension, crt_depth, crt_bits, base_bits)

    @staticmethod
    def default() -> "RingParams":
        """Insecure test parameters."""
        return RingParams.new(4, 2, 17, 1)

    # ---------------------------------------------------------------- basics

    @property
    def n(self) -> int:
        return self.ring_dimension

    @property
    def log_n(self) -> int:
        return self.ring_dimension.bit_length() - 1

    @functools.cached_property
    def moduli(self) -> tuple[int, ...]:
        return numth.gen_crt_moduli(self.ring_dimension, self.crt_depth, self.crt_bits)

    @functools.cached_property
    def modulus(self) -> int:
        """The full composite modulus q = prod q_t (host big int)."""
        return math.prod(self.moduli)

    @property
    def modulus_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def digits_per_tower(self) -> int:
        return -(-self.crt_bits // self.base_bits)

    @property
    def modulus_digits(self) -> int:
        """k: total gadget digits = digits_per_tower * crt_depth."""
        return self.digits_per_tower * self.crt_depth

    @property
    def base(self) -> int:
        return 1 << self.base_bits

    @property
    def decompose_last_mask(self) -> int | None:
        """Mask for the most-significant digit within each CRT tower."""
        if self.crt_bits % self.base_bits == 0:
            return None
        last_bits = self.crt_bits - self.base_bits * (self.digits_per_tower - 1)
        return (1 << last_bits) - 1

    def to_crt(self) -> tuple[tuple[int, ...], int, int]:
        return (self.moduli, self.crt_bits, self.crt_depth)

    # ----------------------------------------------------- host CRT helpers

    @functools.cached_property
    def crt_idempotents(self) -> tuple[int, ...]:
        """e_t = (q/q_t) * ((q/q_t)^{-1} mod q_t) mod q: e_t = 1 mod q_t, 0 mod q_s."""
        q = self.modulus
        out = []
        for qt in self.moduli:
            qh = q // qt
            out.append(qh * numth.modinv(qh % qt, qt) % q)
        return tuple(out)

    def reconstruct_coeff(self, residues) -> int:
        """CRT-reconstruct one coefficient from its per-limb residues."""
        acc = 0
        for r, e in zip(residues, self.crt_idempotents):
            acc += int(r) * e
        return acc % self.modulus

    # --------------------------------------------------------- numpy tables

    def _table(self, name, builder):
        if name not in self._tables:
            self._tables[name] = builder()
        return self._tables[name]

    @property
    def np_moduli(self) -> np.ndarray:
        return self._table("np_moduli", lambda: np.array(self.moduli, dtype=np.uint32))

    @property
    def np_qinv_neg(self) -> np.ndarray:
        def build():
            return np.array(
                [(-numth.modinv(q, R32)) % R32 for q in self.moduli], dtype=np.uint32
            )

        return self._table("np_qinv_neg", build)

    @property
    def np_r1(self) -> np.ndarray:
        """R mod q (Montgomery form of 1)."""
        return self._table(
            "np_r1", lambda: np.array([R32 % q for q in self.moduli], dtype=np.uint32)
        )

    @property
    def np_r2(self) -> np.ndarray:
        """R^2 mod q."""
        return self._table(
            "np_r2", lambda: np.array([R32 * R32 % q for q in self.moduli], dtype=np.uint32)
        )

    def _psi_tables(self):
        def build():
            n, ln = self.n, self.log_n
            psi_rev = np.empty((self.crt_depth, n), dtype=np.uint32)
            psi_inv_rev = np.empty((self.crt_depth, n), dtype=np.uint32)
            n_inv = np.empty((self.crt_depth,), dtype=np.uint32)
            for t, q in enumerate(self.moduli):
                psi = numth.find_primitive_2n_root(q, n)
                psi_i = numth.modinv(psi, q)
                for i in range(n):
                    b = numth.bit_reverse(i, ln)
                    psi_rev[t, i] = pow(psi, b, q) * R32 % q
                    psi_inv_rev[t, i] = pow(psi_i, b, q) * R32 % q
                n_inv[t] = numth.modinv(n, q) * R32 % q
            return psi_rev, psi_inv_rev, n_inv

        return self._table("psi", build)

    @property
    def np_psi_rev_mont(self) -> np.ndarray:
        return self._psi_tables()[0]

    @property
    def np_psi_inv_rev_mont(self) -> np.ndarray:
        return self._psi_tables()[1]

    @property
    def np_n_inv_mont(self) -> np.ndarray:
        return self._psi_tables()[2]

    def _from_mont(self, name: str, mont: np.ndarray) -> np.ndarray:
        """Standard form a = (a R) R^{-1} mod q of a Montgomery table [L, ...]."""

        def build():
            q = self.np_moduli.astype(np.uint64)
            rinv = np.array([numth.modinv(R32 % int(v), int(v)) for v in self.moduli],
                            dtype=np.uint64)
            shape = (-1,) + (1,) * (mont.ndim - 1)
            return (mont.astype(np.uint64) * rinv.reshape(shape) % q.reshape(shape)).astype(
                np.uint32
            )

        return self._table(name, build)

    @property
    def np_psi_rev(self) -> np.ndarray:
        """Standard-form forward twiddles psi^bitrev(i) [L, n]."""
        return self._from_mont("np_psi_rev", self.np_psi_rev_mont)

    @property
    def np_psi_inv_rev(self) -> np.ndarray:
        return self._from_mont("np_psi_inv_rev", self.np_psi_inv_rev_mont)

    @property
    def np_n_inv(self) -> np.ndarray:
        return self._from_mont("np_n_inv", self.np_n_inv_mont)

    @property
    def np_gadget_res(self) -> np.ndarray:
        """Gadget vector residues [k, L]: gv[t*dpt+j, s] = b^j * e_t mod q_s.

        Digit (tower t, position j) has weight b^j on tower t and 0 elsewhere.
        """

        def build():
            dpt = self.digits_per_tower
            k = self.modulus_digits
            out = np.empty((k, self.crt_depth), dtype=np.uint32)
            for t in range(self.crt_depth):
                et = self.crt_idempotents[t]
                for j in range(dpt):
                    v = (1 << (self.base_bits * j)) * et % self.modulus
                    for s, qs in enumerate(self.moduli):
                        out[t * dpt + j, s] = v % qs
            return out

        return self._table("np_gadget_res", build)

    @property
    def np_small_gadget_res(self) -> np.ndarray:
        """Small gadget residues [dpt, L]: b^j mod q_s (constant poly b^j)."""

        def build():
            dpt = self.digits_per_tower
            out = np.empty((dpt, self.crt_depth), dtype=np.uint32)
            for j in range(dpt):
                v = 1 << (self.base_bits * j)
                for s, qs in enumerate(self.moduli):
                    out[j, s] = v % qs
            return out

        return self._table("np_small_gadget_res", build)

    @property
    def np_digit_masks(self) -> np.ndarray:
        """Per-digit-position masks [dpt] for in-tower decomposition."""

        def build():
            dpt = self.digits_per_tower
            masks = np.full((dpt,), (1 << self.base_bits) - 1, dtype=np.uint32)
            if self.decompose_last_mask is not None:
                masks[dpt - 1] = self.decompose_last_mask
            return masks

        return self._table("np_digit_masks", build)

    # int8-digit matmul combination constants of the JAX package, kept so the
    # host tables compare one to one; the port's matmul does not use them.
    @property
    def np_combine_pows_mont(self) -> np.ndarray:
        def build():
            out = np.empty((7, self.crt_depth), dtype=np.uint32)
            for s in range(7):
                for t, q in enumerate(self.moduli):
                    out[s, t] = (1 << (8 * s)) * R32 % q
            return out

        return self._table("np_combine_pows_mont", build)

    @property
    def np_sign_corr_pows(self) -> np.ndarray:
        def build():
            out = np.empty((7, self.crt_depth), dtype=np.uint32)
            for s in range(7):
                for t, q in enumerate(self.moduli):
                    out[s, t] = (1 << (32 + 8 * s)) % q
            return out

        return self._table("np_sign_corr_pows", build)

    # ------------------------------------------- modulus-switch tables (per P)

    def ms_tables(self, new_modulus: int) -> tuple[np.ndarray, np.ndarray]:
        """(floor(e_t P / q) mod P, frac(e_t P / q)) per limb as int64[L] and
        float64[L]: the tables of `PolyMatrix.modulus_switch` (the JAX
        package's `ms_int_parts` / `ms_frac_parts`)."""

        def build():
            q = self.modulus
            ints = []
            fracs = []
            for e in self.crt_idempotents:
                num = e * new_modulus
                ints.append((num // q) % new_modulus)
                # exact rational remainder -> float64 fraction
                fracs.append(float((num % q) / q))
            return np.array(ints, dtype=np.int64), np.array(fracs, dtype=np.float64)

        return self._table(("ms", new_modulus), build)

    # -------------------------------------------------------- device tables

    def tables(self, device) -> TorchTables:
        """int64 standard-form tables on `device`, built once per device."""
        device = torch.device(device)
        key = ("torch", str(device))
        if key not in self._tables:

            def put(a):
                return torch.from_numpy(a.astype(np.int64)).to(device)

            self._tables[key] = TorchTables(
                moduli=put(self.np_moduli),
                psi_rev=put(self.np_psi_rev),
                psi_inv_rev=put(self.np_psi_inv_rev),
                n_inv=put(self.np_n_inv),
                gadget_res=put(self.np_gadget_res),
                digit_masks=put(self.np_digit_masks),
            )
        return self._tables[key]

    def __hash__(self):
        return hash((self.ring_dimension, self.crt_depth, self.crt_bits, self.base_bits))

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return (
            f"RingParams(n={self.ring_dimension}, depth={self.crt_depth}, "
            f"crt_bits={self.crt_bits}, base_bits={self.base_bits})"
        )
