"""BGG+ public-key and encoding samplers (the port's counterpart of
`mxx_tpu/bgg/sampler.py`, bit for bit).

- `BGGPublicKeySampler`: hash-derived A_i matrices, one per input slot plus
  the leading constant-one slot.
- `BGGEncodingSampler`: c = s*[A_0 || A_1 || ...] - x tensor (s*G) + e,
  sliced per input; slot 0 encodes the constant 1.
"""

from __future__ import annotations

from ..matrix import PolyMatrix
from ..ring.params import RingParams
from ..ring.poly import Poly
from ..sampler import FinRingDist, GaussDist, HashSampler, UniformSampler
from .encoding import BggEncoding
from .public_key import BggPublicKey


class BGGPublicKeySampler:
    def __init__(self, hash_key: bytes, d: int, device="cuda"):
        if len(hash_key) != 32:
            raise ValueError("hash key must be 32 bytes")
        self.hash_key = hash_key
        self.d = d
        self._sampler = HashSampler(device)

    def sample(
        self, params: RingParams, tag: bytes, reveal_plaintexts: list[bool]
    ) -> list[BggPublicKey]:
        """Sample pubkeys for [const-one] + inputs."""
        columns = self.d * params.modulus_digits
        input_size = len(reveal_plaintexts) + 1
        all_matrix = self._sampler.sample_hash(
            params, self.hash_key, tag, self.d, columns * input_size, FinRingDist()
        )
        out = []
        for idx in range(input_size):
            reveal = True if idx == 0 else reveal_plaintexts[idx - 1]
            out.append(
                BggPublicKey(all_matrix.slice_columns(columns * idx, columns * (idx + 1)), reveal)
            )
        return out


class BGGEncodingSampler:
    """Encodings under the secret row s = secrets (1 x d); the error is zero
    when `gauss_sigma` is None, else a table-Gaussian draw from `seed`. The
    device is the secrets'."""

    def __init__(
        self,
        params: RingParams,
        secrets: list[Poly],
        gauss_sigma: float | None = None,
        seed: int | None = None,
    ):
        self.secret_vec = PolyMatrix.from_poly_row(params, secrets)  # 1 x d
        self.gauss_sigma = gauss_sigma
        self.device = self.secret_vec.data.device
        self._uniform = UniformSampler(seed, self.device)

    def sample(
        self,
        params: RingParams,
        public_keys: list[BggPublicKey],
        plaintexts: list[Poly],
    ) -> list[BggEncoding]:
        """public_keys must include the leading const-one key (len = 1 + #plaintexts)."""
        packed_input_size = 1 + len(plaintexts)
        if len(public_keys) != packed_input_size:
            raise ValueError(f"{len(public_keys)} public keys for {len(plaintexts)} plaintexts + 1")
        all_plaintexts = [Poly.one(params, self.device)] + list(plaintexts)
        d = self.secret_vec.ncol
        m = d * params.modulus_digits
        columns = m * packed_input_size
        if self.gauss_sigma is None:
            error = PolyMatrix.zero(params, 1, columns, device=self.device)
        else:
            error = self._uniform.sample_uniform(params, 1, columns, GaussDist(self.gauss_sigma))
        all_pk = public_keys[0].matrix.concat_columns([pk.matrix for pk in public_keys[1:]])
        first_term = self.secret_vec @ all_pk  # 1 x columns
        s_g = self.secret_vec @ PolyMatrix.gadget_matrix(params, d, self.device)  # 1 x m
        encoded_row = PolyMatrix.from_poly_row(params, all_plaintexts)  # 1 x packed
        second_term = encoded_row.tensor(s_g)  # 1 x columns
        all_vector = first_term - second_term + error
        out = []
        for idx, pt in enumerate(all_plaintexts):
            vector = all_vector.slice_columns(m * idx, m * (idx + 1))
            pk = public_keys[idx]
            out.append(BggEncoding(vector, pk, pt if pk.reveal_plaintext else None))
        return out
