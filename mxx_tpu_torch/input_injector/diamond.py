"""Diamond iO input insertion: trapdoor-chain state machine over input digits.

The port's counterpart of `mxx_tpu/input_injector/diamond.py`, with the same
artifact names and bytes, so either package reads what the other wrote.
Preprocessing builds, per level l (1..=input_count), digit value, and branch
state, the transition preimage
    K_{l,digit,state} = B_{l-1,src}^{-1}( S * B_{l,state} + e )
with 2x2 BLOCK selectors S over a per-(level,digit) ternary d x d mask S'
(d = secret_size; state 0 keeps the k payload: [[S',0],[0,I]]; newly-born bit
branches embed one digit bit: [[S', x*S'],[0,0]] applied to the empty-prefix
state; existing bit branches propagate: [[S',0],[0,S']]). The empty-prefix
seed is
    p_eps = [s_eps, k*e_1] * B_{0,0} + e,
with s_eps a 1 x d ternary row and the payload k riding the first coordinate
of the second block. Online evaluation threads the chosen digits through the
stored K chain; the final states encode [sigma, k*e_1] (state 0) and
[sigma, bit*sigma] (bit branches) under the final bases
(sigma = s_eps * prod of chosen masks, a 1 x d row).

Every matrix lives on the injector's `device`; artifacts read back land
there too. The transitions of one source state are ONE batched preimage
call on that device (the JAX package's mesh sharding of that call is not
ported: a `mesh` raises).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch

from ..matrix import PolyMatrix
from ..ring.poly import Poly
from ..sampler import GaussDist, TernaryDist, Trapdoor, TrapdoorSampler, UniformSampler
from ..utils.tracing import span

DIAMOND_PREFIX_SIZE = 2
DIAMOND_SECRET_SIZE = 1


@dataclass
class DiamondInjectorPreprocessOut:
    final_trapdoors: list[Trapdoor]
    final_pub_matrices: list[PolyMatrix]

    @property
    def final_state_count(self) -> int:
        return len(self.final_pub_matrices)

    def final_checkpoint(self, state_idx: int):
        return self.final_trapdoors[state_idx], self.final_pub_matrices[state_idx]


class DiamondInjector:
    def __init__(self, params, input_count: int, base: int, batch_bits: int,
                 trapdoor_sigma: float, error_sigma: float, seed: int | None = None,
                 mesh=None, secret_size: int = DIAMOND_SECRET_SIZE, device="cuda"):
        if base < (1 << batch_bits):
            raise ValueError("base must be at least 2^batch_bits")
        if mesh is not None:
            raise NotImplementedError(
                "DiamondInjector runs on one device; sharding its preimages over a mesh is "
                "not ported (ROADMAP Queue 1)")
        self.params = params
        self.input_count = input_count
        self.base = base
        self.batch_bits = batch_bits
        self.trapdoor_sigma = trapdoor_sigma
        self.error_sigma = error_sigma
        self.secret_size = secret_size
        self.device = torch.device(device)
        # the same seed for both, as in the JAX package: its streams depend on it
        self._uniform = UniformSampler(seed, self.device)
        self._trap = TrapdoorSampler(params, trapdoor_sigma, seed=seed, device=self.device)

    # ------------------------------------------------------------- geometry

    @property
    def state_row_size(self) -> int:
        return DIAMOND_PREFIX_SIZE * self.secret_size

    def state_col_size(self) -> int:
        return self.state_row_size * (self.params.modulus_digits + 2)

    def state_count_at_level(self, level: int) -> int:
        return 1 + level * self.batch_bits

    def first_bit_state_idx_for_level(self, level: int) -> int:
        return 1 + (level - 1) * self.batch_bits

    def bit_state_idx(self, input_idx: int, bit_idx: int) -> int:
        return 1 + input_idx * self.batch_bits + bit_idx

    def new_bit_idx_for_state(self, level: int, state_idx: int) -> int | None:
        first = self.first_bit_state_idx_for_level(level)
        if first <= state_idx < first + self.batch_bits:
            return state_idx - first
        return None

    def transition_source_state_idx(self, level: int, state_idx: int) -> int:
        return 0 if self.new_bit_idx_for_state(level, state_idx) is not None else state_idx

    def digit_bit_value(self, digit_value: int, bit_idx: int) -> int:
        return (digit_value >> bit_idx) & 1

    # ---------------------------------------------------------- persistence

    def _mpath(self, d, mid):
        return Path(d) / f"{mid}.matrixbin"

    def _bpath(self, d, bid):
        return Path(d) / f"{bid}.bytesbin"

    def _write_matrix(self, d, mid, m: PolyMatrix):
        self._mpath(d, mid).write_bytes(m.to_compact_bytes())

    def read_matrix(self, d, mid) -> PolyMatrix:
        return PolyMatrix.from_compact_bytes(self.params, self._mpath(d, mid).read_bytes(),
                                             self.device)

    def secret_epsilon_id(self):
        return "diamond_secret_epsilon_tensor"

    def digit_secret_id(self, level, digit_value):
        return f"diamond_secret_tensor_{level}_{digit_value}"

    def b_matrix_id(self, level, state_idx):
        return f"diamond_b_tensor_{level}_{state_idx}"

    def k_id(self, level, digit_value, state_idx):
        return f"diamond_transition_tensor_{level}_{digit_value}_{state_idx}"

    def p_epsilon_id(self):
        return "diamond_initial_state_tensor"

    # ------------------------------------------------------------- sampling

    def _zero(self, nrow, ncol) -> PolyMatrix:
        return PolyMatrix.zero(self.params, nrow, ncol, device=self.device)

    def _error(self, nrow, ncol) -> PolyMatrix:
        if self.error_sigma == 0.0:
            return self._zero(nrow, ncol)
        return self._uniform.sample_uniform(self.params, nrow, ncol, GaussDist(self.error_sigma))

    def _load_or_sample_secret(self, d, mid, nrow: int, ncol: int) -> PolyMatrix:
        if self._mpath(d, mid).exists():
            return self.read_matrix(d, mid)
        s = self._uniform.sample_uniform(self.params, nrow, ncol, TernaryDist())
        self._write_matrix(d, mid, s)
        return s

    def _load_or_sample_b(self, d, level, state_idx):
        mid = self.b_matrix_id(level, state_idx)
        tid = mid + "_trapdoor"
        if self._mpath(d, mid).exists() and self._bpath(d, tid).exists():
            td = Trapdoor.from_compact_bytes(self.params, self._bpath(d, tid).read_bytes(),
                                             self.device)
            return td, self.read_matrix(d, mid)
        td, b = self._trap.trapdoor(self.params, self.state_row_size)
        self._bpath(d, tid).write_bytes(td.to_compact_bytes())
        self._write_matrix(d, mid, b)
        return td, b

    # ------------------------------------------------------------ selectors
    # 2x2 BLOCK selectors over the d x d ternary mask S (d = secret_size)

    def _zero_block(self) -> PolyMatrix:
        return self._zero(self.secret_size, self.secret_size)

    def _transition_selector(self, mask: PolyMatrix) -> PolyMatrix:
        z = self._zero_block()
        return mask.concat_columns([z]).concat_rows([z.concat_columns([mask])])

    def _k_transition_selector(self, mask: PolyMatrix) -> PolyMatrix:
        z = self._zero_block()
        eye = PolyMatrix.identity(self.params, self.secret_size, device=self.device)
        return mask.concat_columns([z]).concat_rows([z.concat_columns([eye])])

    def _special_transition_selector(self, bit_value: int, mask: PolyMatrix) -> PolyMatrix:
        z = self._zero_block()
        xs = mask.mul_poly_scalar(Poly.const(self.params, bit_value, self.device))
        return mask.concat_columns([xs]).concat_rows([z.concat_columns([z])])

    # ------------------------------------------------------------ preprocess

    def preprocess(self, dir_path, k: Poly) -> DiamondInjectorPreprocessOut:
        with span("diamond_injector.preprocess", input_count=self.input_count,
                  base=self.base, batch_bits=self.batch_bits):
            return self._preprocess(dir_path, k)

    def _preprocess(self, dir_path, k: Poly) -> DiamondInjectorPreprocessOut:
        d = Path(dir_path)
        d.mkdir(parents=True, exist_ok=True)
        (d / "diamond_injector_metadata.json").write_text(
            json.dumps(
                {
                    "input_count": self.input_count,
                    "base": self.base,
                    "batch_bits": self.batch_bits,
                }
            )
        )
        self._bpath(d, "diamond_k_plaintext").write_bytes(k.to_compact_bytes())

        b_checkpoints, trapdoors = [], []
        for level in range(self.input_count + 1):
            level_b, level_t = [], []
            for state_idx in range(self.state_count_at_level(level)):
                td, b = self._load_or_sample_b(d, level, state_idx)
                level_t.append(td)
                level_b.append(b)
            trapdoors.append(level_t)
            b_checkpoints.append(level_b)

        ds = self.secret_size
        secret_eps = self._load_or_sample_secret(d, self.secret_epsilon_id(), 1, ds)
        if not self._mpath(d, self.p_epsilon_id()).exists():
            # [s_eps | k*e_1]: the payload rides the first coordinate of the
            # second block
            k_row = [k] + [Poly.zero(self.params, device=self.device)] * (ds - 1)
            selector = secret_eps.concat_columns(
                [PolyMatrix.from_poly_row(self.params, k_row)]
            )
            p_eps = selector @ b_checkpoints[0][0] + self._error(1, self.state_col_size())
            self._write_matrix(d, self.p_epsilon_id(), p_eps)

        for level in range(1, self.input_count + 1):
            # transitions sharing a source state share its trapdoor: group by
            # src and sample each group as ONE batched preimage call
            pending: dict[int, list[tuple[str, PolyMatrix]]] = {}
            for digit_value in range(self.base):
                mask = self._load_or_sample_secret(
                    d, self.digit_secret_id(level, digit_value), ds, ds
                )
                for state_idx in range(self.state_count_at_level(level)):
                    kid = self.k_id(level, digit_value, state_idx)
                    if self._mpath(d, kid).exists():
                        continue
                    bit_idx = self.new_bit_idx_for_state(level, state_idx)
                    if bit_idx is not None:
                        sel = self._special_transition_selector(
                            self.digit_bit_value(digit_value, bit_idx), mask
                        )
                    elif state_idx == 0:
                        sel = self._k_transition_selector(mask)
                    else:
                        sel = self._transition_selector(mask)
                    src = self.transition_source_state_idx(level, state_idx)
                    err = self._error(self.state_row_size, self.state_col_size())
                    if src == 0 and self.error_sigma > 0.0:
                        # Transitions sourced from the k-carrying state: the
                        # online product [sigma, k] @ e_target multiplies the
                        # bottom error rows by the payload k, fatal when k is
                        # q/2-scaled (DiamondWE: (q/2)*e mod q flips decode by
                        # parity). Those rows of the target are [0, I] @ B or
                        # [0, 0] @ B, public values, so the error there
                        # protects nothing; zero it by construction.
                        err = err.slice_rows(0, self.secret_size).concat_rows([
                            self._zero(self.secret_size, self.state_col_size())
                        ])
                    target = sel @ b_checkpoints[level][state_idx] + err
                    pending.setdefault(src, []).append((kid, target))
            for src, items in pending.items():
                preimages = self._trap.preimage_batched_chunked(
                    self.params,
                    trapdoors[level - 1][src],
                    b_checkpoints[level - 1][src],
                    [t for _, t in items],
                )
                for (kid, _), k_mat in zip(items, preimages):
                    self._write_matrix(d, kid, k_mat)
        return DiamondInjectorPreprocessOut(trapdoors[-1], b_checkpoints[-1])

    def read_preprocessed_k(self, dir_path) -> Poly:
        raw = self._bpath(dir_path, "diamond_k_plaintext").read_bytes()
        return Poly.from_compact_bytes(self.params, raw, self.device)

    def debug_final_secret_matrix(self, dir_path, input_digits: list[int]) -> PolyMatrix:
        """TEST-ONLY: sigma_final = s_eps * prod(level masks) from the
        persisted secrets: the 1 x d secret row sigma such that final wires
        satisfy c = sigma (A - x G)."""
        d = Path(dir_path)
        sigma = self.read_matrix(d, self.secret_epsilon_id())  # 1 x d
        for digit_idx, digit_value in enumerate(input_digits):
            mask = self.read_matrix(
                d, self.digit_secret_id(digit_idx + 1, digit_value)
            )  # d x d
            sigma = sigma @ mask
        return sigma

    # ------------------------------------------------------------ online

    def online_eval(self, dir_path, preprocess_out: DiamondInjectorPreprocessOut,
                    input_digits: list[int]) -> list[PolyMatrix]:
        with span("diamond_injector.online_eval", digits=len(input_digits)):
            return self._online_eval(dir_path, preprocess_out, input_digits)

    def _online_eval(self, dir_path, preprocess_out: DiamondInjectorPreprocessOut,
                     input_digits: list[int]) -> list[PolyMatrix]:
        if len(input_digits) != self.input_count:
            raise ValueError(f"{len(input_digits)} digits for {self.input_count} inputs")
        if not all(0 <= v < self.base for v in input_digits):
            raise ValueError(f"digits {input_digits} out of range for base {self.base}")
        d = Path(dir_path)
        states = [self.read_matrix(d, self.p_epsilon_id())]
        for digit_idx, digit_value in enumerate(input_digits):
            level = digit_idx + 1
            prev = states
            prev_p0 = prev[0]
            states = []
            for state_idx in range(self.state_count_at_level(level)):
                lhs = (
                    prev_p0
                    if self.new_bit_idx_for_state(level, state_idx) is not None
                    else prev[state_idx]
                )
                k_mat = self.read_matrix(d, self.k_id(level, digit_value, state_idx))
                states.append(lhs @ k_mat)
        return states
