"""WEE25 matrix commitment with trapdoor-sampled openings.

The port's counterpart of `mxx_tpu/commit/wee25.py`. Structure:

- Public params: trapdoor pair (B, T) with B in M^{d x m_b}; Gaussian
  T_bottom in M^{m_b x j2m} (j2m = l*log_q cols, l = tree_base*m_b); and for
  every digit block b = (msg column g, digit row r) a preimage
      T_top_b = B^{-1}( G J_b - W_b T_bottom ),
  where W_b = Hash(b"wee25_w_block_" || b) and J_b = G^{-1}(Y_b) with
  Y_b[:, (g', s)] = g_s * g_k * e_i [[g' == g]] (r = i*log_q + k) — chosen so
  that for the digit vector a of any message, sum_b (G J_b) a_b has columns
  X[:, (g, s)] = g_s * msg[:, g].
- Base commit: C = sum_b W_b a_b. Base opening: Z = sum_b T_top_b a_b, giving
  the binding relation  C * T_bottom = X - B * Z.
- Tree: tree_base children commit/open recursively; the opening composes as
  z = z_parent * G^{-1}(V_child) + z_child, and verification is
      C * V = msg_block - B * z  with the recursive verifier V.

Device form: the l*m_g blocks W_b are drawn once per (params, key, device)
in one hash batch and kept as one tensor, and the T_top_b are kept stacked
by rows in one matrix, so a base commit or opening is one digit-weighted sum
over the blocks' tensor instead of l*m_g hash draws and matrix products.
The sums are exact mod q, so every commitment, opening and verifier equals
the JAX package's bit for bit on the same public params. Everything lives
on the device of B.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..matrix import PolyMatrix
from ..ring.poly import EVAL, residue_planes_from_ints
from ..sampler import FinRingDist, GaussDist, HashSampler, TrapdoorSampler, UniformSampler

WEE25_PUBLIC_PARAMS_PREFIX = "wee25_public_params"

@dataclass
class Wee25PublicParams:
    b: PolyMatrix
    t_bottom: PolyMatrix  # m_b x j2m
    t_top: PolyMatrix  # the l*m_g preimages (m_b x j2m each) stacked: block b is rows b*m_b..
    hash_key: bytes

    def t_top_block(self, block_idx: int) -> PolyMatrix:
        m_b = self.b.ncol
        return self.t_top.slice_rows(block_idx * m_b, (block_idx + 1) * m_b)


class MsgMatrixStream:
    """Lazy window over message blocks (reference wee25.rs:48-110)."""

    def __init__(self, length: int, reader, offset: int = 0):
        self.reader = reader
        self.offset = offset
        self.length = length

    @staticmethod
    def from_blocks(blocks: list[PolyMatrix]) -> "MsgMatrixStream":
        return MsgMatrixStream(len(blocks), lambda rng: blocks[rng.start : rng.stop])

    def __len__(self):
        return self.length

    def slice(self, start: int, end: int) -> "MsgMatrixStream":
        return MsgMatrixStream(end - start, self.reader, self.offset + start)

    def read(self, start: int, end: int) -> list[PolyMatrix]:
        return self.reader(range(self.offset + start, self.offset + end))


def _w_tag(block_idx: int) -> bytes:
    return b"wee25_w_block_" + block_idx.to_bytes(8, "little")


def _digit_sum(blocks: torch.Tensor, digits: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """sum_b blocks[:, b] * digits[:, b] mod q (EVAL form): blocks int64[L, B,
    r, c, n] (any strides), digits int64[L, B, n] -> int64[L, r, c, n]."""
    L, B = blocks.shape[:2]
    qb = q.reshape(L, 1, 1, 1)
    acc = torch.zeros((L,) + tuple(blocks.shape[2:]), dtype=torch.int64, device=blocks.device)
    for b in range(B):
        acc += blocks[:, b] * digits[:, b, None, None, :]
        acc.remainder_(qb)
    return acc


class Wee25Commit:
    def __init__(self, secret_size: int, tree_base: int, m_b: int, m_g: int,
                 trapdoor_sigma: float):
        self.d = secret_size
        self.tree_base = tree_base
        self.m_b = m_b
        self.m_g = m_g
        self.trapdoor_sigma = trapdoor_sigma
        self._w_cache: dict = {}

    @property
    def l(self) -> int:
        return self.tree_base * self.m_b

    def _log_q(self, params) -> int:
        return self.m_g // self.d

    def _j2m_cols(self, params) -> int:
        return self.l * self._log_q(params)

    def checkpoint_prefix(self, params, hash_key: bytes) -> str:
        kd = hashlib.sha256(hash_key).hexdigest()[:16]
        return (
            f"{WEE25_PUBLIC_PARAMS_PREFIX}_n{params.n}_L{params.crt_depth}"
            f"_d{self.d}_tb{self.tree_base}_key{kd}"
        )

    def _w_blocks(self, params, hash_key: bytes, device) -> torch.Tensor:
        """Every W_b (EVAL form) as int64[L, l*m_g, d, m_b, n]: one hash batch,
        equal block for block to one draw per tag, kept per (params, key,
        device)."""
        device = torch.device(device)
        key = (params, hash_key, str(device))
        if key not in self._w_cache:
            tags = [_w_tag(b) for b in range(self.l * self.m_g)]
            mats = HashSampler(device).sample_hash_batch(params, hash_key, tags, self.d, self.m_b,
                                                         FinRingDist(), eval_form=True)
            self._w_cache[key] = torch.stack([m.data for m in mats], dim=1)
        return self._w_cache[key]

    def _gadget_row_values(self, params) -> list[int]:
        return [params.reconstruct_coeff(r) for r in params.np_gadget_res]

    def _t_top_targets(self, params, w: torch.Tensor, t_bottom: PolyMatrix) -> PolyMatrix:
        """Every block's target G J_b - W_b T_bottom, stacked by rows
        ([l*m_g*d, j2m], EVAL). G G^{-1}(Y) = Y exactly, so G J_b is Y_b: the
        constants g_s g_k at row i, columns g*log_q + s."""
        log_q = self._log_q(params)
        j2m = self._j2m_cols(params)
        blocks = self.l * self.m_g
        q = params.modulus
        g_vals = self._gadget_row_values(params)
        y = np.zeros((blocks, self.d, j2m), dtype=object)
        for block_idx in range(blocks):
            g_col, r = divmod(block_idx, self.m_g)
            i_row, k_dig = divmod(r, log_q)
            for s in range(log_q):
                y[block_idx, i_row, g_col * log_q + s] = g_vals[s] * g_vals[k_dig] % q
        planes = residue_planes_from_ints(params, y.reshape(-1).tolist()).astype(np.int64)
        device = w.device
        L, n = params.crt_depth, params.n
        y_eval = torch.from_numpy(planes).to(device).reshape(L, blocks * self.d, j2m, 1)
        y_mat = PolyMatrix(y_eval.expand(L, blocks * self.d, j2m, n), EVAL, params)
        w_rows = PolyMatrix(w.reshape(L, blocks * self.d, self.m_b, n), EVAL, params)
        return y_mat - w_rows @ t_bottom

    def sample_public_params(self, params, hash_key: bytes, seed: int | None = None,
                             mesh=None, device="cuda") -> Wee25PublicParams:
        """Sample (B, T), T_bottom, and all T_top preimages (wee25.rs:494-760).
        Every T_top preimage shares (B, T): they go to the preimage sampler as
        one chunked batch of requests, sharded over `mesh`'s col axis if given."""
        log_q = self._log_q(params)
        if log_q != params.modulus_digits:
            raise ValueError(f"m_g = {self.m_g} must equal d * modulus_digits = "
                             f"{self.d * params.modulus_digits}")
        j2m = self._j2m_cols(params)
        ts = TrapdoorSampler(params, self.trapdoor_sigma, seed=seed, device=device)
        trapdoor, b = ts.trapdoor(params, self.d)
        if b.ncol != self.m_b:
            raise ValueError(f"the trapdoor's B has {b.ncol} columns, m_b is {self.m_b}")
        t_bottom = UniformSampler(seed, device).sample_uniform(
            params, self.m_b, j2m, GaussDist(self.trapdoor_sigma)
        )
        targets = self._t_top_targets(params, self._w_blocks(params, hash_key, device), t_bottom)
        requests = [targets.slice_rows(i * self.d, (i + 1) * self.d)
                    for i in range(self.l * self.m_g)]
        preimages = ts.preimage_batched_chunked(params, trapdoor, b, requests, mesh=mesh)
        del requests, targets
        t_top = torch.empty((params.crt_depth, len(preimages) * self.m_b, j2m, params.n),
                            dtype=torch.int64, device=b.data.device)
        for i, pre in enumerate(preimages):
            t_top[:, i * self.m_b : (i + 1) * self.m_b] = pre.to_eval().data
        return Wee25PublicParams(b, t_bottom, PolyMatrix(t_top, EVAL, params), hash_key)

    # ------------------------------------------------------------- commit

    def _digits(self, msg: PolyMatrix) -> torch.Tensor:
        """The digit polys a_b of msg (EVAL), block b = j*m_g + r being row r
        of G^{-1}(column j): int64[L, l*m_g, n]."""
        dec = msg.decompose().to_eval().data  # [L, m_g, l, n]
        L, _, _, n = dec.shape
        return dec.transpose(1, 2).reshape(L, self.l * self.m_g, n)

    def commit_base(self, params, msg: PolyMatrix, pp: Wee25PublicParams) -> PolyMatrix:
        if msg.shape != (self.d, self.l):
            raise ValueError(f"message block {msg.shape} is not ({self.d}, {self.l})")
        device = pp.b.data.device
        w = self._w_blocks(params, pp.hash_key, device)
        q = params.tables(device).moduli
        return PolyMatrix(_digit_sum(w, self._digits(msg), q), EVAL, params)

    def commit(self, params, msg_stream: MsgMatrixStream, pp: Wee25PublicParams
               ) -> tuple[PolyMatrix, dict]:
        """Tree commit; returns (commitment, cache of intermediate nodes)."""
        cache: dict[tuple[int, int], PolyMatrix] = {}
        c = self._commit_recursive(params, msg_stream, pp, cache)
        return c, cache

    def _commit_recursive(self, params, stream, pp, cache):
        cols = len(stream)
        if cols == self.tree_base:
            parts = stream.read(0, cols)
            msg = parts[0].concat_columns(parts[1:])
            c = self.commit_base(params, msg, pp)
            cache[(stream.offset, cols)] = c
            return c
        if cols % self.tree_base:
            raise ValueError(f"{cols} message blocks are not a power of {self.tree_base}")
        child = cols // self.tree_base
        commits = [
            self._commit_recursive(params, stream.slice(i * child, (i + 1) * child), pp, cache)
            for i in range(self.tree_base)
        ]
        combined = commits[0].concat_columns(commits[1:])
        c = self.commit_base(params, combined, pp)
        cache[(stream.offset, cols)] = c
        return c

    # --------------------------------------------------------------- open

    def open_base(self, params, msg: PolyMatrix, col_idx: int, pp, is_leaf: bool
                  ) -> PolyMatrix:
        """Z slice for block col_idx: columns [col_idx*m_b*log_q, ...)."""
        log_q = self._log_q(params)
        slice_width = self.m_b * log_q
        col_start = slice_width * col_idx
        t = pp.t_top.to_eval().data
        L, _, j2m, n = t.shape
        blocks = t.reshape(L, self.l * self.m_g, self.m_b, j2m, n)
        device = t.device
        acc = PolyMatrix(
            _digit_sum(blocks[:, :, :, col_start : col_start + slice_width], self._digits(msg),
                       params.tables(device).moduli),
            EVAL, params,
        )
        if is_leaf:
            return acc @ PolyMatrix.identity(params, self.m_b, device=device).decompose()
        return acc

    def open(self, params, msg_stream: MsgMatrixStream, col_range, pp,
             cache: dict) -> PolyMatrix:
        cols = len(msg_stream)
        col_range = col_range if col_range is not None else range(cols)
        outs = [
            self._open_recursive(params, msg_stream, ci, pp, cache) for ci in col_range
        ]
        return outs[0].concat_columns(outs[1:])

    def _open_recursive(self, params, stream, col_idx, pp, cache):
        cols = len(stream)
        if cols == self.tree_base:
            parts = stream.read(0, cols)
            msg = parts[0].concat_columns(parts[1:])
            return self.open_base(params, msg, col_idx, pp, True)
        child = cols // self.tree_base
        child_idx = col_idx % child
        sibling = col_idx // child
        commits = [
            cache[(stream.offset + i * child, child)] for i in range(self.tree_base)
        ]
        commits_msg = commits[0].concat_columns(commits[1:])
        z_prime = self.open_base(params, commits_msg, sibling, pp, False)
        z_child = self._open_recursive(
            params, stream.slice(child * sibling, child * (sibling + 1)), child_idx, pp, cache
        )
        verifier = self._verifier_recursive(params, pp, child, child_idx)
        return z_prime @ verifier.decompose() + z_child

    # ----------------------------------------------------------- verifier

    def _verifier_base(self, params, pp, is_leaf: bool) -> PolyMatrix:
        if is_leaf:
            device = pp.t_bottom.data.device
            return pp.t_bottom @ PolyMatrix.identity(params, self.l, device=device).decompose()
        return pp.t_bottom

    def _verifier_recursive(self, params, pp, cols, col_idx) -> PolyMatrix:
        if cols == self.tree_base:
            base_last = self._verifier_base(params, pp, True)
            return base_last.slice_columns(self.m_b * col_idx, self.m_b * (col_idx + 1))
        child = cols // self.tree_base
        child_idx = col_idx % child
        sibling = col_idx // child
        child_col = self._verifier_recursive(params, pp, child, child_idx)
        base = self._verifier_base(params, pp, False)
        slice_width = base.ncol // self.tree_base
        sl = base.slice_columns(slice_width * sibling, slice_width * (sibling + 1))
        return sl @ child_col.decompose()

    def verifier(self, params, cols, col_range, pp) -> PolyMatrix:
        col_range = col_range if col_range is not None else range(cols)
        mats = [self._verifier_recursive(params, pp, cols, ci) for ci in col_range]
        return mats[0].concat_columns(mats[1:])

    def verify(self, params, msg: PolyMatrix, commit: PolyMatrix, opening: PolyMatrix,
               col_range, pp) -> bool:
        msg_size = msg.ncol // self.m_b
        v = self.verifier(params, msg_size, col_range, pp)
        target = (
            msg
            if col_range is None
            else msg.slice_columns(self.m_b * col_range.start, self.m_b * col_range.stop)
        )
        lhs = commit @ v
        rhs = target - pp.b @ opening
        return lhs == rhs
