"""MP12 gadget trapdoor generation and preimage sampling.

The port's counterpart of `mxx_tpu/sampler/trapdoor.py`:

- Trapdoor: R, E ~ D_{Z,sigma}^{d x dk}; public A = [A_bar | I | G - (A_bar R + E)].
- Preimage of target U: sample perturbation p_hat, compute the perturbed
  syndrome V = U - A p_hat, solve G z = V on the G-lattice, then output
  [p1 + R z ; p2 + E z ; p3 + z] so that A x = U exactly.

Constants: SPECTRAL_CONSTANT = 1.8, c = (b+1) sigma,
s = 1.8 (b+1) sigma^2 (sqrt(d n k) + sqrt(2n) + 4.7).

- G-lattice solve: per-tower Genise-Micciancio randomized coset sampling:
  continuous perturbation through the bidiagonal factor (l/h/c_vec), then a
  digit-wise discrete Gaussian along the Lambda^perp(g_t) basis
  [[b,..,q_0],[-1,b,..,q_1],..,[0,..,-1,q_{k'-1}]] per CRT tower.
- Perturbation: p2 ~ D_{Z, sqrt(s^2-c^2)}; p1 sampled with the MP12
  conditional covariance s^2 I - c^2 [[RR^T,RE^T],[ER^T,EE^T]] per
  coefficient slot via a downward LDL elimination and mean
  -c^2/(s^2-c^2) [R;E] p2.

Both samplers are pure functions of their standard normals (`_gauss_samp_gq`,
`_sample_p1_ints`): the caller draws the normals from the keyed ChaCha20
stream and passes them in. Integer rounding uses the Peikert rounded-normal
in place of a per-slot Karney loop (OpenFHE's PEIKERT mode) — sequential
rejection loops don't map to data-parallel hardware.

Peikert-vs-Karney statistical distance. The reference switches to Karney's
exact sampler above KARNEY_THRESHOLD because its inversion TABLE grows
linearly in sigma; this build replaces Karney with two Peikert-style paths
whose distance from the exact D_{Z,sigma} is quantified per path:

- sigma <= 300 (inversion table, core.gauss_table, acc = 5e-32): tail cut at
  t*sigma with t = sqrt(-2 ln 5e-32) = 12.0, so truncation mass <= 5e-32
  ~= 2^-104; u64-quantized CDF thresholds add <= (2*ceil(12 sigma)+1) * 2^-64
  per sample (at sigma = 4.578: 111 * 2^-64 ~= 2^-57). Identical in shape to
  the reference's own small-sigma inversion path (same acc constant).
- sigma > 300 (rounded continuous normal): the algorithmic gap between the
  rounded Gaussian and D_{Z,sigma} is <= 2*eps for any eps with the smoothing
  parameter eta_eps(Z) <= sigma; eta_{2^-128}(Z) ~= 5.4 << 300, and solving
  for eps at sigma = 300 gives eps ~= 2*exp(-pi*300^2) ~= 2^-408000 —
  the Peikert-vs-Karney DISTRIBUTIONAL gap is beyond-cryptographic.
  What remains is float64 quantization of the underlying normal draw
  (~2^-53 relative density error per sample, the same floor OpenFHE's
  long-double Karney loop has): over the ~2^30 Gaussians of one
  production-scale preimage the union-bound distinguishing advantage is
  ~2^-23 per preimage call against an adversary with exact-real reference
  samples — comfortably below the >= 100-bit protocol security level the
  parameter search targets, and identical in kind (float rounding, not
  algorithm) to the reference's own floating-point perturbation chain.

Batched entry points: `preimage_batched_sharded` concatenates many
requests' columns into one preimage call, or, given a mesh, splits those
columns over its `col` axis, one preimage body per shard on the shard's
device; `preimage_batched_chunked` runs it in request chunks and rehydrates
offloaded targets chunk by chunk, and `preimage_extend` solves [B | C] x = U.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..matrix import PolyMatrix
from ..matrix.offload import OffloadedMatrix
from ..parallel.mesh import COL_AXIS
from ..ring.params import RingParams
from ..ring.poly import COEFF, EVAL
from ..utils.numth import modinv
from . import chacha, core
from .dist import FinRingDist, GaussDist
from .samplers import UniformSampler

SPECTRAL_CONSTANT = 1.8


def preimage_c(base: int, sigma: float) -> float:
    return (base + 1.0) * sigma


def preimage_smoothing_parameter(base: int, sigma: float, d: int, n: int, k: int) -> float:
    return (
        SPECTRAL_CONSTANT
        * (base + 1.0)
        * sigma
        * sigma
        * (math.sqrt(d * n * k) + math.sqrt(2 * n) + 4.7)
    )


@dataclass(frozen=True)
class Trapdoor:
    """Trapdoor (R, E) and its Gram blocks."""

    r: PolyMatrix
    e: PolyMatrix

    @property
    def re(self) -> PolyMatrix:
        return self.r.concat_rows([self.e])

    def a_mat(self) -> PolyMatrix:
        return self.r @ self.r.transpose()

    def b_mat(self) -> PolyMatrix:
        return self.r @ self.e.transpose()

    def d_mat(self) -> PolyMatrix:
        return self.e @ self.e.transpose()

    def to_compact_bytes(self) -> bytes:
        """R and E as compact bytes, each after its 8-byte little-endian length
        (the JAX package's bytes)."""
        out = b""
        for p in (self.r.to_compact_bytes(), self.e.to_compact_bytes()):
            out += len(p).to_bytes(8, "little") + p
        return out

    @staticmethod
    def from_compact_bytes(params: RingParams, raw: bytes, device="cuda") -> "Trapdoor":
        mats = []
        off = 0
        for _ in range(2):
            ln = int.from_bytes(raw[off : off + 8], "little")
            off += 8
            mats.append(PolyMatrix.from_compact_bytes(params, raw[off : off + ln], device))
            off += ln
        return Trapdoor(r=mats[0], e=mats[1])


def _centered_lift_f64(mat: PolyMatrix) -> torch.Tensor:
    """Centered integer lift of a small-norm matrix as float64 [r, c, n].

    Exact while |value| < q0 q1 / 2 (or q0 / 2 single-tower) — always true for
    the trapdoor Gram blocks and [R;E] p2 at supported parameter scales."""
    params = mat.params
    data = mat.to_coeff().data
    q0 = int(params.moduli[0])
    if params.crt_depth == 1:
        x = data[0]
        return torch.where(x > q0 // 2, x - q0, x).to(torch.float64)
    q1 = int(params.moduli[1])
    inv = modinv(q0 % q1, q1)
    a0 = data[0]
    a1 = data[1]
    t = (a1 + q1 - a0 % q1) * inv % q1  # < 2^32 * 2^31: exact in int64
    x = a0 + q0 * t  # lift mod q0 q1 < 2^62
    m = q0 * q1
    return torch.where(x > m // 2, x - m, x).to(torch.float64)


def _matrix_from_signed(params: RingParams, vals: torch.Tensor) -> PolyMatrix:
    """Small signed integer coefficients [r, c, n] (integer-valued floats
    allowed) -> PolyMatrix (COEFF), the value reduced into every CRT tower."""
    q = params.tables(vals.device).moduli
    return PolyMatrix(vals.to(torch.int64)[None] % q.view(-1, 1, 1, 1), COEFF, params)


def _gauss_samp_gq(coeff_data: torch.Tensor, normals: torch.Tensor, *, base_bits: int,
                   dpt: int, moduli: tuple, sigma: float, c: float) -> torch.Tensor:
    """Genise-Micciancio G-lattice coset sampler, per CRT tower.

    coeff_data: int64 [L, r, cols, n] tower residues of the syndrome;
    normals: float32 [2, L, dpt, r, cols, n] standard normals -> int64 digit
    rows [r * L * dpt, cols, n] with G z == syndrome (mod q) and z distributed
    as a width-~c discrete Gaussian over the coset. float32 chains as in the
    JAX package: digits ~ 30 b and z ~ b sigma stay f32-exact."""
    L, r, cols, n = coeff_data.shape
    b = 1 << base_bits
    bf = float(b)
    kf = float(dpt)
    tower_digits = []  # [L][dpt] int64 digit tensors
    for t in range(L):
        qt = int(moduli[t])
        v = coeff_data[t]
        if dpt == 1:
            # Lambda^perp(g=(1)) mod q_t is q_t Z: sample the coset directly.
            gn = normals[0, t, 0].to(torch.float64)
            vf = v.to(torch.float64)
            z = torch.round(-vf / qt + (c / qt) * gn)
            tower_digits.append([(vf + qt * z).to(torch.int64)])
            continue
        m_digits = [(qt >> (j * base_bits)) & (b - 1) for j in range(dpt)]
        v_int = [(v >> (j * base_bits)) & (b - 1) for j in range(dpt)]
        v_digits = [vi.to(torch.float32) for vi in v_int]
        l = [math.sqrt(bf * (1.0 + 1.0 / kf) + 1.0)] + [
            math.sqrt(bf * (1.0 + 1.0 / (kf - i))) for i in range(1, dpt)
        ]
        h = [0.0] + [math.sqrt(bf * (1.0 - 1.0 / (kf - (i - 1)))) for i in range(1, dpt)]
        c_vec = [m_digits[0] / bf]
        for i in range(1, dpt):
            c_vec.append((c_vec[i - 1] + m_digits[i]) / bf)
        zf = float(np.float32(sigma)) * normals[0, t]
        p = [l[i] * zf[i] + h[i + 1] * zf[i + 1] for i in range(dpt - 1)]
        p.append(h[dpt - 1] * zf[dpt - 1])
        a = [(v_digits[0] - p[0]) / bf]
        for i in range(1, dpt):
            a.append((a[i - 1] + v_digits[i] - p[i]) / bf)
        gn = normals[1, t]
        last = dpt - 1
        z_last = torch.round(-a[last] / c_vec[last] + (sigma / c_vec[last]) * gn[last])
        a = [a[i] + z_last * c_vec[i] for i in range(dpt)]
        z_int = [torch.round(-a[i] + sigma * gn[i]).to(torch.int64) for i in range(last)]
        z_int.append(z_last.to(torch.int64))
        digs = [b * z_int[0] + m_digits[0] * z_int[last] + v_int[0]]
        for i in range(1, last):
            digs.append(b * z_int[i] - z_int[i - 1] + m_digits[i] * z_int[last] + v_int[i])
        digs.append(m_digits[last] * z_int[last] - z_int[last - 1] + v_int[last])
        tower_digits.append(digs)
    stacked = torch.stack([d for digs in tower_digits for d in digs])  # [L*dpt, r, cols, n]
    return stacked.transpose(0, 1).reshape(r * L * dpt, cols, n)


def _build_p1_cov(a_c: np.ndarray, b_c: np.ndarray, d_c: np.ndarray,
                  s: float, c: float) -> np.ndarray:
    """Per-coefficient-slot covariance s^2 I - c^2 [[A,B],[B^T,D]] ->
    [n, 2d, 2d]."""
    d = a_c.shape[0]
    n = a_c.shape[2]
    m = 2 * d
    c2, s2 = c * c, s * s
    cov = np.zeros((n, m, m), dtype=np.float64)
    cov[:, :d, :d] = -c2 * a_c.transpose(2, 0, 1)
    cov[:, d:, d:] = -c2 * d_c.transpose(2, 0, 1)
    cov[:, :d, d:] = -c2 * b_c.transpose(2, 0, 1)
    cov[:, d:, :d] = -c2 * b_c.transpose(2, 1, 0)
    cov[:, np.arange(m), np.arange(m)] += s2
    return cov


def _p1_ldl_tables(cov: np.ndarray, fallback_var: float):
    """Downward LDL elimination (t = m-1 .. 0) per slot: conditional stddevs
    and mean-update coefficients."""
    n, m, _ = cov.shape
    cov = cov.copy()
    sqrt_var = np.empty((n, m), dtype=np.float64)
    upd = np.zeros((n, m, m), dtype=np.float64)
    for t in range(m - 1, -1, -1):
        var = cov[:, t, t].copy()
        var[var <= 1e-9] = fallback_var
        sqrt_var[:, t] = np.sqrt(var)
        if t == 0:
            break
        u = cov[:, :t, t] / var[:, None]
        upd[:, t, :t] = u
        cov[:, :t, :t] -= u[:, :, None] * u[:, None, :] * var[:, None, None]
    return sqrt_var, upd


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors, rounded once to float32 (the product is
    exact in float64). XLA fuses these multiply-adds, and at values ~s
    (~2^15) one rounding instead of two moves about 1 slot in 10^3 across a
    rounding boundary; rounding once keeps the integers the JAX package's."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def _sample_p1_ints(tp2c: torch.Tensor, sqrt_var: torch.Tensor, upd: torch.Tensor,
                    c_scale: float, normals: torch.Tensor) -> torch.Tensor:
    """Conditional integer Gaussian for p1: mean c_scale * [R;E] p2, then the
    sequential (within-slot) chain t = m-1 .. 0, from float32 standard normals
    [m, cols, n]. float32 suffices: the mean is ~s-scale (< 2^24)."""
    m = tp2c.shape[0]
    mean = float(np.float32(c_scale)) * tp2c.to(torch.float32)  # [m, cols, n]
    sqrt_var32 = sqrt_var.to(torch.float32)
    upd32 = upd.to(torch.float32)
    zs = [None] * m
    for t in range(m - 1, -1, -1):
        z = torch.round(_fma32(sqrt_var32[:, t][None, :], normals[t], mean[t]))
        zs[t] = z
        if t:
            delta = (z - mean[t])[None]  # [1, cols, n]
            upd_t = upd32[:, t, :t].T[:, None, :]  # [t, 1, n]
            mean = torch.cat([_fma32(upd_t, delta, mean[:t]), mean[t:]])
    return torch.stack(zs).to(torch.int64)


def _preimage_core(params: RingParams, key: torch.Tensor, target: PolyMatrix,
                   r_e: PolyMatrix, e_e: PolyMatrix, pub: PolyMatrix,
                   sqrt_var: torch.Tensor, upd: torch.Tensor, *, sigma: float, c: float,
                   s: float) -> PolyMatrix:
    """The whole preimage body: all matrices in EVAL form, every matrix
    transformed exactly once; draws come from `key`."""
    d = pub.nrow
    k = params.modulus_digits
    L, n, dpt = params.crt_depth, params.n, params.digits_per_tower
    sigma_large = math.sqrt(max(s * s - c * c, 1.0))
    c_scale = -(c * c) / max(s * s - c * c, 1.0)
    kp2, kp1, kg = chacha.split(key, 3)
    cols = target.ncol
    # p2 ~ rounded normal at sigma_large (Peikert branch, sigma > 300). f32
    # rounding above 2^24 coarsens support to multiples of 2^(e-24): still
    # exact integers, relative granularity ~1e-7 of sigma_large.
    gn = chacha.normal(kp2, (d * k, cols, n), torch.float32)
    p2_int = torch.round(gn * float(np.float32(sigma_large)))
    p2e = _matrix_from_signed(params, p2_int).to_eval()
    tp2c = _centered_lift_f64(r_e.concat_rows([e_e]) @ p2e)
    p1_normals = chacha.normal(kp1, tuple(tp2c.shape), torch.float32)
    p1i = _sample_p1_ints(tp2c, sqrt_var, upd, c_scale, p1_normals)
    p1e = _matrix_from_signed(params, p1i).to_eval()
    p_hat_e = p1e.concat_rows([p2e])
    syndrome = (target - pub @ p_hat_e).to_coeff()
    g_normals = chacha.normal(kg, (2, L, dpt, d, cols, n), torch.float32)
    z_i = _gauss_samp_gq(syndrome.data, g_normals, base_bits=params.base_bits, dpt=dpt,
                         moduli=tuple(params.moduli), sigma=sigma, c=c)
    ze = _matrix_from_signed(params, z_i).to_eval()
    top = p1e.slice_rows(0, d) + r_e @ ze
    mid = p1e.slice_rows(d, 2 * d) + e_e @ ze
    bot = p2e + ze
    return top.concat_rows([mid, bot])


class TrapdoorSampler:
    """MP12 trapdoor sampler on one device."""

    def __init__(self, params: RingParams, sigma: float, seed: int | None = None, device="cuda"):
        self.device = torch.device(device)
        self.sigma = sigma
        self.base = 1 << params.base_bits
        self.c = preimage_c(self.base, sigma)
        self._uniform = UniformSampler(seed, self.device)
        # 256-bit ChaCha key (OS entropy when unseeded) for every preimage draw
        self._key = core.fresh_key(seed, self.device)
        self._ctr = 0
        # Values hold strong references to the objects their keys were
        # id()-derived from, so an id is never recycled into a stale hit.
        self._cache: dict = {}

    def _operands(self, trapdoor: Trapdoor, public_matrix: PolyMatrix, s: float, device=None):
        """EVAL-form (r, e, pub) and the p1 LDL tables on the device, cached
        per (trapdoor, public_matrix, s); with `device`, their copy there,
        cached per device too."""
        key = (id(trapdoor), id(public_matrix), s)
        entry = self._cache.get(key)
        if entry is None or entry[0] is not trapdoor or entry[1] is not public_matrix:
            lifts = [_centered_lift_f64(m).cpu().numpy()
                     for m in (trapdoor.a_mat(), trapdoor.b_mat(), trapdoor.d_mat())]
            cov = _build_p1_cov(*lifts, s, self.c)
            sqrt_var, upd = _p1_ldl_tables(cov, self.sigma * self.sigma)
            entry = (
                trapdoor,
                public_matrix,
                trapdoor.r.to_eval(),
                trapdoor.e.to_eval(),
                public_matrix.to_eval(),
                torch.from_numpy(sqrt_var).to(self.device),
                torch.from_numpy(upd).to(self.device),
            )
            self._cache[key] = entry
        ops = entry[2:]
        if device is None or ops[0].data.device == torch.device(device):
            return ops
        key += (str(device),)
        copy = self._cache.get(key)
        if copy is None or copy[0] is not trapdoor or copy[1] is not public_matrix:
            copy = (trapdoor, public_matrix,
                    *[PolyMatrix(m.data.to(device), m.fmt, m.params) for m in ops[:3]],
                    *[t.to(device) for t in ops[3:]])
            self._cache[key] = copy
        return copy[2:]

    def trapdoor(self, params: RingParams, size: int) -> tuple[Trapdoor, PolyMatrix]:
        d = size
        k = params.modulus_digits
        gauss = GaussDist(self.sigma)
        r = self._uniform.sample_uniform(params, d, d * k, gauss)
        e = self._uniform.sample_uniform(params, d, d * k, gauss)
        a_bar = self._uniform.sample_uniform(params, d, d, FinRingDist())
        g = PolyMatrix.gadget_matrix(params, d, self.device)
        a0 = a_bar.concat_columns([PolyMatrix.identity(params, d, device=self.device)])
        a1 = g - (a_bar @ r + e)
        a = a0.concat_columns([a1])
        return Trapdoor(r=r, e=e), a

    def preimage(self, params: RingParams, trapdoor: Trapdoor, public_matrix: PolyMatrix,
                 target: PolyMatrix) -> PolyMatrix:
        """x with public_matrix @ x == target exactly (EVAL form)."""
        return self._preimage_cols(params, trapdoor, public_matrix, target)

    def preimage_batched_sharded(self, params: RingParams, trapdoor: Trapdoor,
                                 public_matrix: PolyMatrix, targets: list[PolyMatrix],
                                 mesh=None) -> list[PolyMatrix]:
        """Many preimage requests as ONE preimage call over their
        concatenated columns (column blocks are independent), split back per
        request. With a `parallel.Mesh`, the columns split over its `col`
        axis (see `_preimage_cols`)."""
        if not targets:
            raise ValueError("preimage_batched_sharded requires targets")
        combined = targets[0].to_eval().concat_columns(targets[1:])
        # one body either way; an unsharded call goes through `preimage`, the
        # entry that callers wrap to count and time preimage calls
        out = (self.preimage(params, trapdoor, public_matrix, combined) if mesh is None
               else self._preimage_cols(params, trapdoor, public_matrix, combined, mesh))
        outs = []
        start = 0
        for t in targets:
            outs.append(out.slice_columns(start, start + t.ncol))
            start += t.ncol
        return outs

    def _preimage_cols(self, params: RingParams, trapdoor: Trapdoor, public_matrix: PolyMatrix,
                       target: PolyMatrix, mesh=None) -> PolyMatrix:
        """The preimage of target's columns under one call counter. With no
        mesh, one shard on the sampler's device. With a `parallel.Mesh`, the
        columns are padded to a multiple of its `col` axis size with repeats
        of the last column; shard j runs the whole preimage body on its own
        device with the call's key folded with j (the JAX package's
        `shard_map` over `col`, no collective), and the shards come back to
        the public matrix's device with the padding dropped."""
        d = public_matrix.nrow
        if target.nrow != d:
            raise ValueError("target rows must match public matrix rows")
        k = params.modulus_digits
        s = preimage_smoothing_parameter(self.base, self.sigma, d, params.n, k)
        shards = 1 if mesh is None else mesh.shape[COL_AXIS]
        total = target.ncol
        data = target.to_eval().data
        pad = (-total) % shards
        if pad:
            data = torch.cat([data, data[:, :, total - 1:].expand(-1, -1, pad, -1)], dim=2)
        width = data.shape[2] // shards
        self._ctr += 1
        call_key = chacha.fold_in(self._key, self._ctr)
        # every shard is enqueued on its device before any is gathered, so
        # the shards of a multi-card mesh overlap. JAX replicates the body
        # over the limb axis of a 2-D mesh; here each column shard is
        # computed once, on the device at limb index 0.
        outs = []
        for j in range(shards):
            dev = None if mesh is None else mesh.device(**{COL_AXIS: j})
            r_e, e_e, pub, sqrt_var, upd = self._operands(trapdoor, public_matrix, s, dev)
            dev = r_e.data.device
            shard = PolyMatrix(data[:, :, j * width:(j + 1) * width].to(dev), EVAL, params)
            key = chacha.fold_in(call_key.to(dev), j)
            outs.append(_preimage_core(params, key, shard, r_e, e_e, pub, sqrt_var, upd,
                                       sigma=self.sigma, c=self.c, s=s))
        if shards == 1:
            return outs[0]
        home = public_matrix.data.device
        x = torch.cat([o.data.to(home) for o in outs], dim=2)
        return PolyMatrix(x[:, :, :total], EVAL, params)

    def preimage_batched_chunked(self, params: RingParams, trapdoor: Trapdoor,
                                 public_matrix: PolyMatrix, targets: list, mesh=None,
                                 chunk: int | None = None) -> list[PolyMatrix]:
        """`preimage_batched_sharded` in chunks of `chunk` requests (default
        LUT_PREIMAGE_CHUNK_SIZE), so the preimage's intermediates stay within
        device memory at large ring dimension. The tail chunk is not padded:
        49 requests at chunk 16 are calls of 16, 16, 16 and 1.

        Targets may be `matrix.offload.OffloadedMatrix` entries (host/disk
        memmaps): they rehydrate chunk by chunk onto the public matrix's
        device, so an out-of-core offline plane streams through the device
        one request chunk at a time."""
        chunk = chunk or config.lut_preimage_chunk_size()
        device = public_matrix.data.device
        outs: list[PolyMatrix] = []
        for i in range(0, len(targets), chunk):
            hydrated = [t.load(device) if isinstance(t, OffloadedMatrix) else t
                        for t in targets[i : i + chunk]]
            outs.extend(self.preimage_batched_sharded(params, trapdoor, public_matrix, hydrated,
                                                      mesh=mesh))
        return outs

    def preimage_extend(self, params: RingParams, trapdoor: Trapdoor, public_matrix: PolyMatrix,
                        ext_matrix: PolyMatrix, target: PolyMatrix) -> PolyMatrix:
        """x with [public_matrix | ext_matrix] @ x == target (Algorithm 5 of
        eprint 2017/601): the lower block is Gaussian at the smoothing
        width, the upper block a preimage of what remains."""
        d = public_matrix.nrow
        k = params.modulus_digits
        s = preimage_smoothing_parameter(self.base, self.sigma, d, params.n, k)
        pre_right = self._uniform.sample_uniform(params, ext_matrix.ncol, target.ncol,
                                                 GaussDist(s))
        t = target - ext_matrix @ pre_right
        pre_left = self.preimage(params, trapdoor, public_matrix, t)
        return pre_left.concat_rows([pre_right])
