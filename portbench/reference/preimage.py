"""The plain judge of trapdoor preimages: MP12 (Micciancio-Peikert 2012).

The public matrix is A = [A_bar | I | G - (A_bar R + E)] for the trapdoor
(R, E), and a preimage x of a target U satisfies A x = U over Z_Q[X]/(X^n+1)
with x short: a discrete Gaussian whose width is the smoothing bound
s = 1.8 (base + 1) sigma^2 (sqrt(d n k) + sqrt(2 n) + 4.7).

Numbers compared, each over every judged answer:
- `a_rebuild_mismatch`: residues where A differs from the matrix rebuilt from
  A_bar, R and E (limit 0: exact);
- `re_rms_gap`: how far the root mean square of R's and of E's coefficients
  (centred on limb 0) lies from the trapdoor's sigma, as a share of sigma,
  the larger of the two: R and E are discrete Gaussians of width sigma, and
  a narrower or zero trapdoor still rebuilds A exactly;
- `ax_mismatch`: residues of A x - U that are not 0 (limit 0: exact);
- `lift_mismatch`: coefficients of x whose integer, lifted from limbs 0 and
  1, has another residue on some other limb than x holds there (limit 0: x
  is one short integer vector, not a set of unrelated residues);
- `x_rms_gap`: how far the root mean square of x's lifted coefficients lies
  from s, as a share of s: a preimage without its perturbation, or from a
  narrower sampler, still solves A x = U exactly.
"""

from __future__ import annotations

import math

import torch

from .ring import Ring


def smoothing_s(ring: Ring, d: int, sigma: float) -> float:
    base = 1 << ring.base_bits
    return 1.8 * (base + 1.0) * sigma * sigma * (
        math.sqrt(d * ring.n * ring.k) + math.sqrt(2 * ring.n) + 4.7)


def rms_gap(ring: Ring, coeff: torch.Tensor, sigma: float) -> float:
    """|RMS / sigma - 1| of the coefficients of one limb-0 COEFF tensor,
    each centred into (-q_0 / 2, q_0 / 2]."""
    q0 = int(ring.moduli[0])
    v = torch.where(coeff > q0 // 2, coeff - q0, coeff).to(torch.float64)
    return abs(float(v.square().mean().sqrt()) / sigma - 1.0)


def rebuild_mismatch(ring: Ring, a_eval: torch.Tensor, r: torch.Tensor, e: torch.Tensor,
                     d: int) -> int:
    """Residues where EVAL A [L, d, d(k+2), n] differs from the rebuild from
    its own A_bar and the trapdoor's EVAL R, E [L, d, dk, n]."""
    a_bar = a_eval[:, :, :d]
    ident = torch.zeros_like(a_bar)
    ident[:, torch.arange(d), torch.arange(d)] = 1
    right = (ring.gadget(d) - ring.matmul(a_bar, r) - e) % ring.qb(4)
    expect = torch.cat([a_bar, ident, right], dim=2)
    return int((expect != a_eval).sum())


def judge_answer(ring: Ring, a_eval: torch.Tensor, x_eval: torch.Tensor,
                 u_coeff: torch.Tensor) -> dict:
    """Counts and the sum of squares of one answer x (EVAL [L, m, c, n]) to
    the target U (COEFF [L, d, c, n])."""
    ax_bad = 0
    lift_bad = 0
    v = None
    for t in range(ring.depth):
        xt = x_eval[t]
        ax = (a_eval[t, :, :, None, :] * xt[None]) % ring.moduli[t]  # [d, m, c, n]
        ax = ax.sum(dim=1) % ring.moduli[t]
        ax_bad += int((ax != ring._fwd_limb(u_coeff[t], t)).sum())
        del ax
        if t == 0:
            c0 = ring._inv_limb(xt, 0)
        elif t == 1:
            v = ring.lift2(c0, ring._inv_limb(xt, 1))
            del c0
        else:
            lift_bad += int((v % ring.moduli[t] != ring._inv_limb(xt, t)).sum())
    vf = v.to(torch.float64)
    return {"ax_mismatch": ax_bad, "lift_mismatch": lift_bad,
            "sum_sq": float((vf * vf).sum()), "count": v.numel()}
