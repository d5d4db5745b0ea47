"""The plain BGG+ evaluator (Boneh et al. 2014, with the GSW-style gadget):
an encoding of x under the public matrix A and secret s is
c = s A - x (s G) + e, and the gates act as

- Add / Sub: A1 +- A2, c1 +- c2, x1 +- x2;
- Mul (left plaintext known): D = G^-1(A2); A1 D, c1 D + x1 c2, x1 x2;
- small scalar p (a polynomial with small coefficients): A p, c p, x p;
- large scalar p: D = G^-1(p G); A D, c D, x p.

Wires are (A, c, x) with A and c EVAL [L, 1, k, n] and x EVAL [L, n] or None
(a secret input's plaintext is unknown, and so is every product with it).
"""

from __future__ import annotations

import torch

from .ring import Ring


def _ginv(ring: Ring, m_eval: torch.Tensor) -> torch.Tensor:
    """G^-1 of an EVAL [L, r, c, n] matrix, in EVAL form [L, r k, c, n]."""
    return ring.fwd(ring.decompose(ring.inv(m_eval)))


def make_encoding(ring: Ring, s_eval, a_eval, x_coeff, e_coeff):
    """c = s A - x (s G) + e of W wires at once, for secret s EVAL [L, n],
    A EVAL [L, W, k, n], x COEFF [L, W, n], error e COEFF [L, W, k, n]."""
    q4 = ring.qb(4)
    sg = s_eval[:, None, None, :] * ring.gadget(1) % q4
    x = ring.fwd(x_coeff)[:, :, None, :]
    return (s_eval[:, None, None, :] * a_eval - x * sg + ring.fwd(e_coeff)) % q4


def evaluate(ring: Ring, circuit: dict, wires: list, large_cache: dict) -> list:
    """The outputs (A, c, x) of `circuit` over input wires [one, inputs...];
    `large_cache` keeps G^-1(p G) per large scalar across calls."""
    q4, q2 = ring.qb(4), ring.qb(2)
    w = list(wires)
    for g in circuit["gates"]:
        a = w[g["in"][0]]
        op = g["op"]
        if op in ("add", "sub"):
            b = w[g["in"][1]]
            sign = 1 if op == "add" else -1
            x = None if a[2] is None or b[2] is None else (a[2] + sign * b[2]) % q2
            w.append(((a[0] + sign * b[0]) % q4, (a[1] + sign * b[1]) % q4, x))
        elif op == "mul":
            b = w[g["in"][1]]
            dec = _ginv(ring, b[0])
            c = (ring.matmul(a[1], dec) + a[2][:, None, None, :] * b[1]) % q4
            x = None if b[2] is None else a[2] * b[2] % q2
            w.append((ring.matmul(a[0], dec), c, x))
        elif op in ("small", "large"):
            p = ring.fwd(ring.from_ints(g["scalar"]))
            x = None if a[2] is None else a[2] * p % q2
            if op == "small":
                pb = p[:, None, None, :]
                w.append((a[0] * pb % q4, a[1] * pb % q4, x))
            else:
                key = tuple(g["scalar"])
                if key not in large_cache:
                    large_cache[key] = _ginv(ring, ring.gadget(1) * p[:, None, None, :] % q4)
                dec = large_cache[key]
                w.append((ring.matmul(a[0], dec), ring.matmul(a[1], dec), x))
        else:
            raise ValueError(f"unknown gate {op}")
    return [w[i] for i in circuit["outputs"]]
