"""Bridge to the external `lattice-estimator-cli` security estimator (a copy
of `mxx_tpu/simulator/lattice_estimator.py`).

Shells out with JSON distribution specs and a timeout, parsing achieved
security bits. When the CLI is not installed, callers get None and fall back
to the closed-form core-SVP estimate (`heuristic_security_bits`).
"""

from __future__ import annotations

import json
import shutil
import subprocess
from dataclasses import dataclass


@dataclass(frozen=True)
class LweDistSpec:
    """Distribution spec matching the CLI's JSON schema."""

    kind: str  # "gaussian" | "ternary" | "uniform" | "centered_binomial"
    sigma: float | None = None
    eta: int | None = None

    def to_json(self):
        out = {"kind": self.kind}
        if self.sigma is not None:
            out["sigma"] = self.sigma
        if self.eta is not None:
            out["eta"] = self.eta
        return out


def estimator_cli_available(binary: str = "lattice-estimator-cli") -> bool:
    return shutil.which(binary) is not None


def run_lattice_estimator_cli(
    ring_dimension: int,
    log_q: int,
    secret_dist: LweDistSpec,
    error_dist: LweDistSpec,
    timeout_secs: float = 600.0,
    binary: str = "lattice-estimator-cli",
) -> float | None:
    """Returns achieved security bits, or None if the CLI is missing/fails."""
    if not estimator_cli_available(binary):
        return None
    payload = json.dumps(
        {
            "n": ring_dimension,
            "log_q": log_q,
            "secret": secret_dist.to_json(),
            "error": error_dist.to_json(),
        }
    )
    try:
        proc = subprocess.run(
            [binary],
            input=payload.encode(),
            capture_output=True,
            timeout=timeout_secs,
        )
    except (subprocess.TimeoutExpired, OSError):
        return None
    if proc.returncode != 0:
        return None
    try:
        result = json.loads(proc.stdout.decode())
        return float(result["security_bits"])
    except (json.JSONDecodeError, KeyError, ValueError):
        return None


def core_svp_security_bits(n: int, log2_q: float, sigma: float = 3.19,
                           classical_exponent: float = 0.292) -> float:
    """Core-SVP primal-uSVP estimate (the public Alkim-Ducas-Poppelmann-
    Schwabe methodology, also the lattice-estimator's primal baseline):

    find the smallest BKZ block size beta for which, over the optimal number
    of LWE samples m (embedding dimension d = m + n + 1), the projected
    target length sigma * sqrt(beta) falls below the GSA estimate
    delta(beta)^{2 beta - d - 1} * q^{m/d}; security = 0.292 * beta classical
    core-SVP bits (0.265 for quantum).

    This is an honest closed-form approximation, typically within a few bits
    of the lattice-estimator CLI's primal figure; dual/hybrid attacks and
    small-secret refinements can shave more — run the CLI for certification.
    """
    import math

    def delta(beta: int) -> float:
        return ((math.pi * beta) ** (1.0 / beta) * beta / (2 * math.pi * math.e)) ** (
            1.0 / (2.0 * (beta - 1))
        )

    for beta in range(50, 2048, 1):
        lhs = math.log2(sigma) + 0.5 * math.log2(beta)
        d_b = math.log2(delta(beta))
        ok = False
        for m in range(max(beta - n, n // 8), 3 * n + 1, max(n // 16, 1)):
            d = m + n + 1
            rhs = (2 * beta - d - 1) * d_b + (m / d) * log2_q
            if lhs <= rhs:
                ok = True
                break
        if ok:
            return classical_exponent * beta
    return classical_exponent * 2048  # parameters beyond the scan range


def heuristic_security_bits(ring_dimension: int, log_q: int) -> float:
    """Fallback when the lattice-estimator CLI is absent: the core-SVP
    primal estimate (see `core_svp_security_bits`)."""
    return core_svp_security_bits(ring_dimension, float(log_q))
