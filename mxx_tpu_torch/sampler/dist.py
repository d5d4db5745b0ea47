"""Sampling distribution types (a copy of `mxx_tpu/sampler/dist.py`)."""

from __future__ import annotations

from dataclasses import dataclass


class DistType:
    pass


@dataclass(frozen=True)
class FinRingDist(DistType):
    """Uniform over Z_q (per-limb uniform via CRT)."""


@dataclass(frozen=True)
class GaussDist(DistType):
    """Discrete Gaussian over Z with parameter sigma, sampled per coefficient."""

    sigma: float


@dataclass(frozen=True)
class BitDist(DistType):
    """Uniform bits {0, 1}."""


@dataclass(frozen=True)
class TernaryDist(DistType):
    """Uniform over {-1, 0, 1}."""
