"""Faults planted in the program, for the readings that set the limits of
`correct` and for the tests that see `correct` come out false.

Each fault is a context manager that patches one module of `mxx_tpu_torch`
while it is entered; every answer the program then gives still solves
A x = U exactly, so only the widths that the reference compares can tell.
`control.py --fault <name>` reads a cell with one on the card; the
benchmark's own runs never plant one.
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def no_perturbation():
    """MP12's perturbation p left out: every normal that the preimage body
    draws, but the G-sampler's, is 0, so x = [R z; E z; z]."""
    from mxx_tpu_torch.sampler import trapdoor

    real = trapdoor.chacha

    class Chacha:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def normal(key, shape, dtype):
            out = real.normal(key, shape, dtype)
            return out if len(shape) == 6 else out.zero_()  # the G-sampler's are 6-D

    trapdoor.chacha = Chacha()
    try:
        yield
    finally:
        trapdoor.chacha = real


@contextmanager
def narrow_trapdoor():
    """R and E drawn at half the configured sigma; A is built from them."""
    from mxx_tpu_torch.sampler import trapdoor

    real = trapdoor.GaussDist
    trapdoor.GaussDist = lambda sigma: real(sigma / 2)
    try:
        yield
    finally:
        trapdoor.GaussDist = real


FAULTS = {"no_perturbation": no_perturbation, "narrow_trapdoor": narrow_trapdoor}
