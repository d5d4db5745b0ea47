"""`mxx_tpu_torch.utils.rng.Drbg` against `mxx_tpu.utils.rng.Drbg`: the same
byte stream and the same `randrange`, `choice`, `gauss`, `getrandbits`,
`random` and `gauss_int` results for int and bytes seeds (tolerance 0: the
floats come from the same 53-bit draws through the same `random.Random`
code); an unseeded generator is keyed from the OS and repeats nothing."""

import pytest

from mxx_tpu.utils.rng import Drbg as DrbgJ, secure_rng as secure_j
from mxx_tpu_torch.utils.rng import Drbg as DrbgT, secure_rng as secure_t

SEEDS = [0, 1, -7, 2**80 + 3, b"", b"noise_refresh" + b"refresh0", bytes(range(32)), "text"]


def _draws(r):
    out = [r.getrandbits(k) for k in (1, 7, 8, 53, 64, 300)]
    out += [r.randrange(10**40) for _ in range(20)]
    out += [r.randrange(3, 17) for _ in range(20)]
    out += [r.choice([-1, 0, 1]) for _ in range(40)]
    out += [r.gauss(0.0, 3.2) for _ in range(25)]
    out += [r.random() for _ in range(10)]
    out += [r.gauss_int(4.0) for _ in range(10)] + [r.gauss_int(0.0)]
    out += [r.getstate()]
    return out


@pytest.mark.parametrize("seed", SEEDS, ids=[repr(s)[:16] for s in SEEDS])
def test_streams_equal(seed):
    assert _draws(DrbgJ(seed)) == _draws(DrbgT(seed))
    assert _draws(secure_j(seed)) == _draws(secure_t(seed))


def test_state_round_trip_and_reseed():
    a, b = DrbgT(5), DrbgJ(5)
    a.getrandbits(100)
    b.getrandbits(100)
    st = a.getstate()
    assert st == b.getstate()
    first = [a.randrange(1000) for _ in range(8)]
    a.setstate(st)
    assert [a.randrange(1000) for _ in range(8)] == first
    a.seed(5)
    assert _draws(a) == _draws(DrbgJ(5))


def test_unseeded_is_keyed_from_the_os():
    assert DrbgT().getrandbits(256) != DrbgT().getrandbits(256)
    assert DrbgT(None).getrandbits(256) != secure_t().getrandbits(256)
