"""`mxx_tpu_torch.bgg.lift.lift_constants_batched` and `bgg.digits_to_int`
against the JAX package and against per-call `large_scalar_mul`, bit for bit
(integer work, tolerance 0), for public keys and for encodings, at a count
of constants that crosses a chunk boundary of either package's chunking.
"""

import random

import numpy as np
import pytest

import mxx_tpu  # noqa: F401
from mxx_tpu.bgg import BGGEncodingSampler as JaxBGGEncodingSampler
from mxx_tpu.bgg import BGGPublicKeySampler as JaxBGGPublicKeySampler
from mxx_tpu.bgg import digits_to_int as jax_digits
from mxx_tpu.bgg import lift as jax_lift
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.ring.poly import Poly as JaxPoly
from mxx_tpu.sampler import TernaryDist as JaxTernaryDist
from mxx_tpu.sampler import UniformSampler as JaxUniformSampler

from mxx_tpu_torch import config, convert
from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler, BggEncoding, lift
from mxx_tpu_torch.bgg.digits_to_int import digits_to_int, power_of_base
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import Poly
from mxx_tpu_torch.sampler import TernaryDist, UniformSampler

KEY = bytes(range(32))
ARGS = (16, 2, 20, 5)
CPU = "cpu"


def _eq(mine, theirs):
    assert mine.fmt == theirs.fmt
    np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))


def _wires(d, n_inputs=0, plaintexts=()):
    p, jp = RingParams.new(*ARGS), JaxRingParams.new(*ARGS)
    pks = BGGPublicKeySampler(KEY, d, CPU).sample(p, b"lift", [True] * n_inputs)
    jpks = JaxBGGPublicKeySampler(KEY, d).sample(jp, b"lift", [True] * n_inputs)
    us, jus = UniformSampler(seed=5, device=CPU), JaxUniformSampler(seed=5)
    secrets = [us.sample_poly(p, TernaryDist()) for _ in range(d)]
    jsecrets = [jus.sample_poly(jp, JaxTernaryDist()) for _ in range(d)]
    encs = BGGEncodingSampler(p, secrets, 3.0, seed=6).sample(
        p, pks, [Poly.const(p, v, CPU) for v in plaintexts])
    jencs = JaxBGGEncodingSampler(jp, jsecrets, 3.0, seed=6).sample(
        jp, jpks, [JaxPoly.const(jp, v) for v in plaintexts])
    return p, jp, pks, jpks, encs, jencs


def _values(p, count):
    rng = random.Random(8)
    return [0, 1, p.modulus - 1] + [rng.randrange(p.modulus) for _ in range(count - 3)]


@pytest.mark.parametrize("d", [1, 2])
def test_lift_equals_jax_and_per_call(d, monkeypatch):
    p, jp, pks, jpks, encs, jencs = _wires(d)
    values = _values(p, 7)
    per_value = p.crt_depth * (d + 1) * d * p.modulus_digits * p.n * 8
    monkeypatch.setenv("LUT_BYTES_LIMIT", str(3 * per_value))  # encodings: 3 + 3 + 1
    monkeypatch.setattr(jax_lift, "LIFT_CHUNK", 4)  # the JAX function: 4 + 3 (padded to 4)
    assert lift.lift_chunk_size(p, d, True) == 3
    assert lift.lift_chunk_size(p, d, False) == 3 * (d + 1) // d

    got_pk = lift.lift_constants_batched(p, pks[0], values)
    want_pk = jax_lift.lift_constants_batched(jp, jpks[0], values)
    assert len(got_pk) == len(values)
    for v, mine, theirs in zip(values, got_pk, want_pk):
        _eq(mine.matrix, theirs.matrix)
        assert mine.reveal_plaintext == theirs.reveal_plaintext
        assert mine == pks[0].large_scalar_mul(p, [v])
        assert mine.matrix.data.device.type == CPU

    got = lift.lift_constants_batched(p, encs[0], values)
    want = jax_lift.lift_constants_batched(jp, jencs[0], values)
    for v, mine, theirs in zip(values, got, want):
        _eq(mine.vector, theirs.vector)
        _eq(mine.pubkey.matrix, theirs.pubkey.matrix)
        _eq(mine.plaintext, theirs.plaintext)
        assert mine == encs[0].large_scalar_mul(p, [v])
        assert isinstance(mine, BggEncoding) and mine.plaintext.const_coeff() == v


def test_chunk_size_follows_the_byte_budget(monkeypatch):
    p = RingParams.new(8192, 8, 28, 14)
    monkeypatch.delenv("LUT_BYTES_LIMIT", raising=False)
    per_pk = 8 * 16 * 8192 * 8  # one [L, 1, 16, n] int64 result
    assert lift.lift_chunk_size(p, 1, False) == config.lut_bytes_limit() // per_pk == 128
    assert lift.lift_chunk_size(p, 1, True) == 64
    monkeypatch.setenv("LUT_BYTES_LIMIT", "1")
    assert lift.lift_chunk_size(p, 1, True) == 1  # never below one constant


def test_lifted_wires_need_no_host_copy():
    """Nothing is padded and the wires are views of the chunk's tensors."""
    p, _, pks, _, encs, _ = _wires(1)
    out = lift.lift_constants_batched(p, encs[0], [5, 6, 7])
    assert len(out) == 3
    base = out[0].vector.data.untyped_storage().data_ptr()
    assert all(o.vector.data.untyped_storage().data_ptr() == base for o in out)
    assert lift.lift_constants_batched(p, pks[0], []) == []


@pytest.mark.parametrize("d", [1, 2])
def test_digits_to_int_equal(d):
    k = RingParams.new(*ARGS).modulus_digits
    p, jp, pks, jpks, encs, jencs = _wires(d, k, list(range(1, k + 1)))
    got = digits_to_int(pks[1:], p)
    want = jax_digits.digits_to_int(jpks[1:], jp)
    _eq(got.matrix, want.matrix)
    assert got.matrix.shape == (d, 1)
    got_e = digits_to_int(encs[1:], p)
    want_e = jax_digits.digits_to_int(jencs[1:], jp)
    _eq(got_e.vector, want_e.vector)
    _eq(got_e.pubkey.matrix, want_e.pubkey.matrix)
    _eq(got_e.plaintext, want_e.plaintext)
    total = sum((i + 1) << (p.base_bits * i) for i in range(k)) % p.modulus
    assert got_e.plaintext.const_coeff() == total
    plain = digits_to_int([Poly.const(p, i + 1, CPU) for i in range(k)], p)
    assert plain.const_coeff() == total
    _eq(power_of_base(Poly.const(p, 3, CPU), p, 2),
        jax_digits.power_of_base(JaxPoly.const(jp, 3), jp, 2))
    with pytest.raises(TypeError):
        power_of_base(3, p, 1)
