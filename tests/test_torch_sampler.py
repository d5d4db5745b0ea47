"""mxx_tpu_torch samplers against mxx_tpu: ChaCha20 words (RFC 8439 vector,
fold_in, split, random_bits) and every integer draw bit for bit; Box-Muller
normals within float tolerance (the words are exact, libm's log/cos/sin may
differ in the last bits)."""

import numpy as np
import pytest
import torch

import mxx_tpu  # noqa: F401
import jax.numpy as jnp

from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.sampler import UniformSampler as JaxUniformSampler
from mxx_tpu.sampler import chacha as jax_chacha
from mxx_tpu.sampler import core as jax_core
from mxx_tpu.sampler import dist as jax_dist

from mxx_tpu_torch import convert
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.sampler import BitDist, FinRingDist, GaussDist, TernaryDist, UniformSampler
from mxx_tpu_torch.sampler import chacha, core

SEEDS = [0, 7, 12345]


def _keys(seed):
    """The same fresh key in both packages."""
    jk = jax_core.fresh_key(seed)
    k = core.fresh_key(seed, device="cpu")
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk).astype(np.int64))
    return k, jk


def _eq(mine: torch.Tensor, theirs, as_u64=False):
    got = mine.numpy()
    if as_u64:
        got = got.view(np.uint64)
    np.testing.assert_array_equal(got, np.asarray(theirs).astype(got.dtype))


def test_chacha_rfc8439_vector():
    assert chacha.self_test_vector(device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_split_equal(seed):
    k, jk = _keys(seed)
    for data in (0, 1, 7, 2**31 + 3, 2**32 + 5):
        _eq(chacha.fold_in(k, data), jax_chacha.fold_in(jk, data))
    for num in (2, 3, 5):
        _eq(chacha.split(k, num), jax_chacha.split(jk, num))
    a, b = chacha.split2(k)
    ja, jb = jax_chacha.split2(jk)
    _eq(a, ja)
    _eq(b, jb)
    _eq(core.derive_key(bytes(range(32)), "tag", b"dom", device="cpu"),
        jax_core.derive_key(bytes(range(32)), "tag", b"dom"))
    _eq(convert.key_from_numpy(np.asarray(jk), device="cpu"), jk)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 17)])
def test_random_bits_equal(seed, shape):
    k, jk = _keys(seed)
    _eq(chacha.random_bits(k, shape), jax_chacha.random_bits(jk, shape, jnp.uint32))
    _eq(chacha.random_bits(k, shape, "uint64"),
        jax_chacha.random_bits(jk, shape, jnp.uint64), as_u64=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_residue_draws_equal(seed):
    p, jp = RingParams.new(16, 3, 28, 14), JaxRingParams.new(16, 3, 28, 14)
    k, jk = _keys(seed)
    q, jq = p.tables("cpu").moduli, jp.jt.moduli
    shape = (2, 3, 16)
    _eq(core.uniform_residues(k, shape, q), jax_core.uniform_residues(jk, shape, jq))
    _eq(core.bit_residues(k, shape, q), jax_core.bit_residues(jk, shape, jq))
    _eq(core.ternary_residues(k, shape, q), jax_core.ternary_residues(jk, shape, jq))
    # sigma = 4.578 is the trapdoor's; every table's upper thresholds lie
    # beyond int64, so the searchsorted goes through the signed map
    for sigma in (1.5, 4.578, 40.0, 512.0):
        _eq(core.gauss_residues(k, shape, q, sigma), jax_core.gauss_residues(jk, shape, jq, sigma))


def test_gauss_table_holds_top_threshold():
    thresholds, tail = core.gauss_table(4.578)
    want, want_tail = jax_core.gauss_table(4.578)
    np.testing.assert_array_equal(thresholds, want)
    # the upper thresholds lie beyond int64
    assert tail == want_tail and int(thresholds[-1]) >= 2**63


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_sampler_equal(seed):
    args = (16, 2, 20, 5)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    s, js = UniformSampler(seed, device="cpu"), JaxUniformSampler(seed)
    for dist, jdist in [(FinRingDist(), jax_dist.FinRingDist()),
                        (GaussDist(4.578), jax_dist.GaussDist(4.578)),
                        (BitDist(), jax_dist.BitDist()), (TernaryDist(), jax_dist.TernaryDist()),
                        (FinRingDist(), jax_dist.FinRingDist())]:
        mine = s.sample_uniform(p, 2, 3, dist)
        theirs = js.sample_uniform(jp, 2, 3, jdist)
        assert mine.fmt == theirs.fmt
        _eq(mine.data, theirs.data)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_close(seed):
    k, jk = _keys(seed)
    for shape in [(7,), (4, 33)]:
        got = chacha.normal(k, shape, torch.float32)
        want = np.asarray(jax_chacha.normal(jk, shape, jnp.float32))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        got64 = chacha.normal(k, shape, torch.float64)
        want64 = np.asarray(jax_chacha.normal(jk, shape, jnp.float64))
        np.testing.assert_allclose(got64.numpy(), want64, rtol=1e-12, atol=1e-12)
