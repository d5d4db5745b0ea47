"""mxx_tpu_torch BGG+ wires against mxx_tpu, bit for bit: the hash sampler
(whole matrices, column windows, tag batches), the Poly and PolyMatrix
operations the wires stand on, the public-key and encoding samplers, and
every BggPublicKey / BggEncoding operation on the same secrets. The decode
invariant c = s A - x (s G) + e is checked on the port's own results."""

import numpy as np
import pytest
import torch

import mxx_tpu  # noqa: F401
from mxx_tpu.bgg import BGGEncodingSampler as JaxBGGEncodingSampler
from mxx_tpu.bgg import BGGPublicKeySampler as JaxBGGPublicKeySampler
from mxx_tpu.matrix import PolyMatrix as JaxPolyMatrix
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.ring.poly import Poly as JaxPoly
from mxx_tpu.sampler import HashSampler as JaxHashSampler
from mxx_tpu.sampler import UniformSampler as JaxUniformSampler
from mxx_tpu.sampler import chacha as jax_chacha
from mxx_tpu.sampler import core as jax_core
from mxx_tpu.sampler import dist as jax_dist

from mxx_tpu_torch import convert
from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler, BggEncoding
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import COEFF, Poly
from mxx_tpu_torch.sampler import (BitDist, FinRingDist, GaussDist, HashSampler, TernaryDist,
                                   UniformSampler, chacha, core)

KEY = bytes(range(32))
ARGS = (16, 2, 20, 5)  # n, L, crt_bits, base_bits: k = 8 gadget digits
DISTS = [(FinRingDist(), jax_dist.FinRingDist()), (BitDist(), jax_dist.BitDist()),
         (TernaryDist(), jax_dist.TernaryDist()), (GaussDist(3.0), jax_dist.GaussDist(3.0))]


def _params(args=ARGS):
    return RingParams.new(*args), JaxRingParams.new(*args)


def _eq(mine, theirs):
    """Same residues and format (PolyMatrix or Poly against its JAX twin)."""
    assert mine.fmt == theirs.fmt
    np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))


def _keys(nb, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(nb, 8), dtype=np.uint64).astype(np.uint32)


# ----------------------------------------------------------------- ChaCha20


@pytest.mark.parametrize("nwords", [1, 16, 37])
def test_chacha_batch_forms_equal(nwords):
    keys = _keys(3, nwords)
    k = torch.from_numpy(keys.astype(np.int64))
    datas = np.array([0, 5, 2**32 - 1], dtype=np.uint32)
    np.testing.assert_array_equal(
        chacha.fold_in_batch(k, torch.from_numpy(datas.astype(np.int64))).numpy(),
        np.asarray(jax_chacha.fold_in_batch(keys, datas)).astype(np.int64))
    np.testing.assert_array_equal(
        chacha.keystream_words_batch(k, nwords, 7).numpy(),
        np.asarray(jax_chacha.keystream_words_batch(keys, nwords, np.uint32(7))).astype(np.int64))
    np.testing.assert_array_equal(
        chacha.random_bits_batch(k, (2, nwords)).numpy(),
        np.asarray(jax_chacha.random_bits_batch(keys, (2, nwords))).astype(np.int64))
    # each row is the single-key stream
    for i in range(3):
        assert torch.equal(chacha.random_bits_batch(k, (nwords,))[i],
                           chacha.random_bits(k[i], (nwords,)))


def test_uniform_residues_batch_equal():
    p, jp = _params((16, 3, 28, 14))
    keys = _keys(4, 1)
    got = core.uniform_residues_batch(torch.from_numpy(keys.astype(np.int64)), (2, 16),
                                      p.tables("cpu").moduli)
    want = np.asarray(jax_core.uniform_residues_batch(keys, (2, 16), jp.jt.moduli))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ------------------------------------------------------------ hash sampler


@pytest.mark.parametrize("dist,jdist", DISTS)
def test_hash_sampler_matrices_and_windows_equal(dist, jdist):
    p, jp = _params()
    hs, jhs = HashSampler(device="cpu"), JaxHashSampler()
    full = hs.sample_hash(p, KEY, b"tag", 2, 5, dist)
    _eq(full, jhs.sample_hash(jp, KEY, b"tag", 2, 5, jdist))
    window = hs.sample_hash_columns(p, KEY, b"tag", 2, 5, 1, 3, dist)
    _eq(window, jhs.sample_hash_columns(jp, KEY, b"tag", 2, 5, 1, 3, jdist))
    assert torch.equal(window.data, full.data[:, :, 1:4])
    with pytest.raises(ValueError, match="window"):
        hs.sample_hash_columns(p, KEY, b"tag", 2, 5, 4, 2, dist)


@pytest.mark.parametrize("eval_form", [False, True])
@pytest.mark.parametrize("dist,jdist", DISTS[:2] + DISTS[3:])
def test_hash_sampler_batch_equal(eval_form, dist, jdist):
    p, jp = _params()
    tags = [b"a", b"bb", "c", b"a"]
    mine = HashSampler(device="cpu").sample_hash_batch(p, KEY, tags, 1, 3, dist, eval_form=eval_form)
    theirs = JaxHashSampler().sample_hash_batch(jp, KEY, tags, 1, 3, jdist, eval_form=eval_form)
    assert len(mine) == len(theirs) == 4
    for m, t, tag in zip(mine, theirs, tags):
        _eq(m, t)
        single = HashSampler(device="cpu").sample_hash(p, KEY, tag, 1, 3, dist)
        assert m == single


# ------------------------------------------------------ Poly and PolyMatrix


def test_poly_constructors_accessors_and_bytes_equal():
    p, jp = _params()
    coeffs = [(-1) ** i * (i * 7919 + 2**70) for i in range(p.n)]
    mine = Poly.from_int_coeffs(p, coeffs, device="cpu")
    theirs = JaxPoly.from_int_coeffs(jp, coeffs)
    _eq(mine, theirs)
    assert mine.coeffs() == theirs.coeffs()
    assert mine.to_eval().const_coeff() == theirs.const_coeff() == coeffs[0] % p.modulus
    _eq(mine.small_scalar_mul(p, [3, 0, 1]), theirs.small_scalar_mul(jp, [3, 0, 1]))
    _eq(mine.large_scalar_mul(p, [2**40, 5]), theirs.large_scalar_mul(jp, [2**40, 5]))
    for poly, jpoly in [(mine, theirs), (mine.to_eval(), theirs.to_eval())]:
        raw = poly.to_compact_bytes()
        assert raw == jpoly.to_compact_bytes()
        _eq(Poly.from_compact_bytes(p, raw, device="cpu"), JaxPoly.from_compact_bytes(jp, raw))
    with pytest.raises(ValueError):
        Poly.from_int_coeffs(p, coeffs[:-1], device="cpu")


def test_poly_matrix_operations_equal():
    p, jp = _params()
    us, jus = UniformSampler(3, device="cpu"), JaxUniformSampler(3)
    polys = [us.sample_poly(p, FinRingDist()) for _ in range(4)]
    jpolys = [jus.sample_poly(jp, jax_dist.FinRingDist()) for _ in range(4)]
    mixed, jmixed = [polys[0], polys[1].to_eval()], [jpolys[0], jpolys[1].to_eval()]
    _eq(PolyMatrix.from_poly_row(p, polys), JaxPolyMatrix.from_poly_row(jp, jpolys))
    _eq(PolyMatrix.from_poly_column(p, mixed), JaxPolyMatrix.from_poly_column(jp, jmixed))
    a = PolyMatrix.from_polys(p, [polys[:2], polys[2:]])
    ja = JaxPolyMatrix.from_polys(jp, [jpolys[:2], jpolys[2:]])
    _eq(a, ja)
    b, jb = PolyMatrix.from_poly_row(p, polys[1:4]), JaxPolyMatrix.from_poly_row(jp, jpolys[1:4])
    _eq(a.tensor(b), ja.tensor(jb))
    _eq(a * polys[3], ja * jpolys[3])
    _eq(a.mul_poly_scalar(polys[0]), ja.mul_poly_scalar(jpolys[0]))
    _eq(a * 12345, ja * 12345)
    _eq(a * a, ja * ja)
    g = PolyMatrix.gadget_matrix(p, 2, device="cpu")
    jg = JaxPolyMatrix.gadget_matrix(jp, 2)
    _eq(g.mul_decompose(a), jg.mul_decompose(ja))
    assert g.mul_decompose(a) == a
    for m, jm in [(a, ja), (a.to_eval(), ja.to_eval())]:
        raw = m.to_compact_bytes()
        assert raw == jm.to_compact_bytes()
        _eq(PolyMatrix.from_compact_bytes(p, raw, device="cpu"), JaxPolyMatrix.from_compact_bytes(jp, raw))


# ---------------------------------------------------------------------- BGG


def _check_invariant(params, enc, secret_vec, error=None):
    """c == s A - x (s G) (+ e) exactly."""
    g = PolyMatrix.gadget_matrix(params, secret_vec.ncol, device="cpu")
    want = secret_vec @ enc.pubkey.matrix - (secret_vec @ g).mul_poly_scalar(enc.plaintext)
    if error is not None:
        want = want + error
    assert enc.vector == want, "BGG invariant violated"


def _both_bgg(params, jparams, sigma, n_inputs=3, d=1):
    """The same secrets, public keys, plaintexts and encodings in both
    packages; the port's secrets come across through convert."""
    jus = JaxUniformSampler(seed=5)
    jsecrets = [jus.sample_poly(jparams, jax_dist.TernaryDist()) for _ in range(d)]
    jplain = [jus.sample_poly(jparams, jax_dist.FinRingDist()) for _ in range(n_inputs)]
    reveal = [True] * (n_inputs - 1) + [False]
    jpks = JaxBGGPublicKeySampler(KEY, d).sample(jparams, b"bgg", reveal)
    jencs = JaxBGGEncodingSampler(jparams, jsecrets, gauss_sigma=sigma, seed=8).sample(
        jparams, jpks, jplain)

    us = UniformSampler(seed=5, device="cpu")
    own = [us.sample_poly(params, TernaryDist()) for _ in range(d)]
    secrets = convert.secrets_from_numpy(params, [np.asarray(s.data) for s in jsecrets], COEFF, device="cpu")
    for s, o in zip(secrets, own):
        assert s == o
    plain = [convert.poly_from_numpy(params, np.asarray(x.data), x.fmt, device="cpu") for x in jplain]
    pks = BGGPublicKeySampler(KEY, d, device="cpu").sample(params, b"bgg", reveal)
    for pk, jpk in zip(pks, jpks):
        assert pk.reveal_plaintext == jpk.reveal_plaintext
        _eq(pk.matrix, jpk.matrix)
    es = BGGEncodingSampler(params, secrets, gauss_sigma=sigma, seed=8)
    encs = es.sample(params, pks, plain)
    for e, je in zip(encs, jencs):
        _eq(e.vector, je.vector)
        assert (e.plaintext is None) == (je.plaintext is None)
        if e.plaintext is not None:
            _eq(e.plaintext, je.plaintext)
    return es, encs, jencs


@pytest.mark.parametrize("sigma", [None, 2.0])
def test_bgg_samplers_equal(sigma):
    p, jp = _params()
    es, encs, _ = _both_bgg(p, jp, sigma)
    if sigma is None:
        for e in encs[:-1]:
            _check_invariant(p, e, es.secret_vec)
    else:
        # the error is the first draw of the sampler's own key
        err = UniformSampler(8, device="cpu").sample_uniform(p, 1, 4 * p.modulus_digits, GaussDist(sigma))
        for i, e in enumerate(encs[:-1]):
            m = p.modulus_digits
            _check_invariant(p, e, es.secret_vec, err.slice_columns(m * i, m * (i + 1)))


def test_bgg_operations_equal():
    p, jp = _params()
    es, encs, jencs = _both_bgg(p, jp, None)
    _, e1, e2, e3 = encs
    _, j1, j2, j3 = jencs
    results = [
        (e1 + e2, j1 + j2), (e1 - e3, j1 - j3), (e1 * e2, j1 * j2), (e2 * e3, j2 * j3),
        (e1.small_scalar_mul(p, [2, 0, 7]), j1.small_scalar_mul(jp, [2, 0, 7])),
        (e3.large_scalar_mul(p, [2**30 + 1, 9]), j3.large_scalar_mul(jp, [2**30 + 1, 9])),
    ]
    for mine, theirs in results:
        _eq(mine.vector, theirs.vector)
        _eq(mine.pubkey.matrix, theirs.pubkey.matrix)
        assert mine.pubkey.reveal_plaintext == theirs.pubkey.reveal_plaintext
        assert (mine.plaintext is None) == (theirs.plaintext is None)
        if mine.plaintext is not None:
            _eq(mine.plaintext, theirs.plaintext)
            _check_invariant(p, mine, es.secret_vec)
    with pytest.raises(ValueError, match="plaintext"):
        e3 * e1
    # pubkey wires alone, and encodings carried across from the JAX package
    pk1, pk2 = e1.pubkey, e2.pubkey
    for mine, theirs in [(pk1 + pk2, j1.pubkey + j2.pubkey), (pk1 - pk2, j1.pubkey - j2.pubkey),
                         (pk1 * pk2, j1.pubkey * j2.pubkey),
                         (pk1.small_scalar_mul(p, [4]), j1.pubkey.small_scalar_mul(jp, [4])),
                         (pk1.large_scalar_mul(p, [2**33]), j1.pubkey.large_scalar_mul(jp, [2**33]))]:
        _eq(mine.matrix, theirs.matrix)
    jpk = convert.public_key_from_numpy(p, np.asarray(j2.pubkey.matrix.data),
                                        j2.pubkey.matrix.fmt, j2.pubkey.reveal_plaintext, device="cpu")
    carried = convert.encoding_from_numpy(p, np.asarray(j2.vector.data), j2.vector.fmt, jpk,
                                          np.asarray(j2.plaintext.data), j2.plaintext.fmt, device="cpu")
    assert isinstance(carried, BggEncoding) and carried == e2
