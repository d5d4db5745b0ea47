"""The rest of mxx_tpu_torch's Poly and PolyMatrix against mxx_tpu, bit for
bit: the Poly constructors, accessors, digit decompositions and bit
extractions, the small gadget and small decomposition, block accessors,
concat_diag, tensor-identity products, the column-chunked mul_decompose
(MXX_MUL_DECOMPOSE_COLUMN_CHUNK_WIDTH), .mxxp/.mxxm files loading across the
packages, the hash-decomposed samplers and the table path of gauss_ints.
The Karney path of gauss_ints draws a float normal: held by mean and
variance. Inputs come from seeded numpy generators."""

import numpy as np
import pytest
import torch

import mxx_tpu  # noqa: F401
import jax.numpy as jnp

from mxx_tpu.matrix import PolyMatrix as JaxPolyMatrix
from mxx_tpu.ring.element import FinRingElem as JaxFinRingElem
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.ring.poly import Poly as JaxPoly
from mxx_tpu.sampler import FinRingDist as JaxFinRingDist
from mxx_tpu.sampler import HashSampler as JaxHashSampler
from mxx_tpu.sampler import core as jax_core

from mxx_tpu_torch import convert
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ring.element import FinRingElem
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import COEFF, EVAL, Poly
from mxx_tpu_torch.sampler import FinRingDist, HashSampler, core

ARGS = [(16, 2, 20, 5), (32, 3, 28, 14)]
KEY = bytes(range(32))


def _params(args):
    return RingParams.new(*args), JaxRingParams.new(*args)


def _residues(params, lead, seed, bound=None):
    rng = np.random.default_rng(seed)
    out = np.empty((params.crt_depth,) + tuple(lead) + (params.n,), dtype=np.uint32)
    if bound is not None:  # small entries: the same integer in every limb
        small = rng.integers(0, bound, size=out.shape[1:], dtype=np.uint64)
        out[:] = small[None]
        return out
    for t, q in enumerate(params.moduli):
        out[t] = rng.integers(0, q, size=out.shape[1:], dtype=np.uint64)
    return out


def _mats(args, lead, seed, fmt=COEFF, bound=None):
    p, jp = _params(args)
    arr = _residues(p, lead, seed, bound)
    return (convert.poly_matrix_from_numpy(p, arr, fmt, device="cpu"),
            JaxPolyMatrix(jnp.asarray(arr), fmt, jp))


def _polys(args, seed, fmt=COEFF):
    p, jp = _params(args)
    arr = _residues(p, (), seed)
    return convert.poly_from_numpy(p, arr, fmt, device="cpu"), JaxPoly(jnp.asarray(arr), fmt, jp)


def _same(mine, theirs):
    assert mine.fmt == theirs.fmt
    np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))


def _ints(params, seed, hi=None):
    rng = np.random.default_rng(seed)
    hi = params.modulus if hi is None else hi
    return [int.from_bytes(rng.bytes(32), "little") % hi for _ in range(params.n)]


# ------------------------------------------------------------------ Poly


@pytest.mark.parametrize("args", ARGS)
def test_poly_constructors_equal(args):
    p, jp = _params(args)
    _same(Poly.minus_one(p, device="cpu"), JaxPoly.minus_one(jp))
    ints = _ints(p, 1)
    _same(Poly.from_elems(p, [FinRingElem(v, p.modulus) for v in ints], device="cpu"),
          JaxPoly.from_elems(jp, [JaxFinRingElem(v, jp.modulus) for v in ints]))
    _same(Poly.from_ints_eval(p, ints, device="cpu"), JaxPoly.from_ints_eval(jp, ints))
    digits = [_polys(args, 10 + i, fmt) for i, fmt in enumerate((COEFF, EVAL, COEFF))]
    _same(Poly.from_decomposed(p, [d for d, _ in digits]),
          JaxPoly.from_decomposed(jp, [d for _, d in digits]))
    _same(Poly.from_decomposed(p, [], device="cpu"), JaxPoly.from_decomposed(jp, []))


@pytest.mark.parametrize("args", ARGS)
@pytest.mark.parametrize("fmt", [COEFF, EVAL])
def test_poly_accessors_equal(args, fmt):
    mine, theirs = _polys(args, 2, fmt)
    np.testing.assert_array_equal(mine.coeffs_np(), theirs.coeffs_np())
    assert mine.coeffs_np().dtype == np.uint32
    assert mine.const_coeff_u64() == theirs.const_coeff_u64()
    assert mine.eval_slots() == theirs.eval_slots()
    assert mine.extract_bits_with_threshold() == theirs.extract_bits_with_threshold()
    digits, jdigits = mine.decompose_base(), theirs.decompose_base()
    assert len(digits) == len(jdigits) == mine.params.modulus_digits
    for d, jd in zip(digits, jdigits):
        _same(d, jd)


@pytest.mark.parametrize("args", ARGS)
def test_poly_round_trips(args):
    p, _ = _params(args)
    slots = _ints(p, 3)
    assert Poly.from_ints_eval(p, slots, device="cpu").eval_slots() == slots
    # digits that cover the modulus recompose it
    x = Poly.from_int_coeffs(p, _ints(p, 4), device="cpu")
    if p.modulus_digits * p.base_bits >= p.modulus_bits:
        assert Poly.from_decomposed(p, x.decompose_base()) == x
    q = p.modulus
    bits = [bool(b) for b in np.random.default_rng(5).integers(0, 2, p.n)]
    half = Poly.from_int_coeffs(p, [(q // 2) * b for b in bits], device="cpu")
    assert half.extract_bits_with_threshold() == bits
    assert Poly.from_int_coeffs(p, [int(b) for b in bits], device="cpu").to_bool_vec() == bits
    jp = JaxRingParams.new(*args)
    for coeffs in ([int(b) for b in bits], [(q // 2) * b + 1 for b in bits]):
        mine = Poly.from_int_coeffs(p, coeffs, device="cpu").to_eval()
        theirs = JaxPoly.from_int_coeffs(jp, coeffs).to_eval()
        assert mine.to_bool_vec() == theirs.to_bool_vec()
        assert mine.extract_bits_with_threshold() == theirs.extract_bits_with_threshold()


@pytest.mark.parametrize("args", ARGS)
def test_poly_files_cross_load(args, tmp_path):
    p, jp = _params(args)
    mine, theirs = _polys(args, 6, EVAL)
    mine.write_to_file(tmp_path / "port", "x")
    theirs.write_to_file(tmp_path / "jax", "x")
    assert (tmp_path / "port" / "x.mxxp").read_bytes() == (tmp_path / "jax" / "x.mxxp").read_bytes()
    _same(Poly.read_from_file(p, tmp_path / "jax", "x", device="cpu"), theirs)
    back = JaxPoly.read_from_file(jp, tmp_path / "port", "x")
    _same(mine, back)


# ------------------------------------------------------------ PolyMatrix


@pytest.mark.parametrize("args", ARGS)
def test_small_gadget_and_small_decompose_equal(args):
    p, jp = _params(args)
    _same(PolyMatrix.small_gadget_matrix(p, 3, device="cpu"),
          JaxPolyMatrix.small_gadget_matrix(jp, 3))
    for fmt in (COEFF, EVAL):
        mine, theirs = _mats(args, (2, 3), 7, fmt)
        _same(mine.small_decompose(), theirs.small_decompose())
    # G_small small_G^{-1}(X) == X for entries below every q_t
    x, _ = _mats(args, (2, 2), 8, bound=min(p.moduli))
    dec = x.small_decompose()
    assert dec.shape == (2 * p.digits_per_tower, 2)
    assert PolyMatrix.small_gadget_matrix(p, 2, device="cpu") @ dec == x


@pytest.mark.parametrize("args", ARGS)
def test_block_accessors_and_concat_diag_equal(args):
    a, ja = _mats(args, (2, 3), 9)
    b, jb = _mats(args, (1, 2), 10, EVAL)
    assert (a.row_size(), a.col_size()) == (ja.row_size(), ja.col_size()) == (2, 3)
    for got, want in [(a.get_row(1), ja.get_row(1)), (a.get_column(2), ja.get_column(2))]:
        assert len(got) == len(want)
        for x, y in zip(got, want):
            _same(x, y)
    blocks, jblocks = a.block_entries(range(0, 2), range(1, 3)), ja.block_entries(range(0, 2),
                                                                                  range(1, 3))
    for row, jrow in zip(blocks, jblocks):
        for x, y in zip(row, jrow):
            _same(x, y)
    for first, jfirst, rest, jrest in [(a, ja, [b], [jb]), (b, jb, [a, b], [ja, jb])]:
        got = first.concat_diag(rest)
        _same(got, jfirst.concat_diag(jrest))
    got = a.concat_diag([b])
    assert got.shape == (3, 5)
    assert got.slice(0, 2, 0, 3) == a and got.slice(2, 3, 3, 5) == b
    assert got.slice(0, 2, 3, 5) == PolyMatrix.zero(a.params, 2, 2, COEFF, device="cpu")


@pytest.mark.parametrize("args", ARGS)
def test_decompose_products_equal(args):
    p, jp = _params(args)
    k, dpt = p.modulus_digits, p.digits_per_tower
    a, ja = _mats(args, (2, 2 * k), 11)
    b, jb = _mats(args, (2, 3), 12)
    got = a.mul_decompose(b)
    _same(got, ja.mul_decompose(jb))
    assert got == a @ b.decompose()
    s, js = _mats(args, (2, 2 * dpt), 13)
    _same(s.mul_decompose_small(b), js.mul_decompose_small(jb))
    assert s.mul_decompose_small(b) == s @ b.small_decompose()
    # the tensor-identity products against the materialized I x other
    t, jt = _mats(args, (1, 3 * 2), 14)
    got = t.mul_tensor_identity(b.slice_columns(0, 2), 3)
    _same(got, jt.mul_tensor_identity(jb.slice_columns(0, 2), 3))
    ident = PolyMatrix.identity(p, 3, device="cpu")
    assert got == t @ ident.tensor(b.slice_columns(0, 2))
    u, ju = _mats(args, (1, 3 * 2 * k), 15)
    got = u.mul_tensor_identity_decompose(b, 3)
    _same(got, ju.mul_tensor_identity_decompose(jb, 3))
    assert got == u @ ident.tensor(b.decompose())


@pytest.mark.parametrize("width", ["1", "3", "7"])
def test_mul_decompose_column_chunks_exact(monkeypatch, width):
    args = (16, 2, 17, 5)
    p, _ = _params(args)
    k = p.modulus_digits
    a, ja = _mats(args, (1, 2 * k), 16)
    b, jb = _mats(args, (2, 7), 17)
    want = a.mul_decompose(b)
    monkeypatch.setenv("MXX_MUL_DECOMPOSE_COLUMN_CHUNK_WIDTH", width)
    got = a.mul_decompose(b)
    assert got == want
    _same(got, ja.mul_decompose(jb))


@pytest.mark.parametrize("args", ARGS)
def test_matrix_files_cross_load(args, tmp_path):
    p, jp = _params(args)
    mine, theirs = _mats(args, (2, 3), 18, EVAL)
    mine.write_to_file(tmp_path / "port", "m")
    theirs.write_to_file(tmp_path / "jax", "m")
    assert (tmp_path / "port" / "m.mxxm").read_bytes() == (tmp_path / "jax" / "m.mxxm").read_bytes()
    _same(PolyMatrix.read_from_file(p, tmp_path / "jax", "m", device="cpu"), theirs)
    _same(mine, JaxPolyMatrix.read_from_file(jp, tmp_path / "port", "m"))


# -------------------------------------------------------------- samplers


@pytest.mark.parametrize("args", ARGS)
def test_hash_decomposed_samplers_equal(args):
    p, jp = _params(args)
    hs, jhs = HashSampler(device="cpu"), JaxHashSampler()
    d, jd = FinRingDist(), JaxFinRingDist()
    got = hs.sample_hash_decomposed(p, KEY, "t", 2, 3, d)
    _same(got, jhs.sample_hash_decomposed(jp, KEY, "t", 2, 3, jd))
    assert got == hs.sample_hash(p, KEY, "t", 2, 3, d).decompose()
    got = hs.sample_hash_decomposed_columns(p, KEY, "t", 2, 5, 1, 3, d)
    _same(got, jhs.sample_hash_decomposed_columns(jp, KEY, "t", 2, 5, 1, 3, jd))
    assert got == hs.sample_hash(p, KEY, "t", 2, 5, d).slice_columns(1, 4).decompose()
    got = hs.sample_hash_small_decomposed(p, KEY, "u", 2, 3, d)
    _same(got, jhs.sample_hash_small_decomposed(jp, KEY, "u", 2, 3, jd))
    assert got == hs.sample_hash(p, KEY, "u", 2, 3, d).small_decompose()


@pytest.mark.parametrize("sigma", [0.5, 4.0, 300.0])
def test_gauss_ints_table_path_equal(sigma):
    key = core.derive_key(KEY, "g", b"", device="cpu")
    got = core.gauss_ints(key, (4, 64), sigma)
    want = np.asarray(jax_core.gauss_ints(jax_core.derive_key(KEY, "g", b""), (4, 64), sigma))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_gauss_ints_karney_path_by_distribution():
    sigma = 1000.0
    x = core.gauss_ints(core.derive_key(KEY, "k", b"", device="cpu"), (20000,), sigma)
    assert x.dtype == torch.int64
    x = x.to(torch.float64)
    # 20000 draws: the mean's standard error is sigma / 141, the variance's ~1%
    assert abs(float(x.mean())) < 5 * sigma / 141
    assert abs(float(x.var()) / sigma**2 - 1) < 0.05
    y = np.asarray(jax_core.gauss_ints(jax_core.derive_key(KEY, "k", b""), (20000,), sigma))
    assert abs(float(x.var()) - float(y.var())) / sigma**2 < 0.05
