"""mxx_tpu_torch matrix layer against mxx_tpu, bit for bit: zq_matmul,
digit_decompose, the gadget matrix, Poly and PolyMatrix algebra and format
changes. Inputs are drawn from seeded numpy generators."""

import numpy as np
import pytest
import torch

import mxx_tpu  # noqa: F401
import jax.numpy as jnp

from mxx_tpu.matrix import PolyMatrix as JaxPolyMatrix
from mxx_tpu.ops.decompose import digit_decompose as jax_digit_decompose
from mxx_tpu.ops.zq_matmul import zq_matmul as jax_zq_matmul
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.ring.poly import Poly as JaxPoly

from mxx_tpu_torch import convert
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ops.decompose import digit_decompose
from mxx_tpu_torch.ops.zq_matmul import zq_matmul
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import COEFF, EVAL, Poly

ARGS = [(16, 2, 20, 5), (32, 3, 28, 14)]


def _residues(params, lead, seed):
    rng = np.random.default_rng(seed)
    out = np.empty((params.crt_depth,) + tuple(lead) + (params.n,), dtype=np.uint32)
    for t, q in enumerate(params.moduli):
        out[t] = rng.integers(0, q, size=out.shape[1:], dtype=np.uint64)
    return out


def _both(args, lead, seed, fmt):
    """The same random matrix in both packages."""
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    arr = _residues(p, lead, seed)
    return convert.poly_matrix_from_numpy(p, arr, fmt, device="cpu"), JaxPolyMatrix(jnp.asarray(arr), fmt, jp)


def _same(mine: PolyMatrix, theirs: JaxPolyMatrix):
    assert mine.fmt == theirs.fmt
    np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))


@pytest.mark.parametrize("args", ARGS)
def test_zq_matmul_equal(args):
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    a, b = _residues(p, (2, 5), 1), _residues(p, (5, 3), 2)
    jt = jp.jt
    want = jax_zq_matmul(jnp.asarray(a), jnp.asarray(b), jt.moduli, jt.qinv_neg,
                         jt.combine_pows_mont, jt.sign_corr_pows)
    got = zq_matmul(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)),
                    p.tables("cpu").moduli)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("args", ARGS)
@pytest.mark.parametrize("small", [False, True])
def test_digit_decompose_equal(args, small):
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    x = _residues(p, (2, 3), 3)
    towers = 1 if small else p.crt_depth
    want = jax_digit_decompose(jnp.asarray(x), jp.jt.moduli, jp.jt.digit_masks,
                               base_bits=p.base_bits, dpt=p.digits_per_tower, towers=towers)
    t = p.tables("cpu")
    got = digit_decompose(torch.from_numpy(x.astype(np.int64)), t.moduli, t.digit_masks,
                          base_bits=p.base_bits, dpt=p.digits_per_tower, towers=towers)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("args", ARGS)
def test_gadget_identity_zero_equal(args):
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    _same(PolyMatrix.gadget_matrix(p, 2, device="cpu"), JaxPolyMatrix.gadget_matrix(jp, 2))
    _same(PolyMatrix.identity(p, 3, device="cpu"), JaxPolyMatrix.identity(jp, 3))
    _same(PolyMatrix.zero(p, 2, 3, COEFF, device="cpu"), JaxPolyMatrix.zero(jp, 2, 3, COEFF))


@pytest.mark.parametrize("args", ARGS)
def test_poly_matrix_algebra_equal(args):
    a, ja = _both(args, (2, 3), 4, COEFF)
    b, jb = _both(args, (3, 2), 5, COEFF)
    c, jc = _both(args, (2, 3), 6, EVAL)
    _same(a.to_eval(), ja.to_eval())
    _same(c.to_coeff(), jc.to_coeff())
    _same(a @ b, ja @ jb)
    _same(a + c, ja + jc)
    _same(a - a, ja - ja)
    _same(c - a, jc - ja)
    _same(-a, -ja)
    _same(a.mul_int_scalar(-12345), ja.mul_int_scalar(-12345))
    _same(a.decompose(), ja.decompose())
    _same(c.decompose(), jc.decompose())
    _same(a.transpose(), ja.transpose())
    _same(a.slice(0, 1, 1, 3), ja.slice(0, 1, 1, 3))
    _same(a.concat_columns([c]), ja.concat_columns([jc]))
    _same(c.concat_rows([a, c]), jc.concat_rows([ja, jc]))
    assert a.to_eval() == a and not (a == c)
    # G @ G^{-1}(x) == x
    p = a.params
    assert PolyMatrix.gadget_matrix(p, 2, device="cpu") @ a.decompose() == a


def test_poly_equal():
    args = (16, 2, 20, 5)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    arr = _residues(p, (2,), 7)
    a = Poly(torch.from_numpy(arr[:, 0].astype(np.int64)), COEFF, p)
    b = Poly(torch.from_numpy(arr[:, 1].astype(np.int64)), EVAL, p)
    ja = JaxPoly(jnp.asarray(arr[:, 0]), COEFF, jp)
    jb = JaxPoly(jnp.asarray(arr[:, 1]), EVAL, jp)
    for mine, theirs in [(a * b, ja * jb), (a + b, ja + jb), (a - b, ja - jb), (-a, -ja),
                         (a.to_eval(), ja.to_eval()), (b.to_coeff(), jb.to_coeff()),
                         (Poly.const(p, -3, device="cpu"), JaxPoly.const(jp, -3)),
                         (Poly.one(p, device="cpu"), JaxPoly.one(jp)), (Poly.zero(p, device="cpu"), JaxPoly.zero(jp))]:
        assert mine.fmt == theirs.fmt
        np.testing.assert_array_equal(mine.data.numpy(), np.asarray(theirs.data).astype(np.int64))
    assert a * Poly.one(p, device="cpu") == a
