"""`PolyMatrix.modulus_switch` of the port against the JAX package.

Both the device path (P < 2^32: exact integer parts mod P, float64
fractions limb by limb, the `>= 0.5` rule) and the host big-int path (larger
P), at `RingParams.new(16, 3, 28, 14)` and `RingParams.new(4, 3, 10, 10)`:
bit for bit against `mxx_tpu`, and against the exact rounding
(c P + q // 2) // q mod P on every coefficient whose fraction is not within
2^-18 of 1/2. Each matrix holds, besides random residues, the two
coefficients c whose c P mod q lies closest to q / 2 on either side,
(q + g) / 2 and (q - g) / 2 with g = gcd(P, q): the fractions closest to 1/2
that q and P allow.
"""

import math

import numpy as np
import pytest

import mxx_tpu_torch.convert as convert
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import COEFF

RINGS = [(16, 3, 28, 14), (4, 3, 10, 10)]


def _matrix(params, new_modulus, seed):
    """uint32 COEFF residues [L, 2, 3, n]: random, plus the two half-way
    coefficients at entry (0, 0), coefficients 0 and 1."""
    rng = np.random.default_rng(seed)
    L, n = params.crt_depth, params.n
    data = np.stack([rng.integers(0, q, size=(2, 3, n)) for q in params.moduli]).astype(np.uint32)
    q = params.modulus
    g = math.gcd(new_modulus, q)
    qg = q // g
    p_inv = pow(new_modulus // g, -1, qg)
    for j, target in enumerate(((qg + 1) // 2, (qg - 1) // 2)):
        c = target * p_inv % qg
        for t, qt in enumerate(params.moduli):
            data[t, 0, 0, j] = c % qt
    return data


def _exact(params, data, new_modulus):
    q = params.modulus
    out = np.zeros(data.shape, dtype=np.int64)
    near_half = np.zeros(data.shape[1:], dtype=bool)
    for i in range(data.shape[1]):
        for j in range(data.shape[2]):
            for k in range(data.shape[3]):
                c = params.reconstruct_coeff(data[:, i, j, k])
                v = (c * new_modulus + q // 2) // q % new_modulus
                rem = c * new_modulus % q
                near_half[i, j, k] = abs(2 * rem - q) < (q >> 17)
                for t, qt in enumerate(params.moduli):
                    out[t, i, j, k] = v % qt
    return out, near_half


def _jax_switch(ring, data, new_modulus):
    import jax.numpy as jnp

    from mxx_tpu.matrix import PolyMatrix as JMatrix
    from mxx_tpu.ring.params import RingParams as JParams

    jp = JParams.new(*ring)
    m = JMatrix(jnp.asarray(data), "coeff", jp).modulus_switch(new_modulus)
    return np.asarray(m.to_coeff().data)


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("which", ["limb0", "limb_last", "p17"])
def test_modulus_switch_u32_matches_jax(ring, which):
    params = RingParams.new(*ring)
    new_modulus = {"limb0": params.moduli[0], "limb_last": params.moduli[-1],
                   "p17": 131071}[which]
    data = _matrix(params, new_modulus, seed=sum(ring) + len(which))
    got = convert.poly_matrix_from_numpy(params, data, COEFF, "cpu").modulus_switch(new_modulus)
    assert got.fmt == COEFF
    got_np = convert.to_numpy(got)
    np.testing.assert_array_equal(got_np, _jax_switch(ring, data, new_modulus))
    want, near_half = _exact(params, data, new_modulus)
    assert near_half[0, 0, 0] and near_half[0, 0, 1]
    mism = (got_np.astype(np.int64) != want).any(axis=0)
    assert not (mism & ~near_half).any(), "off the half-way band the rounding must be exact"


@pytest.mark.parametrize("ring", RINGS)
def test_modulus_switch_bigint_matches_jax(ring):
    params = RingParams.new(*ring)
    new_modulus = (1 << 40) + 15
    data = _matrix(params, new_modulus, seed=7 + sum(ring))
    data = data[:, :1, :2]
    got = convert.poly_matrix_from_numpy(params, data, COEFF, "cpu").modulus_switch(new_modulus)
    got_np = convert.to_numpy(got.to_coeff())
    np.testing.assert_array_equal(got_np, _jax_switch(ring, data, new_modulus))
    want, _ = _exact(params, data, new_modulus)
    np.testing.assert_array_equal(got_np.astype(np.int64), want)


def test_modulus_switch_from_eval_form():
    """An EVAL matrix is switched from its coefficients, as in the JAX package."""
    params = RingParams.new(16, 3, 28, 14)
    data = _matrix(params, params.moduli[1], seed=3)
    m = convert.poly_matrix_from_numpy(params, data, COEFF, "cpu")
    a = m.modulus_switch(params.moduli[1])
    b = m.to_eval().modulus_switch(params.moduli[1])
    assert a == b
