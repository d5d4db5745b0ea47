"""`rlwe_encrypt` of the port against the JAX package (mirrors
`tests/test_misc_gadgets.py::test_rlwe_encrypt_decrypt`): the same seeded
bit and table-Gaussian draws give b bit for bit (tolerance 0), and
b - a t decrypts to m by the q/4 threshold."""

import importlib
from types import SimpleNamespace

import numpy as np

BOTH = ("mxx_tpu", "mxx_tpu_torch")


def _encrypt(pkg):
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in {
        "params": "ring.params", "matrix": "matrix", "sampler": "sampler",
        "rlwe": "rlwe_enc"}.items()})
    kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    params = ns.params.RingParams.default()
    sampler = ns.sampler.UniformSampler(seed=31, **kw)
    m, a, t = (sampler.sample_poly(params, ns.sampler.BitDist()) for _ in range(3))
    row = ns.matrix.PolyMatrix.from_poly_row
    m_mat, a_mat, t_mat = (row(params, [p]) for p in (m, a, t))
    b = ns.rlwe.rlwe_encrypt(params, sampler, t_mat, a_mat, m_mat, 3.0)
    recovered = (b - a_mat @ t_mat).entry(0, 0).coeffs()
    q = params.modulus
    quarter = ((q + 1) // 2) >> 1
    bits = [quarter <= c < 3 * quarter for c in recovered]
    m_bits = [c == 1 for c in m.coeffs()]
    b_data = b.to_coeff().data
    return bits, m_bits, np.asarray(b_data.cpu() if hasattr(b_data, "cpu") else b_data)


def test_rlwe_encrypt_decrypt():
    (bits, m_bits, b), (jbits, jm_bits, jb) = (_encrypt(p) for p in BOTH[::-1])
    assert bits == m_bits == jbits == jm_bits
    np.testing.assert_array_equal(b.astype(np.uint32), jb.astype(np.uint32))
