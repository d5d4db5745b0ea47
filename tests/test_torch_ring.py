"""mxx_tpu_torch ring layer against mxx_tpu: RingParams host tables, the
modular ops, and the radix NTT chain, bit for bit; CPU routing of
ntt_*_auto. Inputs are drawn from seeded numpy generators."""

import numpy as np
import pytest
import torch

import mxx_tpu  # noqa: F401
import jax.numpy as jnp

from mxx_tpu.ring.ntt import ntt_fwd as jax_ntt_fwd
from mxx_tpu.ring.ntt import ntt_inv as jax_ntt_inv
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.utils import u32 as jax_u32

from mxx_tpu_torch.ops import elementwise
from mxx_tpu_torch.ring import ntt
from mxx_tpu_torch.ring.element import FinRingElem
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.utils import tracing, u32

NP_TABLES = [
    "np_moduli", "np_qinv_neg", "np_r1", "np_r2", "np_psi_rev_mont",
    "np_psi_inv_rev_mont", "np_n_inv_mont", "np_gadget_res",
    "np_small_gadget_res", "np_digit_masks", "np_combine_pows_mont",
    "np_sign_corr_pows",
]


def _residues(params, lead, seed):
    """uint32[L, *lead, n] uniform residues."""
    rng = np.random.default_rng(seed)
    out = np.empty((params.crt_depth,) + tuple(lead) + (params.n,), dtype=np.uint32)
    for t, q in enumerate(params.moduli):
        out[t] = rng.integers(0, q, size=out.shape[1:], dtype=np.uint64)
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("args", [(4, 2, 17, 1), (16, 2, 20, 5), (1024, 3, 28, 14),
                                  (64, 1, 30, 7)])
def test_params_tables_equal(args):
    jp, p = JaxRingParams.new(*args), RingParams.new(*args)
    assert p.moduli == jp.moduli and p.modulus == jp.modulus
    assert p.crt_idempotents == jp.crt_idempotents
    assert (p.digits_per_tower, p.modulus_digits, p.decompose_last_mask) == (
        jp.digits_per_tower, jp.modulus_digits, jp.decompose_last_mask)
    for name in NP_TABLES:
        np.testing.assert_array_equal(getattr(p, name), getattr(jp, name), err_msg=name)
    # the device tables are the standard forms of the Montgomery ones
    t = p.tables("cpu")
    q = t.moduli[:, None]
    r = (1 << 32) % q
    assert torch.equal(t.psi_rev * r % q, _t(p.np_psi_rev_mont))
    assert torch.equal(t.psi_inv_rev * r % q, _t(p.np_psi_inv_rev_mont))
    assert torch.equal(t.n_inv * r[:, 0] % t.moduli, _t(p.np_n_inv_mont))


@pytest.mark.parametrize("args", [(4, 2, 17, 1), (16, 3, 24, 5), (8192, 8, 28, 14)])
def test_to_crt_equal(args):
    jp, p = JaxRingParams.new(*args), RingParams.new(*args)
    assert p.to_crt() == jp.to_crt() == (jp.moduli, args[2], args[1])


def test_u32_ops_equal():
    p = RingParams.new(16, 3, 30, 10)
    jp = JaxRingParams.new(16, 3, 30, 10)
    a = _residues(p, (64,), 1)
    b = _residues(p, (64,), 2)
    b[:, :3] = 0  # zero operands exercise negmod and the Montgomery carry
    jq = jnp.asarray(jp.np_moduli)[:, None, None]
    jqi = jnp.asarray(jp.np_qinv_neg)[:, None, None]
    jr2 = jnp.asarray(jp.np_r2)[:, None, None]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    q, qi = _t(p.np_moduli)[:, None, None], _t(p.np_qinv_neg)[:, None, None]
    pairs = [
        (u32.addmod(ta, tb, q), jax_u32.addmod(ja, jb, jq)),
        (u32.submod(ta, tb, q), jax_u32.submod(ja, jb, jq)),
        (u32.negmod(tb, q), jax_u32.negmod(jb, jq)),
        (u32.mulmod(ta, tb, q), jax_u32.mulmod(ja, jb, jq, jqi, jr2)),
        (u32.montmul(ta, tb, q, qi), jax_u32.montmul(ja, jb, jq, jqi)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_elementwise_and_element():
    p = RingParams.new(16, 2, 20, 5)
    a, b = _t(_residues(p, (3,), 3)), _t(_residues(p, (3,), 4))
    q = p.tables("cpu").moduli
    qb = q[:, None, None]
    assert torch.equal(elementwise.ew_add(a, b, q), (a + b) % qb)
    assert torch.equal(elementwise.ew_sub(a, b, q), (a - b) % qb)
    assert torch.equal(elementwise.ew_neg(a, q), (-a) % qb)
    assert torch.equal(elementwise.ew_mul(a, b, q), a * b % qb)
    assert torch.equal(elementwise.ew_mul_const(a, q - 1, q), (-a) % qb)
    assert torch.equal(elementwise.reduce_once(a + qb, q), a)
    x = FinRingElem(7, 11)
    assert (x * x).value == 5 and (-x).value == 4 and x.modulus_switch(22).value == 14


@pytest.mark.parametrize("n", [16, 1024])
@pytest.mark.parametrize("L", [2, 3])
def test_ntt_chain_equal(n, L):
    p, jp = RingParams.new(n, L, 28, 14), JaxRingParams.new(n, L, 28, 14)
    x = _residues(p, (3, 2), 10 * n + L)
    jt, t = jp.jt, p.tables("cpu")
    want = np.asarray(jax_ntt_fwd(jnp.asarray(x), jt.psi_rev_mont, jt.moduli, jt.qinv_neg))
    got = ntt.ntt_fwd(_t(x), t.psi_rev, t.moduli)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    want_inv = np.asarray(jax_ntt_inv(jnp.asarray(want), jt.psi_inv_rev_mont, jt.n_inv_mont,
                                      jt.moduli, jt.qinv_neg))
    back = ntt.ntt_inv(got, t.psi_inv_rev, t.n_inv, t.moduli)
    np.testing.assert_array_equal(back.numpy(), want_inv.astype(np.int64))
    assert torch.equal(back, _t(x))


def test_ntt_pointwise_mul_is_negacyclic():
    p = RingParams.new(16, 2, 20, 5)
    t = p.tables("cpu")
    a, b = _residues(p, (), 5), _residues(p, (), 6)
    prod = ntt.pointwise_mul(ntt.ntt_fwd(_t(a), t.psi_rev, t.moduli),
                             ntt.ntt_fwd(_t(b), t.psi_rev, t.moduli), t.moduli)
    got = ntt.ntt_inv(prod, t.psi_inv_rev, t.n_inv, t.moduli).numpy()
    n = p.n
    for limb, q in enumerate(p.moduli):
        want = [0] * n
        for i in range(n):
            for j in range(n):
                s = 1 if i + j < n else -1
                want[(i + j) % n] += s * int(a[limb, i]) * int(b[limb, j])
        assert got[limb].tolist() == [w % q for w in want]


def test_ntt_auto_on_cpu_takes_the_chain():
    """A CPU tensor never reaches the kernel wrappers, even at an n that the
    card's plan sends to them."""
    p = RingParams.new(2048, 2, 28, 14)
    x = _t(_residues(p, (2,), 7))
    t = p.tables("cpu")
    with tracing.recording() as rec:
        y = ntt.ntt_fwd_auto(x, p)
        assert torch.equal(y, ntt.ntt_fwd(x, t.psi_rev, t.moduli))
        assert torch.equal(ntt.ntt_inv_auto(y, p), x)
    assert (rec.counters["ntt.k1"], rec.counters["ntt.k2"]) == (0, 0)
    assert (rec.counters["ntt.chain_fwd"], rec.counters["ntt.chain_inv"]) == (1, 1)
    assert ntt._fused_plan(x) is None
