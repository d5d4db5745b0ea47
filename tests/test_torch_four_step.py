"""mxx_tpu_torch four-step NTT against mxx_tpu: the W2 / T / W1 tables and
their inverses, and the plain four-step against the Pallas four-step kernel
(interpret mode, as tests/test_pallas_ntt_fused.py runs it) and the radix
chain, bit for bit. The CUDA kernel tests carry the `cuda` marker and skip
without a card.

The machine with the card has no jax, so the JAX package is imported inside
the tests that compare with it, and the kernel tests run there with

    python -m pytest --noconftest -m cuda tests/test_torch_four_step.py
"""

import numpy as np
import pytest
import torch

from mxx_tpu_torch.ops import four_step
from mxx_tpu_torch.ring import ntt
from mxx_tpu_torch.ring.params import RingParams


def _residues(params, B, seed):
    rng = np.random.default_rng(seed)
    x = np.empty((params.crt_depth, B, params.n), dtype=np.uint32)
    for t, q in enumerate(params.moduli):
        x[t] = rng.integers(0, q, size=(B, params.n), dtype=np.uint64)
    return x


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_tables_and_inverses_equal():
    import mxx_tpu  # noqa: F401
    from mxx_tpu.ops.four_step_ntt import _tables as jax_tables
    from mxx_tpu.ops.pallas_four_step import _mod_matinv as jax_mod_matinv
    from mxx_tpu.ring.params import RingParams as JaxRingParams

    args = (1024, 2, 28, 14)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    mine = four_step._tables(p, 16)
    theirs = jax_tables(jp, 16)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    w2, t_mont, w1 = theirs
    inv_left, inv_tw, inv_right = four_step._std_tables(p, 16, inverse=True)
    fwd_left, fwd_tw, fwd_right = four_step._std_tables(p, 16, inverse=False)
    for t, q in enumerate(p.moduli):
        want_w2i = jax_mod_matinv(w2[t], q)
        want_w1i = jax_mod_matinv(w1[t], q)
        np.testing.assert_array_equal(four_step._mod_matinv(w2[t], q), want_w2i)
        np.testing.assert_array_equal(four_step._mod_matinv(w1[t], q), want_w1i)
        np.testing.assert_array_equal(inv_left[t], want_w2i)
        np.testing.assert_array_equal(inv_right[t], want_w1i)
        t_std = t_mont[t].astype(object) * pow(1 << 32, -1, q) % q
        np.testing.assert_array_equal(fwd_tw[t], t_std.astype(np.int64))
        assert np.all(fwd_tw[t] * inv_tw[t] % q == 1)


def test_plain_four_step_equals_pallas_and_chain():
    import mxx_tpu  # noqa: F401
    import jax.numpy as jnp
    from mxx_tpu.ops.pallas_four_step import four_step_ntt_fwd_fused, four_step_ntt_inv_fused
    from mxx_tpu.ring.ntt import ntt_fwd as jax_ntt_fwd
    from mxx_tpu.ring.ntt import ntt_inv as jax_ntt_inv
    from mxx_tpu.ring.params import RingParams as JaxRingParams

    args = (1024, 2, 28, 14)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    jt = jp.jt
    x = _residues(p, 4, 7)
    xj = jnp.asarray(x)
    want = np.asarray(four_step_ntt_fwd_fused(xj, params=jp, n1=16, p_polys=2, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_ntt_fwd(xj, jt.psi_rev_mont, jt.moduli, jt.qinv_neg)))
    got = four_step.four_step_ntt_fwd_plain(_t(x), p, 16)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))

    want_back = np.asarray(four_step_ntt_inv_fused(jnp.asarray(want), params=jp, n1=16,
                                                   p_polys=2, interpret=True))
    np.testing.assert_array_equal(
        want_back,
        np.asarray(jax_ntt_inv(jnp.asarray(want), jt.psi_inv_rev_mont, jt.n_inv_mont,
                               jt.moduli, jt.qinv_neg)))
    back = four_step.four_step_ntt_inv_plain(got, p, 16)
    np.testing.assert_array_equal(back.numpy(), want_back.astype(np.int64))
    assert torch.equal(back, _t(x))


@pytest.mark.parametrize("n", [2048, 8192, 16384])
def test_plain_four_step_at_plan_shapes(n):
    """At the n the card's plan covers (n1 = n / 128), the plain four-step
    equals the port's radix chain in both directions."""
    p = RingParams.new(n, 1, 24, 12)
    t = p.tables("cpu")
    n1 = n // 128
    x = _t(_residues(p, 2, n))
    fwd = four_step.four_step_ntt_fwd_plain(x, p, n1)
    assert torch.equal(fwd, ntt.ntt_fwd(x, t.psi_rev, t.moduli))
    assert torch.equal(four_step.four_step_ntt_inv_plain(fwd, p, n1), x)


def test_wrapper_on_cpu_takes_plain_and_rejects_bad_input():
    p = RingParams.new(1024, 2, 28, 14)
    x = _t(_residues(p, 3, 3)).reshape(2, 3, 1, 1024)
    four_step.launches.update(fwd=0, inv=0)
    y = four_step.four_step_ntt_fwd(x, p, 16)
    assert torch.equal(y, four_step.four_step_ntt_fwd_plain(x, p, 16))
    assert torch.equal(four_step.four_step_ntt_inv(y, p, 16), x)
    assert four_step.launches == {"fwd": 0, "inv": 0}
    with pytest.raises(ValueError, match="CUDA"):
        four_step.check_shape(x, p, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("args,B", [((8192, 8, 28, 14), 16), ((16384, 10, 24, 12), 4)])
def test_kernel_equals_plain_on_card(cuda_device, args, B):
    p = RingParams.new(*args)
    n1 = p.n // 128
    t = p.tables(cuda_device)
    x = _t(_residues(p, B, 1)).to(cuda_device)
    four_step.launches.update(fwd=0, inv=0)
    fwd = four_step.four_step_ntt_fwd(x, p, n1)
    back = four_step.four_step_ntt_inv(fwd, p, n1)
    torch.cuda.synchronize()
    assert four_step.launches == {"fwd": 1, "inv": 1}
    assert torch.equal(fwd, four_step.four_step_ntt_fwd_plain(x, p, n1))
    assert torch.equal(fwd, ntt.ntt_fwd(x, t.psi_rev, t.moduli))
    assert torch.equal(back, x)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    p = RingParams.new(8192, 2, 28, 14)
    x = _t(_residues(p, 4, 2)).to(cuda_device)
    with pytest.raises(TypeError):
        four_step.four_step_ntt_fwd(x.to(torch.int32), p, 64)
    with pytest.raises(ValueError):
        four_step.four_step_ntt_fwd(x.transpose(1, 2), p, 64)
    with pytest.raises(ValueError):
        four_step.four_step_ntt_fwd(x, p, 2)


@pytest.mark.cuda
def test_ntt_auto_on_card_launches_kernels(cuda_device):
    """ntt_*_auto sends a CUDA tensor with 2048 <= n <= 16384 to the kernels,
    and the radix chain takes n outside that range on the card too."""
    p = RingParams.new(2048, 2, 28, 14)
    x = _t(_residues(p, 3, 5)).to(cuda_device)
    four_step.launches.update(fwd=0, inv=0)
    y = ntt.ntt_fwd_auto(x, p)
    back = ntt.ntt_inv_auto(y, p)
    torch.cuda.synchronize()
    assert four_step.launches == {"fwd": 1, "inv": 1}
    assert torch.equal(back, x)
    small = RingParams.new(1024, 2, 28, 14)
    xs = _t(_residues(small, 3, 6)).to(cuda_device)
    assert torch.equal(ntt.ntt_inv_auto(ntt.ntt_fwd_auto(xs, small), small), xs)
    assert four_step.launches == {"fwd": 1, "inv": 1}
