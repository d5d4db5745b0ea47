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
from mxx_tpu_torch.utils import tracing


def _launches(rec, *names) -> dict:
    """The recording's deltas of the kernel-launch counters `names`."""
    return {n: rec.counters[n] for n in names}


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


def _shoup(b, t, q):
    """b * w mod q as the kernel computes it: t = (w, floor(w 2^32 / q)) on
    the last axis, 32-bit wrap-around emulated in int64 (b, w < q < 2^31)."""
    w, wq = t[..., 0], t[..., 1]
    r = (b * w - ((b * wq) >> 32) * q) & 0xFFFFFFFF
    return torch.where(r >= q, r - q, r)


def _stages(v, tw, q, cyclic, inverse):
    """The kernel's radix-2 stages along the last axis of v [L, P, N]: stage
    j's block i takes tw[2^j + i] (negacyclic) or tw[i] (cyclic); Cooley-Tukey
    forward, Gentleman-Sande in the reverse order for the inverse."""
    L, P, N = v.shape
    log_n = N.bit_length() - 1
    for j in (reversed(range(log_n)) if inverse else range(log_n)):
        m = 1 << j
        u = v.reshape(L, P, m, 2, N // (2 * m))
        w = tw[:, torch.arange(m) + (0 if cyclic else m)].reshape(L, 1, m, 1, 2)
        a, b = u[..., 0, :], u[..., 1, :]
        if inverse:
            a, b = (a + b) % q, _shoup((a - b) % q, w, q)
        else:
            wb = _shoup(b, w, q)
            a, b = (a + wb) % q, (a - wb) % q
        v = torch.stack((a, b), dim=-2).reshape(L, P, N)
    return v


def _schedule(x, p, n1, inverse):
    """A torch statement of the kernel's schedule over its tables: forward,
    step a on the columns, the twist, step c on the rows; inverse, the rows,
    the twist (n^-1 folded in), the columns."""
    L, n = x.shape[0], x.shape[-1]
    n2 = n // n1
    col, twist, row = (_t(a) for a in four_step._kernel_tables(p, n1, inverse))
    q = _t(p.np_moduli).view(L, 1, 1, 1)
    xs = x.reshape(L, -1, n2, n1)
    B = xs.shape[1]

    def columns(v):
        v = v.transpose(-1, -2).reshape(L, B * n1, n2)
        v = _stages(v, col, q, cyclic=False, inverse=inverse)
        return v.reshape(L, B, n1, n2).transpose(-1, -2)

    def rows(v):
        return _stages(v.reshape(L, B * n2, n1), row, q, cyclic=True,
                       inverse=inverse).reshape(L, B, n2, n1)

    def twisted(v):
        return _shoup(v, twist.reshape(L, 1, n2, n1, 2), q)

    out = columns(twisted(rows(xs))) if inverse else rows(twisted(columns(xs)))
    return out.reshape(x.shape)


@pytest.mark.parametrize("n", [2048, 8192, 16384])
def test_kernel_tables_quotients_and_inverses(n):
    """The kernel's tables: each quotient is floor(w 2^32 / q); the forward
    twist is the dense T; the inverse tables are the inverse powers, and the
    inverse twist is n^-1 T^-1."""
    p = RingParams.new(n, 2, 24, 12)
    n1 = n // 128
    fwd = four_step._kernel_tables(p, n1, inverse=False)
    inv = four_step._kernel_tables(p, n1, inverse=True)
    assert [a.shape for a in fwd] == [(2, 128, 2), (2, n, 2), (2, n1 // 2, 2)]
    t_dense = four_step._std_tables(p, n1, inverse=False)[1]
    for t, q in enumerate(p.moduli):
        n_inv = pow(n, -1, q)
        for f, i in zip(fwd, inv):
            for table in (f[t], i[t]):
                w = table[..., 0].astype(object)
                assert np.all(w < q)
                np.testing.assert_array_equal(table[..., 1].astype(object), (w << 32) // q)
        for f, i in zip((fwd[0], fwd[2]), (inv[0], inv[2])):
            assert np.all(f[t, :, 0].astype(object) * i[t, :, 0].astype(object) % q == 1)
        np.testing.assert_array_equal(fwd[1][t, :, 0].reshape(128, n1), t_dense[t])
        prod = fwd[1][t, :, 0].astype(object) * inv[1][t, :, 0].astype(object) % q
        assert np.all(prod == n_inv)


@pytest.mark.parametrize("n", [2048, 8192, 16384])
def test_kernel_schedule_equals_dense_and_jax_chain(n):
    """At the plan shapes the kernel's schedule over its tables equals the
    dense plain version and the JAX package's radix chain bit for bit, in
    both directions."""
    import mxx_tpu  # noqa: F401
    import jax.numpy as jnp
    from mxx_tpu.ring.ntt import ntt_fwd as jax_ntt_fwd
    from mxx_tpu.ring.ntt import ntt_inv as jax_ntt_inv
    from mxx_tpu.ring.params import RingParams as JaxRingParams

    args = (n, 2, 24, 12)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    jt = jp.jt
    n1 = n // 128
    x_np = _residues(p, 2, n + 1)
    x = _t(x_np)
    fwd = _schedule(x, p, n1, inverse=False)
    assert torch.equal(fwd, four_step.four_step_ntt_fwd_plain(x, p, n1))
    want = np.asarray(jax_ntt_fwd(jnp.asarray(x_np), jt.psi_rev_mont, jt.moduli, jt.qinv_neg))
    np.testing.assert_array_equal(fwd.numpy(), want.astype(np.int64))
    back = _schedule(fwd, p, n1, inverse=True)
    assert torch.equal(back, four_step.four_step_ntt_inv_plain(fwd, p, n1))
    want_back = np.asarray(jax_ntt_inv(jnp.asarray(want), jt.psi_inv_rev_mont, jt.n_inv_mont,
                                       jt.moduli, jt.qinv_neg))
    np.testing.assert_array_equal(back.numpy(), want_back.astype(np.int64))
    assert torch.equal(back, x)


def test_kernel_schedule_equals_pallas_fused():
    """At n=1024, n1=16 (the fused TPU path needs p_polys n1 <= 128) the
    kernel's schedule equals the Pallas kernels in interpret mode."""
    import mxx_tpu  # noqa: F401
    import jax.numpy as jnp
    from mxx_tpu.ops.pallas_four_step import four_step_ntt_fwd_fused, four_step_ntt_inv_fused
    from mxx_tpu.ring.params import RingParams as JaxRingParams

    args = (1024, 2, 28, 14)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    x = _residues(p, 4, 8)
    want = np.asarray(four_step_ntt_fwd_fused(jnp.asarray(x), params=jp, n1=16, p_polys=2,
                                              interpret=True))
    fwd = _schedule(_t(x), p, 16, inverse=False)
    np.testing.assert_array_equal(fwd.numpy(), want.astype(np.int64))
    want_back = np.asarray(four_step_ntt_inv_fused(jnp.asarray(want), params=jp, n1=16,
                                                   p_polys=2, interpret=True))
    back = _schedule(fwd, p, 16, inverse=True)
    np.testing.assert_array_equal(back.numpy(), want_back.astype(np.int64))
    assert torch.equal(back, _t(x))


def test_wrapper_on_cpu_takes_plain_and_rejects_bad_input():
    p = RingParams.new(1024, 2, 28, 14)
    x = _t(_residues(p, 3, 3)).reshape(2, 3, 1, 1024)
    with tracing.recording() as rec:
        y = four_step.four_step_ntt_fwd(x, p, 16)
        assert torch.equal(y, four_step.four_step_ntt_fwd_plain(x, p, 16))
        assert torch.equal(four_step.four_step_ntt_inv(y, p, 16), x)
    assert _launches(rec, "ntt.k1", "ntt.k2") == {"ntt.k1": 0, "ntt.k2": 0}
    with pytest.raises(ValueError, match="CUDA"):
        four_step.check_shape(x, p, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("args,B", [((8192, 8, 28, 14), 16), ((16384, 10, 24, 12), 4)])
def test_kernel_equals_plain_on_card(cuda_device, args, B):
    p = RingParams.new(*args)
    n1 = p.n // 128
    t = p.tables(cuda_device)
    x = _t(_residues(p, B, 1)).to(cuda_device)
    with tracing.recording() as rec:
        fwd = four_step.four_step_ntt_fwd(x, p, n1)
        back = four_step.four_step_ntt_inv(fwd, p, n1)
    torch.cuda.synchronize()
    assert _launches(rec, "ntt.k1", "ntt.k2") == {"ntt.k1": 1, "ntt.k2": 1}
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
    # the kernel takes n2 = 128 only: n1 = 128 at n = 8192 would give n2 = 64
    with pytest.raises(ValueError, match="n2"):
        four_step.four_step_ntt_inv(x, p, 128)
    small = RingParams.new(1024, 2, 28, 14)
    with pytest.raises(ValueError, match="bounds"):
        four_step.four_step_ntt_fwd(_t(_residues(small, 2, 2)).to(cuda_device), small, 8)


@pytest.mark.cuda
def test_ntt_auto_on_card_launches_kernels(cuda_device):
    """ntt_*_auto sends a CUDA tensor with 2048 <= n <= 16384 to the kernels,
    and the radix chain takes n outside that range on the card too."""
    p = RingParams.new(2048, 2, 28, 14)
    x = _t(_residues(p, 3, 5)).to(cuda_device)
    with tracing.recording() as rec:
        y = ntt.ntt_fwd_auto(x, p)
        back = ntt.ntt_inv_auto(y, p)
    torch.cuda.synchronize()
    assert _launches(rec, "ntt.k1", "ntt.k2") == {"ntt.k1": 1, "ntt.k2": 1}
    assert torch.equal(back, x)
    small = RingParams.new(1024, 2, 28, 14)
    xs = _t(_residues(small, 3, 6)).to(cuda_device)
    with tracing.recording() as rec:
        assert torch.equal(ntt.ntt_inv_auto(ntt.ntt_fwd_auto(xs, small), small), xs)
    assert _launches(rec, "ntt.k1", "ntt.k2") == {"ntt.k1": 0, "ntt.k2": 0}
