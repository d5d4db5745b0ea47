"""mxx_tpu_torch radix-2 NTT head and hybrid transform against mxx_tpu: the
plain versions against the Pallas head kernel and `ntt_fwd_hybrid` (interpret
mode, as tests/test_pallas_ntt.py runs them) and the radix chain, bit for bit.
The CUDA kernel tests carry the `cuda` marker and skip without a card.

The machine with the card has no jax, so the JAX package is imported inside
the tests that compare with it, and the kernel tests run there with

    python -m pytest --noconftest -m cuda tests/test_torch_hybrid_ntt.py
"""

import numpy as np
import pytest
import torch

from mxx_tpu_torch.ops import four_step, hybrid_ntt
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


# n = 512 is tests/test_pallas_ntt.py's shape (odd log2, two head stages);
# n = 1024 has an even log2 and three head stages
@pytest.mark.parametrize("n", [512, 1024])
def test_head_and_hybrid_equal_pallas(n):
    import mxx_tpu  # noqa: F401
    import jax.numpy as jnp
    from mxx_tpu.ops.pallas_ntt import ntt_fwd_head_pallas
    from mxx_tpu.ops.pallas_ntt import ntt_fwd_hybrid as jax_ntt_fwd_hybrid
    from mxx_tpu.ring.ntt import ntt_fwd as jax_ntt_fwd
    from mxx_tpu.ring.params import RingParams as JaxRingParams

    args = (n, 2, 28, 1)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    jt = jp.jt
    x = _residues(p, 8, 9)
    xj = jnp.asarray(x)
    want_head = np.asarray(ntt_fwd_head_pallas(xj, jt.psi_rev_mont, jt.moduli, jt.qinv_neg,
                                               tile=8, interpret=True))
    want = np.asarray(jax_ntt_fwd_hybrid(xj, jt.psi_rev_mont, jt.moduli, jt.qinv_neg,
                                         tile=8, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_ntt_fwd(xj, jt.psi_rev_mont, jt.moduli, jt.qinv_neg)))

    hybrid_ntt.launches.update(head=0, hybrid=0)
    head = hybrid_ntt.ntt_fwd_head_plain(_t(x), p)
    np.testing.assert_array_equal(head.numpy(), want_head.astype(np.int64))
    assert torch.equal(hybrid_ntt.ntt_fwd_head(_t(x), p), head)
    full = hybrid_ntt.ntt_fwd_hybrid(_t(x), p)
    np.testing.assert_array_equal(full.numpy(), want.astype(np.int64))
    assert torch.equal(hybrid_ntt.ntt_fwd_hybrid_plain(_t(x), p), full)
    # on the CPU the wrappers take the plain versions and launch nothing
    assert hybrid_ntt.launches == {"head": 0, "hybrid": 0}


@pytest.mark.parametrize("n", [2, 64, 128, 256, 2048])
def test_hybrid_equals_radix_chain(n):
    """At n <= 128 the hybrid transform is the radix chain (no head); above,
    the radix-2 stages equal the radix-4 chain on a batch with extra dims."""
    p = RingParams.new(n, 3, 28, 14)
    t = p.tables("cpu")
    x = _t(_residues(p, 6, n)).reshape(3, 2, 3, n)
    assert torch.equal(hybrid_ntt.ntt_fwd_hybrid(x, p), ntt.ntt_fwd(x, t.psi_rev, t.moduli))
    if n <= hybrid_ntt.LANE:
        with pytest.raises(ValueError, match="n > 128"):
            hybrid_ntt.ntt_fwd_head(x, p)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = RingParams.new(1024, 2, 28, 14)
    x = _t(_residues(p, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        hybrid_ntt.check_shape(x, p)
    with pytest.raises(ValueError, match="n > 128"):
        hybrid_ntt.ntt_fwd_head(x[..., :128], p)


def test_shoup_tables_are_exact_quotients():
    p = RingParams.new(256, 3, 28, 14)
    psi, shoup, q = (a.numpy().view(np.uint32).astype(object)
                     for a in hybrid_ntt._device_tables(p, torch.device("cpu")))
    for limb in range(p.crt_depth):
        assert q[limb] == p.moduli[limb]
        assert all(shoup[limb, i] == (int(psi[limb, i]) << 32) // p.moduli[limb]
                   for i in range(p.n))
        np.testing.assert_array_equal(psi[limb].astype(np.int64), p.np_psi_rev[limb])


@pytest.mark.cuda
@pytest.mark.parametrize("args,B", [((8192, 8, 28, 14), 16), ((16384, 10, 24, 12), 4),
                                    ((256, 2, 28, 14), 5)])
def test_kernel_equals_plain_on_card(cuda_device, args, B):
    p = RingParams.new(*args)
    t = p.tables(cuda_device)
    x = _t(_residues(p, B, 1)).to(cuda_device)
    hybrid_ntt.launches.update(head=0, hybrid=0)
    head = hybrid_ntt.ntt_fwd_head(x, p)
    full = hybrid_ntt.ntt_fwd_hybrid(x, p)
    torch.cuda.synchronize()
    assert hybrid_ntt.launches == {"head": 1, "hybrid": 1}
    assert torch.equal(head, hybrid_ntt.ntt_fwd_head_plain(x, p))
    assert torch.equal(full, hybrid_ntt.ntt_fwd_hybrid_plain(x, p))
    assert torch.equal(full, ntt.ntt_fwd(x, t.psi_rev, t.moduli))
    if p.n >= 2048:
        assert torch.equal(full, four_step.four_step_ntt_fwd(x, p, p.n // 128))


@pytest.mark.cuda
def test_kernel_rejects_on_card(cuda_device):
    p = RingParams.new(8192, 2, 28, 14)
    x = _t(_residues(p, 4, 2)).to(cuda_device)
    with pytest.raises(TypeError):
        hybrid_ntt.ntt_fwd_hybrid(x.to(torch.int32), p)
    with pytest.raises(ValueError):
        hybrid_ntt.ntt_fwd_head(x.transpose(1, 2), p)
    big = RingParams.new(32768, 1, 28, 14)
    with pytest.raises(ValueError, match="bounds"):
        hybrid_ntt.ntt_fwd_hybrid(_t(_residues(big, 1, 3)).to(cuda_device), big)
