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
from mxx_tpu_torch.utils import tracing


def _launches(rec) -> dict:
    """The recording's deltas of K3's launch counters."""
    return {n: rec.counters[n] for n in ("ntt.k3_head", "ntt.k3_whole")}


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
# n = 1024 has an even log2 and three head stages; 32768 and 65536 are the
# kernel's largest rings (65536 runs as a cluster of two blocks on the card)
@pytest.mark.parametrize("n", [512, 1024, 32768, 65536])
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
    B = 8 if n <= 1024 else 65536 // n
    x = _residues(p, B, 9)
    xj = jnp.asarray(x)
    want_head = np.asarray(ntt_fwd_head_pallas(xj, jt.psi_rev_mont, jt.moduli, jt.qinv_neg,
                                               tile=B, interpret=True))
    want = np.asarray(jax_ntt_fwd_hybrid(xj, jt.psi_rev_mont, jt.moduli, jt.qinv_neg,
                                         tile=B, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_ntt_fwd(xj, jt.psi_rev_mont, jt.moduli, jt.qinv_neg)))

    with tracing.recording() as rec:
        head = hybrid_ntt.ntt_fwd_head_plain(_t(x), p)
        np.testing.assert_array_equal(head.numpy(), want_head.astype(np.int64))
        assert torch.equal(hybrid_ntt.ntt_fwd_head(_t(x), p), head)
        full = hybrid_ntt.ntt_fwd_hybrid(_t(x), p)
        np.testing.assert_array_equal(full.numpy(), want.astype(np.int64))
        assert torch.equal(hybrid_ntt.ntt_fwd_hybrid_plain(_t(x), p), full)
    # on the CPU the wrappers take the plain versions and launch nothing
    assert _launches(rec) == {"ntt.k3_head": 0, "ntt.k3_whole": 0}


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
    """The kernel's twiddle table holds each twiddle of the whole transform
    once, beside its exact Shoup quotient floor(w 2^32 / q)."""
    p = RingParams.new(256, 3, 28, 14)
    q = hybrid_ntt._device_moduli(p, torch.device("cpu")).numpy().view(np.uint32)
    table = hybrid_ntt.twiddle_table(p, hybrid_ntt.launch_plan(p.n, 1, max(p.moduli)))
    for limb in range(p.crt_depth):
        assert q[limb] == p.moduli[limb]
        psi, shoup = table[limb, 0, :, 0].astype(object), table[limb, 0, :, 1].astype(object)
        assert all(s == (w << 32) // p.moduli[limb] for w, s in zip(psi, shoup))
        np.testing.assert_array_equal(np.sort(table[limb, 0, hybrid_ntt.EXCHANGE_SLOTS:, 0]),
                                      np.sort(p.np_psi_rev[limb, 1:]))


def _all_rings():
    return [1 << e for e in range(8, 17)]


@pytest.mark.parametrize("n", _all_rings())
def test_launch_plan(n):
    """The plan csrc/radix_ntt.cu runs: the stages add up, at most 5 a pass,
    every pass touches each word of its rows once and a warp's accesses fall
    on 32 distinct banks, a block iteration is 16384 coefficients, the cluster
    only above 2^14, the twiddle table C-contiguous, and as many of its whole
    passes in shared memory as fit."""
    p = RingParams.new(n, 2, 30, 15)
    for t_min in (1, hybrid_ntt.LANE):
        plan = hybrid_ntt.launch_plan(n, t_min, max(p.moduli))
        assert plan.threads == hybrid_ntt.THREADS == 512
        assert plan.cluster == max(1, n // 16384)
        assert plan.polys * plan.n_local == 16384
        assert sum(plan.passes) + plan.cluster.bit_length() - 1 == (n // t_min).bit_length() - 1
        assert all(1 <= k <= 5 for k in plan.passes) and len(plan.passes) <= 3
        pitch = plan.n_local + plan.n_local // 32
        words = np.arange(plan.n_local) + np.arange(plan.n_local) // 32
        rows = (np.arange(plan.polys)[:, None] * pitch + words[None, :]).reshape(-1)
        for i in range(len(plan.passes)):
            acc = hybrid_ntt.plan_accesses(plan, i)
            assert acc.shape[0] >= plan.threads
            np.testing.assert_array_equal(np.sort(acc.reshape(-1)), rows)
            for w in range(0, acc.shape[0], 32):
                for r in range(acc.shape[1]):
                    assert len(set(acc[w : w + 32, r] % 32)) == 32
        ends = [off + (((1 << k) - 1) << j0) for off, j0, k
                in zip(plan.tw_offsets, plan.starts, plan.passes)]
        assert plan.tw_entries == ends[-1] <= hybrid_ntt.EXCHANGE_SLOTS + 16384
        assert plan.tw_shared in [hybrid_ntt.EXCHANGE_SLOTS] + ends
        assert plan.tw_shared == plan.tw_entries or plan.data_bytes + 8 * min(
            e for e in ends if e > plan.tw_shared) > hybrid_ntt.SMEM_PER_BLOCK
        assert plan.smem_bytes == plan.data_bytes + 8 * plan.tw_shared
        assert plan.smem_bytes <= hybrid_ntt.SMEM_PER_BLOCK
        table = hybrid_ntt.twiddle_table(p, plan)
        assert table.flags.c_contiguous and table.shape == (2, plan.cluster, plan.tw_entries, 2)
        assert plan.units(10, 1000, 132) == 132 // plan.cluster
    for bad in (dict(n=n * 2 if n == 65536 else 128, t_min=1), dict(n=n, t_min=n)):
        with pytest.raises(ValueError):
            hybrid_ntt.launch_plan(q_max=1 << 29, **bad)


@pytest.mark.parametrize("args,B", [((256, 3, 24, 5), 70), ((2048, 2, 30, 14), 3),
                                    ((16384, 1, 24, 12), 2), ((32768, 2, 28, 14), 1),
                                    ((65536, 1, 24, 12), 2)])
def test_emulated_kernel_equals_plain(args, B):
    """The kernel's arithmetic over its twiddle table (the cluster's stages
    across parts at 2^15 and 2^16 included), run by numpy, equals the plain
    versions bit for bit."""
    p = RingParams.new(*args)
    x = _residues(p, B, 4).astype(np.int64)
    for t_min, plain in ((1, hybrid_ntt.ntt_fwd_hybrid_plain),
                         (hybrid_ntt.LANE, hybrid_ntt.ntt_fwd_head_plain)):
        want = plain(torch.from_numpy(x), p).numpy()
        plan = hybrid_ntt.launch_plan(p.n, t_min, max(p.moduli))
        np.testing.assert_array_equal(hybrid_ntt.emulate_kernel(x, p, plan), want)


def test_fwd_route_is_a_rule_over_n():
    """ntt_fwd_auto's route: K3 on a card for 256 <= n < 2048 and
    16384 < n <= 65536, K1 for 2048 <= n <= 16384, the chain elsewhere and on
    the CPU (where it is also what runs)."""
    want = {n: "chain" for n in (2, 4, 16, 64, 128, 131072)}
    want.update({n: "k3" for n in (256, 512, 1024, 32768, 65536)})
    want.update({n: "k1" for n in (2048, 4096, 8192, 16384)})
    for n, route in want.items():
        assert ntt.fwd_route("cuda", n) == route
        assert ntt.fwd_route("cpu", n) == "chain"
    p = RingParams.new(256, 2, 28, 14)
    t = p.tables("cpu")
    x = _t(_residues(p, 3, 8))
    with tracing.recording() as rec:
        assert torch.equal(ntt.ntt_fwd_auto(x, p), ntt.ntt_fwd(x, t.psi_rev, t.moduli))
    assert _launches(rec) == {"ntt.k3_head": 0, "ntt.k3_whole": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("args,B", [((8192, 8, 28, 14), 16), ((16384, 10, 24, 12), 4),
                                    ((256, 2, 28, 14), 5), ((32768, 4, 24, 12), 3),
                                    ((65536, 3, 24, 12), 2)])
def test_kernel_equals_plain_on_card(cuda_device, args, B):
    p = RingParams.new(*args)
    t = p.tables(cuda_device)
    x = _t(_residues(p, B, 1)).to(cuda_device)
    with tracing.recording() as rec:
        head = hybrid_ntt.ntt_fwd_head(x, p)
        full = hybrid_ntt.ntt_fwd_hybrid(x, p)
    torch.cuda.synchronize()
    assert _launches(rec) == {"ntt.k3_head": 1, "ntt.k3_whole": 1}
    assert torch.equal(head, hybrid_ntt.ntt_fwd_head_plain(x, p))
    assert torch.equal(full, hybrid_ntt.ntt_fwd_hybrid_plain(x, p))
    assert torch.equal(full, ntt.ntt_fwd(x, t.psi_rev, t.moduli))
    if 2048 <= p.n <= 16384:
        assert torch.equal(full, four_step.four_step_ntt_fwd(x, p, p.n // 128))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 32768])
def test_fwd_auto_launches_k3_on_card(cuda_device, n):
    p = RingParams.new(n, 2, 28, 14)
    t = p.tables(cuda_device)
    x = _t(_residues(p, 3, 5)).to(cuda_device)
    with tracing.recording() as rec:
        got = ntt.ntt_fwd_auto(x, p)
    torch.cuda.synchronize()
    assert _launches(rec) == {"ntt.k3_head": 0, "ntt.k3_whole": 1}
    assert torch.equal(got, ntt.ntt_fwd(x, t.psi_rev, t.moduli))


@pytest.mark.cuda
def test_kernel_rejects_on_card(cuda_device):
    p = RingParams.new(8192, 2, 28, 14)
    x = _t(_residues(p, 4, 2)).to(cuda_device)
    with pytest.raises(TypeError):
        hybrid_ntt.ntt_fwd_hybrid(x.to(torch.int32), p)
    with pytest.raises(ValueError):
        hybrid_ntt.ntt_fwd_head(x.transpose(1, 2), p)
    big = RingParams.new(131072, 1, 28, 14)
    with pytest.raises(ValueError, match="bounds"):
        hybrid_ntt.ntt_fwd_hybrid(_t(_residues(big, 1, 3)).to(cuda_device), big)
