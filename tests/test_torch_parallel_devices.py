"""mxx_tpu_torch/parallel/ on meshes of distinct devices: the copies that a
mesh of one repeated device never makes.

- a 1x2 mesh of the card and the CPU: the mesh-sharded preimage holds
  A x == U per request, and each column shard equals, bit for bit,
  `_preimage_core` run on that shard's device under the call's key folded
  with the shard index; the result comes back to the public matrix's card;
- a 2x1 mesh of the card and the CPU (both orders): `crt_switch_sharded`
  equals `PolyMatrix.modulus_switch`, bit for bit, for P in {2, 251, 2^16};
- a mesh over every card (1 x max(2, cards) column shards, and
  `make_mesh(max(2, cards))` for limbs; shards repeat the one card on a
  one-card machine): the same preimage checks at n=4096, where the shards'
  NTTs go through K1/K2 on their own card; the limb-sharded `ntt_fwd` and
  `crt_switch_sharded` against the unsharded results, bit for bit.

Every test needs the card and skips without one. The card's machine has no
jax, and this file imports none, so it runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_devices.py
"""

import numpy as np
import pytest
import torch

from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ops import four_step
from mxx_tpu_torch.parallel import LIMB_AXIS, Mesh, Sharding, crt_switch_sharded, make_mesh
from mxx_tpu_torch.ring import ntt
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import COEFF
from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler, chacha
from mxx_tpu_torch.sampler.trapdoor import _preimage_core, preimage_smoothing_parameter

SIGMA = 4.578
MODULI = (2, 251, 1 << 16)


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _residues(p, lead, seed, device):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, lead, dtype=np.int64) for q in p.moduli])
    return torch.from_numpy(x).to(device)


def _check_sharded_preimage(p, mesh, widths, seed, device):
    """A x == U per request over `mesh`'s col axis, x on the public matrix's
    device, and every shard == `_preimage_core` on its own device."""
    ts = TrapdoorSampler(p, SIGMA, seed=seed, device=device)
    td, a = ts.trapdoor(p, 1)
    us = UniformSampler(seed=seed + 1, device=device)
    targets = [us.sample_uniform(p, 1, w, FinRingDist()) for w in widths]
    outs = ts.preimage_batched_sharded(p, td, a, targets, mesh=mesh)
    assert [x.ncol for x in outs] == list(widths)
    for t, x in zip(targets, outs):
        assert x.data.device == a.data.device
        assert (a @ x) == t
    shards = len(mesh.devices[0])
    total = sum(widths)
    width = -(-total // shards)
    combined = targets[0].to_eval().concat_columns(targets[1:])
    padded = combined.concat_columns([combined.slice_columns(total - 1, total)]
                                     * (shards * width - total))
    got = outs[0].concat_columns(outs[1:]).data
    s = preimage_smoothing_parameter(ts.base, SIGMA, 1, p.n, p.modulus_digits)
    call_key = chacha.fold_in(ts._key, ts._ctr)
    for j in range(shards):
        dev = mesh.device(col=j)
        shard = padded.slice_columns(j * width, (j + 1) * width)
        want = _preimage_core(p, chacha.fold_in(call_key.to(dev), j),
                              PolyMatrix(shard.data.to(dev), shard.fmt, p),
                              *ts._operands(td, a, s, dev), sigma=ts.sigma, c=ts.c, s=s).data
        assert want.device == dev
        cols = min(width, total - j * width)
        if cols > 0:
            assert torch.equal(got[:, :, j * width:j * width + cols], want[:, :, :cols].to(
                got.device)), j


@pytest.mark.cuda
def test_preimage_over_the_card_and_the_cpu(cards):
    mesh = Mesh([[cards[0], "cpu"]])
    _check_sharded_preimage(RingParams.new(16, 2, 20, 5), mesh, (3, 5, 4), 81, cards[0])


@pytest.mark.cuda
@pytest.mark.parametrize("card_first", [True, False])
def test_crt_switch_over_the_card_and_the_cpu(cards, card_first):
    p = RingParams.new(16, 4, 28, 7)
    devs = [cards[0], torch.device("cpu")]
    mesh = Mesh([[d] for d in (devs if card_first else devs[::-1])])
    data = _residues(p, (2, 3, p.n), 91, cards[0])
    m = PolyMatrix(data, COEFF, p)
    for P in MODULI:
        got = crt_switch_sharded(p, data, P, mesh)
        assert got.device == mesh.device()
        assert torch.equal(got.to(cards[0]), m.modulus_switch(P).data[0]), P


@pytest.mark.cuda
def test_mesh_over_every_card(cards):
    """On a machine with several cards, each shard sits on a card of its own."""
    p = RingParams.new(4096, 4, 24, 12)
    n_shards = max(2, len(cards))
    cols = Mesh([[cards[j % len(cards)] for j in range(n_shards)]])
    four_step.launches.update(fwd=0, inv=0)
    _check_sharded_preimage(p, cols, (3, 5), 101, cards[0])
    assert four_step.launches["fwd"] and four_step.launches["inv"]

    limbs = make_mesh(n_shards)
    assert limbs.shape[LIMB_AXIS] * len(limbs.devices[0]) == n_shards
    t = p.tables(cards[0])
    x = _residues(p, (8, p.n), 111, cards[0])
    spec = Sharding(limbs, (LIMB_AXIS,))
    sx, sp, sq = spec.split(x), spec.split(t.psi_rev), spec.split(t.moduli)
    fwd = spec.join([[ntt.ntt_fwd(sx[i][j], sp[i][j], sq[i][j]) for j in range(len(sx[0]))]
                     for i in range(len(sx))])
    assert torch.equal(fwd, ntt.ntt_fwd(x, t.psi_rev, t.moduli))
    m = PolyMatrix(x[:, None], COEFF, p)
    for P in MODULI:
        assert torch.equal(crt_switch_sharded(p, x[:, None], P, limbs).to(cards[0]),
                           m.modulus_switch(P).data[0]), P
