"""mxx_tpu_torch/parallel/ and the mesh-sharded preimage against mxx_tpu.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port runs on logical meshes whose shards all sit on the one CPU device. The
same seeded numpy residues go to both.

- EQUAL: `factor_devices` for n = 1..16 and the mesh shapes of
  `make_mesh`;
- bit for bit (tolerance 0), mirroring tests/test_sharding.py: the limb +
  column sharded `zq_matmul` and the limb-sharded `ntt_fwd` against the
  unsharded results and against the JAX package's sharded ones; the fold
  over limb shards; `crt_switch_sharded` for P in {2, 251, 2^16} against
  the exact big-int rule, the JAX function and `PolyMatrix.modulus_switch`,
  on every limb split of the mesh;
- by relation, mirroring tests/test_sampler.py:180: A x == U per request
  over an 8-shard mesh; bit for bit: a 1x1 mesh gives the unsharded call,
  and every column shard is `_preimage_core` under the call's key folded
  with the shard index; padding columns are dropped.
"""

import numpy as np
import pytest
import torch

import mxx_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mxx_tpu.ops.zq_matmul import zq_matmul as jax_zq_matmul
from mxx_tpu.parallel import crt_switch_sharded as jax_crt_switch_sharded
from mxx_tpu.parallel import factor_devices as jax_factor_devices
from mxx_tpu.parallel import make_mesh as jax_make_mesh
from mxx_tpu.ring.ntt import ntt_fwd as jax_ntt_fwd
from mxx_tpu.ring.params import RingParams as JaxRingParams

from mxx_tpu_torch import convert
from mxx_tpu_torch.ops.zq_matmul import zq_matmul
from mxx_tpu_torch.parallel import (
    COL_AXIS,
    LIMB_AXIS,
    Mesh,
    Sharding,
    crt_switch_sharded,
    factor_devices,
    make_mesh,
    matrix_sharding,
    replicated,
    table_sharding,
)
from mxx_tpu_torch.ring.ntt import ntt_fwd
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import COEFF
from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler, chacha
from mxx_tpu_torch.sampler.trapdoor import _preimage_core, preimage_smoothing_parameter

SIGMA = 4.578
CPU = torch.device("cpu")


def _residues(params, lead, seed):
    """tests/test_sharding.py's `_rand`, as numpy uint32[L, *lead, n]."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, lead, dtype=np.uint64).astype(np.uint32)
                     for q in params.moduli])


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _jax_mesh():
    if len(jax.devices()) < 8:
        pytest.fail("tests/conftest.py gives jax 8 virtual CPU devices")
    return jax_make_mesh(8)


def test_factor_devices_and_mesh_shapes_equal_jax():
    for n in range(1, 17):
        assert factor_devices(n) == jax_factor_devices(n), n
    mesh = make_mesh(8, device="cpu")
    assert mesh.shape == dict(_jax_mesh().shape) == {LIMB_AXIS: 4, COL_AXIS: 2}
    assert mesh.size == 8 and all(d == CPU for row in mesh.devices for d in row)
    assert make_mesh(device="cpu").shape == {LIMB_AXIS: 1, COL_AXIS: 1}
    assert make_mesh(6, device="cpu").shape == {LIMB_AXIS: 2, COL_AXIS: 3}
    # any 2-D device array, repeats included, as jax.sharding.Mesh takes
    assert Mesh([["cpu"] * 3] * 2).shape == {LIMB_AXIS: 2, COL_AXIS: 3}
    with pytest.raises(ValueError):
        Mesh([["cpu"], ["cpu", "cpu"]])


@pytest.mark.parametrize("sharding", ["matrix", "matrix_cols", "table", "replicated"])
def test_split_and_join_round_trip(sharding):
    mesh = make_mesh(8, device="cpu")
    x = torch.arange(4 * 3 * 6 * 5).reshape(4, 3, 6, 5)
    sh = {"matrix": matrix_sharding(mesh), "matrix_cols": matrix_sharding(mesh, True),
          "table": table_sharding(mesh), "replicated": replicated(mesh)}[sharding]
    parts = sh.split(x)
    nl = 1 if sharding == "replicated" else 4
    nc = 2 if sharding == "matrix_cols" else 1
    assert parts[3][1].shape == (4 // nl, 3, 6 // nc, 5)
    assert torch.equal(sh.join(parts), x)
    with pytest.raises(ValueError):
        Sharding(mesh, (LIMB_AXIS,)).split(torch.zeros(3, 2))


def test_limb_and_column_sharded_matmul_matches_single_device():
    jmesh = _jax_mesh()
    mesh = make_mesh(8, device="cpu")
    nl, nc = factor_devices(8)
    args = (32, max(2, nl), 20, 5)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    a = _residues(p, (2, 4, p.n), 20)
    b = _residues(p, (4, 2 * nc, p.n), 21)
    q = p.tables(CPU).moduli
    want = zq_matmul(_t(a), _t(b), q)

    sa = matrix_sharding(mesh).split(_t(a))
    sb = matrix_sharding(mesh, shard_cols=True).split(_t(b))
    sq = table_sharding(mesh).split(q)
    out = [[zq_matmul(sa[i][j], sb[i][j], sq[i][j]) for j in range(nc)] for i in range(nl)]
    got = matrix_sharding(mesh, shard_cols=True).join(out)
    assert torch.equal(got, want)

    jt = jp.jt
    theirs = jax_zq_matmul(
        jax.device_put(jnp.asarray(a), NamedSharding(jmesh, P("limb", None, None, None))),
        jax.device_put(jnp.asarray(b), NamedSharding(jmesh, P("limb", None, "col", None))),
        jax.device_put(jt.moduli, NamedSharding(jmesh, P("limb"))),
        jax.device_put(jt.qinv_neg, NamedSharding(jmesh, P("limb"))),
        jax.device_put(jt.combine_pows_mont, NamedSharding(jmesh, P(None, "limb"))),
        jax.device_put(jt.sign_corr_pows, NamedSharding(jmesh, P(None, "limb"))),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(theirs).astype(np.int64))


def test_sharded_ntt_and_crt_fold():
    jmesh = _jax_mesh()
    mesh = make_mesh(8, device="cpu")
    nl, _ = factor_devices(8)
    args = (64, max(2, nl), 20, 5)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    t = p.tables(CPU)
    x = _residues(p, (3, p.n), 22)
    want = ntt_fwd(_t(x), t.psi_rev, t.moduli)

    limbs = Sharding(mesh, (LIMB_AXIS,))
    sx, sp, sq = limbs.split(_t(x)), limbs.split(t.psi_rev), limbs.split(t.moduli)
    out = [[ntt_fwd(sx[i][j], sp[i][j], sq[i][j]) for j in range(len(sx[0]))]
           for i in range(nl)]
    got = limbs.join(out)
    assert torch.equal(got, want)

    jt = jp.jt
    sh = NamedSharding(jmesh, P("limb", None, None))
    theirs = jax_ntt_fwd(
        jax.device_put(jnp.asarray(x), sh),
        jax.device_put(jt.psi_rev_mont, NamedSharding(jmesh, P("limb", None))),
        jax.device_put(jt.moduli, NamedSharding(jmesh, P("limb"))),
        jax.device_put(jt.qinv_neg, NamedSharding(jmesh, P("limb"))),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(theirs).astype(np.int64))

    # the fold over limb shards: per-shard float64 partials added in shard order
    partials = [out[i][0].to(torch.float64).sum() for i in range(nl)]
    folded = torch.zeros((), dtype=torch.float64)
    for part in partials:
        folded = folded + part
    assert np.isclose(float(folded), float(np.asarray(theirs).astype(np.float64).sum()))


@pytest.mark.parametrize("new_mod", [2, 251, 1 << 16])
def test_crt_switch_sharded_exact(new_mod):
    """The exact big-int scale-and-round rule per coefficient, the JAX
    function's output and `PolyMatrix.modulus_switch`, bit for bit, on the
    4x2 mesh of make_mesh(8) and on every other limb split of the limbs."""
    jmesh = _jax_mesh()
    nl, _ = factor_devices(8)
    depth = 2 * max(2, nl)
    args = (16, depth, 20, 5)
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    q = p.modulus
    x = _residues(p, (3, p.n), 33)
    got = crt_switch_sharded(p, _t(x), new_mod, make_mesh(8, device="cpu"))
    assert got.shape == (3, p.n) and got.device == CPU
    for j in range(3):
        for s in range(p.n):
            val = p.reconstruct_coeff([int(r) for r in x[:, j, s]])
            assert int(got[j, s]) == (val * new_mod + q // 2) // q % new_mod, (j, s)

    theirs = jax_crt_switch_sharded(
        jp, jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("limb", None, None))),
        new_mod, jmesh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(theirs).astype(np.int64))

    switched = convert.poly_matrix_from_numpy(p, x[:, None], COEFF, device="cpu")
    want = switched.modulus_switch(new_mod).data[0, 0]  # new_mod is below every q_t
    for limb_shards in (1, 2, 4, 8):
        mesh = Mesh([["cpu"] * 2] * limb_shards)
        assert torch.equal(crt_switch_sharded(p, _t(x), new_mod, mesh), want), limb_shards


def test_crt_switch_sharded_keeps_the_limb_order_sum_near_one_half():
    """Coefficients x next to q/4, where x * 2 / q lies within ~2^-20 of 1/2
    and the order of the float64 additions decides the rounding: at least
    one of them rounds otherwise when the limbs are summed in two halves
    (the JAX package's independent per-shard partials). Every limb split
    gives `modulus_switch`'s limb-by-limb result."""
    import random

    p = RingParams.new(16, 8, 28, 14)
    q, new_mod = p.modulus, 2
    gen = random.Random(7)
    xs = [q // 4 + gen.randrange(-(q >> 24), q >> 24) for _ in range(4 * p.n)]
    r = np.array([[x % qt for x in xs] for qt in p.moduli], dtype=np.int64)
    terms = r.astype(np.float64) * p.ms_tables(new_mod)[1][:, None]
    seq = np.zeros(r.shape[1])
    for t in range(8):
        seq = seq + terms[t]
    halves = (((terms[0] + terms[1]) + terms[2]) + terms[3]) + (
        ((terms[4] + terms[5]) + terms[6]) + terms[7])
    assert ((seq - np.floor(seq) >= 0.5) != (halves - np.floor(halves) >= 0.5)).any()

    x = r.reshape(8, 4, p.n)
    want = convert.poly_matrix_from_numpy(p, x[:, None], COEFF, device="cpu").modulus_switch(
        new_mod).data[0, 0]
    for limb_shards in (1, 2, 4, 8):
        got = crt_switch_sharded(p, torch.from_numpy(x), new_mod, Mesh([["cpu"]] * limb_shards))
        assert torch.equal(got, want), limb_shards


# ----------------------------------------------------------- sharded preimages


def _sampler_and_targets(widths, seed):
    p = RingParams.new(16, 2, 20, 5)
    ts = TrapdoorSampler(p, SIGMA, seed=seed, device="cpu")
    td, a = ts.trapdoor(p, 1)
    us = UniformSampler(seed=seed + 1, device="cpu")
    return p, ts, td, a, [us.sample_uniform(p, 1, w, FinRingDist()) for w in widths]


@pytest.mark.parametrize("mesh", ["make_mesh(8)", "1x8"])
def test_preimage_batched_sharded_mesh(mesh):
    """tests/test_sampler.py:180 on the port: A x == U per request over an
    8-shard mesh (4 limb x 2 col, and 8 col shards, where the 12 columns pad
    to 16 and the padding is dropped)."""
    p, ts, td, a, targets = _sampler_and_targets((3, 5, 4), 51)
    m = make_mesh(8, device="cpu") if mesh == "make_mesh(8)" else Mesh([["cpu"] * 8])
    outs = ts.preimage_batched_sharded(p, td, a, targets, mesh=m)
    assert len(outs) == 3
    for t, x in zip(targets, outs):
        assert x.shape == (2 + p.modulus_digits, t.ncol)
        assert (a @ x) == t


def test_one_by_one_mesh_is_the_unsharded_call():
    p, ts, td, a, targets = _sampler_and_targets((3, 5, 4), 61)
    twin = TrapdoorSampler(p, SIGMA, seed=61, device="cpu")
    assert twin.trapdoor(p, 1)[1] == a
    got = ts.preimage_batched_sharded(p, td, a, targets, mesh=make_mesh(device="cpu"))
    want = twin.preimage_batched_sharded(p, td, a, targets)
    for g, w in zip(got, want):
        assert torch.equal(g.data, w.data)


def test_each_column_shard_is_the_core_under_its_folded_key():
    """3 + 5 + 4 = 12 columns over 8 col shards: padded to 16 with repeats of
    the last column, 2 per shard; shard j is `_preimage_core` under
    fold_in(fold_in(key, ctr), j) over its 2 columns, and the 4 padding
    columns are gone from the output."""
    p, ts, td, a, targets = _sampler_and_targets((3, 5, 4), 71)
    outs = ts.preimage_batched_sharded(p, td, a, targets, mesh=Mesh([["cpu"] * 8]))
    assert [x.ncol for x in outs] == [3, 5, 4]
    got = outs[0].concat_columns(outs[1:]).data
    combined = targets[0].to_eval().concat_columns(targets[1:])
    last = combined.slice_columns(11, 12)
    padded = combined.concat_columns([last] * 4)
    s = preimage_smoothing_parameter(ts.base, SIGMA, 1, p.n, p.modulus_digits)
    ops = ts._operands(td, a, s)
    call_key = chacha.fold_in(ts._key, ts._ctr)
    for j in range(8):
        want = _preimage_core(p, chacha.fold_in(call_key, j), padded.slice_columns(2 * j, 2 * j + 2),
                              *ops, sigma=ts.sigma, c=ts.c, s=s).data
        cols = min(2, 12 - 2 * j)
        if cols > 0:
            assert torch.equal(got[:, :, 2 * j:2 * j + cols], want[:, :, :cols]), j
        else:  # a shard of padding only: sampled, then dropped
            assert want.shape[2] == 2
