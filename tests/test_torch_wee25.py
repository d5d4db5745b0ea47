"""WEE25 commitment of the port against the JAX package (mirrors
`tests/test_wee25.py`): single level, two-level tree, tampered message, at
`RingParams.new(4, 2, 17, 17)`.

- bit for bit (tolerance 0): every W_b hash draw of the port's one batch,
  `bytes` tag included, against the JAX package's draw per block; B and T_bottom from the same seed
  (integer draws); and, given the JAX package's public params carried
  across, the port's commitment, openings and verifier matrices;
- by relation: the port's own T_top preimages (float-Gaussian draws), each
  B T_top_b == G G^{-1}(Y_b) - W_b T_bottom, with the target built the JAX
  package's way; the port's own commitments verify, a tampered message
  does not.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

KEY = bytes([7] * 32)
SIGMA = 4.578
RING = (4, 2, 17, 17)  # log_q = 2, tiny sizes


def load(pkg):
    mods = {"params": "ring.params", "poly": "ring.poly", "matrix": "matrix",
            "sampler": "sampler", "commit": "commit"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    ns.params = ns.params.RingParams.new(*RING)
    k = ns.params.modulus_digits
    ns.scheme = ns.commit.Wee25Commit(1, 2, k + 2, k, SIGMA)
    return ns


def _np(m):
    m = m.to_coeff()
    return m.data.cpu().numpy().astype(np.uint32) if hasattr(m.data, "cpu") else np.asarray(m.data)


def _blocks(ns, count, seed):
    us = ns.sampler.UniformSampler(seed=seed, **ns.kw)
    return [us.sample_uniform(ns.params, ns.scheme.d, ns.scheme.m_b, ns.sampler.FinRingDist())
            for _ in range(count)]


@pytest.fixture(scope="module")
def jax_pp():
    """The JAX package's public params (seed 61), and the same carried into
    the port."""
    from mxx_tpu_torch import convert

    jx, pt = load("mxx_tpu"), load("mxx_tpu_torch")
    pp = jx.scheme.sample_public_params(jx.params, KEY, seed=61)
    carried = convert.wee25_public_params_from_numpy(
        pt.params, (np.asarray(pp.b.data), pp.b.fmt),
        (np.asarray(pp.t_bottom.data), pp.t_bottom.fmt),
        [(np.asarray(pp.t_top[i].data), pp.t_top[i].fmt) for i in sorted(pp.t_top)],
        pp.hash_key, device="cpu")
    return jx, pp, pt, carried


def test_w_blocks_match_jax():
    """The port's one batch of W_b against the JAX package's draw per block."""
    jx, pt = load("mxx_tpu"), load("mxx_tpu_torch")
    batch = pt.scheme._w_blocks(pt.params, KEY, "cpu")
    for b in range(pt.scheme.l * pt.scheme.m_g):
        mine = pt.matrix.PolyMatrix(batch[:, b], "eval", pt.params)
        np.testing.assert_array_equal(_np(mine), _np(jx.scheme._w_block(jx.params, KEY, b)))


@pytest.mark.parametrize("key", [KEY, bytes(32)])
def test_checkpoint_prefix_matches_jax(key):
    jx, pt = load("mxx_tpu"), load("mxx_tpu_torch")
    assert pt.commit.wee25.WEE25_PUBLIC_PARAMS_PREFIX == jx.commit.wee25.WEE25_PUBLIC_PARAMS_PREFIX
    mine = pt.scheme.checkpoint_prefix(pt.params, key)
    assert mine == jx.scheme.checkpoint_prefix(jx.params, key)
    assert mine.startswith("wee25_public_params_n4_L2_d1_tb2_key")


def test_public_params_draws_and_relations(jax_pp):
    _, jpp, pt, _ = jax_pp
    pp = pt.scheme.sample_public_params(pt.params, KEY, seed=61, device="cpu")
    np.testing.assert_array_equal(_np(pp.b), _np(jpp.b))
    np.testing.assert_array_equal(_np(pp.t_bottom), _np(jpp.t_bottom))
    _check_t_top(pt, pp)


def test_public_params_over_a_mesh(jax_pp, monkeypatch):
    """T_top's preimage batch split over a logical 2-shard CPU mesh: B and
    T_bottom still equal the JAX package's, each T_top_b holds its relation."""
    from mxx_tpu_torch.parallel import Mesh
    from mxx_tpu_torch.sampler import TrapdoorSampler

    _, jpp, pt, _ = jax_pp
    meshes = []
    orig = TrapdoorSampler._preimage_cols

    def recording(self, params, trapdoor, public_matrix, target, mesh=None):
        meshes.append(mesh)
        return orig(self, params, trapdoor, public_matrix, target, mesh)

    monkeypatch.setattr(TrapdoorSampler, "_preimage_cols", recording)
    mesh = Mesh([["cpu", "cpu"]])
    pp = pt.scheme.sample_public_params(pt.params, KEY, seed=61, mesh=mesh, device="cpu")
    assert meshes and all(m is mesh for m in meshes)
    np.testing.assert_array_equal(_np(pp.b), _np(jpp.b))
    np.testing.assert_array_equal(_np(pp.t_bottom), _np(jpp.t_bottom))
    _check_t_top(pt, pp)


def _check_t_top(pt, pp):
    """Each T_top_b against its target, built as the JAX package builds it."""
    p, scheme = pt.params, pt.scheme
    log_q = scheme.m_g // scheme.d
    gadget = pt.matrix.PolyMatrix.gadget_matrix(p, scheme.d, device="cpu")
    g_vals = [gadget.entry(0, t).const_coeff() for t in range(p.modulus_digits)]
    zero = pt.poly.Poly.zero(p, device="cpu")
    for block in range(scheme.l * scheme.m_g):
        g_col, r = divmod(block, scheme.m_g)
        i_row, k_dig = divmod(r, log_q)
        y_b = pt.matrix.PolyMatrix.from_polys(p, [[
            pt.poly.Poly.const(p, g_vals[col % log_q] * g_vals[k_dig] % p.modulus, device="cpu")
            if i == i_row and col // log_q == g_col else zero
            for col in range(scheme.l * log_q)] for i in range(scheme.d)])
        w_b = pt.matrix.PolyMatrix(scheme._w_blocks(p, KEY, "cpu")[:, block], "eval", p)
        target = gadget @ y_b.decompose() - w_b @ pp.t_bottom
        assert pp.b @ pp.t_top_block(block) == target, f"block {block}"


@pytest.mark.parametrize("nblocks, col_range", [(2, None), (2, range(0, 1)), (4, range(1, 3))])
def test_wee25_commit_open_verify_match_jax(jax_pp, nblocks, col_range):
    """Single level (whole and one-column openings) and a two-level tree:
    on the JAX package's public params the port's commitment, opening and
    verifier equal the JAX package's, and both verify."""
    jx, jpp, pt, pp = jax_pp
    outs = []
    for ns, params_pp in ((jx, jpp), (pt, pp)):
        blocks = _blocks(ns, nblocks, seed=62 + nblocks)
        stream = ns.commit.MsgMatrixStream.from_blocks(blocks)
        commitment, cache = ns.scheme.commit(ns.params, stream, params_pp)
        msg = blocks[0].concat_columns(blocks[1:])
        opening = ns.scheme.open(ns.params, stream, col_range, params_pp, cache)
        v = ns.scheme.verifier(ns.params, nblocks, col_range, params_pp)
        assert commitment.shape == (ns.scheme.d, ns.scheme.m_b)
        assert ns.scheme.verify(ns.params, msg, commitment, opening, col_range, params_pp)
        outs.append([_np(m) for m in (msg, commitment, opening, v)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nblocks", [2, 8])
def test_wee25_port_params_verify_and_reject_tampered(nblocks):
    """The port's own public params: a commitment over a tree of `nblocks`
    verifies with every opening, and a message changed in one coefficient
    does not."""
    pt = load("mxx_tpu_torch")
    p, scheme = pt.params, pt.scheme
    pp = scheme.sample_public_params(p, KEY, seed=61, device="cpu")
    blocks = _blocks(pt, nblocks, seed=70)
    stream = pt.commit.MsgMatrixStream.from_blocks(blocks)
    commitment, cache = scheme.commit(p, stream, pp)
    msg = blocks[0].concat_columns(blocks[1:])
    opening = scheme.open(p, stream, None, pp, cache)
    assert scheme.verify(p, msg, commitment, opening, None, pp)
    PolyMatrix = pt.matrix.PolyMatrix
    bad = msg + PolyMatrix.identity(p, scheme.d, device="cpu").concat_columns(
        [PolyMatrix.zero(p, scheme.d, msg.ncol - scheme.d, device="cpu")])
    assert not scheme.verify(p, bad, commitment, opening, None, pp)
