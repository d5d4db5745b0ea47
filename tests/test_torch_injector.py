"""mxx_tpu_torch's Diamond input injector against mxx_tpu, on the CPU:

- `Trapdoor` compact bytes equal the JAX package's and round-trip both ways;
  the unit column vectors equal the JAX package's;
- with the same seed, every artifact that is not a transition preimage K
  (B matrices, trapdoors, secrets, masks, p_eps with its table-Gaussian
  error, the k plaintext, the metadata) is byte-identical between the
  packages;
- every K of the port satisfies B_{l-1,src} K == S B_{l,state} exactly with
  error_sigma = 0, the final states keep their exact relations
  (tests/test_input_injector.py), and a second preprocess resumes;
- either package's `online_eval` over the other's artifact directory gives
  the other's states bit for bit;
- `simulate_output_error_bounds` equals the JAX package's.

K is a preimage (Box-Muller normals in float), so it is held to its relation,
not to the JAX package's bits.
"""

import numpy as np
import pytest

import mxx_tpu  # noqa: F401
from mxx_tpu.input_injector import DiamondInjector as JaxDiamondInjector
from mxx_tpu.input_injector.simulation import (
    simulate_output_error_bounds as jax_simulate_output_error_bounds,
)
from mxx_tpu.matrix import PolyMatrix as JaxPolyMatrix
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.ring.poly import Poly as JaxPoly
from mxx_tpu.sampler import FinRingDist as JaxFinRingDist
from mxx_tpu.sampler import Trapdoor as JaxTrapdoor
from mxx_tpu.sampler import TrapdoorSampler as JaxTrapdoorSampler
from mxx_tpu.sampler import UniformSampler as JaxUniformSampler

from mxx_tpu_torch import convert
from mxx_tpu_torch.input_injector import DiamondInjector
from mxx_tpu_torch.input_injector.simulation import simulate_output_error_bounds
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import Poly
from mxx_tpu_torch.sampler import FinRingDist, Trapdoor, TrapdoorSampler, UniformSampler

ARGS = (16, 4, 28, 7)  # n, L, crt_bits, base_bits: 16 gadget digits, states 2 x 36
SIGMA = 4.578
SHAPE = (2, 2, 1)  # input_count, base, batch_bits: level 2 runs all three selectors
DIGITS = [1, 0]


def _params(args=ARGS):
    return RingParams.new(*args), JaxRingParams.new(*args)


def _eq(mine, theirs):
    """Same residues and format (PolyMatrix or Poly against its JAX twin)."""
    assert mine.fmt == theirs.fmt
    np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))


def _is_transition(path) -> bool:
    return path.name.startswith("diamond_transition_tensor_")


# ------------------------------------------------- trapdoor bytes, unit vectors


@pytest.mark.parametrize("d", [1, 2])
def test_trapdoor_compact_bytes(d):
    p, jp = _params()
    td, _ = TrapdoorSampler(p, SIGMA, seed=3, device="cpu").trapdoor(p, d)
    jtd, _ = JaxTrapdoorSampler(jp, SIGMA, seed=3).trapdoor(jp, d)
    raw = td.to_compact_bytes()
    assert raw == jtd.to_compact_bytes()
    back = Trapdoor.from_compact_bytes(p, jtd.to_compact_bytes(), device="cpu")
    _eq(back.r, jtd.r)
    _eq(back.e, jtd.e)
    assert JaxTrapdoor.from_compact_bytes(jp, raw).to_compact_bytes() == raw


@pytest.mark.parametrize("size,index", [(1, 0), (2, 1), (3, 0), (3, 2)])
def test_unit_column_vectors(size, index):
    p, jp = _params()
    _eq(PolyMatrix.unit_column_vector(p, size, index, device="cpu"),
        JaxPolyMatrix.unit_column_vector(jp, size, index))
    scalar = UniformSampler(seed=size, device="cpu").sample_poly(p, FinRingDist())
    jscalar = JaxUniformSampler(seed=size).sample_poly(jp, JaxFinRingDist())
    _eq(PolyMatrix.scaled_unit_column_vector(p, size, index, scalar),
        JaxPolyMatrix.scaled_unit_column_vector(jp, size, index, jscalar))
    with pytest.raises(ValueError):
        PolyMatrix.unit_column_vector(p, size, size, device="cpu")


# ---------------------------------------------------------- artifacts, online


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's preprocess (error sigma 4.0, seed 31) and its
    online states for DIGITS."""
    _, jp = _params()
    d = tmp_path_factory.mktemp("jax_injector")
    inj = JaxDiamondInjector(jp, *SHAPE, SIGMA, 4.0, seed=31)
    out = inj.preprocess(d, JaxPoly.const(jp, 5))
    return d, out, inj.online_eval(d, out, DIGITS)


def test_injector_artifacts_bit_equal(jax_run, tmp_path):
    jdir, _, _ = jax_run
    p, _ = _params()
    DiamondInjector(p, *SHAPE, SIGMA, 4.0, seed=31, device="cpu").preprocess(tmp_path, Poly.const(p, 5, device="cpu"))
    mine = {f.name: f for f in tmp_path.iterdir()}
    theirs = {f.name: f for f in jdir.iterdir()}
    assert sorted(mine) == sorted(theirs)
    compared = 0
    for name, f in mine.items():
        if _is_transition(f):
            assert f.stat().st_size == theirs[name].stat().st_size, name
            continue
        assert f.read_bytes() == theirs[name].read_bytes(), name
        compared += 1
    # metadata, k, p_eps, s_eps, 2 x 2 masks, 6 B matrices and 6 trapdoors
    assert compared == 3 + 1 + 4 + 12
    assert sum(_is_transition(f) for f in mine.values()) == 4 + 6


def _transition_target(inj, d, level, digit, state_idx):
    """S B_{l,state} of one transition, from the stored mask and basis."""
    mask = inj.read_matrix(d, inj.digit_secret_id(level, digit))
    bit_idx = inj.new_bit_idx_for_state(level, state_idx)
    if bit_idx is not None:
        sel = inj._special_transition_selector(inj.digit_bit_value(digit, bit_idx), mask)
    elif state_idx == 0:
        sel = inj._k_transition_selector(mask)
    else:
        sel = inj._transition_selector(mask)
    return sel @ inj.read_matrix(d, inj.b_matrix_id(level, state_idx))


@pytest.mark.parametrize("args,shape", [(ARGS, SHAPE), ((4, 2, 17, 1), (2, 4, 2))])
def test_injector_transitions_exact(args, shape, tmp_path):
    p, _ = _params(args)
    inj = DiamondInjector(p, *shape, SIGMA, 0.0, seed=41, device="cpu")
    inj.preprocess(tmp_path, Poly.const(p, 2, device="cpu"))
    checked = 0
    for level in range(1, inj.input_count + 1):
        for digit in range(inj.base):
            for state_idx in range(inj.state_count_at_level(level)):
                src = inj.transition_source_state_idx(level, state_idx)
                b_src = inj.read_matrix(tmp_path, inj.b_matrix_id(level - 1, src))
                k_mat = inj.read_matrix(tmp_path, inj.k_id(level, digit, state_idx))
                assert k_mat.shape == (inj.state_col_size(), inj.state_col_size())
                target = _transition_target(inj, tmp_path, level, digit, state_idx)
                assert b_src @ k_mat == target, (level, digit, state_idx)
                checked += 1
    assert checked == sum(inj.base * inj.state_count_at_level(lv)
                          for lv in range(1, inj.input_count + 1))


def test_injector_exact_relations(tmp_path):
    """tests/test_input_injector.py's relation test on the port."""
    params = RingParams.default()
    input_count, base, batch_bits = 3, 4, 2
    injector = DiamondInjector(params, input_count, base, batch_bits, SIGMA, 0.0, seed=71, device="cpu")
    k = Poly.const(params, 3, device="cpu")
    out = injector.preprocess(tmp_path, k)
    digits = [1, 3, 2]
    states = injector.online_eval(tmp_path, out, digits)
    assert len(states) == 1 + input_count * batch_bits
    assert injector.read_preprocessed_k(tmp_path) == k
    sigma_full = injector.debug_final_secret_matrix(tmp_path, digits).entry(0, 0)
    s_eps = injector.read_matrix(tmp_path, injector.secret_epsilon_id()).entry(0, 0)
    masks = [injector.read_matrix(tmp_path, injector.digit_secret_id(i + 1, digits[i]))
             .entry(0, 0) for i in range(input_count)]
    assert sigma_full == s_eps * masks[0] * masks[1] * masks[2]
    assert states[0] == PolyMatrix.from_poly_row(params, [sigma_full, k]) @ out.final_pub_matrices[0]
    for input_idx in range(input_count):
        for bit_idx in range(batch_bits):
            sidx = injector.bit_state_idx(input_idx, bit_idx)
            bit = injector.digit_bit_value(digits[input_idx], bit_idx)
            row = PolyMatrix.from_poly_row(params, [sigma_full, sigma_full * Poly.const(params, bit, device="cpu")])
            assert states[sidx] == row @ out.final_pub_matrices[sidx], (input_idx, bit_idx)


def test_injector_resume(tmp_path):
    """tests/test_input_injector.py's resume test on the port: a second
    preprocess (another seed) finds every checkpoint and samples nothing."""
    params = RingParams.default()
    injector = DiamondInjector(params, 1, 2, 1, SIGMA, 0.0, seed=72, device="cpu")
    k = Poly.const(params, 5, device="cpu")
    out1 = injector.preprocess(tmp_path, k)
    files = {f.name: f.read_bytes() for f in tmp_path.iterdir()}
    out2 = DiamondInjector(params, 1, 2, 1, SIGMA, 0.0, seed=99, device="cpu").preprocess(tmp_path, k)
    assert {f.name: f.read_bytes() for f in tmp_path.iterdir()} == files
    assert out1.final_pub_matrices[0] == out2.final_pub_matrices[0]
    assert out1.final_trapdoors[0].to_compact_bytes() == out2.final_trapdoors[0].to_compact_bytes()


def test_online_eval_reads_jax_artifacts(jax_run):
    """The JAX package preprocesses; the port's online_eval reads that
    directory (the final checkpoints carried over by `convert`)."""
    jdir, jout, jstates = jax_run
    p, _ = _params()
    out = convert.preprocess_out_from_numpy(
        p,
        [(np.asarray(t.r.data), np.asarray(t.e.data), t.r.fmt) for t in jout.final_trapdoors],
        [(np.asarray(b.data), b.fmt) for b in jout.final_pub_matrices], device="cpu",
    )
    for t, jt in zip(out.final_trapdoors, jout.final_trapdoors):
        assert t.to_compact_bytes() == jt.to_compact_bytes()
    inj = DiamondInjector(p, *SHAPE, SIGMA, 4.0, seed=0, device="cpu")  # reads only: any seed
    states = inj.online_eval(jdir, out, DIGITS)
    assert len(states) == len(jstates) == 3
    for mine, theirs in zip(states, jstates):
        _eq(mine, theirs)


def test_jax_online_eval_reads_port_artifacts(tmp_path):
    p, jp = _params()
    inj = DiamondInjector(p, *SHAPE, SIGMA, 4.0, seed=33, device="cpu")
    out = inj.preprocess(tmp_path, Poly.const(p, 9, device="cpu"))
    states = inj.online_eval(tmp_path, out, [0, 1])
    jinj = JaxDiamondInjector(jp, *SHAPE, SIGMA, 4.0, seed=0)
    jstates = jinj.online_eval(tmp_path, None, [0, 1])
    for mine, theirs in zip(states, jstates):
        _eq(mine, theirs)


@pytest.mark.parametrize("args,shape,error_sigma", [
    (ARGS, SHAPE, 4.0),
    ((8192, 8, 28, 14), SHAPE, 4.0),
    ((256, 4, 28, 14), (3, 4, 2), 0.0),
])
def test_simulation_equal(args, shape, error_sigma):
    p, jp = _params(args)
    sim = simulate_output_error_bounds(DiamondInjector(p, *shape, SIGMA, error_sigma, device="cpu"))
    jsim = jax_simulate_output_error_bounds(JaxDiamondInjector(jp, *shape, SIGMA, error_sigma))

    def flat(m):
        pn = m.poly_norm
        return (m.nrow, m.ncol, m.zero_rows, pn.norm, pn.is_constant, pn.ctx.ring_dim_sqrt,
                pn.ctx.base, pn.ctx.secret_size, pn.ctx.log_base_q, pn.ctx.log_base_q_small)

    assert len(sim.state_errors) == len(jsim.state_errors) == 1 + shape[0] * shape[2]
    for mine, theirs in [(sim.state_errors, jsim.state_errors),
                         (sim.secret_state_factors, jsim.secret_state_factors),
                         ([sim.output_preimage], [jsim.output_preimage])]:
        assert [flat(m) for m in mine] == [flat(m) for m in theirs]
