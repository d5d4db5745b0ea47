"""The port's noise refresh (`noise_refresh/*`) against the JAX package.

- the material circuits of `tests/test_noise_refresh_circuits.py` (batched
  polynomial GSW decryption, the centered mask decode, the merge circuits,
  the per-CRT-level decrypt sub-circuit): gate for gate, and the same
  integers over `Poly` wires on the CPU;
- `round_keep_low_bits`, `crt_recompose`, `twisted_residues` and the
  error-growth simulation: equal (integers and `Decimal`s, tolerance 0);
- `DiamondNoiseRefresher`: the mask value, `a_m`, `digit_pks` and every
  preimage TARGET bit for bit; the preimages themselves are float-Gaussian
  draws, so they are held to B0 P == target; the refreshed wire satisfies
  the exact fresh relation; material made by the JAX package, carried over
  by `convert.refresh_material_from_numpy`, is refreshed by the port to the
  JAX package's result bit for bit;
- the CRT-level-split `NoiseRefresherNaiveVec` of `refresh.py` at
  `RingParams.new(4, 2, 17, 4)`: the recomposed wire exact for x_hat, and
  x_hat within the rounding bound of x.
"""

import random
from decimal import Decimal

import numpy as np
import pytest
import torch

from test_torch_structure import BOTH, assert_circuits_equal, load

from mxx_tpu_torch import convert
from mxx_tpu_torch.bgg import BggEncoding, BggPublicKey
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.noise_refresh import (NoiseRefresher, round_keep_low_bits,
                                         simulate_noise_refresh_error_growth)
from mxx_tpu_torch.noise_refresh.refresh import (DiamondNoiseRefresher, NoiseRefresherNaiveVec,
                                                 crt_recompose, pre_rounding_bound_holds,
                                                 twisted_residues)
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import COEFF, Poly
from mxx_tpu_torch.sampler import TernaryDist, TrapdoorSampler, UniformSampler
from mxx_tpu_torch.simulator import SimulatorContext
from mxx_tpu_torch.utils.rng import Drbg

KEY = bytes(range(32))
CPU = "cpu"


# ------------------------------------------------------------ the circuits


def _gsw(ns):
    params = ns.params.RingParams.new(4, 1, 14, 1)
    circuit = ns.circuit.PolyCircuit()
    return params, circuit, ns.ring_gsw.RingGswContext(circuit, params, 7)


def _c_batch(ns, params, circuit, ctx):
    msgs = [1, 0, 1, 1]
    ws = [ns.ring_gsw.RingGswCiphertext.input(ctx, circuit) for _ in msgs]
    key = circuit.input(1)[0]
    circuit.output([ns.circuit_decrypt.decrypt_error_coefficients_as_polynomial(
        circuit, ws, key, ctx.q_big)])
    return 1, msgs, 31, [msgs]


def _c_centered(ns, params, circuit, ctx):
    bits, q = [1, 0, 1, 0], ctx.q_big
    moduli = ns.mask_circuit.mask_plaintext_moduli_from_full_modulus(q, 1)
    ws = [ns.ring_gsw.RingGswCiphertext.input(ctx, circuit) for _ in bits]
    key = circuit.input(1)[0]
    circuit.output([ns.circuit_decrypt.decrypt_centered_bit_decomposed_polynomial(
        circuit, ws, key, moduli)])
    return -1, bits, 32, [[(b + 1) % q for b in bits]]


def _c_two_bit_parts(ns, params, circuit, ctx):
    bits, q = [1, 1, 0, 1], ctx.q_big  # two coefficients of two bits, coeff-major
    moduli = ns.mask_circuit.mask_plaintext_moduli_from_full_modulus(q, 2)
    ws = [ns.ring_gsw.RingGswCiphertext.input(ctx, circuit) for _ in bits]
    key = circuit.input(1)[0]
    sd, pb = ns.circuit_decrypt.decrypt_bit_decomposed_polynomial_parts(circuit, ws, key, moduli)
    circuit.output([circuit.add_gate(sd, pb)])
    s1 = q // (q >> 1)
    return 1, bits, 33, [[(1 + s1) % q, s1 % q, 0, 0]]


CASES = {"decrypt_batch_polynomial": _c_batch, "centered_mask_polynomial": _c_centered,
         "bit_decomposed_parts": _c_two_bit_parts}


def _run_case(ns, name):
    params, circuit, ctx = _gsw(ns)
    s, msgs, seed, want = CASES[name](ns, params, circuit, ctx)
    rng = random.Random(seed)
    inputs = []
    for m in msgs:
        native = ns.ring_gsw.native_encrypt(ctx, s, m, rng)
        inputs.extend(ns.ring_gsw.encode_ciphertext_inputs(ctx, native, **ns.kw))
    inputs.append(ns.const(params, -s))
    res = circuit.eval(params, ns.one(params), inputs,
                       plt_evaluator=ns.lookup.PolyPltEvaluator())
    return params, circuit, [r.coeffs() for r in res], want


@pytest.mark.parametrize("name", list(CASES))
def test_decrypt_circuits_and_values_equal(name):
    (pj, cj, got_j, _), (pt, ct, got_t, want) = (_run_case(load(p), name) for p in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)
    assert got_j == got_t == want


def test_merge_and_crt_decrypt_subcircuits_equal():
    built = []
    for pkg in BOTH:
        ns = load(pkg)
        params = ns.params.RingParams.default()
        merge = ns.circuit_merge.build_refreshed_wire_merge_subcircuit(3)
        got = merge.eval(params, ns.one(params),
                         [ns.const(params, v) for v in (1, 2, 3, 10, 20, 30)])
        assert [g.const_coeff() for g in got] == [11, 22, 33]
        crt = ns.circuit_merge.build_refreshed_wire_digit_all_crt_merge(params)
        got2 = crt.eval(params, ns.one(params), [ns.const(params, v) for v in (5, 6, 1, 1)])
        assert [g.const_coeff() for g in got2] == [6, 7]
        gp, gc, ctx = _gsw(ns)
        sub = ns.circuit_decrypt.build_refreshed_wire_crt_decrypt_subcircuit(ctx, 1, 2)
        sub.luts = ctx.nested.luts
        built.append((params, merge, crt, gp, sub))
    (pj, mj, cj, gpj, sj), (pt, mt, ct, gpt, st) = built
    assert_circuits_equal(mj, mt)
    assert_circuits_equal(cj, ct)
    assert_circuits_equal(sj, st, gpj, gpt)
    # the key wire, then 2 error and 4 mask ciphertexts of 728 wires each
    assert st.num_output == 2 and st.num_input == 1 + (2 + 4) * 728


# ------------------------------------------------------------- the integers


def test_rounding_recompose_and_simulation_equal():
    rj = load("mxx_tpu").refresh
    moduli = list(RingParams.new(16, 4, 28, 7).moduli)
    q = int(np.prod([int(m) for m in moduli], dtype=object))
    rng = random.Random(2)
    for _ in range(20):
        v, m, bits = rng.randrange(1 << 40), rng.randrange(2, 1 << 40), rng.randrange(1, 12)
        assert round_keep_low_bits(v % m, m, bits) == rj.round_keep_low_bits(v % m, m, bits)
        x = rng.randrange(q)
        ys = twisted_residues(x, moduli)
        assert ys == rj.twisted_residues(x, moduli)
        assert sum(y * (q // qi) for y, qi in zip(ys, moduli)) % q == x
        res = [x % qi for qi in moduli]
        assert crt_recompose(res, moduli) == rj.crt_recompose(res, moduli) == x
    assert round_keep_low_bits(0, 97, 4) == 0 and round_keep_low_bits(96, 97, 4) == 0
    assert round_keep_low_bits(48, 97, 4) == 8
    sj = load("mxx_tpu").refresh.SimulatorContext
    for args in [(Decimal(1000), 8, 4, 2, 112), (Decimal(3), 6, 2, 1, 34)]:
        ctx_t = SimulatorContext(Decimal(4096).sqrt(), Decimal(128), 1, 16, 4)
        ctx_j = sj(Decimal(4096).sqrt(), Decimal(128), 1, 16, 4)
        assert simulate_noise_refresh_error_growth(ctx_t, *args) == \
            rj.simulate_noise_refresh_error_growth(ctx_j, *args)
    assert pre_rounding_bound_holds(Decimal(2) ** 20, 30, 8)
    assert not pre_rounding_bound_holds(Decimal(2) ** 21, 30, 8)
    assert rj.pre_rounding_bound_holds(Decimal(2) ** 20, 30, 8)


# ------------------------------------------------- the Diamond noise refresher


class _Recording:
    """A trapdoor sampler that records each preimage target and hands the
    call on."""

    def __init__(self, inner):
        self.inner = inner
        self.targets = []

    def preimage(self, params, trapdoor, public_matrix, target):
        self.targets.append(target)
        return self.inner.preimage(params, trapdoor, public_matrix, target)


def _small_error(params, ncol, every_entry=True, value=7):
    small = np.zeros((params.crt_depth, 1, ncol, params.n), dtype=np.int64)
    if every_entry:
        small[:, :, :, 0] = value
    else:
        small[:, :, 0, 0] = value
    return small


def _jax_side(args, v_bits, x_of_delta):
    """The JAX package's run of `tests/test_noise_refresh.py`: everything
    the port's run is compared with, as numpy arrays and ints."""
    import jax.numpy as jnp

    from mxx_tpu.bgg import BggEncoding as JEnc, BggPublicKey as JPk
    from mxx_tpu.matrix import PolyMatrix as JPM
    from mxx_tpu.noise_refresh.refresh import DiamondNoiseRefresher as JRefresher
    from mxx_tpu.ring.params import RingParams as JParams
    from mxx_tpu.ring.poly import COEFF as JCOEFF, Poly as JPoly
    from mxx_tpu.sampler import TernaryDist as JTernary, TrapdoorSampler as JTrap
    from mxx_tpu.sampler import UniformSampler as JUniform
    from mxx_tpu.utils.rng import Drbg as JDrbg

    jp = JParams.new(*args)
    ts = _Recording(JTrap(jp, 4.578, seed=141))
    td0, b0 = ts.inner.trapdoor(jp, 2)
    sigma = JUniform(seed=142).sample_poly(jp, JTernary())
    state0 = JPM.from_poly_row(jp, [sigma, JPoly.const(jp, 1)]) @ b0
    nr = JRefresher(jp, ts, b0, td0, KEY, 1, v_bits, base_bits=4)
    x = x_of_delta(nr.delta, jp.modulus)
    a_c = nr._hash_pk("wire_a_c")
    clean = state0 @ nr._abs_encoding_preimage(a_c, x)
    dirty_vec = clean + JPM(jnp.asarray(_small_error(jp, clean.ncol).astype(np.uint32)),
                            JCOEFF, jp)
    material = nr.preprocess(b"refresh0", a_c, JDrbg(b"refresh-rng"))
    refreshed = nr.online_eval(b"refresh0", state0, JEnc(dirty_vec, JPk(a_c, False), None),
                               material)
    pair = lambda m: (np.asarray(m.data), m.fmt)  # noqa: E731
    return {
        "x": x, "a_c": pair(a_c), "dirty": pair(dirty_vec), "state0": pair(state0),
        "targets": [pair(t) for t in ts.targets[1:]],  # [0] is the wire's own encoding
        "material": {
            "mask_value": material["mask_value"], "a_m": pair(material["a_m"]),
            "digit_pks": [pair(m) for m in material["digit_pks"]],
            "p_mask": pair(material["p_mask"]),
            "p_digits": [pair(m) for m in material["p_digits"]],
            "p_decoder": pair(material["p_decoder"]),
        },
        "refreshed": pair(refreshed.vector), "refreshed_pk": pair(refreshed.pubkey.matrix),
    }


def test_diamond_noise_refresher_against_jax():
    args, v_bits = (4, 2, 17, 17), 8
    p = RingParams.new(*args)
    q = p.modulus

    def x_of_delta(delta, modulus):
        return delta * random.Random(143).randrange(1, (modulus // delta) - 1)

    jx = _jax_side(args, v_bits, x_of_delta)

    ts = _Recording(TrapdoorSampler(p, 4.578, seed=141, device=CPU))
    td0, b0 = ts.inner.trapdoor(p, 2)
    sigma = UniformSampler(seed=142, device=CPU).sample_poly(p, TernaryDist())
    state0 = PolyMatrix.from_poly_row(p, [sigma, Poly.const(p, 1, CPU)]) @ b0
    np.testing.assert_array_equal(convert.to_numpy(state0.to_eval()), jx["state0"][0])
    nr = DiamondNoiseRefresher(p, ts, b0, td0, KEY, 1, v_bits, base_bits=4)
    assert isinstance(nr, NoiseRefresher) and nr.device.type == CPU
    x = x_of_delta(nr.delta, q)
    assert x == jx["x"] and x % nr.delta == 0
    a_c = nr._hash_pk("wire_a_c")
    np.testing.assert_array_equal(convert.to_numpy(a_c), jx["a_c"][0])

    # the port's own preprocess: integers and targets equal, preimages exact
    material = nr.preprocess(b"refresh0", a_c, Drbg(b"refresh-rng"))
    jm = jx["material"]
    assert material["mask_value"] == jm["mask_value"]
    np.testing.assert_array_equal(convert.to_numpy(material["a_m"]), jm["a_m"][0])
    assert len(material["digit_pks"]) == len(jm["digit_pks"]) == nr.num_digits == 3
    for mine, theirs in zip(material["digit_pks"], jm["digit_pks"]):
        np.testing.assert_array_equal(convert.to_numpy(mine), theirs[0])
    assert len(ts.targets) == len(jx["targets"]) == 2 + nr.num_digits
    for mine, (theirs, fmt) in zip(ts.targets, jx["targets"]):
        assert mine.fmt == fmt
        np.testing.assert_array_equal(convert.to_numpy(mine), theirs)
    preimages = [material["p_mask"], *material["p_digits"], material["p_decoder"]]
    for pre, target in zip(preimages, ts.targets):
        assert b0 @ pre == target

    # a dirtied wire through the port's own material: the exact fresh relation
    dirty_vec = convert.poly_matrix_from_numpy(p, *jx["dirty"], device=CPU)
    dirty = BggEncoding(dirty_vec, BggPublicKey(a_c, False), None)
    g = PolyMatrix.gadget_matrix(p, 1, CPU)
    x_g = g.mul_poly_scalar(Poly.const(p, x, CPU))
    refreshed = nr.online_eval(b"refresh0", state0, dirty, material)
    assert refreshed.vector == refreshed.pubkey.matrix.mul_poly_scalar(sigma) - x_g
    assert not (dirty.vector == a_c.mul_poly_scalar(sigma) - x_g)

    # the JAX package's material, refreshed by the port: the JAX result
    carried = convert.refresh_material_from_numpy(p, jm, device=CPU)
    again = nr.online_eval(b"refresh0", state0, dirty, carried)
    np.testing.assert_array_equal(convert.to_numpy(again.vector.to_eval()),
                                  jx["refreshed"][0])
    np.testing.assert_array_equal(convert.to_numpy(again.pubkey.matrix.to_eval()),
                                  jx["refreshed_pk"][0])
    assert again.vector == again.pubkey.matrix.mul_poly_scalar(sigma) - x_g

    # default rng: a Drbg keyed by the refresh id, the same in both packages
    from mxx_tpu.utils.rng import Drbg as JDrbg
    want = nr.delta * JDrbg(b"noise_refresh" + b"id7").randrange(nr.value_range // nr.delta)
    assert nr.preprocess(b"id7", a_c)["mask_value"] == want


def test_crt_split_refresher():
    p = RingParams.new(4, 2, 17, 4)
    q = p.modulus
    ts = _Recording(TrapdoorSampler(p, 4.578, seed=151, device=CPU))
    td0, b0 = ts.inner.trapdoor(p, 2)
    sigma = UniformSampler(seed=152, device=CPU).sample_poly(p, TernaryDist())
    state0 = PolyMatrix.from_poly_row(p, [sigma, Poly.const(p, 1, CPU)]) @ b0
    nr = NoiseRefresherNaiveVec(p, ts, b0, td0, KEY, 1, 6, base_bits=4)
    rng = random.Random(153)
    x = rng.randrange(q)
    ys = nr.encode_values(x)
    assert sum(y * (q // q_i) for y, q_i in zip(ys, p.moduli)) % q == x
    a_cs, encs = [], []
    for i, (lvl, y) in enumerate(zip(nr.levels, ys)):
        a_c = lvl._hash_pk(f"nv_wire_{i}")
        clean = state0 @ lvl._abs_encoding_preimage(a_c, y)
        err = torch.from_numpy(_small_error(p, clean.ncol, every_entry=False, value=1))
        dirty = clean + PolyMatrix(err, COEFF, p)
        a_cs.append(a_c)
        encs.append(BggEncoding(dirty, BggPublicKey(a_c, False), None))
    ts.targets.clear()
    materials = nr.preprocess(b"nv", a_cs, rng)
    assert len(ts.targets) == p.crt_depth * (2 + nr.levels[0].num_digits)
    refreshed, recomposed, x_hat = nr.online_eval(b"nv", state0, encs, materials)
    assert len(refreshed) == p.crt_depth
    g = PolyMatrix.gadget_matrix(p, 1, CPU)
    expected = recomposed.pubkey.matrix.mul_poly_scalar(sigma) - g.mul_poly_scalar(
        Poly.const(p, x_hat, CPU))
    assert recomposed.vector == expected
    bound = sum((lvl.delta // 2 + 1) * (q // q_i) for lvl, q_i in zip(nr.levels, p.moduli))
    diff = (x_hat - x) % q
    assert min(diff, q - diff) <= bound
