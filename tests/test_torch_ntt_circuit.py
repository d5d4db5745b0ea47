"""`mxx_tpu_torch.gadgets.ntt_circuit` against the JAX package: the serde
JSON of the forward-then-inverse circuit (equal string for string) and its
gates and LUT, the case of `tests/test_conv_ntt_gadgets.py` evaluated over
`PolyVec` wires on the CPU (the forward output equals the host NTT mod p and
the round trip the input), and the port's `nested_level_ntt`, which says it
mirrors these butterflies: for p = q_level it builds the same slot transfers
stage for stage. Integer work, tolerance 0."""

import random

import pytest

from test_conv_ntt_gadgets import host_ntt
from test_torch_structure import BOTH, assert_circuits_equal, load

from mxx_tpu_torch.circuit.gate import SLOT_TRANSFER
from mxx_tpu_torch.gadgets.arith import nested_rns

SLOTS = 8
P = 17  # 1 mod 16


def _case(pkg):
    ns = load(pkg)
    params = ns.params.RingParams.new(8, 2, 17, 1)  # the ring covers the slots
    rng = random.Random(12)
    vals = [rng.randrange(P) for _ in range(SLOTS)]
    circuit = ns.circuit.PolyCircuit()
    (w,) = circuit.input(1)
    lut = ns.ntt_circuit.register_mod_p_lut(circuit, params, P, 2 * P * P)
    fwd = ns.ntt_circuit.forward_ntt(circuit, w, SLOTS, P, lut)
    back = ns.ntt_circuit.inverse_ntt(circuit, fwd, SLOTS, P, lut)
    circuit.output([fwd, back])
    vec = ns.poly_vec.PolyVec
    outs = circuit.eval(params, vec.const(params, [1] * SLOTS, **ns.kw),
                        [vec.const(params, vals, **ns.kw)],
                        plt_evaluator=ns.vec_eval.PolyVecPltEvaluator(),
                        slot_transfer_evaluator=ns.slot_transfer.PolyVecSlotTransferEvaluator())
    got = [[p.const_coeff() for p in o.slots] for o in outs]
    assert got == [host_ntt(vals, P), vals]
    return circuit, params, got, ns.serde.circuit_to_json(circuit)


def test_forward_inverse_equal():
    (cj, pj, gj, sj), (ct, pt, gt, st) = (_case(pkg) for pkg in BOTH)
    assert st == sj
    assert_circuits_equal(cj, ct, pj, pt)
    assert gt == gj


@pytest.mark.parametrize("inverse", [False, True])
def test_nested_level_ntt_mirrors_the_butterflies(monkeypatch, inverse):
    ns = load("mxx_tpu_torch")
    params = ns.params.RingParams.new(16, 2, 20, 5)
    circuit = ns.circuit.PolyCircuit()
    ctx = ns.nested.NestedRnsPolyContext(circuit, params, 7, 2)
    stages = []
    real = nested_rns._level_ntt_stage_wires

    def record(ctx_, circuit_, wires, left, right):
        stages.append((list(left), list(right)))
        return real(ctx_, circuit_, wires, left, right)

    monkeypatch.setattr(nested_rns, "_level_ntt_stage_wires", record)
    x = ns.nested.NestedRnsPoly.input(ctx, circuit, 0, 1)
    nested_rns.nested_level_ntt(x, circuit, SLOTS, inverse=inverse)
    q = ctx.q_moduli[0]
    ref = ns.circuit.PolyCircuit()
    (w,) = ref.input(1)
    lut = ns.ntt_circuit.register_mod_p_lut(ref, params, q, 2 * q * q)
    build = ns.ntt_circuit.inverse_ntt if inverse else ns.ntt_circuit.forward_ntt
    build(ref, w, SLOTS, q, lut)
    specs = [list(g.payload.values) for g in ref.gates if g.kind == SLOT_TRANSFER]
    assert len(stages) == SLOTS.bit_length() - 1
    assert [s for stage in stages for s in stage] == specs
