"""`mxx_tpu_torch.circuit.serde` against the JAX package's: the JSON of the
same circuit (sub-circuit calls, summed calls, param bindings of every kind,
slot-transfer specs of every kind, a LUT gate, a big constant as u32
digits) is equal string for string; a circuit saved by either package loads
in the other gate for gate; and the JAX-saved circuit, loaded by the port
with its LUT registered again, evaluates over the same `PolyVec` inputs to
the JAX package's outputs."""

import pytest

from test_torch_structure import BOTH, assert_circuits_equal, load


SLOTS = 4
INPUTS = [[1, 2, 3, 4], [5, 0, 2, 7]]


def _build(ns):
    """Every serialized payload kind once, in the package of `ns`."""
    cm = ns.circuit.circuit
    spec = ns.circuit.SlotTransferSpec
    params = ns.params.RingParams.default()
    c = ns.circuit.PolyCircuit()
    a, b = c.input(2)
    lut = c.register_public_lut(ns.lookup.PublicLut.from_dict(
        params, {x: (x, (3 * x + 1) % 11) for x in range(8)}))
    sub = c.fresh_sub_circuit()
    x, y = sub.input(2)
    ps = sub.register_sub_circuit_param(cm.PARAM_SMALL_SCALAR_MUL)
    pl = sub.register_sub_circuit_param(cm.PARAM_LARGE_SCALAR_MUL)
    pt = sub.register_sub_circuit_param(cm.PARAM_SLOT_TRANSFER)
    t = sub.large_scalar_mul_param(sub.small_scalar_mul_param(sub.add_gate(x, y), ps), pl)
    sub.output([sub.slot_transfer_gate_param(t, pt), sub.mul_gate(x, y)])
    sid = c.register_sub_circuit(sub)
    big = params.modulus - 3  # above 2^32: serialized as u32 digits
    la = c.public_lookup_gate(a, lut)
    u, v = c.call_sub_circuit(sid, [la, b], param_bindings=(
        (2,), (big, 1), spec.explicit([(1, None), (0, 3), (3, 2), (2, None)])))
    w, z = c.call_sub_circuit_sum_many(sid, [[u, a], [b, v]], [
        ((1, 2), (5,), spec.rotation(1, SLOTS)),
        ((3,), (1 << 40,), spec.repeated(0, SLOTS, 2, 5))])
    r = c.slot_transfer_gate_spec(c.sub_gate(w, z), spec.rotation(3, SLOTS))
    s = c.slot_reduce_gate([r, c.large_scalar_mul(c.const_one_gate(), [big, 7])], SLOTS)
    c.output([u, v, w, z, c.large_scalar_mul(r, [big]), s])
    return c, params


def _eval(ns, circuit, params):
    kw = ns.kw
    one = ns.poly_vec.PolyVec.const(params, [1] * SLOTS, **kw)
    outs = circuit.eval(params, one, [ns.poly_vec.PolyVec.const(params, v, **kw) for v in INPUTS],
                        plt_evaluator=ns.vec_eval.PolyVecPltEvaluator(),
                        slot_transfer_evaluator=ns.slot_transfer.PolyVecSlotTransferEvaluator())
    return [[p.const_coeff() for p in o.slots] for o in outs]


def test_json_equal_string_for_string():
    (cj, _), (ct, _) = (_build(load(pkg)) for pkg in BOTH)
    jj, jt = load("mxx_tpu"), load("mxx_tpu_torch")
    raw = jj.serde.circuit_to_json(cj)
    assert jt.serde.circuit_to_json(ct) == raw
    # a second pass through the port's loader is stable
    assert jt.serde.circuit_to_json(jt.serde.circuit_from_json(raw)) == raw


@pytest.mark.parametrize("saver", BOTH)
def test_saved_circuit_loads_in_the_other_package(tmp_path, saver):
    loader = BOTH[1 - BOTH.index(saver)]
    s, l_ = load(saver), load(loader)
    circuit, _ = _build(s)
    path = tmp_path / "c.json"
    s.serde.save_circuit(circuit, path)
    loaded = l_.serde.load_circuit(path)
    mine = loaded if loader == "mxx_tpu_torch" else circuit
    theirs = circuit if loader == "mxx_tpu_torch" else loaded
    assert_circuits_equal(theirs, mine)
    assert loaded.luts == {}  # LUT tables are not serialized


def test_jax_saved_circuit_evaluates_equal_in_the_port():
    jj, jt = load("mxx_tpu"), load("mxx_tpu_torch")
    cj, pj = _build(jj)
    ct, pt = _build(jt)  # only for its LUT registry
    loaded = jt.serde.circuit_from_json(jj.serde.circuit_to_json(cj))
    loaded.luts.update(ct.luts)
    assert loaded.sub_circuits[0].luts is loaded.luts
    want = _eval(jj, cj, pj)
    assert _eval(jt, loaded, pt) == want
    assert _eval(jt, ct, pt) == want
