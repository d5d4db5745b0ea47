"""Gate-for-gate comparison of a circuit built by `mxx_tpu` with the one the
same calls give in `mxx_tpu_torch`.

`assert_circuits_equal` is the helper the other `test_torch_*` files import:
it holds the two circuits equal in every gate (kind, input ids, payload:
scalars, LUT ids, slot-transfer specs, sub-circuit call ids and parameter
markers), in their outputs, parameters, sub-circuit calls and registered
sub-circuits (recursively), and in every registered `PublicLut` (length,
`max_output_row`, and the entries: all of them up to `LUT_FULL` entries, a
strided sample with both ends beyond). The tests below hold the helper
itself: it passes on equal circuits and names the first difference of each
kind it is meant to see.
"""

import dataclasses
import importlib
from types import SimpleNamespace

import pytest

LUT_FULL = 20000
LUT_SAMPLES = 2000


_MODULES = {
    "circuit": "circuit", "params": "ring.params", "poly": "ring.poly", "matrix": "matrix",
    "lookup": "lookup", "rng": "utils.rng", "nested": "gadgets.arith.nested_rns",
    "conv_mul": "gadgets.conv_mul", "ring_gsw": "gadgets.fhe.ring_gsw",
    "plain_gsw": "gadgets.fhe.plain_gsw", "packed": "gadgets.fhe.packed_ring_gsw",
    "goldreich": "gadgets.fhe_prg.goldreich", "mask_circuit": "decoder.mask_circuit",
    "prg": "decoder.prg", "circuit_decrypt": "noise_refresh.circuit_decrypt",
    "circuit_merge": "noise_refresh.circuit_merge", "circuit_prg": "noise_refresh.circuit_prg",
    "refresh": "noise_refresh.refresh", "serde": "circuit.serde",
    "poly_vec": "circuit.poly_vec", "vec_eval": "lookup.vec_eval",
    "slot_transfer": "slot_transfer", "mod_switch": "gadgets.mod_switch",
    "ntt_circuit": "gadgets.ntt_circuit", "ckks": "gadgets.fhe.ckks",
    "carry": "gadgets.arith.carry_montgomery", "parallel": "parallel",
}


def load(pkg: str) -> SimpleNamespace:
    """The modules of this slice under the same names for either package
    ("mxx_tpu" or "mxx_tpu_torch"), with `const(params, v)` and `one(params)`
    making plaintext wires on the CPU."""
    ns = SimpleNamespace(pkg=pkg, **{
        k: importlib.import_module(f"{pkg}.{m}") for k, m in _MODULES.items()})
    kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    ns.kw = kw
    ns.const = lambda params, v: ns.poly.Poly.const(params, v, **kw)
    ns.one = lambda params: ns.poly.Poly.one(params, **kw)
    return ns


BOTH = ("mxx_tpu", "mxx_tpu_torch")


def _norm(payload):
    """A gate payload as plain Python data, equal across the packages."""
    if dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        return (type(payload).__name__, dataclasses.astuple(payload))
    if isinstance(payload, (tuple, list)):
        return tuple(_norm(p) for p in payload)
    return payload


def _lut_rows(params, lut, xs):
    out = []
    for x in xs:
        got = lut.get(params, x)
        out.append(None if got is None else (got[0], got[1].value, got[1].modulus))
    return out


def assert_luts_equal(params_j, luts_j, params_t, luts_t):
    assert sorted(luts_j) == sorted(luts_t), "LUT ids differ"
    for lid in sorted(luts_j):
        a, b = luts_j[lid], luts_t[lid]
        assert len(a) == len(b), f"LUT {lid}: length {len(a)} != {len(b)}"
        ma, mb = a.max_output_row, b.max_output_row
        assert (ma[0], ma[1].value, ma[1].modulus) == (mb[0], mb[1].value, mb[1].modulus), (
            f"LUT {lid}: max_output_row differs")
        n = len(a)
        if n <= LUT_FULL:
            xs = range(n + 1)  # one past the end: both must answer None there
        else:
            step = max(1, n // LUT_SAMPLES)
            xs = sorted(set(range(0, n, step)) | {n - 2, n - 1, n})
        assert _lut_rows(params_j, a, xs) == _lut_rows(params_t, b, xs), (
            f"LUT {lid}: entries differ")


def assert_circuits_equal(cj, ct, params_j=None, params_t=None, _path="circuit"):
    """`cj` of `mxx_tpu`, `ct` of `mxx_tpu_torch`; with both params given the
    registered LUTs are compared too (once, at the top: sub-circuits share
    the registry)."""
    assert cj.num_input == ct.num_input, f"{_path}: num_input"
    assert len(cj.gates) == len(ct.gates), (
        f"{_path}: {len(cj.gates)} gates != {len(ct.gates)}")
    for ga, gb in zip(cj.gates, ct.gates):
        if (ga.gate_id, ga.kind, tuple(ga.inputs)) != (gb.gate_id, gb.kind, tuple(gb.inputs)) \
                or _norm(ga.payload) != _norm(gb.payload):
            raise AssertionError(f"{_path}: gate {ga.gate_id} differs: {ga} != {gb}")
    assert list(cj.output_ids) == list(ct.output_ids), f"{_path}: output ids"
    assert list(cj.sub_circuit_params) == list(ct.sub_circuit_params), f"{_path}: params"
    assert sorted(cj.sub_circuit_calls) == sorted(ct.sub_circuit_calls), f"{_path}: calls"
    for cid, a in cj.sub_circuit_calls.items():
        b = ct.sub_circuit_calls[cid]
        assert (a.sub_circuit_id, tuple(a.inputs), _norm(a.param_bindings),
                list(a.output_gate_ids)) == (
            b.sub_circuit_id, tuple(b.inputs), _norm(b.param_bindings),
            list(b.output_gate_ids)), f"{_path}: sub-circuit call {cid}"
    assert sorted(cj.summed_sub_circuit_calls) == sorted(ct.summed_sub_circuit_calls), (
        f"{_path}: summed calls")
    for cid, a in cj.summed_sub_circuit_calls.items():
        b = ct.summed_sub_circuit_calls[cid]
        assert (a.sub_circuit_id, _norm(a.call_inputs), _norm(a.param_bindings),
                list(a.output_gate_ids)) == (
            b.sub_circuit_id, _norm(b.call_inputs), _norm(b.param_bindings),
            list(b.output_gate_ids)), f"{_path}: summed call {cid}"
    assert sorted(cj.sub_circuits) == sorted(ct.sub_circuits), f"{_path}: sub-circuit ids"
    for sid in cj.sub_circuits:
        assert_circuits_equal(cj.sub_circuits[sid], ct.sub_circuits[sid],
                              _path=f"{_path}.sub[{sid}]")
    if params_j is not None:
        assert_luts_equal(params_j, cj.luts, params_t, ct.luts)


# ------------------------------------------------------- the helper's own tests


def _build(pkg, *, scalar=3, lut_shift=0, extra_gate=False, sub_scalar=5, spec_scalar=2):
    """The same small circuit in either package: every payload kind once."""
    import importlib

    circ = importlib.import_module(f"{pkg}.circuit")
    params_cls = importlib.import_module(f"{pkg}.ring.params").RingParams
    lut_cls = importlib.import_module(f"{pkg}.lookup").PublicLut
    params = params_cls.default()
    c = circ.PolyCircuit()
    a, b = c.input(2)
    lut = c.register_public_lut(lut_cls.from_dict(
        params, {x: (x, (x * x + lut_shift) % 11) for x in range(8)}))
    sub = c.fresh_sub_circuit()
    (x,) = sub.input(1)
    sub.output([sub.small_scalar_mul(x, [sub_scalar])])
    sid = c.register_sub_circuit(sub)
    t = c.add_gate(c.mul_gate(a, b), c.small_scalar_mul(a, [scalar, 1]))
    t = c.public_lookup_gate(c.large_scalar_mul(t, [params.modulus - 1]), lut)
    t = c.slot_transfer_gate_spec(t, circ.SlotTransferSpec.repeated(1, 4, 2, spec_scalar))
    t = c.slot_transfer_gate(t, [(0, None), (1, 3)])
    (u,) = c.call_sub_circuit(sid, [t])
    (v,) = c.call_sub_circuit_sum_many(sid, [[t], [u]])
    if extra_gate:
        v = c.sub_gate(v, a)
    c.output([u, v])
    return c, params


def test_equal_circuits_compare_equal():
    cj, pj = _build("mxx_tpu")
    ct, pt = _build("mxx_tpu_torch")
    assert_circuits_equal(cj, ct, pj, pt)


@pytest.mark.parametrize("change, where", [
    (dict(scalar=4), "gate"),
    (dict(extra_gate=True), "gates"),
    (dict(lut_shift=1), "LUT 0"),
    (dict(sub_scalar=6), "sub[0]"),
    (dict(spec_scalar=3), "gate"),
])
def test_a_difference_is_named(change, where):
    cj, pj = _build("mxx_tpu")
    ct, pt = _build("mxx_tpu_torch", **change)
    with pytest.raises(AssertionError, match=where.replace("[", r"\[").replace("]", r"\]")):
        assert_circuits_equal(cj, ct, pj, pt)


# ------------------------------------------- the arithmetic gadget modules


def _gadget_circuit(pkg, gadget):
    """A small circuit of each arithmetic gadget module in either package."""
    ns = load(pkg)
    c = ns.circuit.PolyCircuit()
    if gadget == "ntt_circuit":
        params = ns.params.RingParams.new(8, 2, 17, 1)
        (w,) = c.input(1)
        lut = ns.ntt_circuit.register_mod_p_lut(c, params, 17, 2 * 17 * 17)
        fwd = ns.ntt_circuit.forward_ntt(c, w, 8, 17, lut)
        c.output([fwd, ns.ntt_circuit.inverse_ntt(c, fwd, 8, 17, lut)])
        return c, params
    if gadget == "carry_montgomery":
        params = ns.params.RingParams.default()
        ctx = ns.carry.CarryArithContext(c, params, 4, 4)
        a, b = ns.carry.CarryArithPoly.input(ctx, c), ns.carry.CarryArithPoly.input(ctx, c)
        prod = ns.carry.MontgomeryContext(ctx, 64513).mont_mul(a, b, c)
        c.output(a.add(b, c).normalize(c).limbs + a.mul(b, c).limbs + prod.limbs)
        return c, params
    params = ns.params.RingParams.new(16, 3, 20, 5)
    ctx = ns.ckks.CKKSContext(c, params, 8, max_unreduced_muls=2, scale=1 << 17,
                              relinearization_extra_levels=1)
    if gadget == "mod_switch":
        x = ns.nested.NestedRnsPoly.input(ctx.nested, c, 0, 3)
        c.output(ns.mod_switch.drop_levels(x, 2).flatten())
        return c, params
    w1 = ns.ckks.CKKSCiphertext.input(ctx, c)
    w2 = ns.ckks.CKKSCiphertext.input(ctx, c)
    c.output(w1.add(w2, c).rescale(c).flatten())
    return c, params


@pytest.mark.parametrize("gadget", ["mod_switch", "ntt_circuit", "ckks", "carry_montgomery"])
def test_gadget_circuits_equal(gadget):
    (cj, pj), (ct, pt) = (_gadget_circuit(pkg, gadget) for pkg in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)
