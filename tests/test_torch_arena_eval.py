"""The arena evaluator (`circuit/arena_eval.py`) and the stacked matrix ops
(`matrix/rows.py`) of the port against the code they stand in for.

- A Ring-GSW external product over nested-RNS wires (the unit of real-mode
  Diamond iO's PRG rounds: Add, Sub, Mul, SmallScalarMul, PubLut) and a
  circuit of every batchable kind with LargeScalarMul: `eval_batched` over
  the arena equals the general level walk (`eval_batched` with a live-bytes
  budget, which never takes the arena) and, for the second, the sequential
  `PolyCircuit.eval`, bit for bit, over public keys and over encodings
  under a uniform secret (plaintexts and reveal flags included), with the
  debug evaluators' `public_lookup_rows` and with an evaluator that has
  only `public_lookup_batch`. Both evaluators run `gate_rows`, so the walk
  holds the arena's gathers, scatters and flags; the sequential evaluator
  and the JAX package (`tests/test_torch_gsw.py`) hold the arithmetic.
- The arena declines what it does not take (mixed wire types, a sub-circuit
  call) and the general walk gives the same results.
- A Mul whose left operand hides its plaintext raises as the general walk
  does.
- Each stacked op of `matrix/rows.py` equals its `PolyMatrix` op per matrix.
"""

import pytest
import torch

from mxx_tpu_torch.bgg import BGGPublicKeySampler, BggEncoding
from mxx_tpu_torch.circuit import PolyCircuit
from mxx_tpu_torch.circuit.batched_eval import eval_batched
from mxx_tpu_torch.gadgets.fhe.ring_gsw import RingGswCiphertext, RingGswContext, native_encrypt
from mxx_tpu_torch.lookup.debug import DebugBGGEncodingPltEvaluator, DebugBGGPubKeyPltEvaluator
from mxx_tpu_torch.matrix import PolyMatrix, rows
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import COEFF, Poly
from mxx_tpu_torch.sampler import FinRingDist, UniformSampler
from mxx_tpu_torch.utils.rng import Drbg
from mxx_tpu_torch.bgg.lift import lift_constants_batched

KEY = bytes([7] * 32)
RING = (2, 1, 12, 12)


class _BatchOnly:
    """An evaluator with `public_lookup_batch` and `public_lookup` only: the
    arena hands it wire objects."""

    def __init__(self, inner):
        self.inner = inner

    def public_lookup(self, *args):
        return self.inner.public_lookup(*args)

    def public_lookup_batch(self, params, items):
        return self.inner.public_lookup_batch(params, items)


def _gsw_product():
    """A GSW external product of two ciphertexts, reduced at the boundary,
    with the wire values of two encryptions."""
    params = RingParams.new(*RING)
    circuit = PolyCircuit()
    ctx = RingGswContext(circuit, params, 6, 2, p_basis="wide")
    c = ctx.fresh_circuit()
    a = RingGswCiphertext.input(ctx, c, canonical=False)
    b = RingGswCiphertext.input(ctx, c, canonical=False)
    c.output(a.and_(b, c).reduced(c).flatten())
    rng = Drbg(4)
    cts = [native_encrypt(ctx, -1, bit, rng, 0.0) for bit in (1, 1)]
    from mxx_tpu_torch.gadgets.arith.nested_rns import encode_nested_rns_value

    values = [x for ct in cts for row in ct for v in row
              for lvl in encode_nested_rns_value(ctx.nested, v % ctx.q_big) for x in lvl]
    return params, c, values


def _every_kind():
    params = RingParams.new(*RING)
    c = PolyCircuit()
    x = c.input(3)
    s = c.sub_gate(c.add_gate(x[0], x[1]), x[2])
    m = c.mul_gate(s, c.small_scalar_mul(x[1], [3, 1]))
    big = c.large_scalar_mul(m, [params.modulus // 3, 5])
    c.output([big, c.mul_gate(x[0], big), s, x[2]])
    return params, c, [5, 7, 11]


def _wires(params, values):
    one = BGGPublicKeySampler(KEY, 1, device="cpu").sample(params, b"arena", [])[0]
    us = UniformSampler(seed=3, device="cpu")
    # a uniform secret: a ternary one at n=2 is zero one time in nine
    s = us.sample_uniform(params, 1, 1, FinRingDist())
    assert s.to_coeff().data.any()
    g = PolyMatrix.gadget_matrix(params, 1, "cpu")
    one_enc = BggEncoding(s @ (one.matrix - g), one, Poly.one(params, "cpu"))
    return (one, lift_constants_batched(params, one, values), DebugBGGPubKeyPltEvaluator(KEY),
            one_enc, lift_constants_batched(params, one_enc, values),
            DebugBGGEncodingPltEvaluator(KEY, s))


def _equal(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert type(x) is type(y) and x == y
        if isinstance(x, BggEncoding):
            assert (x.plaintext is None) == (y.plaintext is None)
            assert x.plaintext is None or x.plaintext == y.plaintext


@pytest.mark.parametrize("make", [_gsw_product, _every_kind])
@pytest.mark.parametrize("wire", ["pubkey", "encoding"])
@pytest.mark.parametrize("lut_api", ["rows", "batch"])
def test_arena_equals_the_level_walk_and_sequential(make, wire, lut_api):
    params, circuit, values = make()
    one, ins, ev, one_enc, ins_enc, ev_enc = _wires(params, values)
    if wire == "encoding":
        one, ins, ev = one_enc, ins_enc, ev_enc
    if lut_api == "batch":
        ev = _BatchOnly(ev)
    arena = eval_batched(circuit, params, one, ins, ev)
    walk = eval_batched(circuit, params, one, ins, ev, live_bytes_budget=1 << 60)
    _equal(arena, walk)
    if make is _every_kind:
        _equal(arena, circuit.eval(params, one, ins, plt_evaluator=ev))


def test_arena_declines_and_the_walk_agrees(monkeypatch):
    from mxx_tpu_torch.circuit import arena_eval

    params, circuit, values = _every_kind()
    one, ins, ev, one_enc, ins_enc, _ = _wires(params, values)
    mixed = [ins[0], ins_enc[1], ins[2]]
    assert arena_eval.eval_arena(circuit, params, one, mixed, ev) is None
    sub = PolyCircuit()
    y = sub.input(1)
    sub.output([sub.add_gate(y[0], y[0])])
    outer = PolyCircuit()
    z = outer.input(1)
    outer.output(outer.call_sub_circuit(outer.register_sub_circuit(sub), [z[0]]))
    assert arena_eval.eval_arena(outer, params, one, ins[:1], ev) is None
    _equal(eval_batched(outer, params, one, ins[:1], ev),
           outer.eval(params, one, ins[:1], plt_evaluator=ev))


def test_mul_with_a_hidden_left_plaintext_raises():
    params, circuit, values = _every_kind()
    _, _, _, one_enc, ins, ev = _wires(params, values)
    hidden = [BggEncoding(ins[0].vector, ins[0].pubkey, None)] + ins[1:]
    for budget in (None, 1 << 60):
        with pytest.raises(ValueError, match="left-hand input of multiplication"):
            eval_batched(circuit, params, one_enc, hidden, ev, live_bytes_budget=budget)


def test_rows_ops_equal_per_matrix_ops():
    params = RingParams.new(4, 2, 10, 5)
    us = UniformSampler(seed=8, device="cpu")
    mats = [us.sample_uniform(params, 2, 2 * params.modulus_digits, FinRingDist())
            for _ in range(5)]
    mats[1] = mats[1].to_eval()
    left = us.sample_uniform(params, 1, 2 * params.modulus_digits, FinRingDist())
    const = us.sample_uniform(params, 2, 3, FinRingDist())
    st = rows.stack(params, mats)
    assert all(a == b for a, b in zip(rows.unstack(params, st), mats))
    got = rows.left_mul_decompose(params, left, st)
    assert all(a == left.mul_decompose(m) for a, m in zip(rows.unstack(params, got), mats))
    got = rows.mul_decompose_const(params, st, const)
    assert all(a == m.mul_decompose(const) for a, m in zip(rows.unstack(params, got), mats))
    got = rows.mul_int(params, st, params.modulus // 7)
    assert all(a == m.mul_int_scalar(params.modulus // 7)
               for a, m in zip(rows.unstack(params, got), mats))
    q0 = int(params.moduli[0])
    got = rows.modulus_switch(params, st, q0)
    assert all(a == m.modulus_switch(q0)
               for a, m in zip(rows.unstack(params, got, COEFF), mats))
    stacked_pre = torch.stack([m.to_eval().data for m in mats], dim=0)
    got = rows.matmul_left(params, left.slice_columns(0, 2), stacked_pre)
    assert all(a == left.slice_columns(0, 2) @ m for a, m in zip(rows.unstack(params, got), mats))
