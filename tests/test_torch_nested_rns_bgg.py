"""The slice as a whole at a small ring: one nested-RNS modular
multiplication (`a.mul(b).full_reduce()` and its `reconstruct()`, wide
p-basis) over BGG+ public keys and encodings whose inputs are lifted from
the one wire by `lift_constants_batched`, evaluated by `eval_batched` with
the debug LUT evaluators: the path `chip_smoke.py` drives on the card at
n=2^13, L=8.

The same seeded inputs go through the JAX package and through the port on
the CPU: lifted wires, output public keys, output vectors and plaintexts
bit for bit (integer work, tolerance 0). On the port's own results: the
outputs decode to x y mod Q, equal the plaintext oracle and satisfy
c = s A - pt (s G) exactly (the debug evaluator's outputs carry no error),
and a batched pass cut into byte-bounded parts equals the uncut and the
sequential pass.
"""

import random

import numpy as np
import pytest

from test_torch_structure import assert_circuits_equal

from mxx_tpu_torch import convert
from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler
from mxx_tpu_torch.bgg.lift import lift_constants_batched
from mxx_tpu_torch.circuit import PolyCircuit
from mxx_tpu_torch.circuit.batched_eval import WireStore, eval_batched
from mxx_tpu_torch.gadgets.arith.nested_rns import (NestedRnsPoly, decode_nested_rns_outputs,
                                                    encode_nested_rns_value)
from mxx_tpu_torch.gadgets.fhe import RingGswContext
from mxx_tpu_torch.lookup import (DebugBGGEncodingPltEvaluator, DebugBGGPubKeyPltEvaluator,
                                  PolyPltEvaluator)
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import Poly
from mxx_tpu_torch.sampler import TernaryDist, UniformSampler

KEY = bytes([0x13, 0x37, 0xC0, 0xDE] * 8)
ARGS = (16, 2, 28, 14)
CPU = "cpu"


def _circuit(circuit_cls, ctx_cls, poly_cls, params):
    circuit = circuit_cls()
    ctx = ctx_cls(circuit, params, 8, 2, p_basis="wide").nested
    a = poly_cls.input(ctx, circuit)
    b = poly_cls.input(ctx, circuit)
    prod = a.mul(b, circuit).full_reduce(circuit)
    circuit.output(prod.flatten() + [prod.reconstruct(circuit)])
    return circuit, ctx, prod


@pytest.fixture(scope="module")
def port():
    p = RingParams.new(*ARGS)
    circuit, ctx, prod = _circuit(PolyCircuit, RingGswContext, NestedRnsPoly, p)
    rng = random.Random(61)
    x, y = rng.randrange(p.modulus), rng.randrange(p.modulus)
    values = [r for v in (x, y) for row in encode_nested_rns_value(ctx, v) for r in row]
    secret = UniformSampler(seed=62, device=CPU).sample_poly(p, TernaryDist())
    one_pk = BGGPublicKeySampler(KEY, 1, CPU).sample(p, b"nested_rns", [])
    es = BGGEncodingSampler(p, [secret], gauss_sigma=4.0, seed=63)
    one_enc = es.sample(p, one_pk, [])[0]
    pk_in = lift_constants_batched(p, one_pk[0], values)
    enc_in = lift_constants_batched(p, one_enc, values)
    pk_out = eval_batched(circuit, p, one_pk[0], pk_in, DebugBGGPubKeyPltEvaluator(KEY))
    enc_out = eval_batched(circuit, p, one_enc, enc_in,
                           DebugBGGEncodingPltEvaluator(KEY, es.secret_vec))
    return dict(p=p, circuit=circuit, ctx=ctx, prod=prod, x=x, y=y, values=values, es=es,
                one_pk=one_pk[0], one_enc=one_enc, pk_in=pk_in, enc_in=enc_in, pk_out=pk_out,
                enc_out=enc_out)


def test_outputs_decode_match_the_oracle_and_hold_the_relation(port):
    p, ctx, circuit = port["p"], port["ctx"], port["circuit"]
    enc_out, s = port["enc_out"], port["es"].secret_vec
    raw = [e.plaintext.const_value() for e in enc_out]
    rows = [raw[l * ctx.k:(l + 1) * ctx.k] for l in range(port["prod"].levels)]
    want = port["x"] * port["y"] % p.modulus
    assert decode_nested_rns_outputs(ctx, rows) == want and raw[-1] == want
    oracle = circuit.eval(p, Poly.one(p, CPU), [Poly.const(p, v, CPU) for v in port["values"]],
                          plt_evaluator=PolyPltEvaluator())
    s_g = s @ PolyMatrix.gadget_matrix(p, 1, CPU)
    assert len(enc_out) == port["prod"].levels * ctx.k + 1
    for e, k, o in zip(enc_out, port["pk_out"], oracle):
        assert e.plaintext == o and e.pubkey == k
        assert e.vector == s @ e.pubkey.matrix - s_g.mul_poly_scalar(o)
    # the lifted inputs carry the one wire's error: they hold the relation only up to it
    e0 = port["enc_in"][0]
    assert not (e0.vector == s @ e0.pubkey.matrix - s_g.mul_poly_scalar(e0.plaintext))


def test_parts_equal_the_whole_and_the_sequential_pass(port, monkeypatch):
    p, circuit = port["p"], port["circuit"]
    wire = WireStore._wire_bytes(port["enc_in"][0])
    monkeypatch.setenv("LUT_BYTES_LIMIT", str(5 * wire))  # parts of 5 encodings, 10 pubkeys
    stores = []
    enc_parts = eval_batched(circuit, p, port["one_enc"], port["enc_in"],
                             DebugBGGEncodingPltEvaluator(KEY, port["es"].secret_vec),
                             wire_store_out=stores)
    pk_parts = eval_batched(circuit, p, port["one_pk"], port["pk_in"],
                            DebugBGGPubKeyPltEvaluator(KEY))
    assert all(a == b for a, b in zip(enc_parts, port["enc_out"]))
    assert all(a == b for a, b in zip(pk_parts, port["pk_out"]))
    assert stores[0].peak_live_bytes > 100 * wire  # a level of this circuit is wide
    monkeypatch.delenv("LUT_BYTES_LIMIT")
    seq = circuit.eval(p, port["one_pk"], port["pk_in"],
                       plt_evaluator=DebugBGGPubKeyPltEvaluator(KEY))
    assert all(a == b for a, b in zip(seq, port["pk_out"]))


def test_against_the_jax_package(port):
    from mxx_tpu.bgg import BGGEncodingSampler as JEncSampler, BGGPublicKeySampler as JPkSampler
    from mxx_tpu.bgg.lift import lift_constants_batched as jax_lift
    from mxx_tpu.circuit import PolyCircuit as JCircuit
    from mxx_tpu.circuit.batched_eval import eval_batched as jax_eval_batched
    from mxx_tpu.gadgets.arith.nested_rns import NestedRnsPoly as JNested
    from mxx_tpu.gadgets.fhe import RingGswContext as JCtx
    from mxx_tpu.lookup.debug import DebugBGGEncodingPltEvaluator as JEncEval
    from mxx_tpu.lookup.debug import DebugBGGPubKeyPltEvaluator as JPkEval
    from mxx_tpu.ring.params import RingParams as JParams
    from mxx_tpu.sampler import TernaryDist as JTernary, UniformSampler as JUniform

    jp = JParams.new(*ARGS)
    jcircuit, _, _ = _circuit(JCircuit, JCtx, JNested, jp)
    assert_circuits_equal(jcircuit, port["circuit"], jp, port["p"])
    secret = JUniform(seed=62).sample_poly(jp, JTernary())
    one_pk = JPkSampler(KEY, 1).sample(jp, b"nested_rns", [])
    es = JEncSampler(jp, [secret], gauss_sigma=4.0, seed=63)
    one_enc = es.sample(jp, one_pk, [])[0]
    pk_in = jax_lift(jp, one_pk[0], port["values"])
    enc_in = jax_lift(jp, one_enc, port["values"])

    def same(mine, theirs):
        assert mine.fmt == theirs.fmt
        np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))

    for mine, theirs in zip(port["enc_in"], enc_in):
        same(mine.vector, theirs.vector)
        same(mine.pubkey.matrix, theirs.pubkey.matrix)
    pk_out = jax_eval_batched(jcircuit, jp, one_pk[0], pk_in, JPkEval(KEY))
    enc_out = jax_eval_batched(jcircuit, jp, one_enc, enc_in, JEncEval(KEY, es.secret_vec))
    assert len(enc_out) == len(port["enc_out"])
    for mine, theirs in zip(port["pk_out"], pk_out):
        same(mine.matrix.to_eval(), theirs.matrix.to_eval())
    for mine, theirs in zip(port["enc_out"], enc_out):
        same(mine.vector.to_eval(), theirs.vector.to_eval())
        same(mine.pubkey.matrix.to_eval(), theirs.pubkey.matrix.to_eval())
        same(mine.plaintext.to_eval(), theirs.plaintext.to_eval())
