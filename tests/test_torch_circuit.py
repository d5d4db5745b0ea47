"""mxx_tpu_torch circuit IR and level-batched evaluator against mxx_tpu: the
same circuit built in both packages has the same levels, use counts and
execution plan; over BGG+ wires the port's batched evaluation equals its
sequential evaluation and the JAX package's `eval_batched`, bit for bit, for
a circuit with every batched gate kind; the outputs satisfy the decode
invariant c = s A - x (s G) with x from the plaintext evaluation."""

import numpy as np
import pytest

import mxx_tpu  # noqa: F401
from mxx_tpu.bgg import BGGEncodingSampler as JaxBGGEncodingSampler
from mxx_tpu.bgg import BGGPublicKeySampler as JaxBGGPublicKeySampler
from mxx_tpu.circuit import PolyCircuit as JaxPolyCircuit
from mxx_tpu.circuit.analysis import GroupedExecutionPlan as JaxPlan
from mxx_tpu.circuit.batched_eval import eval_batched as jax_eval_batched
from mxx_tpu.gadgets.secret_ip import secret_inner_product as jax_secret_inner_product
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.ring.poly import Poly as JaxPoly

from mxx_tpu_torch import convert
from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler
from mxx_tpu_torch.circuit import PolyCircuit
from mxx_tpu_torch.circuit.analysis import GroupedExecutionPlan
from mxx_tpu_torch.circuit.batched_eval import eval_batched
from mxx_tpu_torch.gadgets import secret_inner_product
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import Poly
from mxx_tpu_torch.sampler import TernaryDist, UniformSampler

KEY = bytes([0x13, 0x37, 0xC0, 0xDE] * 8)
ARGS = (16, 2, 20, 5)
N_PAIRS = 6


def _build(circuit, inner_product, n=N_PAIRS):
    """n public and n secret inputs; public inputs scaled (SmallScalarMul for
    the first half, LargeScalarMul for the second), then the inner product
    of the scaled public wires with the secret ones (one level of n Mul and a
    chain of Add), a level of Sub and a level of Add."""
    pub = circuit.input(n)
    sec = circuit.input(n)
    half = n // 2
    scaled = [circuit.small_scalar_mul(pub[i], [i + 1, 0, 1]) for i in range(half)]
    scaled += [circuit.large_scalar_mul(pub[i], [2**20 + i, 3]) for i in range(half, n)]
    ip = inner_product(circuit, scaled, list(sec))
    subs = [circuit.sub_gate(scaled[j], scaled[j + half]) for j in range(half)]
    adds = [circuit.add_gate(scaled[j], pub[j]) for j in range(half)]
    circuit.output([ip] + subs + adds)
    return circuit


def test_levels_use_counts_and_plan_equal():
    mine = _build(PolyCircuit(), secret_inner_product)
    theirs = _build(JaxPolyCircuit(), jax_secret_inner_product)
    # a sub-circuit call and the boolean helpers, in both
    for c in (mine, theirs):
        sub = c.fresh_sub_circuit()
        a, b = sub.input(2)
        sub.output([sub.xor_gate(a, b), sub.or_gate(a, b)])
        cid = c.register_sub_circuit(sub)
        c.output(c.call_sub_circuit(cid, [c.output_ids[0], 1]))
    assert mine.compute_levels() == theirs.compute_levels()
    assert mine.use_counts() == theirs.use_counts()
    assert mine.gate_counts() == theirs.gate_counts()
    assert mine.non_free_depth() == theirs.non_free_depth()
    pm, pt = GroupedExecutionPlan.from_circuit(mine), JaxPlan.from_circuit(theirs)
    assert [lvl.groups for lvl in pm.levels] == [lvl.groups for lvl in pt.levels]
    assert pm.max_parallelism == pt.max_parallelism and pm.total_gates() == pt.total_gates()


def _inputs(params, jparams, n=N_PAIRS):
    """Small public constants (revealed) and uniform-ternary secret
    plaintexts (not revealed), the same in both packages."""
    rng = np.random.default_rng(4)
    pub_vals = [int(v) for v in rng.integers(0, 50, size=n)]
    sec_coeffs = [[int(c) for c in rng.integers(-1, 2, size=params.n)] for _ in range(n)]
    mine = [Poly.const(params, v, device="cpu") for v in pub_vals]
    mine += [Poly.from_int_coeffs(params, c, device="cpu") for c in sec_coeffs]
    theirs = [JaxPoly.const(jparams, v) for v in pub_vals]
    theirs += [JaxPoly.from_int_coeffs(jparams, c) for c in sec_coeffs]
    return mine, theirs, [True] * n + [False] * n


def _same(a, b):
    np.testing.assert_array_equal(convert.to_numpy(a), np.asarray(b.data))


@pytest.mark.parametrize("budget", [0, 1])
def test_batched_equals_sequential_and_jax(budget):
    p, jp = RingParams.new(*ARGS), JaxRingParams.new(*ARGS)
    circuit = _build(PolyCircuit(), secret_inner_product)
    jcircuit = _build(JaxPolyCircuit(), jax_secret_inner_product)
    plain, jplain, reveal = _inputs(p, jp)

    pks = BGGPublicKeySampler(KEY, 1, device="cpu").sample(p, b"circuit", reveal)
    jpks = JaxBGGPublicKeySampler(KEY, 1).sample(jp, b"circuit", reveal)
    seq = circuit.eval(p, pks[0], pks[1:])
    store = []
    bat = eval_batched(circuit, p, pks[0], pks[1:], live_bytes_budget=budget,
                       wire_store_out=store)
    assert (store[0].spill_count > 0) == (budget > 0)
    jbat = jax_eval_batched(jcircuit, jp, jpks[0], jpks[1:])
    for s, b, j in zip(seq, bat, jbat):
        assert s == b
        _same(b.matrix.to_eval(), j.matrix.to_eval())

    secret = UniformSampler(seed=9, device="cpu").sample_poly(p, TernaryDist())
    jsecret = convert.poly_from_numpy(p, np.asarray(secret.data), secret.fmt, device="cpu")
    es = BGGEncodingSampler(p, [jsecret], gauss_sigma=None)
    jes = JaxBGGEncodingSampler(jp, [JaxPoly(np.asarray(convert.to_numpy(secret)), secret.fmt, jp)],
                                gauss_sigma=None)
    encs = es.sample(p, pks, plain)
    jencs = jes.sample(jp, jpks, jplain)
    seq_e = circuit.eval(p, encs[0], encs[1:])
    bat_e = circuit.eval(p, encs[0], encs[1:], batched=True)
    jbat_e = jax_eval_batched(jcircuit, jp, jencs[0], jencs[1:])
    x_out = circuit.eval(p, Poly.one(p, device="cpu"), plain)  # the plaintext oracle
    s_g = es.secret_vec @ PolyMatrix.gadget_matrix(p, 1, device="cpu")
    for s, b, j, pk, x in zip(seq_e, bat_e, jbat_e, bat, x_out):
        assert s == b
        assert b.pubkey == pk
        _same(b.vector.to_eval(), j.vector.to_eval())
        _same(b.pubkey.matrix.to_eval(), j.pubkey.matrix.to_eval())
        assert b.vector == es.secret_vec @ b.pubkey.matrix - s_g.mul_poly_scalar(x)
        if b.plaintext is not None:
            assert b.plaintext == x


def test_sub_circuit_and_singles_through_batched_walk():
    """A sub-circuit call, and groups below the batch width, take the
    sequential dispatch inside the level walk and still equal `eval`."""
    p = RingParams.new(*ARGS)
    c = PolyCircuit()
    a, b = c.input(2)
    sub = c.fresh_sub_circuit()
    x, y = sub.input(2)
    sub.output([sub.add_gate(sub.mul_gate(x, y), x), sub.sub_gate(y, x)])
    cid = c.register_sub_circuit(sub)
    outs = c.call_sub_circuit(cid, [a, b])
    c.output(outs + [c.mul_gate(a, b)])
    pks = BGGPublicKeySampler(KEY, 1, device="cpu").sample(p, b"sub", [True, True])
    plain = [Poly.const(p, 3, device="cpu"), Poly.const(p, 5, device="cpu")]
    encs = BGGEncodingSampler(p, [Poly.const(p, 1, device="cpu")]).sample(p, pks, plain)
    for one, ins in [(pks[0], pks[1:]), (encs[0], encs[1:])]:
        assert c.eval(p, one, ins) == c.eval(p, one, ins, batched=True)
    x_out = c.eval(p, Poly.one(p, device="cpu"), plain)
    assert [x.const_coeff() for x in x_out] == [18, 2, 15]
