"""WEE25-commitment-backed LUT of the port against the JAX package (mirrors
`tests/test_commit_eval.py`, zero-error encodings, `RingParams.new(4, 2,
17, 17)`).

- by relation, on the port's own public params and commitment preimage
  (float-Gaussian draws): the output public key is `derive_a_out_matrix`,
  the plaintext is the table's, and c == s (A_out - G y) exactly, for x=2
  and for x=0 (the (idx+1)^{-1} guard at idx=0); B0 preimage == commit + B_1;
- bit for bit (tolerance 0), on the JAX package's public params carried
  across and its stored commitment preimage: B_1, A_out, every committed
  message block, the commitment, and the online c_out. The JAX side of the
  x=2 case is `slow`, as the JAX package marks that test.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

KEY = bytes([3] * 32)
SIGMA = 4.578
RING = (4, 2, 17, 17)
TABLES = {2: {x: (x, (5 * x + 1) % 11) for x in range(4)},
          0: {x: (x, (3 * x + 7) % 13) for x in range(4)}}


def load(pkg):
    mods = {"params": "ring.params", "poly": "ring.poly", "matrix": "matrix",
            "sampler": "sampler", "bgg": "bgg", "circuit": "circuit", "lookup": "lookup",
            "ce": "lookup.commit_eval", "commit": "commit", "storage": "storage"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    ns.params = ns.params.RingParams.new(*RING)
    k = ns.params.modulus_digits
    ns.scheme = ns.commit.Wee25Commit(1, 2, k + 2, k, SIGMA)
    return ns


def _np(m):
    m = m.to_coeff()
    return m.data.cpu().numpy().astype(np.uint32) if hasattr(m.data, "cpu") else np.asarray(m.data)


def run_commit_lut(ns, tmp_path, x_val, pp=None):
    """The JAX test's offline+online pipeline on a 1-lookup circuit; the
    public params are sampled (seed 111) unless given."""
    params = ns.params
    table = TABLES[x_val]
    pp = pp or ns.scheme.sample_public_params(params, KEY, seed=111, **ns.kw)
    circuit = ns.circuit.PolyCircuit()
    w = circuit.input(1)
    lut_id = circuit.register_public_lut(ns.lookup.PublicLut.from_dict(params, table))
    circuit.output([circuit.public_lookup_gate(w[0], lut_id)])
    us = ns.sampler.UniformSampler(seed=112, **ns.kw)
    secrets = [us.sample_poly(params, ns.sampler.TernaryDist())]
    pubkeys = ns.bgg.BGGPublicKeySampler(KEY, 1, **ns.kw).sample(params, b"ce", [True])
    enc_sampler = ns.bgg.BGGEncodingSampler(params, secrets)  # zero error: exact decode
    encs = enc_sampler.sample(params, pubkeys, [ns.poly.Poly.const(params, x_val, **ns.kw)])
    ts = ns.sampler.TrapdoorSampler(params, SIGMA, seed=113, **ns.kw)
    b0_td, b0 = ts.trapdoor(params, 1)
    s_vec = enc_sampler.secret_vec
    ns.storage.init_storage_system(tmp_path)
    off = ns.ce.CommitBGGPubKeyPltEvaluator(params, ns.scheme, pp, KEY)
    result_pk = circuit.eval(params, pubkeys[0], pubkeys[1:], plt_evaluator=off)[0]
    off.commit_all_lut_matrices(ts, b0_td, b0)
    ns.storage.wait_for_all_writes()
    on = ns.ce.CommitBGGEncodingPltEvaluator(
        params, ns.scheme, pp, KEY, circuit, pubkeys[0], pubkeys[1:], s_vec @ b0,
        s_vec @ pp.b, tmp_path)
    got = circuit.eval(params, encs[0], encs[1:], plt_evaluator=on)[0]
    return SimpleNamespace(got=got, result_pk=result_pk, s_vec=s_vec, y=table[x_val][1], on=on,
                           b0=b0, pp=pp)


def check_exact(ns, run):
    params = run.got.pubkey.matrix.params
    assert run.got.pubkey == run.result_pk
    assert run.got.pubkey.matrix == ns.ce.derive_a_out_matrix(params, 1, KEY, 2, **ns.kw)
    assert run.got.plaintext.const_coeff() == run.y
    g = ns.matrix.PolyMatrix.gadget_matrix(params, 1, **ns.kw)
    want = run.s_vec @ (run.got.pubkey.matrix
                        - g.mul_poly_scalar(ns.poly.Poly.const(params, run.y, **ns.kw)))
    assert run.got.vector == want


@pytest.mark.parametrize("x_val", [2, 0])
def test_commit_eval_exact_decode(tmp_path, x_val):
    """The port's own pipeline (x=0 exercises the (idx+1)^{-1} guard)."""
    pt = load("mxx_tpu_torch")
    run = run_commit_lut(pt, tmp_path, x_val)
    check_exact(pt, run)
    pre = pt.storage.read_matrix_from_multi_batch(pt.params, tmp_path,
                                                   pt.ce.PREIMAGE_OF_COMMIT_ID, 0, "cpu")
    commitment, _ = pt.scheme.commit(pt.params, run.on.stream, run.pp)
    assert run.b0 @ pre == commitment + run.on.b_1


def _matches_jax(tmp_path, x_val):
    """The port's online pass over the JAX package's public params and stored
    commitment preimage: blocks, commitment and c_out bit for bit."""
    from mxx_tpu_torch import convert

    jx, pt = load("mxx_tpu"), load("mxx_tpu_torch")
    jrun = run_commit_lut(jx, tmp_path, x_val)
    check_exact(jx, jrun)
    jpp = jrun.pp
    pp = convert.wee25_public_params_from_numpy(
        pt.params, (np.asarray(jpp.b.data), jpp.b.fmt),
        (np.asarray(jpp.t_bottom.data), jpp.t_bottom.fmt),
        [(np.asarray(jpp.t_top[i].data), jpp.t_top[i].fmt) for i in sorted(jpp.t_top)],
        jpp.hash_key, device="cpu")
    # the offline pass of the port on the same pp rewrites the preimage: keep
    # the JAX package's file and give the port's online pass a fresh directory
    run = run_commit_lut(pt, tmp_path / "port", x_val, pp=pp)
    check_exact(pt, run)
    np.testing.assert_array_equal(_np(run.b0), _np(jrun.b0))
    np.testing.assert_array_equal(_np(run.on.b_1), _np(jrun.on.b_1))
    assert len(run.on.blocks) == len(jrun.on.blocks)
    for mine, theirs in zip(run.on.blocks, jrun.on.blocks):
        np.testing.assert_array_equal(_np(mine), _np(theirs))
    for key in jrun.on.cache:
        np.testing.assert_array_equal(_np(run.on.cache[key]), _np(jrun.on.cache[key]))
    # online over the JAX package's stored preimage
    circuit = pt.circuit.PolyCircuit()
    w = circuit.input(1)
    lut_id = circuit.register_public_lut(pt.lookup.PublicLut.from_dict(pt.params,
                                                                       TABLES[x_val]))
    circuit.output([circuit.public_lookup_gate(w[0], lut_id)])
    pubkeys = pt.bgg.BGGPublicKeySampler(KEY, 1, device="cpu").sample(pt.params, b"ce", [True])
    encs = pt.bgg.BGGEncodingSampler(pt.params, [pt.sampler.UniformSampler(
        seed=112, device="cpu").sample_poly(pt.params, pt.sampler.TernaryDist())]).sample(
        pt.params, pubkeys, [pt.poly.Poly.const(pt.params, x_val, device="cpu")])
    on = pt.ce.CommitBGGEncodingPltEvaluator(
        pt.params, pt.scheme, pp, KEY, circuit, pubkeys[0], pubkeys[1:], run.s_vec @ run.b0,
        run.s_vec @ pp.b, tmp_path)
    got = circuit.eval(pt.params, encs[0], encs[1:], plt_evaluator=on)[0]
    np.testing.assert_array_equal(_np(got.vector), _np(jrun.got.vector))
    np.testing.assert_array_equal(_np(got.pubkey.matrix), _np(jrun.got.pubkey.matrix))


def test_commit_eval_other_input_matches_jax(tmp_path):
    _matches_jax(tmp_path, 0)


@pytest.mark.slow
def test_commit_eval_exact_decode_matches_jax(tmp_path):
    _matches_jax(tmp_path, 2)
