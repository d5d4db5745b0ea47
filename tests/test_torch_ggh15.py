"""GGH15 chain of the port against the JAX package (mirrors
`tests/test_ggh15.py`): the checkpoint marker, the single-input chain at
`RingParams.default()`, d=2, zero error, and a resume that samples nothing
new.

- bit for bit (tolerance 0): the checkpoint prefix; the hash-derived blocks
  W_*, V_k, U_g and A_out; the offline B1 targets of every entry (the port
  builds them in batches); the result public key of the pubkey pass; and
  c_out of the port's online evaluator reading a chain that the JAX package
  stored (its trapdoors cross as compact bytes in the same files);
- by relation: the port's own chain, whose preimages are float-Gaussian
  draws: B1 L_x == target for every stored L_x, and the exact output
  c == s (A_out - G y).
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

SIGMA = 4.578
KEY = bytes([0x5A] * 32)
D = 2
T_N = 16
X_IN = 11


def load(pkg):
    mods = {"params": "ring.params", "poly": "ring.poly", "matrix": "matrix",
            "sampler": "sampler", "bgg": "bgg", "circuit": "circuit", "lookup": "lookup",
            "ggh15": "lookup.ggh15", "storage": "storage"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    ns.params = ns.params.RingParams.default()
    return ns


def _np(m):
    m = m.to_coeff()
    return m.data.cpu().numpy().astype(np.uint32) if hasattr(m.data, "cpu") else np.asarray(m.data)


def single_input_chain(ns, tmp_path, table=None, d=D, x_in=X_IN, seed=41, tag=b"ggh15_tag",
                       **extra):
    """The JAX test's single-lookup circuit, its inputs and its offline
    pass into tmp_path: (circuit, encodings, sampler, pubkey evaluator,
    result pubkey)."""
    params = ns.params
    table = table or {x: (x, x % 2) for x in range(T_N)}
    lut = ns.lookup.PublicLut.from_dict(params, table)
    circuit = ns.circuit.PolyCircuit()
    inputs = circuit.input(1)
    plt_id = circuit.register_public_lut(lut)
    circuit.output([circuit.public_lookup_gate(inputs[0], plt_id)])
    us = ns.sampler.UniformSampler(seed=seed, **ns.kw)
    secrets = [us.sample_poly(params, ns.sampler.TernaryDist()) for _ in range(d)]
    pubkeys = ns.bgg.BGGPublicKeySampler(KEY, d, **ns.kw).sample(params, tag, [True])
    es = ns.bgg.BGGEncodingSampler(params, secrets, None, seed=seed + 1)
    encodings = es.sample(params, pubkeys, [ns.poly.Poly.const(params, x_in, **ns.kw)])
    ns.storage.init_storage_system(tmp_path)
    pk_eval = ns.ggh15.GGH15BGGPubKeyPltEvaluator(KEY, d, SIGMA, 0.0, tmp_path, seed=seed + 2,
                                                  **ns.kw, **extra)
    result_pk = circuit.eval(params, pubkeys[0], pubkeys[1:], plt_evaluator=pk_eval)[0]
    pk_eval.sample_aux_matrices(params)
    ns.storage.wait_for_all_writes()
    return circuit, encodings, es, pk_eval, result_pk


def online(ns, tmp_path, circuit, encodings, c_b0, cp):
    enc_eval = ns.ggh15.GGH15BGGEncodingPltEvaluator(KEY, tmp_path, cp, ns.params, c_b0)
    return circuit.eval(ns.params, encodings[0], encodings[1:], plt_evaluator=enc_eval)[0]


@pytest.fixture(scope="module")
def jax_chain(tmp_path_factory):
    """The JAX package's chain, stored, and its online output."""
    jx = load("mxx_tpu")
    tmp = tmp_path_factory.mktemp("jax_chain")
    circuit, encodings, es, pk_eval, result_pk = single_input_chain(jx, tmp)
    b0 = pk_eval.load_b0_matrix_checkpoint(jx.params)
    cp = pk_eval.checkpoint_prefix(jx.params)
    enc = online(jx, tmp, circuit, encodings, es.secret_vec @ b0, cp)
    return SimpleNamespace(ns=jx, dir=tmp, cp=cp, pk_eval=pk_eval, result_pk=result_pk,
                           enc=enc, s_vec=es.secret_vec)


def test_ggh15_checkpoint_prefix_marker():
    jx, pt = load("mxx_tpu"), load("mxx_tpu_torch")
    mine = pt.ggh15.GGH15BGGPubKeyPltEvaluator(KEY, D, SIGMA, 0.0, "/unused", device="cpu")
    theirs = jx.ggh15.GGH15BGGPubKeyPltEvaluator(KEY, D, SIGMA, 0.0, "/unused")
    assert "_ins0_key" in mine.checkpoint_prefix(pt.params)
    assert mine.checkpoint_prefix(pt.params) == theirs.checkpoint_prefix(jx.params)
    assert mine._lut_aux_id(pt.params, 0, 5) == theirs._lut_aux_id(jx.params, 0, 5)


def test_ggh15_hash_blocks_and_targets_match_jax():
    """W_*, V_k, U_g, A_out one at a time, and every entry's B1 target from
    the port's batches, against the JAX package's formula."""
    jx, pt = load("mxx_tpu"), load("mxx_tpu_torch")
    mine = pt.ggh15.GGH15BGGPubKeyPltEvaluator(KEY, D, SIGMA, 0.0, "/unused", device="cpu")
    theirs = jx.ggh15.GGH15BGGPubKeyPltEvaluator(KEY, D, SIGMA, 0.0, "/unused")
    pp, jp = pt.params, jx.params
    lut_id, gate_id = 0, 1
    for a, b in zip(mine._w_blocks(pp, lut_id), [theirs._derive_w_block(jp, lut_id, t)
                                                  for t in pt.ggh15.W_TAGS]):
        np.testing.assert_array_equal(_np(a), _np(b))
    a_out, u_g = mine._hash_mats(pp, list(pt.ggh15._gate_tags(gate_id)))
    np.testing.assert_array_equal(_np(a_out), _np(theirs._a_out(jp, gate_id)))
    np.testing.assert_array_equal(_np(mine._a_out(pp, gate_id)), _np(theirs._a_out(jp, gate_id)))
    np.testing.assert_array_equal(_np(u_g), _np(theirs._u_g(jp, gate_id)))
    v_raw = mine._hash_mats(pp, [pt.ggh15._v_tag(lut_id, k) for k in (0, 3)])
    for k, v in zip((0, 3), v_raw):
        np.testing.assert_array_equal(_np(v.decompose()), _np(theirs._v_idx(jp, lut_id, k)))
    # an arbitrary table: repeated rows k and outputs y
    table = {x: ((5 * x + 3) % 4, (x * x + 1) % 3) for x in range(6)}
    lut_t = pt.lookup.PublicLut.from_dict(pp, table)
    targets = mine._lut_targets(pp, lut_id, list(lut_t.entries(pp)))
    w_id, w_gy, w_v, w_vx = (theirs._derive_w_block(jp, lut_id, t) for t in pt.ggh15.W_TAGS)
    gadget = jx.matrix.PolyMatrix.gadget_matrix(jp, D)
    for (x, (k, y)), target in zip(jx.lookup.PublicLut.from_dict(jp, table).entries(jp), targets):
        v_k = theirs._v_idx(jp, lut_id, k)
        y_poly = jx.poly.Poly.from_elem_to_constant(jp, y)
        want = (w_id + w_gy @ gadget.mul_poly_scalar(y_poly).decompose() + w_v @ v_k
                + w_vx @ v_k.mul_poly_scalar(jx.poly.Poly.const(jp, x)))
        np.testing.assert_array_equal(_np(target), _np(want))


def test_ggh15_plt_eval_single_input(tmp_path, jax_chain, monkeypatch):
    """The port's own chain: exact relation c = s (A_out - G y) with zero
    error, B1 L_x == target for every stored L_x, and the result public key
    equal to the JAX package's."""
    pt = load("mxx_tpu_torch")
    params = pt.params
    captured = []
    pk_cls = pt.ggh15.GGH15BGGPubKeyPltEvaluator
    orig = pk_cls._lut_targets

    def capture(self, p, lut_id, entries):
        out = orig(self, p, lut_id, entries)
        captured.extend(zip([x for x, _ in entries], out))
        return out

    monkeypatch.setattr(pk_cls, "_lut_targets", capture)
    circuit, encodings, es, pk_eval, result_pk = single_input_chain(pt, tmp_path)
    np.testing.assert_array_equal(_np(result_pk.matrix), _np(jax_chain.result_pk.matrix))
    b0 = pk_eval.load_b0_matrix_checkpoint(params)
    cp = pk_eval.checkpoint_prefix(params)
    enc = online(pt, tmp_path, circuit, encodings, es.secret_vec @ b0, cp)
    assert enc.pubkey == result_pk
    y = pt.poly.Poly.const(params, X_IN % 2, device="cpu")
    assert enc.plaintext == y
    g = pt.matrix.PolyMatrix.gadget_matrix(params, D, device="cpu")
    assert enc.vector == es.secret_vec @ (enc.pubkey.matrix - g.mul_poly_scalar(y))
    b1 = pt.storage.read_matrix_from_multi_batch(params, tmp_path, f"{cp}_b1", 0, "cpu")
    m_g = D * params.modulus_digits
    assert len(captured) == T_N
    for x, target in captured:
        l_x = pt.ggh15.read_matrix_chunked(params, tmp_path, pk_eval._lut_aux_id(params, 0, x),
                                          m_g, device="cpu")
        assert b1 @ l_x == target, f"L_{x}"


def test_ggh15_online_reads_jax_chain(jax_chain):
    """The port's online evaluator over the chain the JAX package stored:
    c_out, the output public key and plaintext equal the JAX evaluator's."""
    from mxx_tpu_torch import convert

    pt = load("mxx_tpu_torch")
    params = pt.params
    jx = jax_chain.ns
    circuit = pt.circuit.PolyCircuit()
    inputs = circuit.input(1)
    plt_id = circuit.register_public_lut(pt.lookup.PublicLut.from_dict(
        params, {x: (x, x % 2) for x in range(T_N)}))
    circuit.output([circuit.public_lookup_gate(inputs[0], plt_id)])
    # the JAX chain's inputs, rebuilt from the same seeds (integer draws)
    us = pt.sampler.UniformSampler(seed=41, device="cpu")
    secrets = [us.sample_poly(params, pt.sampler.TernaryDist()) for _ in range(D)]
    pubkeys = pt.bgg.BGGPublicKeySampler(KEY, D, device="cpu").sample(params, b"ggh15_tag",
                                                                      [True])
    es = pt.bgg.BGGEncodingSampler(params, secrets, None, seed=42)
    encodings = es.sample(params, pubkeys, [pt.poly.Poly.const(params, X_IN, device="cpu")])
    np.testing.assert_array_equal(_np(es.secret_vec), _np(jax_chain.s_vec))
    jb0 = jax_chain.pk_eval.load_b0_matrix_checkpoint(jx.params)
    b0 = pt.ggh15.GGH15BGGPubKeyPltEvaluator(KEY, D, SIGMA, 0.0, jax_chain.dir,
                                             device="cpu").load_b0_matrix_checkpoint(params)
    np.testing.assert_array_equal(_np(b0), _np(jb0))
    c_b0 = convert.poly_matrix_from_numpy(params, _np(jax_chain.s_vec @ jb0), "coeff", "cpu")
    enc = online(pt, jax_chain.dir, circuit, encodings, c_b0, jax_chain.cp)
    np.testing.assert_array_equal(_np(enc.vector), _np(jax_chain.enc.vector))
    np.testing.assert_array_equal(_np(enc.pubkey.matrix), _np(jax_chain.enc.pubkey.matrix))
    assert enc.plaintext.const_coeff() == jax_chain.enc.plaintext.const_coeff() == X_IN % 2


def test_ggh15_resume_skips_existing(tmp_path):
    """A second offline pass with the same prefix resumes: it writes no new
    artifact, and the online path still decodes."""
    pt = load("mxx_tpu_torch")
    params = pt.params
    table = {x: (x, (x * 3) % 5) for x in range(8)}
    circuit, encodings, es, pk_eval, _ = single_input_chain(pt, tmp_path, table, d=1, x_in=6,
                                                            seed=51, tag=b"resume_tag")
    files_before = sorted(p.name for p in tmp_path.iterdir())
    pk_eval2 = pt.ggh15.GGH15BGGPubKeyPltEvaluator(KEY, 1, SIGMA, 0.0, tmp_path, seed=99,
                                                   device="cpu")
    circuit.eval(params, encodings[0].pubkey, [e.pubkey for e in encodings[1:]],
                 plt_evaluator=pk_eval2)
    pk_eval2.sample_aux_matrices(params)
    pt.storage.wait_for_all_writes()
    assert sorted(p.name for p in tmp_path.iterdir()) == files_before
    b0 = pk_eval2.load_b0_matrix_checkpoint(params)
    enc = online(pt, tmp_path, circuit, encodings, es.secret_vec @ b0,
                 pk_eval2.checkpoint_prefix(params))
    assert enc.plaintext.const_coeff() == (6 * 3) % 5


def test_ggh15_offline_over_a_mesh(tmp_path, monkeypatch):
    """An evaluator built with a logical 2-shard CPU mesh hands it to every
    offline preimage batch (the L_x stage under B1, the gate stages under
    B0), and every row of each batch holds B x == target exactly."""
    from mxx_tpu_torch.parallel import Mesh
    from mxx_tpu_torch.sampler import TrapdoorSampler

    pt = load("mxx_tpu_torch")
    mesh = Mesh([["cpu", "cpu"]])
    batches = []
    orig = TrapdoorSampler.preimage_batched_chunked

    def recording(self, params, trapdoor, public_matrix, targets, mesh=None, chunk=None):
        outs = orig(self, params, trapdoor, public_matrix, targets, mesh=mesh, chunk=chunk)
        batches.append((mesh, public_matrix, list(targets), outs))
        return outs

    monkeypatch.setattr(TrapdoorSampler, "preimage_batched_chunked", recording)
    single_input_chain(pt, tmp_path, mesh=mesh)
    assert len(batches) == 2  # the 16 L_x under B1, the 5 gate stages under B0
    assert [len(t) for _, _, t, _ in batches] == [T_N, 5]
    for used, b, targets, outs in batches:
        assert used is mesh
        assert all(b @ x == t for x, t in zip(outs, targets))
