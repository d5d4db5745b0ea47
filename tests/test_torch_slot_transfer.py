"""Preimage-backed slot transfer of the port against the JAX package
(mirrors `tests/test_slot_transfer_preimage.py`).

The offline pass (pubkey evaluation, `sample_aux_matrices` through the
artifact store) and the online pass (`BggPolyEncodingSTEvaluator` reading
the artifacts) run in the port on the CPU. The output public keys, the
hash-derived slot and gate matrices and the checkpoint names are integer
work: bit for bit against `mxx_tpu`. The stored preimages are float-Gaussian
draws, so the online output is held to its plaintexts and to the exact
invariant c_s = sigma_s A - x_s sigma_s G on every slot (zero-error aux).
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import mxx_tpu  # noqa: F401

KEY = bytes([5] * 32)
S = 3


def load(pkg):
    mods = {"params": "ring.params", "poly": "ring.poly", "matrix": "matrix",
            "sampler": "sampler", "bgg": "bgg", "pe": "bgg.poly_encoding",
            "circuit": "circuit", "st": "slot_transfer.preimage", "storage": "storage"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    return ns


def _np(m):
    m = m.to_coeff()
    return m.data.cpu().numpy().astype(np.uint32) if hasattr(m.data, "cpu") else np.asarray(m.data)


def setup(ns, params, slot_values, seed):
    us = ns.sampler.UniformSampler(seed=seed, **ns.kw)
    secrets = [us.sample_poly(params, ns.sampler.TernaryDist())]
    pubkeys = ns.bgg.BGGPublicKeySampler(KEY, 1, **ns.kw).sample(
        params, b"st", [True] * len(slot_values))
    sampler = ns.pe.BGGPolyEncodingSampler(params, secrets, S, None, seed=seed + 1)
    slot_pts = [[ns.poly.Poly.const(params, v, **ns.kw) for v in vals] for vals in slot_values]
    encs = sampler.sample(params, pubkeys, slot_pts)
    t_row = ns.matrix.PolyMatrix.from_poly_row(params, secrets)
    s_mats = [ns.matrix.PolyMatrix.from_polys(params, [[m]]) for m in sampler.masks]
    return sampler, pubkeys, encs, t_row, s_mats


def check_invariant(ns, params, enc, sampler):
    g = ns.matrix.PolyMatrix.gadget_matrix(params, 1, **ns.kw)
    sg = sampler.secret_mat @ g
    sa = sampler.secret_mat @ enc.pubkey.matrix
    for s in range(enc.num_slots):
        want = sa.slice_rows(s, s + 1) - sg.slice_rows(s, s + 1).mul_poly_scalar(enc.plaintext(s))
        assert enc.vector(s) == want, f"slot {s}"


def _circuit(ns, kind):
    circuit = ns.circuit.PolyCircuit()
    w = circuit.input(1)
    if kind == "transfer":
        # dst0 <- slot2, dst1 <- slot0 * 3, dst2 <- slot1
        out = circuit.slot_transfer_gate(w[0], [(2, None), (0, 3), (1, None)])
    else:
        out = circuit.slot_reduce_gate([w[0]], S)
    circuit.output([out])
    return circuit


def _offline(ns, params, circuit, pubkeys, s_mats, dir_path):
    ns.storage.init_storage_system(dir_path)
    st_pk = ns.st.BggPublicKeySTEvaluator(KEY, S, 4.578, 0.0, dir_path, seed=91, **ns.kw)
    result_pk = circuit.eval(params, pubkeys[0], pubkeys[1:], slot_transfer_evaluator=st_pk)[0]
    st_pk.sample_aux_matrices(params, s_mats)
    ns.storage.wait_for_all_writes()
    return st_pk, result_pk


CASES = [("transfer", [[2, 5, 7]], 90), ("reduce", [[1, 2, 3]], 95)]


@pytest.mark.parametrize("kind,values,seed", CASES)
def test_slot_transfer_offline_online(tmp_path, kind, values, seed):
    ns = load("mxx_tpu_torch")
    params = ns.params.RingParams.default()
    sampler, pubkeys, encs, t_row, s_mats = setup(ns, params, values, seed)
    circuit = _circuit(ns, kind)
    st_pk, result_pk = _offline(ns, params, circuit, pubkeys, s_mats, tmp_path / "t")
    b0 = st_pk.load_b0_matrix_checkpoint(params)
    assert b0 == st_pk.b0_matrix
    # a fresh online evaluator that only reads the artifacts
    enc_eval = ns.st.BggPolyEncodingSTEvaluator(
        KEY, tmp_path / "t", st_pk.checkpoint_prefix(params), params, t_row @ b0)
    got = circuit.eval(params, encs[0], encs[1:], slot_transfer_evaluator=enc_eval)[0]
    assert got.pubkey == result_pk
    if kind == "transfer":
        assert [p.const_coeff() for p in got.plaintexts] == [7, 6, 5]
    else:
        assert got.plaintext(0).coeffs()[:3] == [1, 2, 3]
    check_invariant(ns, params, got, sampler)

    jns = load("mxx_tpu")
    jparams = jns.params.RingParams.default()
    _, jpubkeys, _, _, js_mats = setup(jns, jparams, values, seed)
    jcircuit = _circuit(jns, kind)
    jst_pk, jresult_pk = _offline(jns, jparams, jcircuit, jpubkeys, js_mats, tmp_path / "j")
    np.testing.assert_array_equal(_np(result_pk.matrix), _np(jresult_pk.matrix))
    assert st_pk.checkpoint_prefix(params) == jst_pk.checkpoint_prefix(jparams)
    for a, b in zip(s_mats, js_mats):
        np.testing.assert_array_equal(_np(a), _np(b))
    # the trapdoor matrices come from the same seeded uniform streams
    np.testing.assert_array_equal(_np(st_pk.b0_matrix), _np(jst_pk.b0_matrix))
    np.testing.assert_array_equal(_np(st_pk.b1_matrix), _np(jst_pk.b1_matrix))
