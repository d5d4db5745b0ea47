"""mxx_tpu_torch LWE public-LUT path against mxx_tpu, at the ring of
tests/test_lwe_modp_chain.py (n=16, L=4, crt_bits 28, base_bits 7, d=1,
p=7, the 49-entry mod-p LUT, Mul -> PubLut -> Mul -> PubLut):

- bit for bit: A_LT (single and batched), K_low, the plaintext oracle, the
  offline K_high targets and the batch files they become, the online c_out
  over the same stored K_high, and the debug evaluators (sequential and
  batched);
- exact relations of the port's own chain: B K_high == target for every
  stored row, the masked-rounding decode, with and without every target
  spilled to a memmap; the batched/chunked/extended preimages.

Preimage Gaussians are float draws, so K_high itself is held to its relation,
not to the JAX package's bits. The machine with the card has no jax, so the
JAX package is imported inside the tests that compare with it, and the
`cuda` test runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_lookup.py
"""

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mxx_tpu_torch import convert
from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler
from mxx_tpu_torch.circuit import PolyCircuit
from mxx_tpu_torch.circuit.batched_eval import eval_batched
from mxx_tpu_torch.lookup import (
    DebugBGGEncodingPltEvaluator,
    DebugBGGPubKeyPltEvaluator,
    LWEBGGEncodingPltEvaluator,
    LWEBGGPubKeyPltEvaluator,
    PolyPltEvaluator,
    PublicLut,
    RelationCheckingPltEvaluator,
    debug_trapdoor_preimage,
)
from mxx_tpu_torch.lookup import lwe
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.matrix.offload import OffloadedMatrix, offload_matrix
from mxx_tpu_torch.parallel import Mesh
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import Poly
from mxx_tpu_torch.sampler import FinRingDist, TernaryDist, TrapdoorSampler, UniformSampler
from mxx_tpu_torch.storage import (
    init_storage_system,
    read_matrix_from_multi_batch,
    wait_for_all_writes,
)

ARGS = (16, 4, 28, 7)
P_MOD = 7
ERROR_SIGMA = 4.0
TRAPDOOR_SIGMA = 4.578
KEY = bytes([0x5F, 0x92, 0x10, 0x6A] * 8)


@pytest.fixture
def jx():
    """The JAX package's modules this file compares with."""
    names = {
        "RingParams": ("mxx_tpu.ring.params", "RingParams"),
        "Poly": ("mxx_tpu.ring.poly", "Poly"),
        "PolyMatrix": ("mxx_tpu.matrix", "PolyMatrix"),
        "PolyCircuit": ("mxx_tpu.circuit", "PolyCircuit"),
        "PublicLut": ("mxx_tpu.lookup", "PublicLut"),
        "PolyPltEvaluator": ("mxx_tpu.lookup", "PolyPltEvaluator"),
        "BGGPublicKeySampler": ("mxx_tpu.bgg", "BGGPublicKeySampler"),
        "BggEncoding": ("mxx_tpu.bgg", "BggEncoding"),
        "BggPublicKey": ("mxx_tpu.bgg", "BggPublicKey"),
        "eval_batched": ("mxx_tpu.circuit.batched_eval", "eval_batched"),
    }
    ns = {k: getattr(importlib.import_module(m), a) for k, (m, a) in names.items()}
    ns["lwe"] = importlib.import_module("mxx_tpu.lookup.lwe")
    ns["debug"] = importlib.import_module("mxx_tpu.lookup.debug")
    ns["storage"] = importlib.import_module("mxx_tpu.storage")
    return SimpleNamespace(**ns)


def mod_p_lut(lut_cls, params):
    # x in [0, p^2) -> (row x, x mod p)
    return lut_cls.from_dict(params, {x: (x, x % P_MOD) for x in range(P_MOD * P_MOD)})


def chain_circuit(circuit, lut):
    inputs = circuit.input(3)
    lut_id = circuit.register_public_lut(lut)
    t1 = circuit.public_lookup_gate(circuit.mul_gate(inputs[0], inputs[1]), lut_id)
    circuit.output([circuit.public_lookup_gate(circuit.mul_gate(t1, inputs[2]), lut_id)])
    return circuit


def jax_matrix(jx, jp, m):
    return jx.PolyMatrix(convert.to_numpy(m), m.fmt, jp)


def jax_encoding(jx, jp, e):
    jpk = jx.BggPublicKey(jax_matrix(jx, jp, e.pubkey.matrix), e.pubkey.reveal_plaintext)
    pt = jx.Poly(convert.to_numpy(e.plaintext), e.plaintext.fmt, jp)
    return jx.BggEncoding(jax_matrix(jx, jp, e.vector), jpk, pt)


# ------------------------------------------------------------ hash derivations


def test_a_lt_and_k_low_equal_jax(jx):
    p, jp = RingParams.new(*ARGS), jx.RingParams.new(*ARGS)
    for ctx, slot in [("", None), ("round1/branch0", 2)]:
        mine = lwe.derive_a_lt_matrix(p, 1, KEY, 5, slot, ctx, device="cpu")
        theirs = jx.lwe.derive_a_lt_matrix(jp, 1, KEY, 5, slot, ctx)
        assert mine.fmt == theirs.fmt
        np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))
        gates = [3, 5, 9]
        batch = lwe.derive_a_lt_matrices_batch(p, 1, KEY, gates, slot, ctx, device="cpu")
        jbatch = jx.lwe.derive_a_lt_matrices_batch(jp, 1, KEY, gates, slot, ctx)
        for a, ja in zip(batch, jbatch):
            np.testing.assert_array_equal(convert.to_numpy(a), np.asarray(ja.data))
        assert batch[1] == mine  # the batch equals the single derivation
        again = lwe.derive_a_lt_matrices_batch(p, 1, KEY, gates, slot, ctx, device="cpu")
        assert all(x is y for x, y in zip(again, batch))  # cache hit
        k_low = lwe.derive_k_low(p, 1, KEY, 5, 0, 11, slot, ctx, device="cpu")
        jk_low = jx.lwe.derive_k_low(jp, 1, KEY, 5, 0, 11, slot, ctx)
        assert k_low.fmt == jk_low.fmt and k_low.shape == (p.modulus_digits, p.modulus_digits)
        np.testing.assert_array_equal(convert.to_numpy(k_low), np.asarray(jk_low.data))
        assert (lwe.k_high_checkpoint_prefix(5, 0, slot, ctx)
                == jx.lwe.k_high_checkpoint_prefix(5, 0, slot, ctx))


@pytest.mark.parametrize("abc", [(3, 5, 6), (6, 6, 6), (0, 4, 2)])
def test_plaintext_oracle_equals_jax(jx, abc):
    p, jp = RingParams.new(*ARGS), jx.RingParams.new(*ARGS)
    mine = chain_circuit(PolyCircuit(), mod_p_lut(PublicLut, p))
    theirs = chain_circuit(jx.PolyCircuit(), mod_p_lut(jx.PublicLut, jp))
    out = mine.eval(p, Poly.one(p, device="cpu"), [Poly.const(p, v, device="cpu") for v in abc],
                    plt_evaluator=PolyPltEvaluator())[0]
    jout = theirs.eval(jp, jx.Poly.one(jp), [jx.Poly.const(jp, v) for v in abc],
                       plt_evaluator=jx.PolyPltEvaluator())[0]
    a, b, c = abc
    assert out.const_coeff() == ((a * b) % P_MOD) * c % P_MOD
    assert out.fmt == jout.fmt
    np.testing.assert_array_equal(convert.to_numpy(out), np.asarray(jout.data))


# ------------------------------------------------------------- offline targets


class _RecordingSampler:
    """A stand-in trap_sampler: records the preimage targets it is given and
    returns them as the 'preimages', so the batch files hold the targets."""

    def __init__(self):
        self.targets = []

    def preimage_batched_chunked(self, params, trapdoor, public_matrix, targets, mesh=None,
                                 chunk=None):
        self.targets.append(list(targets))
        return list(targets)


def _read_dir(path):
    return {f.name: f.read_bytes() for f in sorted(path.iterdir())}


def test_offline_targets_and_batch_files_equal_jax(jx, tmp_path, monkeypatch):
    p, jp = RingParams.new(*ARGS), jx.RingParams.new(*ARGS)
    # a small part limit: each gate's buffer splits into several batch files
    monkeypatch.setenv("LUT_BYTES_LIMIT", str(20_000))
    circuit = chain_circuit(PolyCircuit(), mod_p_lut(PublicLut, p))
    jcircuit = chain_circuit(jx.PolyCircuit(), mod_p_lut(jx.PublicLut, jp))
    pks = BGGPublicKeySampler(KEY, 1, device="cpu").sample(p, b"bgg_pubkey", [True] * 3)
    jpks = jx.BGGPublicKeySampler(KEY, 1).sample(jp, b"bgg_pubkey", [True] * 3)
    _, b0 = TrapdoorSampler(p, TRAPDOOR_SIGMA, seed=79, device="cpu").trapdoor(p, 1)

    buffers = {"port": [], "jax": []}
    for name, mod in [("port", lwe), ("jax", jx.lwe)]:
        add = mod.add_lookup_buffer
        monkeypatch.setattr(mod, "add_lookup_buffer",
                            lambda buf, add=add, name=name: (buffers[name].append(buf), add(buf)))

    init_storage_system(tmp_path / "port")
    stub = _RecordingSampler()
    pk_eval = LWEBGGPubKeyPltEvaluator(KEY, stub, b0, None, tmp_path / "port")
    out_pk = circuit.eval(p, pks[0], pks[1:], plt_evaluator=pk_eval)
    states = dict(pk_eval.gate_state)
    pk_eval.sample_aux_matrices(p)
    wait_for_all_writes()

    jx.storage.init_storage_system(tmp_path / "jax")
    jstub = _RecordingSampler()
    jpk_eval = jx.lwe.LWEBGGPubKeyPltEvaluator(KEY, jstub, jax_matrix(jx, jp, b0), None,
                                               tmp_path / "jax")
    jout_pk = jcircuit.eval(jp, jpks[0], jpks[1:], plt_evaluator=jpk_eval)
    jpk_eval.sample_aux_matrices(jp)
    jx.storage.wait_for_all_writes()

    np.testing.assert_array_equal(convert.to_numpy(out_pk[0].matrix), np.asarray(jout_pk[0].matrix.data))
    # the JAX package samples gate by gate, one request per entry; the port's
    # two gates share one call, one request per gate, its entries side by side
    assert len(jstub.targets) == 2 and len(stub.targets) == 1 and len(stub.targets[0]) == 2
    m_g = p.modulus_digits
    mine = [req.slice_columns(e * m_g, (e + 1) * m_g) for req in stub.targets[0]
            for e in range(req.ncol // m_g)]
    theirs = [t for call in jstub.targets for t in call]
    assert len(mine) == len(theirs) == 2 * P_MOD * P_MOD
    for i, ((ctx, gate_id, slot), st) in enumerate(states.items()):
        direct = pk_eval._k_high_targets(p, st.plt, st.input_pubkey, st.output_pubkey,
                                         gate_id, st.lut_id, slot, ctx)
        recorded = mine[i * P_MOD * P_MOD : (i + 1) * P_MOD * P_MOD]
        assert len(direct) == len(recorded) and all(a == b for a, b in zip(direct, recorded))
    for t, jt in zip(mine, theirs):
        assert t.fmt == jt.fmt
        np.testing.assert_array_equal(convert.to_numpy(t), np.asarray(jt.data))
    assert len(buffers["port"]) == len(buffers["jax"]) == 2
    for b, jb in zip(buffers["port"], buffers["jax"]):
        assert b.id_prefix == jb.id_prefix and b.serialize() == jb.serialize()
    files, jfiles = _read_dir(tmp_path / "port"), _read_dir(tmp_path / "jax")
    assert sum(name.endswith(".bin") for name in files) > 2  # split into parts
    assert files == jfiles


# ------------------------------------------------------------ the port's chain


def run_port_chain(tmp_path, device, abc=(3, 5, 6)):
    """The port's whole chain at the test ring: offline pubkey pass,
    K_high sampling and writes, online encoding pass. Returns what the
    checks need."""
    p = RingParams.new(*ARGS)
    circuit = chain_circuit(PolyCircuit(), mod_p_lut(PublicLut, p))
    plaintexts = [Poly.const(p, v, device) for v in abc]
    secret = UniformSampler(seed=77, device=device).sample_poly(p, TernaryDist())
    pubkeys = BGGPublicKeySampler(KEY, 1, device=device).sample(p, b"bgg_pubkey", [True] * 3)
    es = BGGEncodingSampler(p, [secret], gauss_sigma=ERROR_SIGMA, seed=78)
    encodings = es.sample(p, pubkeys, plaintexts)
    ts = TrapdoorSampler(p, TRAPDOOR_SIGMA, seed=79, device=device)
    td, b0 = ts.trapdoor(p, 1)

    init_storage_system(tmp_path)
    pk_eval = LWEBGGPubKeyPltEvaluator(KEY, ts, b0, td, tmp_path)
    out_pk = circuit.eval(p, pubkeys[0], pubkeys[1:], plt_evaluator=pk_eval)[0]
    states = dict(pk_eval.gate_state)
    pk_eval.sample_aux_matrices(p)
    offloaded = pk_eval.last_offloaded_targets
    wait_for_all_writes()

    c_b = es.secret_vec @ b0
    enc_eval = LWEBGGEncodingPltEvaluator(KEY, tmp_path, c_b)
    out_enc = circuit.eval(p, encodings[0], encodings[1:], plt_evaluator=enc_eval)[0]
    return SimpleNamespace(p=p, circuit=circuit, abc=abc, es=es, b0=b0, c_b=c_b,
                           encodings=encodings, pk_eval=pk_eval, states=states,
                           out_pk=out_pk, out_enc=out_enc, offloaded=offloaded, dir=tmp_path)


def decode(run):
    """The masked-rounding decode of tests/test_lwe_modp_chain.py: the error
    of c - s A + x (s G) and whether a masked value rounds back."""
    p, enc = run.p, run.out_enc
    q = p.modulus
    a, b, c = run.abc
    expected = ((a * b) % P_MOD) * c % P_MOD
    s_g = run.es.secret_vec @ PolyMatrix.gadget_matrix(p, 1, run.c_b.data.device)
    diff = (enc.vector - run.es.secret_vec @ enc.pubkey.matrix
            + s_g.mul_poly_scalar(Poly.const(p, expected, run.c_b.data.device)))
    coeff = diff.entry(0, 0).coeffs()[0]
    err = min(coeff, q - coeff)
    q_over_p = q // P_MOD
    mask = random.Random(1234).randrange(P_MOD)
    rounded = (coeff + q_over_p * mask + q_over_p // 2) // q_over_p
    return expected, err, q_over_p, rounded % P_MOD == mask


def check_stored_rows(run):
    """B K_high == target exactly for every stored row, K_high read back
    through read_matrix_from_multi_batch; returns the rows checked."""
    p, device = run.p, run.b0.data.device
    checked = 0
    for (ctx, gate_id, slot), st in run.states.items():
        targets = run.pk_eval._k_high_targets(p, st.plt, st.input_pubkey, st.output_pubkey,
                                              gate_id, st.lut_id, slot, ctx)
        prefix = lwe.k_high_checkpoint_prefix(gate_id, st.lut_id, slot, ctx)
        for (_, (k, _)), t in zip(st.plt.entries(p), targets):
            if isinstance(t, OffloadedMatrix):
                t, off = t.load(device), t
                off.delete()
            k_high = read_matrix_from_multi_batch(p, run.dir, prefix, k, device)
            assert k_high.shape == (2 + p.modulus_digits, p.modulus_digits)
            assert run.b0 @ k_high == t, f"B K_high != target at gate {gate_id} row {k}"
            checked += 1
    return checked


@pytest.fixture(scope="module")
def port_chain(tmp_path_factory):
    return run_port_chain(tmp_path_factory.mktemp("chain"), torch.device("cpu"))


def test_port_chain_decodes(port_chain):
    run = port_chain
    p = run.p
    expected, err, q_over_p, mask_ok = decode(run)
    assert run.out_enc.plaintext.const_coeff() == expected
    assert run.out_enc.pubkey == run.out_pk  # online A_LT == offline A_LT
    assert err < q_over_p // 2, f"error too large: {err} vs {q_over_p // 2}"
    assert mask_ok
    assert check_stored_rows(run) == 2 * P_MOD * P_MOD
    x = run.circuit.eval(p, Poly.one(p, device="cpu"), [Poly.const(p, v, device="cpu") for v in run.abc],
                         plt_evaluator=PolyPltEvaluator())[0]
    assert run.out_enc.plaintext == x


def test_port_chain_with_every_target_spilled(tmp_path, monkeypatch):
    """MXX_OFFLOAD_BUDGET_BYTES=1: every assembled target spills to a
    memmap and rehydrates inside the chunked preimage; the chain still
    decodes and every stored row is exact."""
    monkeypatch.setenv("MXX_OFFLOAD_BUDGET_BYTES", "1")
    run = run_port_chain(tmp_path, torch.device("cpu"), abc=(6, 4, 5))
    assert run.offloaded == 2 * P_MOD * P_MOD  # the last group's count (both gates): all spilled
    expected, err, q_over_p, mask_ok = decode(run)
    assert run.out_enc.plaintext.const_coeff() == expected
    assert run.out_enc.pubkey == run.out_pk
    assert err < q_over_p // 2 and mask_ok
    assert check_stored_rows(run) == 2 * P_MOD * P_MOD


@pytest.mark.parametrize("slots", [None, [2, 0, 1]])
def test_lut_level_batches_equal_per_gate(jx, tmp_path, slots):
    """One level of three LUT gates through `public_lookup_batch` of both
    LWE evaluators (as `eval_batched` hands them over) equals the JAX
    package's per-gate `public_lookup`: the same A_LT and gate records
    offline; every stored row exact after the gates' shared preimage call;
    online, over the port's stored K_high, the same c_out, A_LT and
    plaintext, bit for bit, and each output decodes."""
    p, jp = RingParams.new(*ARGS), jx.RingParams.new(*ARGS)
    q = p.modulus
    lut, jlut = mod_p_lut(PublicLut, p), mod_p_lut(jx.PublicLut, jp)
    xs = (3, 40, 17)
    pubkeys = BGGPublicKeySampler(KEY, 1, device="cpu").sample(p, b"bgg_pubkey", [True] * 3)
    secret = UniformSampler(seed=77, device="cpu").sample_poly(p, TernaryDist())
    es = BGGEncodingSampler(p, [secret], gauss_sigma=ERROR_SIGMA, seed=78)
    encodings = es.sample(p, pubkeys, [Poly.const(p, x, "cpu") for x in xs])
    ts = TrapdoorSampler(p, TRAPDOOR_SIGMA, seed=79, device="cpu")
    td, b0 = ts.trapdoor(p, 1)
    gates = [7, 8, 9]
    per_slot = slots or [None] * 3

    def assert_same(mine, theirs):
        mine = mine.to_coeff() if theirs.fmt == "coeff" else mine.to_eval()
        np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))

    init_storage_system(tmp_path)
    pk_eval = LWEBGGPubKeyPltEvaluator(KEY, ts, b0, td, tmp_path)
    lwe.set_plt_context(pk_eval, "level")
    bat = pk_eval.public_lookup_batch(p, [(lut, pk, g, 0) for pk, g in zip(pubkeys[1:], gates)],
                                      slot_idxs=slots)
    jpk_eval = jx.lwe.LWEBGGPubKeyPltEvaluator(KEY, None, jax_matrix(jx, jp, b0), None, tmp_path)
    jx.lwe.set_plt_context(jpk_eval, "level")
    seq = [jpk_eval.public_lookup(jp, jlut, None,
                                  jx.BggPublicKey(jax_matrix(jx, jp, pk.matrix), True), g, 0,
                                  slot_idx=s)
           for pk, g, s in zip(pubkeys[1:], gates, per_slot)]
    for a, b in zip(bat, seq):
        assert_same(a.matrix, b.matrix)
    states = dict(pk_eval.gate_state)
    assert list(states) == list(jpk_eval.gate_state)
    for key, st in states.items():
        jst = jpk_eval.gate_state[key]
        assert st.lut_id == jst.lut_id and st.context == jst.context
        assert_same(st.input_pubkey, jst.input_pubkey)
        assert_same(st.output_pubkey, jst.output_pubkey)
    pk_eval.sample_aux_matrices(p)
    wait_for_all_writes()
    for (ctx, gate_id, slot), st in states.items():
        targets = pk_eval._k_high_targets(p, st.plt, st.input_pubkey, st.output_pubkey,
                                          gate_id, st.lut_id, slot, ctx)
        prefix = lwe.k_high_checkpoint_prefix(gate_id, st.lut_id, slot, ctx)
        for (_, (k, _)), t in zip(st.plt.entries(p), targets):
            assert b0 @ read_matrix_from_multi_batch(p, tmp_path, prefix, k, "cpu") == t

    c_b = es.secret_vec @ b0
    enc_eval = LWEBGGEncodingPltEvaluator(KEY, tmp_path, c_b)
    lwe.set_plt_context(enc_eval, "level")
    bat_e = enc_eval.public_lookup_batch(
        p, [(lut, e, g, 0) for e, g in zip(encodings[1:], gates)], slot_idxs=slots)
    jenc_eval = jx.lwe.LWEBGGEncodingPltEvaluator(KEY, tmp_path, jax_matrix(jx, jp, c_b))
    jx.lwe.set_plt_context(jenc_eval, "level")
    seq_e = [jenc_eval.public_lookup(jp, jlut, None, jax_encoding(jx, jp, e), g, 0, slot_idx=s)
             for e, g, s in zip(encodings[1:], gates, per_slot)]
    s_g = es.secret_vec @ PolyMatrix.gadget_matrix(p, 1, "cpu")
    for b, a, x, pk in zip(bat_e, seq_e, xs, bat):
        assert_same(b.vector, a.vector)
        assert_same(b.pubkey.matrix, a.pubkey.matrix)
        assert b.pubkey.matrix == pk.matrix
        mine_pt = b.plaintext.to_coeff() if a.plaintext.fmt == "coeff" else b.plaintext
        np.testing.assert_array_equal(convert.to_numpy(mine_pt), np.asarray(a.plaintext.data))
        assert b.plaintext.const_coeff() == x % P_MOD
        diff = b.vector - es.secret_vec @ b.pubkey.matrix + s_g.mul_poly_scalar(b.plaintext)
        coeff = diff.entry(0, 0).const_coeff()
        assert min(coeff, q - coeff) < (q // P_MOD) // 2


def test_port_chain_in_small_preimage_calls(tmp_path, monkeypatch):
    """Calls of at most 5 entries: each gate's 49 entries are 10 requests,
    sampled in calls of one request, and its rows are gathered from all of
    them into one buffer; the chain still decodes and every stored row is
    exact."""
    monkeypatch.setattr(lwe, "PREIMAGE_CALL_BYTES", 1)
    monkeypatch.setenv("LUT_PREIMAGE_CHUNK_SIZE", "5")
    run = run_port_chain(tmp_path, torch.device("cpu"), abc=(2, 5, 3))
    expected, err, q_over_p, mask_ok = decode(run)
    assert run.out_enc.plaintext.const_coeff() == expected
    assert err < q_over_p // 2 and mask_ok
    assert check_stored_rows(run) == 2 * P_MOD * P_MOD


def test_online_c_out_equals_jax(jx, port_chain):
    """Both packages' online evaluators over the port's stored K_high and
    the same encodings give the same c_out, A_LT and plaintext, bit for bit."""
    run = port_chain
    p, jp = run.p, jx.RingParams.new(*ARGS)

    jencs = [jax_encoding(jx, jp, e) for e in run.encodings]
    jcircuit = chain_circuit(jx.PolyCircuit(), mod_p_lut(jx.PublicLut, jp))
    jenc_eval = jx.lwe.LWEBGGEncodingPltEvaluator(KEY, run.dir, jax_matrix(jx, jp, run.c_b))
    jout = jcircuit.eval(jp, jencs[0], jencs[1:], plt_evaluator=jenc_eval)[0]
    mine = run.out_enc
    for a, b in [(mine.vector, jout.vector), (mine.pubkey.matrix, jout.pubkey.matrix)]:
        assert a.fmt == b.fmt
        np.testing.assert_array_equal(convert.to_numpy(a), np.asarray(b.data))
    np.testing.assert_array_equal(convert.to_numpy(mine.plaintext), np.asarray(jout.plaintext.data))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_port_chain_on_card(cuda_device, tmp_path, monkeypatch):
    """The tiny chain with every operand on the card: the online K_high is
    read onto the card, and c_out is there."""
    read = lwe.read_matrix_from_multi_batch
    devices = []

    def recording_read(*args, **kwargs):
        m = read(*args, **kwargs)
        devices.append(m.data.device.type)
        return m

    monkeypatch.setattr(lwe, "read_matrix_from_multi_batch", recording_read)
    run = run_port_chain(tmp_path, cuda_device)
    assert devices == ["cuda", "cuda"]
    assert run.out_enc.vector.data.device.type == "cuda"
    assert run.out_enc.pubkey.matrix.data.device.type == "cuda"
    expected, err, q_over_p, mask_ok = decode(run)
    assert err < q_over_p // 2 and mask_ok
    assert check_stored_rows(run) == 2 * P_MOD * P_MOD


# ------------------------------------------------------------ batched preimages


def _trapdoor_and_targets(count, width, seed=5):
    p = RingParams.new(*ARGS)
    ts = TrapdoorSampler(p, TRAPDOOR_SIGMA, seed=seed, device="cpu")
    td, b = ts.trapdoor(p, 1)
    us = UniformSampler(seed=seed + 1, device="cpu")
    return p, ts, td, b, [us.sample_uniform(p, 1, width, FinRingDist()) for _ in range(count)]


def test_preimage_batched_chunked_exact_and_unpadded(tmp_path, monkeypatch):
    """5 targets at chunk 2: three preimage calls of 2, 2 and 1 requests (no
    padded tail), B x == t for each; an offloaded target rehydrates."""
    p, ts, td, b, targets = _trapdoor_and_targets(5, 3)
    targets[3] = offload_matrix(targets[3], str(tmp_path / "t3.mxmm"))
    widths = []
    preimage = ts.preimage

    def counting(params, trapdoor, public_matrix, target):
        widths.append(target.ncol)
        return preimage(params, trapdoor, public_matrix, target)

    monkeypatch.setattr(ts, "preimage", counting)
    xs = ts.preimage_batched_chunked(p, td, b, targets, chunk=2)
    assert widths == [6, 6, 3]
    assert len(xs) == 5
    for x, t in zip(xs, targets):
        if isinstance(t, OffloadedMatrix):
            t = t.load(torch.device("cpu"))
        assert x.shape == (2 + p.modulus_digits, 3)
        assert b @ x == t


def test_preimage_batched_sharded_is_one_call_and_takes_a_mesh():
    """One call without a mesh; over a logical 1x4 mesh (6 columns padded to
    8) the batched and the chunked call give each request its own columns,
    B x == t exactly."""
    p, ts, td, b, targets = _trapdoor_and_targets(3, 2, seed=8)
    xs = ts.preimage_batched_sharded(p, td, b, targets)
    assert [x.ncol for x in xs] == [2, 2, 2]
    assert all(b @ x == t for x, t in zip(xs, targets))
    mesh = Mesh([["cpu"] * 4])
    for xs in (ts.preimage_batched_sharded(p, td, b, targets, mesh=mesh),
               ts.preimage_batched_chunked(p, td, b, targets, mesh=mesh, chunk=2)):
        assert [x.ncol for x in xs] == [2, 2, 2]
        assert all(b @ x == t for x, t in zip(xs, targets))


def test_preimage_extend_exact():
    p, ts, td, b, (target,) = _trapdoor_and_targets(1, 4, seed=11)
    ext = UniformSampler(seed=12, device="cpu").sample_uniform(p, 1, 5, FinRingDist())
    x = ts.preimage_extend(p, td, b, ext, target)
    assert x.shape == (b.ncol + ext.ncol, 4)
    assert b.concat_columns([ext]) @ x == target


def test_debug_trapdoor_preimage_exact():
    p, ts, td, b, (target,) = _trapdoor_and_targets(1, 3, seed=13)
    assert b @ debug_trapdoor_preimage(p, td, target) == target


# ------------------------------------------------------------- debug evaluators


N_LUT = 8


def debug_circuit(circuit, lut):
    """One level of N_LUT PubLut gates over products of input pairs."""
    ins = circuit.input(N_LUT + 1)
    lut_id = circuit.register_public_lut(lut)
    prods = [circuit.mul_gate(ins[i], ins[i + 1]) for i in range(N_LUT)]
    circuit.output([circuit.public_lookup_gate(w, lut_id) for w in prods])
    return circuit


def test_debug_evaluators_equal_jax(jx):
    p, jp = RingParams.new(*ARGS), jx.RingParams.new(*ARGS)
    circuit = debug_circuit(PolyCircuit(), mod_p_lut(PublicLut, p))
    jcircuit = debug_circuit(jx.PolyCircuit(), mod_p_lut(jx.PublicLut, jp))
    vals = [int(v) for v in np.random.default_rng(3).integers(0, P_MOD, size=N_LUT + 1)]
    plain = [Poly.const(p, v, device="cpu") for v in vals]
    pks = BGGPublicKeySampler(KEY, 1, device="cpu").sample(p, b"debug_lut", [True] * len(vals))
    jpks = jx.BGGPublicKeySampler(KEY, 1).sample(jp, b"debug_lut", [True] * len(vals))
    secret = UniformSampler(seed=21, device="cpu").sample_poly(p, TernaryDist())
    es = BGGEncodingSampler(p, [secret])  # zero error: the relation is exact
    encs = es.sample(p, pks, plain)
    s_vec = es.secret_vec

    pk_seq = circuit.eval(p, pks[0], pks[1:], plt_evaluator=DebugBGGPubKeyPltEvaluator(KEY))
    pk_bat = eval_batched(circuit, p, pks[0], pks[1:], DebugBGGPubKeyPltEvaluator(KEY))
    enc_seq = circuit.eval(p, encs[0], encs[1:], plt_evaluator=RelationCheckingPltEvaluator(
        DebugBGGEncodingPltEvaluator(KEY, s_vec), s_vec))
    enc_bat = eval_batched(circuit, p, encs[0], encs[1:], DebugBGGEncodingPltEvaluator(KEY, s_vec))
    x_out = circuit.eval(p, Poly.one(p, device="cpu"), plain, plt_evaluator=PolyPltEvaluator())
    s_g = s_vec @ PolyMatrix.gadget_matrix(p, 1, device="cpu")
    for s, b, es_, eb, x in zip(pk_seq, pk_bat, enc_seq, enc_bat, x_out):
        assert s == b and es_ == eb and eb.pubkey == b
        assert eb.vector == s_vec @ eb.pubkey.matrix - s_g.mul_poly_scalar(x)

    jdebug = jx.debug
    js_vec = jax_matrix(jx, jp, s_vec)
    jencs = [jx.BggEncoding(jax_matrix(jx, jp, e.vector),
                            jx.BggPublicKey(jax_matrix(jx, jp, e.pubkey.matrix), True),
                            jx.Poly(convert.to_numpy(e.plaintext), e.plaintext.fmt, jp))
             for e in encs]
    jpk_seq = jcircuit.eval(jp, jpks[0], jpks[1:],
                            plt_evaluator=jdebug.DebugBGGPubKeyPltEvaluator(KEY))
    jpk_bat = jx.eval_batched(jcircuit, jp, jpks[0], jpks[1:],
                              jdebug.DebugBGGPubKeyPltEvaluator(KEY))
    jenc_seq = jcircuit.eval(jp, jencs[0], jencs[1:],
                             plt_evaluator=jdebug.DebugBGGEncodingPltEvaluator(KEY, js_vec))
    jenc_bat = jx.eval_batched(jcircuit, jp, jencs[0], jencs[1:],
                               jdebug.DebugBGGEncodingPltEvaluator(KEY, js_vec))
    for mine, theirs in [(pk_seq, jpk_seq), (pk_bat, jpk_bat)]:
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(convert.to_numpy(a.matrix.to_eval()),
                                          np.asarray(b.matrix.to_eval().data))
    for mine, theirs in [(enc_seq, jenc_seq), (enc_bat, jenc_bat)]:
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(convert.to_numpy(a.vector.to_eval()),
                                          np.asarray(b.vector.to_eval().data))
            np.testing.assert_array_equal(convert.to_numpy(a.pubkey.matrix.to_eval()),
                                          np.asarray(b.pubkey.matrix.to_eval().data))
            np.testing.assert_array_equal(convert.to_numpy(a.plaintext.to_eval()),
                                          np.asarray(b.plaintext.to_eval().data))


def test_relation_checking_evaluator_rejects_a_wrong_output():
    p = RingParams.new(*ARGS)
    circuit = debug_circuit(PolyCircuit(), mod_p_lut(PublicLut, p))
    plain = [Poly.const(p, v, device="cpu") for v in range(1, N_LUT + 2)]
    pks = BGGPublicKeySampler(KEY, 1, device="cpu").sample(p, b"debug_lut", [True] * len(plain))
    es = BGGEncodingSampler(p, [UniformSampler(seed=22, device="cpu").sample_poly(p, TernaryDist())])
    encs = es.sample(p, pks, plain)
    wrong = PolyMatrix.from_poly_row(p, [Poly.const(p, 1, device="cpu")])  # not the encodings' secret
    checking = RelationCheckingPltEvaluator(DebugBGGEncodingPltEvaluator(KEY, wrong),
                                            es.secret_vec)
    with pytest.raises(AssertionError, match="relation violated"):
        circuit.eval(p, encs[0], encs[1:], plt_evaluator=checking)
