"""Real-mode Diamond iO (no debug flag: the Goldreich PRG round runs
in-circuit over the seed ciphertexts' wires, the refresh material comes from
in-circuit PRG streams, every wire is refreshed) in the port against the JAX
package.

The smallest real-mode `PrfConfig` both packages accept is
`RingParams.new(2, 1, 12, 12)` with seed_bits 5 (the Goldreich graph needs
at least 5 inputs), a wide p-basis below 2^6 (a narrower one's LUT domain
exceeds q, a wider one needs a larger q) and max_unreduced_muls 2 (1 fails
the p-CRT budget): 288 wires per GSW ciphertext. Even there one branch of
the PRG round is 5 x 136,513 gates (one Goldreich output is an XOR3 + AND2
of GSW external products), which the JAX package evaluates for minutes on
the CPU, and the refresh-material circuit is larger still. So the tier-1
cases below cut the Goldreich predicate, in both packages alike, to a
stand-in: output bit = x[a] (`one_input`, the circuit then holds only the
CBD combinations and the decrypts) or the GSW sum x[a] + x[d] (`sum`, a
nested-RNS add and full reduce per ciphertext: 48,961 gates per branch).
Everything else (graphs, ranges, circuit boundaries, wire order, hashes,
targets, refresh algebra) is the real code. The real predicate's GSW
product, one Ring-GSW AND over BGG+ public keys at this config, is held bit
for bit in `tests/test_torch_gsw.py`. The `slow` cases run the real predicate:
one PRG round branch at this config against the JAX package, the mirror of
`test_diamond_io_real_mode_e2e` at its config (`RingParams.new(2, 2, 9, 9)`,
~2M gates per round branch and ~6M per refresh-material circuit) and the
port evaluating the JAX package's real-mode obfuscation.

All comparisons are exact:
- `decoded_terms_prg` over BGG+ public keys: the per-CRT term matrices bit
  for bit (hash-derived public keys and integer circuit evaluation);
- `_eval_prg_round` over public keys for one branch: every output wire
  (with the stand-in; with the real predicate in a `slow` case);
- the real branch of `compute_public_key_path` with a stand-in trapdoor
  sampler that records its targets and returns them: every rebase and
  refresh target, the preimage ids in order, and the next-round seed-wire
  public keys, bit for bit;
- the real branch of `compute_seed_encoding_path` over the port's own
  stored preimages (exact trapdoor preimages, error sigma 0), port only and
  at the JAX test's ring (L=2, so each CRT level is rounded): every
  refreshed wire c satisfies c == s (A' - x G) - eps s, eps the refresh
  material's CBD errors computed in the clear from the seed bits.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import mxx_tpu  # noqa: F401

KEY = bytes(range(32))
SMALL = (2, 1, 12, 12)
SMALL_P_BITS = 6
REAL = (2, 2, 9, 9)


def load(pkg):
    mods = {"params": "ring.params", "prf": "io_protocols.prf_mask", "bgg": "bgg",
            "debug": "lookup.debug", "matrix": "matrix", "poly": "ring.poly",
            "rng": "utils.rng", "sampler": "sampler", "goldreich": "gadgets.fhe_prg.goldreich",
            "ring_gsw": "gadgets.fhe.ring_gsw", "dio": "io_protocols.diamond_io"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    return ns


JAX, PORT = load("mxx_tpu"), load("mxx_tpu_torch")


def _np(m):
    m = m.to_coeff()
    return m.data.cpu().numpy().astype(np.uint32) if hasattr(m.data, "cpu") else np.asarray(m.data)


def real_config(ns, p_bits=8):
    return ns.prf.PrfConfig(seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=p_bits,
                            max_unreduced_muls=2, noise_refresh_v_bits=1, p_basis="wide",
                            debug_encrypt_random_prg_wires=False,
                            debug_reuse_single_material=False, refresh_wire_limit=None)


def _one_input(self, edge, seed_cts, circuit):
    return seed_cts[edge.xor_inputs[0]]


def _sum(self, edge, seed_cts, circuit):
    return seed_cts[edge.xor_inputs[0]].add(seed_cts[edge.and_inputs[0]], circuit)


STAND_INS = {"one_input": _one_input, "sum": _sum}


@pytest.fixture
def predicate(monkeypatch, request):
    """The Goldreich predicate of both packages cut to a stand-in."""
    for ns in (JAX, PORT):
        monkeypatch.setattr(ns.goldreich.GoldreichFhePrg, "_eval_edge",
                            STAND_INS[request.param])
    return request.param


class _Checkpoint:
    def __init__(self, td, b0):
        self.td, self.b0 = td, b0

    def final_checkpoint(self, idx):
        return self.td, self.b0


class _RecordingSampler:
    """A stand-in trapdoor sampler: records the targets it is given and
    returns them as the 'preimages'."""

    device = "cpu"

    def __init__(self):
        self.targets = []

    def preimage_batched_chunked(self, params, trapdoor, public_matrix, targets, mesh=None,
                                 chunk=None):
        self.targets.extend(targets)
        return list(targets)


def _pipeline(ns, trap, ring=SMALL, p_bits=SMALL_P_BITS):
    params = ns.params.RingParams.new(*ring)
    return params, ns.prf.PrfMaskPipeline(params, real_config(ns, p_bits), KEY, trap, 1, 1)


def _seed_cts(ns, prf, bits, k_int=-1):
    rng = ns.rng.Drbg(11)
    return [ns.ring_gsw.native_encrypt(prf.ctx, k_int, b, rng, 0.0) for b in bits]


def _pubkeys(ns, params):
    """one, k, -k and the round-0 selector public keys."""
    one, k, sel = ns.bgg.BGGPublicKeySampler(KEY, 1, **ns.kw).sample(params, b"real_pks",
                                                                     [False, True])
    zero = ns.matrix.PolyMatrix.zero(params, 1, k.matrix.ncol, **ns.kw)
    return one, k, ns.bgg.BggPublicKey(zero - k.matrix, False), sel


@pytest.mark.parametrize("predicate", ["one_input"], indirect=True)
def test_decoded_terms_prg_matches_jax(predicate):
    got = []
    for ns in (JAX, PORT):
        params, prf = _pipeline(ns, _RecordingSampler())
        one, _, negk, _ = _pubkeys(ns, params)
        seeds = prf.lift_values(one, prf._ct_wire_values(_seed_cts(ns, prf, [1, 0, 1, 1, 0])))
        terms = prf.refresher.decoded_terms_prg(
            one, negk, seeds, prf.material_graph_seed(0, 1), 1,
            ns.debug.DebugBGGPubKeyPltEvaluator(KEY), lambda w: w.matrix, context="refresh.r0.b1")
        got.append([_np(t) for t in terms])
    assert len(got[0]) == len(got[1]) == 1
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


def _seed_pubkeys(ns, params, count):
    return ns.bgg.BGGPublicKeySampler(KEY, 1, **ns.kw).sample(
        params, b"real_seed_wires", [True] * count)[1:]


def _prg_round_matches_jax():
    got = []
    for ns in (JAX, PORT):
        params, prf = _pipeline(ns, _RecordingSampler())
        one = _pubkeys(ns, params)[0]
        seeds = _seed_pubkeys(ns, params, 5 * prf.wires_per_ct)
        out = prf._eval_prg_round(1, one, seeds, ns.debug.DebugBGGPubKeyPltEvaluator(KEY),
                                  only_branch=1)
        assert list(out) == [1] and len(out[1]) == 5
        got.append(np.stack([_np(w.matrix) for chunk in out[1] for w in chunk]))
    assert got[0].shape[0] == 5 * 288
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("predicate", ["sum"], indirect=True)
def test_eval_prg_round_matches_jax(predicate):
    _prg_round_matches_jax()


@pytest.mark.parametrize("predicate", ["one_input"], indirect=True)
def test_public_key_path_matches_jax(predicate):
    got = []
    for ns in (JAX, PORT):
        trap = _RecordingSampler()
        params, prf = _pipeline(ns, trap)
        one, k, negk, sel = _pubkeys(ns, params)
        writes = []
        seeds, debug = prf.compute_public_key_path(
            lambda mid, m: writes.append(mid), _Checkpoint(None, None), one, k, negk, [sel],
            _seed_cts(ns, prf, [0, 1, 1, 0, 1]), -1, ns.rng.Drbg(3), 0.0,
            ns.debug.DebugBGGPubKeyPltEvaluator(KEY))
        assert not debug.prg_cts
        got.append((writes, np.stack([_np(t) for t in trap.targets]),
                    np.stack([_np(w.matrix) for w in seeds])))
    (wj, tj, sj), (wt, tt, st) = got
    wires = 5 * 288
    # per branch: every wire's rebase preimage, then every wire's refresh one
    assert wj == wt and len(wt) == 2 * 2 * wires
    assert wt[wires] == "prf_round_0_branch_0_wire_0_refresh_preimage_crt_0"
    np.testing.assert_array_equal(tj, tt)
    np.testing.assert_array_equal(sj, st)
    assert st.shape[0] == wires


class _ExactSampler:
    """Exact trapdoor preimages without perturbation on the port
    (`debug_trapdoor_preimage`, [R z; E z; z] for z = G^{-1}(target)), the
    targets of a call as one stack."""

    device = "cpu"

    def preimage_batched_chunked(self, params, trapdoor, public_matrix, targets, mesh=None,
                                 chunk=None):
        import torch

        from mxx_tpu_torch.matrix import rows

        z = rows.decompose(params, rows.stack(params, targets))  # [W, L, 2k, m, n]
        out = torch.cat([rows.matmul_left(params, trapdoor.r, z),
                         rows.matmul_left(params, trapdoor.e, z), z.transpose(0, 1)], dim=2)
        return rows.unstack(params, out)


def _clear_cbd(prf, params, seed_bits, graph_seed, stand_in):
    """The refresh material's CBD errors eps[digit][coeff], in the clear."""
    from mxx_tpu_torch.noise_refresh.circuit_prg import derive_noise_refresh_graph_seed

    n, digits = params.n, params.modulus_digits
    per_digit = n * 2  # cbd_n 1: two PRG bits per CBD value
    eps = []
    for d in range(digits):
        graph = PORT.goldreich.GoldreichGraph.generate_range(
            len(seed_bits), digits * per_digit, d * per_digit, per_digit,
            derive_noise_refresh_graph_seed(graph_seed, b"NoiseRefreshCBD/v1", 0))
        bits = [stand_in(e, seed_bits) for e in graph.edges]
        eps.append([bits[2 * i] - bits[2 * i + 1] for i in range(n)])
    return eps


@pytest.mark.parametrize("predicate", ["one_input"], indirect=True)
@pytest.mark.parametrize("branch", [0, 1])
def test_seed_encoding_path_relation(predicate, branch):
    """At the JAX test's ring (L=2: the refresh rounds each CRT level, and the
    material's masks and midpoints fall below the rounding) the refreshed
    wires carry exactly the material's CBD error; the port alone, so the
    3,360 wires per branch are cheap."""
    ns = PORT
    ts = ns.sampler.TrapdoorSampler(ns.params.RingParams.new(*REAL), 4.578, seed=5,
                                    device="cpu")
    params, prf = _pipeline(ns, _ExactSampler(), REAL, 8)
    td, b0 = ts.trapdoor(params, 2)
    one, k, negk, sel = _pubkeys(ns, params)
    seed_bits = [1, 0, 1, 1, 0]
    k_int = -1
    store = {}
    prf.compute_public_key_path(
        store.__setitem__, _Checkpoint(td, b0), one, k, negk, [sel],
        _seed_cts(ns, prf, seed_bits, k_int), k_int, ns.rng.Drbg(3), 0.0,
        ns.debug.DebugBGGPubKeyPltEvaluator(KEY))

    PM, Poly = ns.matrix.PolyMatrix, ns.poly.Poly
    us = ns.sampler.UniformSampler(seed=9, device="cpu")
    s = us.sample_uniform(params, 1, 1, ns.sampler.TernaryDist())  # a small secret, as sigma
    sigma = s.concat_columns([us.sample_uniform(params, 1, 1, ns.sampler.FinRingDist())])
    state0 = sigma @ b0  # state0 P = s T for a preimage P of [T; 0]
    G = PM.gadget_matrix(params, 1, "cpu")
    q = params.modulus

    def enc(pk, x):
        x_g = G.mul_poly_scalar(x) if x is not None else G.mul_int_scalar(k_int % q)
        return ns.bgg.BggEncoding(s @ (pk.matrix - x_g), pk, x)

    one_enc = enc(one, Poly.one(params, "cpu"))
    k_enc = enc(k, None)
    zero = PM.zero(params, 1, k.matrix.ncol, device="cpu")
    negk_enc = ns.bgg.BggEncoding(zero - k_enc.vector, negk, None)
    sel_enc = enc(sel, Poly.const(params, branch, "cpu"))
    out = prf.compute_seed_encoding_path(
        store.__getitem__, state0, one_enc, k_enc, negk_enc, [sel_enc], [branch],
        _seed_cts(ns, prf, seed_bits, k_int), None,
        ns.debug.DebugBGGEncodingPltEvaluator(KEY, s))
    assert len(out) == 5 * prf.wires_per_ct

    # the refresh error: -eps_j s in column j, eps_j the digit's CBD polynomial
    eps = _clear_cbd(prf, params, seed_bits, prf.material_graph_seed(0, branch),
                     lambda e, x: x[e.xor_inputs[0]])
    cols = []
    for coeffs in eps:
        e_poly = Poly.from_int_coeffs(params, [c % q for c in coeffs], "cpu")
        cols.append(s.mul_poly_scalar(e_poly))
    err = cols[0].concat_columns(cols[1:]) if len(cols) > 1 else cols[0]
    assert any(c for row in eps for c in row), "the material's CBD errors are all zero"
    bad = [i for i, w in enumerate(out)
           if not w.vector == s @ (w.pubkey.matrix - G.mul_poly_scalar(w.plaintext)) - err]
    assert not bad, f"{len(bad)} refreshed wires off c == s (A' - x G) - eps s, first {bad[:3]}"


def _real_dio(ns, seed=7):
    """`test_diamond_io_real_mode_e2e`'s DiamondIO."""
    return ns.dio.DiamondIO(
        ns.params.RingParams.new(*REAL), input_count=1, batch_bits=1, seed=seed,
        prf_config=real_config(ns), **ns.kw,
        pk_plt_evaluator_factory=lambda s, d, hk, pre: ns.debug.DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            ns.debug.DebugBGGEncodingPltEvaluator(
                obf.hash_key, s.injector.debug_final_secret_matrix(d, digits)),
    )


def _first_bit(circuit, bits):
    return [bits[0]]


def _check_decodes_and_one(ns, dio, tmp_path, obf):
    for bits in ([0], [1]):
        assert dio.eval(tmp_path, obf, _first_bit, bits) == [bits[0]], bits
    params = dio.params
    states = dio.injector.online_eval(tmp_path, obf.preprocess_out, [1])
    sigma = dio.injector.debug_final_secret_matrix(tmp_path, [1])
    one_pk = ns.bgg.BGGPublicKeySampler(obf.hash_key, 1, **ns.kw).sample(
        params, b"diamond_bgg", [True])[0]
    one_vec = states[0] @ dio._read(tmp_path, "one_preimage")
    gadget = ns.matrix.PolyMatrix.gadget_matrix(params, 1, **ns.kw)
    assert one_vec == sigma @ (one_pk.matrix - gadget), "c_one == sigma (A_one - G)"


@pytest.mark.slow
def test_eval_prg_round_real_predicate_matches_jax():
    """`_eval_prg_round` for one branch with the real Goldreich predicate
    (XOR3 + AND2 of GSW ciphertexts, 5 x 136,513 gates), every output wire
    equal to the JAX package's."""
    _prg_round_matches_jax()


@pytest.mark.slow
def test_diamond_io_real_mode_e2e(tmp_path):
    """The port's mirror of the JAX package's `test_diamond_io_real_mode_e2e`:
    both inputs decode, no PRG ciphertext is recorded, and c_one == sigma
    (A_one - G) exactly."""
    dio = _real_dio(PORT)
    obf = dio.obfuscate(tmp_path, _first_bit)
    assert obf.prf_debug is None or not obf.prf_debug.prg_cts
    _check_decodes_and_one(PORT, dio, tmp_path, obf)


class _Stop(Exception):
    pass


@pytest.mark.slow
def test_port_evaluates_a_jax_real_mode_obfuscation(tmp_path, monkeypatch):
    """A real-mode obfuscation the JAX package made (~16 min on the CPU),
    carried over by `convert.diamond_io_obf_from_numpy` (prf_debug None) with
    its artifact directory: the port evaluates both inputs; the hash key, seed
    ciphertexts and output count equal the port's own obfuscation's (which
    is stopped once its PRF pipeline is handed the seed ciphertexts)."""
    from mxx_tpu_torch import convert

    jdio = _real_dio(JAX)
    jobf = jdio.obfuscate(tmp_path / "j", _first_bit)
    assert not jobf.prf_debug.prg_cts
    pre = jobf.preprocess_out
    obf = convert.diamond_io_obf_from_numpy(
        PORT.params.RingParams.new(*REAL), jobf.hash_key,
        [(np.asarray(t.r.data), np.asarray(t.e.data), t.r.fmt) for t in pre.final_trapdoors],
        [(np.asarray(b.data), b.fmt) for b in pre.final_pub_matrices],
        jobf.num_outputs, jobf.unit_ct_consts, jobf.seed_cts, None, device="cpu")
    dio = _real_dio(PORT)
    _check_decodes_and_one(PORT, dio, tmp_path / "j", obf)

    seen = {}

    def stop(self, write_matrix, preprocess_out, one_pk, k_pk, negk_pk, selector_pks,
             seed_cts, *rest):
        seen["seed_cts"] = seed_cts
        raise _Stop

    monkeypatch.setattr(PORT.prf.PrfMaskPipeline, "compute_public_key_path", stop)
    mine = _real_dio(PORT)
    with pytest.raises(_Stop):
        mine.obfuscate(tmp_path / "t", _first_bit)
    assert mine._hash_key == jobf.hash_key
    assert seen["seed_cts"] == jobf.seed_cts
    assert mine._probe_num_outputs(_first_bit) == jobf.num_outputs
