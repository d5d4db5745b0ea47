"""Diamond iO of the port over the production storage-backed LWE LUT
evaluators (mirrors `tests/test_production_lwe_diamond.py`, `slow` there as
here): the DEFAULT evaluator factories, so the obfuscation samples the LUT
bridge preimage and the K_high rows of every recorded LUT gate into the
artifact store, and the evaluation reads them back (c_b = s B from the
bridge, c_out = c_b K_high + c_z K_low).

Config: `RingParams.new(4, 3, 10, 10)`, input_count 1, batch_bits 1, seed
11, the test's `PrfConfig` (debug replay, nested_rns_scale 64), the builder
[bits[0]].

- the port's own obfuscation on the CPU: more than 100 artifact files, both
  inputs decode, c_one == sigma (A_one - G), B0 lut_bridge == [lut_b; 0],
  and B K_high == target for every stored row of the first LUT gate of
  each plt context (PRG-refresh decrypts and the wrapped circuit), all
  exact;
- the port evaluates the obfuscation the JAX package made (carried over
  by `convert.diamond_io_obf_from_numpy` with its artifact directory, which
  holds `lut_bridge` and the JAX package's K_high rows): both inputs
  decode, and the hash key, seed ciphertexts and output count equal the
  port's own obfuscation.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import mxx_tpu  # noqa: F401

pytestmark = pytest.mark.slow

RING = (4, 3, 10, 10)
SEED = 11


def load(pkg):
    mods = {"params": "ring.params", "dio": "io_protocols.diamond_io",
            "prf": "io_protocols.prf_mask", "bgg": "bgg", "matrix": "matrix",
            "lwe": "lookup.lwe", "storage": "storage"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    return ns


def production_config(ns):
    return ns.prf.PrfConfig(seed_bits=2, prf_mask_output_coeff_bits=1, p_moduli_bits=5,
                            max_unreduced_muls=1, noise_refresh_v_bits=1, nested_rns_scale=64,
                            debug_encrypt_random_prg_wires=True,
                            debug_reuse_single_material=True, refresh_wire_limit=1)


def make_dio(ns):
    # no evaluator factories: the production LWE evaluators
    return ns.dio.DiamondIO(ns.params.RingParams.new(*RING), input_count=1, batch_bits=1,
                            seed=SEED, prf_config=production_config(ns), **ns.kw)


def builder(circuit, bits):
    return [bits[0]]


def check_decodes(dio, d, obf):
    for bits in ([0], [1]):
        assert dio.eval(d, obf, builder, bits) == [bits[0]], bits


@pytest.fixture(scope="module")
def port_obf(tmp_path_factory):
    """The port's obfuscation, with the pubkey evaluator it made (its gate
    records kept from just before `sample_aux_matrices` cleared them)."""
    ns = load("mxx_tpu_torch")
    seen = {}

    class Recording(ns.lwe.LWEBGGPubKeyPltEvaluator):
        def sample_aux_matrices(self, params):
            seen["eval"], seen["states"] = self, dict(self.gate_state)
            super().sample_aux_matrices(params)

    mp = pytest.MonkeyPatch()
    mp.setattr(ns.dio, "LWEBGGPubKeyPltEvaluator", Recording)
    try:
        d = tmp_path_factory.mktemp("port_obf")
        dio = make_dio(ns)
        obf = dio.obfuscate(d, builder)
    finally:
        mp.undo()
    return SimpleNamespace(ns=ns, dio=dio, obf=obf, dir=d, **seen)


def test_production_lwe_diamond_e2e(port_obf):
    ns, dio, obf, d = port_obf.ns, port_obf.dio, port_obf.obf, port_obf.dir
    params = dio.params
    assert len(list(d.iterdir())) > 100
    check_decodes(dio, d, obf)

    digits = [1]
    states = dio.injector.online_eval(d, obf.preprocess_out, digits)
    sigma = dio.injector.debug_final_secret_matrix(d, digits)
    one_pk = ns.bgg.BGGPublicKeySampler(obf.hash_key, 1, **ns.kw).sample(
        params, b"diamond_bgg", [True])[0]
    gadget = ns.matrix.PolyMatrix.gadget_matrix(params, 1, **ns.kw)
    assert states[0] @ dio._read(d, "one_preimage") == sigma @ (one_pk.matrix - gadget)

    pk_eval = port_obf.eval
    lut_b = pk_eval.pub_matrix
    b0 = obf.preprocess_out.final_checkpoint(0)[1]
    zero = ns.matrix.PolyMatrix.zero(params, 1, lut_b.ncol, **ns.kw)
    assert b0 @ dio._read(d, "lut_bridge") == lut_b.concat_rows([zero])

    first = {}
    for key, st in port_obf.states.items():
        first.setdefault(key[0], (key, st))
    assert "wrapped" in first and any(c.startswith("refresh.") for c in first), sorted(first)
    for (ctx, gate_id, slot), st in first.values():
        targets = pk_eval._k_high_targets(params, st.plt, st.input_pubkey, st.output_pubkey,
                                          gate_id, st.lut_id, slot, ctx)
        prefix = ns.lwe.k_high_checkpoint_prefix(gate_id, st.lut_id, slot, ctx)
        rows = dict(ns.storage.read_matrices_from_multi_batch(params, d, prefix, "cpu"))
        assert len(rows) == st.plt.length == len(targets)
        for (_, (k, _)), t in zip(st.plt.entries(params), targets):
            assert lut_b @ rows[int(k)] == t, (ctx, gate_id, k)


def test_port_evaluates_a_jax_production_obfuscation(tmp_path, port_obf):
    from mxx_tpu_torch import convert

    jns, ns = load("mxx_tpu"), port_obf.ns
    jdio = make_dio(jns)
    jobf = jdio.obfuscate(tmp_path, builder)
    assert (tmp_path / "diamond_io_lut_bridge.matrixbin").exists()
    assert any(f.name.startswith("LWE_K_H_wrapped.") for f in tmp_path.iterdir())
    dbg = jobf.prf_debug
    pre = jobf.preprocess_out
    obf = convert.diamond_io_obf_from_numpy(
        ns.params.RingParams.new(*RING), jobf.hash_key,
        [(np.asarray(t.r.data), np.asarray(t.e.data), t.r.fmt) for t in pre.final_trapdoors],
        [(np.asarray(b.data), b.fmt) for b in pre.final_pub_matrices],
        jobf.num_outputs, jobf.unit_ct_consts, jobf.seed_cts,
        {"prg_cts": dbg.prg_cts,
         "refresh_material": [[(m.errors, m.masks) for m in r] for r in dbg.refresh_material],
         "final_mask_cts": dbg.final_mask_cts, "original_seed_bits": dbg.original_seed_bits},
        device="cpu")
    check_decodes(make_dio(ns), tmp_path, obf)
    mine = port_obf.obf
    assert mine.hash_key == jobf.hash_key
    assert mine.seed_cts == jobf.seed_cts
    assert mine.num_outputs == jobf.num_outputs
