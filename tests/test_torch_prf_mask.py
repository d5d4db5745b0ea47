"""The Diamond iO PRF mask pipeline (`io_protocols/prf_mask.py`) of the port
against the JAX package: the hashes, artifact ids and graph seeds, the
hash-derived branch-mask and rebase matrices (bit for bit), the per-round
Goldreich PRG circuit (gate for gate) and the debug-replay PRG ciphertexts
and refresh material drawn from one `Drbg`, scalar and packed (equal
integers), with their wire values."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_structure import assert_circuits_equal

import mxx_tpu  # noqa: F401

KEY = bytes(range(32))


def load(pkg):
    mods = {"params": "ring.params", "prf": "io_protocols.prf_mask", "sampler": "sampler",
            "rng": "utils.rng"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    return ns


def _np(m):
    m = m.to_coeff()
    return m.data.cpu().numpy().astype(np.uint32) if hasattr(m.data, "cpu") else np.asarray(m.data)


def ci_config(ns, **kw):
    args = dict(seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=5,
                max_unreduced_muls=1, noise_refresh_v_bits=1,
                debug_encrypt_random_prg_wires=True, debug_reuse_single_material=True,
                refresh_wire_limit=1)
    args.update(kw)
    return ns.prf.PrfConfig(**args)


def real_config(ns):
    return ns.prf.PrfConfig(seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=8,
                            max_unreduced_muls=2, noise_refresh_v_bits=1, p_basis="wide")


def pipeline(ns, ring=(4, 3, 10, 10), slots=1, cfg=None):
    params = ns.params.RingParams.new(*ring)
    ts = ns.sampler.TrapdoorSampler(params, 4.578, seed=3, **ns.kw)
    return params, ns.prf.PrfMaskPipeline(params, cfg or ci_config(ns), KEY, ts, 2, 1,
                                          num_slots=slots)


BOTH = [load("mxx_tpu"), load("mxx_tpu_torch")]


def test_hashes_ids_and_matrices_match_jax():
    (pj, j), (pt, t) = (pipeline(ns) for ns in BOTH)
    assert j.wires_per_ct == t.wires_per_ct and j.branch_count == t.branch_count == 2
    for r in range(3):
        assert j.graph_seed_for_round(r) == t.graph_seed_for_round(r)
        for b in range(2):
            assert j.material_graph_seed(r, b) == t.material_graph_seed(r, b)
            for w in (0, 7):
                assert j.rebase_preimage_id(r, b, w) == t.rebase_preimage_id(r, b, w)
                assert j.rebase_preimage_id_slot(r, b, w, 3) == t.rebase_preimage_id_slot(
                    r, b, w, 3)
                assert j.refresh_preimage_id(r, b, w, 2) == t.refresh_preimage_id(r, b, w, 2)
                assert j.refresh_preimage_id_slot(r, b, w, 1, 2) == \
                    t.refresh_preimage_id_slot(r, b, w, 1, 2)
        assert j.refresh_id(r, 5) == t.refresh_id(r, 5)
        assert j.refresh_id_slot(r, 5, 2) == t.refresh_id_slot(r, 5, 2)
    cols = pt.modulus_digits
    pairs = [(j._branch_mask_matrix(1, 1, 3, cols), t._branch_mask_matrix(1, 1, 3, cols)),
             (j._common_rebase_pk(0, 2, cols), t._common_rebase_pk(0, 2, cols)),
             (j._common_rebase_pk_slot(1, 0, 3, cols), t._common_rebase_pk_slot(1, 0, 3, cols)),
             (j.refresher._a_prime(b"prf_r0_w0"), t.refresher._a_prime(b"prf_r0_w0"))]
    for a, b in pairs:
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("only_branch,representative", [(0, False), (None, True)])
def test_prg_round_circuit_matches_jax(only_branch, representative):
    (pj, j), (pt, t) = (pipeline(ns, (2, 2, 9, 9), cfg=real_config(ns)) for ns in BOTH)
    assert_circuits_equal(
        j.build_prg_round_circuit(1, only_branch, representative),
        t.build_prg_round_circuit(1, only_branch, representative), pj, pt)


def _debug_material(ns, slots):
    params, prf = pipeline(ns, (8, 3, 10, 10), slots=slots,
                           cfg=ci_config(ns, debug_reuse_single_material=False))
    rng = ns.rng.Drbg(17)
    q = params.modulus
    if slots == 1:
        cts = prf._sample_debug_prg_cts(-1, 3, rng, 0.0, sink := [])
        material = prf._refresh_material(-1, rng, 0.0)
        values = [prf._ct_wire_values(cts[:1])]
    else:
        k = [c % q for c in (1, 0, -1, 1)[:slots]]
        cts = prf._sample_debug_prg_cts_packed(k, 3, rng, 0.0)
        material = prf._refresh_material_packed(k, rng, 0.0)
        sink = []
        values = prf._ct_slot_values(cts[:1])
    return cts, sink, material.errors, material.masks, values, rng.randrange(1 << 30)


@pytest.mark.parametrize("slots", [1, 4])
def test_debug_prg_and_refresh_material_match_jax(slots):
    mine, theirs = (_debug_material(ns, slots) for ns in BOTH[::-1])
    assert mine == theirs
