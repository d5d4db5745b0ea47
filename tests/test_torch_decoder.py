"""The port's masked decoder (`decoder/masked_high_bit.py`, `artifact.py`)
against the JAX package: the rounding functions on edge values, artifact
bytes identical and readable by either package, and `MaskedHighBitDecoder`
end to end. Integer work is held bit for bit (tolerance 0). A trapdoor
preimage is a float-Gaussian draw, so the port's own run is held to its
relations (B0 P == target, the bits come back); to compare targets and
artifacts byte for byte, both packages also run with a stand-in preimage
sampler that returns its target.
"""

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_structure import BOTH

from mxx_tpu_torch import convert
from mxx_tpu_torch.bgg import BggEncoding, BggPublicKey
from mxx_tpu_torch.decoder import (
    DirectoryDecoderArtifacts,
    InMemoryDecoderArtifacts,
    MaskedHighBitDecoder,
    VecDecoderArtifacts,
    decode_centered_masked_boolean_coeff,
    decode_centered_masked_integer_coeff,
    decode_centered_masked_matrix,
)
from mxx_tpu_torch.decoder.masked_high_bit import (
    MaskedHighBitEvaluatedOutput,
    MaskedHighBitOnlineInput,
)
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import Poly
from mxx_tpu_torch.sampler import (FinRingDist, HashSampler, TernaryDist, TrapdoorSampler,
                                   UniformSampler)

KEY = bytes(range(32))
ARGS = (16, 2, 20, 5)
CPU = "cpu"


def _ns(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    kw = {"device": CPU} if pkg == "mxx_tpu_torch" else {}
    return SimpleNamespace(
        pkg=pkg, kw=kw, params=m("ring.params").RingParams.new(*ARGS), poly=m("ring.poly"),
        PolyMatrix=m("matrix").PolyMatrix, decoder=m("decoder"), mhb=m("decoder.masked_high_bit"),
        sampler=m("sampler"), bgg=m("bgg"))


def test_rounding_functions_on_edge_values():
    dj = importlib.import_module("mxx_tpu.decoder")
    for q in (17, 2**20 - 3, RingParams.new(*ARGS).modulus):
        for p in (2, 3, 16):
            edges = {0, 1, q - 1, q // 2, q // 2 + 1, q // 4, q // 4 + 1, 3 * q // 4,
                     q // (2 * p), q // (2 * p) + 1, q - q // (2 * p), q - q // (2 * p) - 1}
            for c in sorted(edges):
                want = dj.decode_centered_masked_integer_coeff(c, q, p)
                assert decode_centered_masked_integer_coeff(c, q, p) == want
                assert want == round(p * c / q) % p or abs(p * c / q % 1 - 0.5) < 1e-6
        for c in (0, q // 4 - 1, q // 4 + 1, q // 2, 3 * q // 4 - 1, 3 * q // 4 + 1, q - 1):
            got = decode_centered_masked_boolean_coeff(c, q)
            assert got == dj.decode_centered_masked_boolean_coeff(c, q)
            assert got == (q // 4 < c < 3 * q // 4)
    with pytest.raises(AssertionError):
        decode_centered_masked_integer_coeff(1, 17, 1)


def test_decode_matrix_equal():
    outs = []
    for pkg in BOTH:
        ns = _ns(pkg)
        noisy = ns.sampler.UniformSampler(seed=9, **ns.kw).sample_uniform(
            ns.params, 2, 3, ns.sampler.FinRingDist())
        got = ns.mhb.decode_centered_masked_matrix(ns.params, noisy, 4)
        outs.append([[got.entry(i, j).coeffs() for j in range(3)] for i in range(2)])
        q = ns.params.modulus
        assert outs[-1][1][2] == [(4 * c + q // 2) // q % 4 for c in noisy.entry(1, 2).coeffs()]
    assert outs[0] == outs[1]


def test_artifact_bytes_identical_and_cross_readable(tmp_path):
    nj, nt = _ns("mxx_tpu"), _ns("mxx_tpu_torch")
    mj = nj.sampler.UniformSampler(seed=4).sample_uniform(nj.params, 2, 3, nj.sampler.FinRingDist())
    mt = UniformSampler(seed=4, device=CPU).sample_uniform(nt.params, 2, 3, FinRingDist())
    dj = nj.decoder.DirectoryDecoderArtifacts(tmp_path / "j", "dec")
    dt = DirectoryDecoderArtifacts(tmp_path / "t", "dec")
    dj.write_matrix("a0", mj)
    dt.write_matrix("a0", mt)
    raw = dt.read_artifact("a0")
    assert raw == dj.read_artifact("a0")
    assert (tmp_path / "t" / "dec_a0.matrixbin").read_bytes() == raw
    # each package reads the other's directory
    cross_t = DirectoryDecoderArtifacts(tmp_path / "j", "dec").read_matrix(nt.params, "a0", CPU)
    assert cross_t == mt and cross_t.data.device.type == CPU
    cross_j = nj.decoder.DirectoryDecoderArtifacts(tmp_path / "t", "dec").read_matrix(nj.params, "a0")
    np.testing.assert_array_equal(np.asarray(cross_j.data), np.asarray(mj.data))
    mem_j, mem_t = nj.decoder.InMemoryDecoderArtifacts(), InMemoryDecoderArtifacts()
    mem_j.write_matrix("x", mj)
    mem_t.write_matrix("x", mt)
    assert mem_j.artifacts == mem_t.artifacts and mem_t.read_matrix(nt.params, "x", CPU) == mt
    vec_j, vec_t = nj.decoder.VecDecoderArtifacts(), VecDecoderArtifacts()
    vec_j.push_matrix(mj)
    vec_t.push_matrix(mt)
    assert vec_j.artifacts == vec_t.artifacts and vec_t.matrix(nt.params, 0, CPU) == mt


def _encodings(ns, sigma, bits, masks):
    """Public keys A_i, ideal encodings sigma A_i - w_i G with
    w = (q/2) bit + mask, and zero public bottoms."""
    p = ns.params
    q = p.modulus
    hs = ns.sampler.HashSampler(**ns.kw) if ns.pkg == "mxx_tpu_torch" else ns.sampler.HashSampler()
    g = ns.PolyMatrix.gadget_matrix(p, 1, **ns.kw)
    pks, encs, pubs = [], [], []
    for i, (bit, mask) in enumerate(zip(bits, masks)):
        a = hs.sample_hash(p, KEY, f"dec_pk_{i}", 1, p.modulus_digits, ns.sampler.FinRingDist())
        w = ((q // 2) * bit + mask) % q
        vec = a.mul_poly_scalar(sigma) - g.mul_poly_scalar(ns.poly.Poly.const(p, w, **ns.kw))
        pks.append(a)
        encs.append(ns.bgg.BggEncoding(vec, ns.bgg.BggPublicKey(a, False), None))
        pubs.append(SimpleNamespace(plaintext=ns.poly.Poly.const(p, 0, **ns.kw)))
    return pks, encs, pubs


def _bits_and_masks(q):
    rng = random.Random(12)
    bits = [1, 0, 1, 1]
    return bits, [rng.randrange(-(q // 4) + 1, q // 4) for _ in bits]


def test_stand_in_sampler_targets_artifacts_and_decode_equal(tmp_path):
    """Both packages with preimage_sampler = identity: the stored artifacts
    are the targets, byte for byte, and decoder_state = [sigma, 1] makes
    `online_decode` the ideal decode."""
    stored, decoded = [], []
    for pkg in BOTH:
        ns = _ns(pkg)
        p = ns.params
        sigma = ns.sampler.UniformSampler(seed=31, **ns.kw).sample_poly(p, ns.sampler.TernaryDist())
        bits, masks = _bits_and_masks(p.modulus)
        pks, encs, pubs = _encodings(ns, sigma, bits, masks)
        arts = ns.decoder.DirectoryDecoderArtifacts(tmp_path / pkg, "mhb")
        dec = ns.decoder.MaskedHighBitDecoder(p, 1, arts, lambda idx, target: target,
                                              lambda idx: f"out{idx}")
        for i, a in enumerate(pks):
            dec.preprocess_public_key_matrix(i, a)
        stored.append([arts.read_artifact(f"out{i}") for i in range(len(pks))])
        state = ns.PolyMatrix.from_poly_row(p, [sigma, ns.poly.Poly.const(p, 1, **ns.kw)])
        out = dec.online_decode(ns.mhb.MaskedHighBitOnlineInput(
            state, [ns.mhb.MaskedHighBitEvaluatedOutput(encs[:2], pubs[:2]),
                    ns.mhb.MaskedHighBitEvaluatedOutput(encs[2:], pubs[2:])], [2, 2]))
        decoded.append(out)
        assert [o[0] for o in out] == [bits[0], bits[2]]
        assert out[0][p.n] == bits[1] and out[1][p.n] == bits[3]
    assert stored[0] == stored[1]
    assert decoded[0] == decoded[1]


def test_masked_high_bit_decoder_end_to_end(tmp_path):
    """The port's own run with real trapdoor preimages (secret_size 1, a
    size-2 trapdoor: targets have two rows)."""
    p = RingParams.new(*ARGS)
    ns = _ns("mxx_tpu_torch")
    ns.params = p
    ts = TrapdoorSampler(p, 4.578, seed=41, device=CPU)
    td0, b0 = ts.trapdoor(p, 2)
    sigma = UniformSampler(seed=42, device=CPU).sample_poly(p, TernaryDist())
    state0 = PolyMatrix.from_poly_row(p, [sigma, Poly.const(p, 1, CPU)]) @ b0
    bits, masks = _bits_and_masks(p.modulus)
    g = PolyMatrix.gadget_matrix(p, 1, CPU)
    pks, encs, pubs = [], [], []
    hs = HashSampler(CPU)
    for i, (bit, mask) in enumerate(zip(bits, masks)):
        a = hs.sample_hash(p, KEY, f"dec_pk_{i}", 1, p.modulus_digits, FinRingDist())
        w = ((p.modulus // 2) * bit + mask) % p.modulus
        bottom = -g.mul_poly_scalar(Poly.const(p, w, CPU))
        vec = state0 @ ts.preimage(p, td0, b0, a.concat_rows([bottom]))
        pks.append(a)
        encs.append(BggEncoding(vec, BggPublicKey(a, False), None))
        pubs.append(SimpleNamespace(plaintext=Poly.const(p, 0, CPU)))
    arts = DirectoryDecoderArtifacts(tmp_path, "mhb")
    targets = {}

    def sampler(idx, target):
        targets[idx] = target
        return ts.preimage(p, td0, b0, target)

    dec = MaskedHighBitDecoder(p, 1, arts, sampler, lambda idx: f"out{idx}")
    for i, a in enumerate(pks):
        dec.preprocess_public_key_matrix(i, a)
        assert targets[i].shape == (2, 1)
        assert targets[i] == dec.projected_public_key_target(a)
        assert b0 @ arts.read_matrix(p, f"out{i}", CPU) == targets[i]
    out = dec.online_decode(MaskedHighBitOnlineInput(
        state0, [MaskedHighBitEvaluatedOutput([e], [b]) for e, b in zip(encs, pubs)],
        [2] * len(bits)))
    assert [o[0] for o in out] == bits
    # an offset start reads the later artifacts
    out2 = dec.online_decode(MaskedHighBitOnlineInput(
        state0, [MaskedHighBitEvaluatedOutput([encs[2]], [pubs[2]])], [2]), initial_offset=2)
    assert out2[0][0] == bits[2]
    assert convert.to_numpy(dec.identity_selector(CPU)).shape == (p.crt_depth, 1, 1, p.n)
