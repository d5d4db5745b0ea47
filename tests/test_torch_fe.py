"""mxx_tpu_torch's AKY24 functional encryption against mxx_tpu, on the CPU:

- `setup` (secrets, trapdoor, B), the keygen target A_f G^{-1}((q/2) e_last),
  the encodings and c_b (with and without table-Gaussian error) equal the
  JAX package's bit for bit;
- `dec` gives f(x) for all four inputs of the XOR function of
  tests/test_func_enc.py, at the default ring and with noise at n=16;
- keys and ciphertexts cross between the packages through `convert`: a JAX
  `keygen` key decodes port ciphertexts made under the JAX master key, and a
  JAX ciphertext decodes with a port key.

K_f is a preimage (float-Gaussian draws), so it is held to B K_f == target
and to the decode, not to the JAX package's bits.
"""

import numpy as np
import pytest

import mxx_tpu  # noqa: F401
from mxx_tpu.circuit import PolyCircuit as JaxPolyCircuit
from mxx_tpu.func_enc import Aky24FuncEnc as JaxAky24FuncEnc
from mxx_tpu.ring.params import RingParams as JaxRingParams

from mxx_tpu_torch import convert
from mxx_tpu_torch.circuit import PolyCircuit
from mxx_tpu_torch.func_enc import Aky24FuncEnc
from mxx_tpu_torch.ring.params import RingParams

DEFAULT = (4, 2, 17, 1)  # RingParams.default()
NOISY = (16, 3, 20, 5)  # tests/test_func_enc.py's noisy ring
INPUTS = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _eq(mine, theirs):
    assert mine.fmt == theirs.fmt
    np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))


def _pair(m):
    return np.asarray(m.data), m.fmt


def _split(wires):
    return wires[0], wires[1:]


def _xor(cls):
    c = cls()
    bits = c.input(2)
    c.output([c.xor_gate(bits[0], bits[1])])
    return c


def _port_and_jax(args, error_sigma, seed):
    p, jp = RingParams.new(*args), JaxRingParams.new(*args)
    return (p, Aky24FuncEnc(2, error_sigma, seed=seed, device="cpu"),
            jp, JaxAky24FuncEnc(2, error_sigma, seed=seed))


@pytest.mark.parametrize("error_sigma", [0.0, 3.0])
def test_fe_setup_target_encodings_equal(error_sigma):
    p, fe, jp, jfe = _port_and_jax(DEFAULT, error_sigma, 101)
    key, msk = fe.setup(p)
    jkey, jmsk = jfe.setup(jp)
    assert key == jkey == fe.hash_key
    for s, js in zip(msk.secrets, jmsk.secrets):
        _eq(s, js)
    _eq(msk.trapdoor.r, jmsk.trapdoor.r)
    _eq(msk.trapdoor.e, jmsk.trapdoor.e)
    _eq(msk.b_matrix, jmsk.b_matrix)
    # keygen's target A_f G^{-1}((q/2) e_last)
    a_f = _xor(PolyCircuit).eval(p, *_split(fe._pubkeys(p)))[0]
    ja_f = _xor(JaxPolyCircuit).eval(jp, *_split(jfe._pubkeys(jp)))[0]
    _eq(a_f.matrix @ fe._decode_selector(p), ja_f.matrix @ jfe._decode_selector(jp))
    # two encryptions: each call draws from its own subkey
    for msg in ([1, 0], [0, 1]):
        ct = fe.enc(p, msk, msg)
        jct = jfe.enc(jp, jmsk, msg)
        assert len(ct.encodings) == len(jct.encodings) == 3
        for e, je in zip(ct.encodings, jct.encodings):
            _eq(e.vector, je.vector)
            _eq(e.pubkey.matrix, je.pubkey.matrix)
            _eq(e.plaintext, je.plaintext)
        _eq(ct.c_b, jct.c_b)


@pytest.mark.parametrize("args,error_sigma", [(DEFAULT, 0.0), (NOISY, 3.0)])
def test_fe_dec_all_inputs(args, error_sigma):
    p = RingParams.new(*args)
    fe = Aky24FuncEnc(2, error_sigma, seed=102, device="cpu")
    func = _xor(PolyCircuit)
    _, msk = fe.setup(p)
    fsk = fe.keygen(p, msk, func)
    pubkeys = fe._pubkeys(p)
    target = func.eval(p, pubkeys[0], pubkeys[1:])[0].matrix @ fe._decode_selector(p)
    assert msk.b_matrix @ fsk.k_f == target
    for b0, b1 in INPUTS:
        assert fe.dec(p, fe.enc(p, msk, [b0, b1]), fsk, func) == b0 ^ b1, (b0, b1)


def test_fe_keys_and_ciphertexts_cross_packages():
    p, fe, jp, jfe = _port_and_jax(DEFAULT, 0.0, 103)
    func, jfunc = _xor(PolyCircuit), _xor(JaxPolyCircuit)
    _, jmsk = jfe.setup(jp)
    jfsk = jfe.keygen(jp, jmsk, jfunc)
    msk = convert.aky24_master_key_from_numpy(
        p, [_pair(s) for s in jmsk.secrets],
        (np.asarray(jmsk.trapdoor.r.data), np.asarray(jmsk.trapdoor.e.data),
         jmsk.trapdoor.r.fmt),
        _pair(jmsk.b_matrix), device="cpu",
    )
    fsk = convert.aky24_func_key_from_numpy(p, *_pair(jfsk.k_f), device="cpu")
    _eq(msk.b_matrix @ fsk.k_f, jmsk.b_matrix @ jfsk.k_f)
    # a JAX key decodes the port's ciphertexts under the JAX master key
    for b0, b1 in INPUTS:
        assert fe.dec(p, fe.enc(p, msk, [b0, b1]), fsk, func) == b0 ^ b1, (b0, b1)
    # a JAX ciphertext decodes with a key of the port
    own_fsk = fe.keygen(p, msk, func)
    for b0, b1 in [(1, 0), (1, 1)]:
        jct = jfe.enc(jp, jmsk, [b0, b1])
        ct = convert.aky24_ciphertext_from_numpy(
            p,
            [(_pair(e.vector), _pair(e.pubkey.matrix), e.pubkey.reveal_plaintext,
              None if e.plaintext is None else _pair(e.plaintext)) for e in jct.encodings],
            _pair(jct.c_b), device="cpu",
        )
        assert fe.dec(p, ct, own_fsk, func) == b0 ^ b1 == jfe.dec(jp, jct, jfsk, jfunc)
