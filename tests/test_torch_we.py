"""mxx_tpu_torch's Diamond witness encryption against mxx_tpu, on the CPU:

- the hash-derived BGG+ public keys (one, k, witness) and r equal the JAX
  package's bit for bit;
- both messages round-trip on the port for the OR circuit of
  tests/test_diamond_we.py, without noise and in the noisy regime of
  tests/test_noise_regime.py (n=256, injector and encoding sigma 4.0);
- a ciphertext of the JAX package (carried over by `convert`, its artifact
  files read as they are) decrypts with the port's `dec`.

The output preimages are float-Gaussian draws, so they are held by the
decode, not by the JAX package's bits.
"""

import numpy as np
import pytest

import mxx_tpu  # noqa: F401
from mxx_tpu.circuit import PolyCircuit as JaxPolyCircuit
from mxx_tpu.input_injector import DiamondInjector as JaxDiamondInjector
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.we import DiamondWE as JaxDiamondWE

from mxx_tpu_torch import convert
from mxx_tpu_torch.circuit import PolyCircuit
from mxx_tpu_torch.input_injector import DiamondInjector
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.we import DiamondWE

ARGS = (16, 4, 28, 7)
SIGMA = 4.578
SHAPE = (2, 2, 1)  # input_count, base, batch_bits: one witness bit per digit
TAG = b"diamond_we_port"


def _eq(mine, theirs):
    assert mine.fmt == theirs.fmt
    np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))


def _or_circuit(cls):
    """OR(w0, w1) over two witness bits and one instance bit."""
    c = cls()
    ins = c.input(3)
    c.output([c.or_gate(ins[0], ins[1])])
    return c


@pytest.mark.parametrize("seed", [5, 200])
def test_we_public_keys_and_r_equal(seed, tmp_path):
    p, jp = RingParams.new(*ARGS), JaxRingParams.new(*ARGS)
    we = DiamondWE(DiamondInjector(p, *SHAPE, SIGMA, 0.0, seed=seed, device="cpu"), 2, tmp_path, TAG, seed)
    jwe = JaxDiamondWE(JaxDiamondInjector(jp, *SHAPE, SIGMA, 0.0, seed=seed), 2, tmp_path, TAG,
                       seed)
    hash_key = bytes([seed % 256] * 32)  # what enc derives from a seed
    one, k_pk, wits = we._sample_bgg_public_keys(hash_key)
    jone, jk_pk, jwits = jwe._sample_bgg_public_keys(hash_key)
    for mine, theirs in zip([one, k_pk] + wits, [jone, jk_pk] + jwits):
        _eq(mine.matrix, theirs.matrix)
        assert mine.reveal_plaintext == theirs.reveal_plaintext
    assert len(wits) == len(jwits) == 2
    _eq(we._sample_r(hash_key), jwe._sample_r(hash_key))


@pytest.mark.parametrize("msg", [False, True])
@pytest.mark.parametrize("args,shape,error_sigma", [
    ((4, 2, 17, 1), SHAPE, 0.0),
    ((256, 5, 28, 7), SHAPE, 4.0),
])
def test_we_roundtrip(args, shape, error_sigma, msg, tmp_path):
    p = RingParams.new(*args)
    injector = DiamondInjector(p, *shape, SIGMA, error_sigma, seed=90 + msg, device="cpu")
    we = DiamondWE(injector, 2, tmp_path, TAG, seed=91 + msg)
    ct = we.enc(msg, _or_circuit(PolyCircuit), [False])
    assert ct.preprocess_out.final_state_count == 1 + shape[0] * shape[2]
    # w0 | w1 == 1 satisfies the relation; the decode gives the message
    assert we.dec(ct, [False, True]) == msg
    assert we.dec(ct, [True, False]) == msg


def test_jax_ciphertext_decrypts_on_port(tmp_path):
    """One JAX encryption of True (its first call compiles every shape, the
    most of this test's time)."""
    p, jp = RingParams.new(*ARGS), JaxRingParams.new(*ARGS)
    jwe = JaxDiamondWE(JaxDiamondInjector(jp, *SHAPE, SIGMA, 4.0, seed=17), 2, tmp_path, TAG, 18)
    jct = jwe.enc(True, _or_circuit(JaxPolyCircuit), [False])
    pre = jct.preprocess_out
    ct = convert.diamond_we_ciphertext_from_numpy(
        p, _or_circuit(PolyCircuit), jct.instance, jct.hash_key,
        [(np.asarray(t.r.data), np.asarray(t.e.data), t.r.fmt) for t in pre.final_trapdoors],
        [(np.asarray(b.data), b.fmt) for b in pre.final_pub_matrices], device="cpu",
    )
    assert ct.hash_key == jct.hash_key and ct.instance == [False]
    for mine, theirs in zip(ct.preprocess_out.final_pub_matrices, pre.final_pub_matrices):
        _eq(mine, theirs)
    # the port reads the JAX package's artifact directory as it is
    we = DiamondWE(DiamondInjector(p, *SHAPE, SIGMA, 4.0, seed=0, device="cpu"), 2, tmp_path, TAG, seed=0)
    assert we.dec(ct, [False, True]) is True
