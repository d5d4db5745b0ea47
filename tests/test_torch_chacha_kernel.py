"""The ChaCha20 kernel (`csrc/chacha20.cu`) against its plain twin in
`mxx_tpu_torch/sampler/chacha.py`.

- On the CPU every entry takes the twin: no kernel launch is counted, and
  the wrapper refuses a CPU tensor rather than fall back. The twin's layout
  (lanes of several blocks, explicit counters) equals one key at a time.
- On the card (`cuda`-marked; skip without one) each public entry gives,
  bit for bit, the words the twin gives on CPU copies of the same keys:
  RFC 8439's vector, 1 block, a ragged word count, over 2^21 blocks, lane
  keys of several blocks, the draws of a preimage call at both benchmark
  rings, and a key on a second card where there is one. `normal` on the card
  equals Box-Muller on the card over the twin's words. A small preimage
  draws every block through the kernel, and equals, bit for bit, the same
  call with the twin on the card.

The card's machine has no jax, and this file imports none, so it runs there
with

    python -m pytest --noconftest -m cuda tests/test_torch_chacha_kernel.py
"""

import numpy as np
import pytest
import torch

from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler, chacha, core
from mxx_tpu_torch.utils import tracing

KERNEL = ("chacha.kernel_launches", "chacha.kernel_blocks")


def _keys(nb: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 32, size=(nb, 8), dtype=np.int64))


def _every_entry(key: torch.Tensor, keys: torch.Tensor) -> dict:
    """What each public entry gives for these keys (on their device), on the
    host."""
    datas = (torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device) * 7919) % (1 << 32)
    out = {
        "fold_in": [chacha.fold_in(key, d) for d in (0, 1, 2**31 + 3, 2**32 + 5, 2**64 - 1)],
        "fold_in_batch": chacha.fold_in_batch(keys, datas),
        "split": chacha.split(key, 5),
        "random_bits_u32": chacha.random_bits(key, (3, 37)),
        "random_bits_u64": chacha.random_bits(key, (2, 19), "uint64"),
        "random_bits_batch": chacha.random_bits_batch(keys, (2, 21)),
        "keystream_words_batch": chacha.keystream_words_batch(keys, 1000, 7),
        "normal_words_f32": chacha._keystream_words(key, 2 * 77, chacha._DOMAIN_NORMAL),
        "normal_words_f64": chacha._keystream_words(key, 4 * 77, chacha._DOMAIN_NORMAL),
    }
    return {k: [t.cpu() for t in v] if isinstance(v, list) else v.cpu() for k, v in out.items()}


def _assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], want[name]
        for a, b in zip(g, w) if isinstance(w, list) else [(g, w)]:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name


# ------------------------------------------------------------------ the CPU


def test_cpu_draws_take_the_twin():
    key = core.fresh_key(3, device="cpu")
    with tracing.recording() as rec:
        _every_entry(key, _keys(5, 1))
        chacha.normal(key, (4, 9), torch.float32)
        chacha.normal(key, (4, 9), torch.float64)
        assert chacha.self_test_vector(device="cpu")
    assert rec.counters["chacha.blocks"] > 0
    assert all(rec.counters[c] == 0 for c in KERNEL)


def test_kernel_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        chacha._launch(_keys(2, 0), None, 1, 16, 0, (0, 0, 0))


@pytest.mark.parametrize("nwords", [1, 16, 37, 1000])
def test_twin_lanes_equal_one_key_at_a_time(nwords):
    """Lanes of several blocks each, and explicit counters, against the same
    keystream key by key (`_keystream_words` on one key, `fold_in`)."""
    keys = _keys(4, nwords)
    rows = chacha.keystream_words_batch(keys, nwords, 5)
    for k in range(4):
        assert torch.equal(rows[k], chacha._keystream_words(keys[k], nwords, 5))
    datas = torch.tensor([0, 9, 2**31, 2**32 - 1])
    folded = chacha.fold_in_batch(keys, datas)
    for k in range(4):
        assert torch.equal(folded[k], chacha.fold_in(keys[k], int(datas[k])))


# ----------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rfc8439_vector_on_card(cuda_device):
    with tracing.recording() as rec:
        assert chacha.self_test_vector(device=cuda_device)
    assert rec.counters["chacha.kernel_launches"] == 1


@pytest.mark.cuda
def test_every_entry_equals_twin_on_card(cuda_device):
    key, keys = core.fresh_key(11, device="cpu"), _keys(7, 2)
    want = _every_entry(key, keys)
    with tracing.recording() as rec:
        got = _every_entry(key.to(cuda_device), keys.to(cuda_device))
        torch.cuda.synchronize()
    _assert_same(got, want)
    assert rec.counters["chacha.kernel_blocks"] == rec.counters["chacha.blocks"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nwords", [1, 16, 37, 16 * ((1 << 21) + 5) - 3])
def test_keystream_sizes_equal_twin_on_card(cuda_device, nwords):
    """1 word, 1 block, a ragged count, and over 2^21 blocks (ragged)."""
    key = core.fresh_key(nwords, device="cpu")
    got = chacha._keystream_words(key.to(cuda_device), nwords, chacha._DOMAIN_BITS)
    assert torch.equal(got.cpu(), chacha._keystream_words(key, nwords, chacha._DOMAIN_BITS))


@pytest.mark.cuda
@pytest.mark.parametrize("nb, nwords", [(1, 40), (3, 16), (5, 1000), (64, 3 * 2 * 16 + 5)])
def test_lane_keys_equal_twin_on_card(cuda_device, nb, nwords):
    keys = _keys(nb, nwords)
    got = chacha.keystream_words_batch(keys.to(cuda_device), nwords, 9)
    assert torch.equal(got.cpu(), chacha.keystream_words_batch(keys, nwords, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ["bench", "sec100"])
def test_preimage_call_draws_equal_twin_on_card(cuda_device, ring):
    """The three normal draws of one preimage call (p2, p1, the G-sampler's),
    at the benchmark's rings: 3.17 M blocks (n 2^14, L 10, 50 cols) and
    2.62 M (n 2^16, L 53, 2 cols)."""
    n, L, dpt, cols = (16384, 10, 2, 50) if ring == "bench" else (65536, 53, 2, 2)
    k = L * dpt
    shapes = [(k, cols, n), (2, cols, n), (2, L, dpt, 1, cols, n)]
    keys = chacha.split(core.fresh_key(L, device="cpu"), 3)
    blocks = 0
    for key, shape in zip(keys, shapes):
        nwords = 2 * (-(-int(np.prod(shape)) // 2))
        blocks += -(-nwords // 16)
        got = chacha._keystream_words(key.to(cuda_device), nwords, chacha._DOMAIN_NORMAL)
        want = chacha._keystream_words(key, nwords, chacha._DOMAIN_NORMAL)
        assert torch.equal(got.cpu(), want)
        normals = chacha.normal(key.to(cuda_device), shape, torch.float32)
        assert torch.equal(normals, chacha._box_muller(want.to(cuda_device), int(np.prod(shape)),
                                                       torch.float32).reshape(shape))
        del got, normals
    assert blocks == (3_174_400 if ring == "bench" else 2_621_440)


@pytest.mark.cuda
def test_key_on_a_second_card(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    key, keys = core.fresh_key(5, device="cpu"), _keys(3, 4)
    want = _every_entry(key, keys)
    got = _every_entry(key.to(dev), keys.to(dev))
    _assert_same(got, want)
    assert chacha.fold_in(key.to(dev), 9).device == dev


@pytest.mark.cuda
def test_preimage_draws_every_block_through_the_kernel(cuda_device, monkeypatch):
    params = RingParams.new(1024, 3, 24, 12)
    ts = TrapdoorSampler(params, 4.578, seed=5, device=cuda_device)
    td, a = ts.trapdoor(params, 1)
    target = UniformSampler(seed=6, device=cuda_device).sample_uniform(params, 1, 2,
                                                                      FinRingDist())
    ctr = ts._ctr
    with tracing.recording() as rec:
        x = ts.preimage(params, td, a, target)
        torch.cuda.synchronize()
    assert (a @ x) == target
    assert rec.counters["chacha.kernel_blocks"] == rec.counters["chacha.blocks"] > 0
    # the same call with the twin on the card gives the same preimage
    ts._ctr = ctr
    monkeypatch.setattr(chacha, "_launch", chacha._plain)
    with tracing.recording() as rec:
        y = ts.preimage(params, td, a, target)
    assert rec.counters["chacha.kernel_blocks"] == 0
    assert torch.equal(x.data, y.data)
