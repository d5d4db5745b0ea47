"""ChaCha20 counter-mode PRNG with a full 256-bit keyspace, on int64 tensors.

The port's counterpart of `mxx_tpu/sampler/chacha.py`, giving the same
keystream words bit for bit. A key is an int64 tensor of 8 words (each in
[0, 2^32)) on the device where draws are made; callers hold it, and a
counter, explicitly. It is not a `torch.Generator`, whose numbers differ.

RFC-8439 ChaCha20 block function over many blocks; the 16-word state is
[4 consts, 8 key words, 1 block counter, 3 nonce words], with the three nonce
words carrying (counter_hi, stream word, purpose tag) so that the
`random_bits` / `fold_in` / `split` streams never collide.

Every entry makes its words through `_keystream`: for a key on a CUDA
device it launches the kernel of `csrc/chacha20.cu` (one thread per block,
words written straight into the layout returned) on that device's current
stream; for a key on the CPU it takes the plain twin `_chacha_words`, 32-bit
arithmetic in int64 masked after every add and rotate. Box-Muller
(`normal`) stays in torch on either device.

Each public entry that makes keystream (`normal`, `random_bits`, `fold_in`,
`split` and the `*_batch` entries) is one `chacha.draw` span (the outer
entry only, where one calls another), and the blocks it makes are counted
in `chacha.blocks`: the samplers' layer in the port's traces. Kernel
launches are counted in `chacha.kernel_launches` and their blocks in
`chacha.kernel_blocks`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..ops import cuda_build
from ..utils import tracing

# Domain tags for the third nonce word (never reuse a (counter, nonce) pair
# across purposes under one key).
_DOMAIN_BITS = 1
_DOMAIN_FOLD = 2
_DOMAIN_SPLIT = 3
_DOMAIN_NORMAL = 5

SOURCE = "chacha20.cu"

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_M32 = 0xFFFFFFFF
_N_ROUNDS = 20
# Blocks per pass on the CPU. A pass's ops cover [4, 2^13] words, torch's
# grain for one thread: larger ops run on several threads, which thrash when
# processes share the cores (as the test workers do), and ops over millions
# of words ran slower per word there (buffers past the allocator's reuse
# threshold are mapped afresh). Elsewhere the twin takes one pass.
_CPU_BLOCKS = 1 << 13


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & _M32) | (x >> (32 - n))


def _quarter_rounds(a, b, c, d):
    """Four quarter rounds at once: row i of a, b, c, d ([4, nblocks]) is one
    quarter round's (a, b, c, d)."""
    a = (a + b) & _M32
    d = _rotl(d ^ a, 16)
    c = (c + d) & _M32
    b = _rotl(b ^ c, 12)
    a = (a + b) & _M32
    d = _rotl(d ^ a, 8)
    c = (c + d) & _M32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def _chacha_words(key8: torch.Tensor, counters: torch.Tensor, nonce0: int, nonce1: int,
                  nonce2: int) -> torch.Tensor:
    """Final ChaCha20 state words (rounds + feed-forward), int64[16, nblocks].

    key8: int64[8], or int64[nblocks, 8] for a key per block; counters:
    int64[nblocks]; nonces: ints < 2^32. The state is held as four rows of
    four words: a column round is the four quarter rounds on the rows as
    they stand, a diagonal round the same after rotating rows b, c, d by 1,
    2, 3 (about 650 tensor ops per call, not 2,300 with one op per word)."""
    nb = counters.shape[0]
    if counters.device.type == "cpu" and nb > _CPU_BLOCKS:
        return torch.cat([
            _chacha_words(key8 if key8.dim() == 1 else key8[i : i + _CPU_BLOCKS],
                          counters[i : i + _CPU_BLOCKS], nonce0, nonce1, nonce2)
            for i in range(0, nb, _CPU_BLOCKS)
        ], dim=1)

    def full(v):
        return torch.full((nb,), v, dtype=torch.int64, device=counters.device)

    init = torch.stack([full(c) for c in _SIGMA] + [key8[..., i].expand(nb) for i in range(8)]
                       + [counters, full(nonce0), full(nonce1), full(nonce2)])
    a, b, c, d = init[0:4], init[4:8], init[8:12], init[12:16]
    for _ in range(_N_ROUNDS // 2):
        a, b, c, d = _quarter_rounds(a, b, c, d)
        a, b, c, d = _quarter_rounds(a, b.roll(-1, 0), c.roll(-2, 0), d.roll(1, 0))
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(-1, 0)
    return (torch.cat([a, b, c, d]) + init) & _M32


def _plain(keys: torch.Tensor, counters: torch.Tensor | None, nblocks: int, nwords: int,
           counter0: int, nonces: tuple) -> torch.Tensor:
    """`_keystream` by the plain twin (`_chacha_words`), on any device."""
    nkeys = keys.shape[0]
    if counters is None:
        counters = ((torch.arange(nblocks, dtype=torch.int64, device=keys.device)
                     + counter0) & _M32).repeat(nkeys)
    lane_keys = keys[0] if nkeys == 1 else keys.repeat_interleave(nblocks, dim=0)
    words = _chacha_words(lane_keys, counters, *nonces)  # [16, nkeys * nblocks]
    words = words.reshape(16, nkeys, nblocks).transpose(0, 1).reshape(nkeys, 16 * nblocks)
    return words[:, :nwords]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_build.load(SOURCE).mxx_chacha20
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_uint] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build() -> float:
    """Build (or load) the kernel library; seconds spent compiling."""
    _kernel()
    return cuda_build.build_seconds(SOURCE)


def _launch(keys: torch.Tensor, counters: torch.Tensor | None, nblocks: int, nwords: int,
            counter0: int, nonces: tuple) -> torch.Tensor:
    """`_keystream` by the kernel of csrc/chacha20.cu, on the keys' device
    and its current stream."""
    if keys.device.type != "cuda":
        raise ValueError(f"ChaCha20 kernel needs a CUDA tensor, got {keys.device}")
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 8:
        raise ValueError(f"ChaCha20 kernel takes int64 keys [nkeys, 8], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    nkeys = keys.shape[0]
    keys = keys.contiguous()
    if counters is not None:
        if counters.dtype != torch.int64 or counters.shape != (nkeys * nblocks,):
            raise ValueError("ChaCha20 kernel takes int64 counters, one per block")
        if counters.device != keys.device:
            raise ValueError(f"counters on {counters.device}, keys on {keys.device}")
        counters = counters.contiguous()
    out = torch.empty((nkeys, nwords), dtype=torch.int64, device=keys.device)
    if nkeys == 0 or nwords == 0:
        return out
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = _kernel()(keys.data_ptr(), None if counters is None else counters.data_ptr(),
                        out.data_ptr(), nkeys, nblocks, nwords, counter0 & _M32,
                        *(v & _M32 for v in nonces), stream)
    if err != 0:
        raise RuntimeError(f"ChaCha20 kernel launch failed: cudaError {err}")
    tracing.count("chacha.kernel_launches")
    tracing.count("chacha.kernel_blocks", nkeys * nblocks)
    return out


def _keystream(keys: torch.Tensor, nwords: int, nblocks: int, *, counters=None,
               counter0: int = 0, nonces: tuple = (0, 0, 0)) -> torch.Tensor:
    """int64[nkeys, nwords] of keystream: key k (row k of keys int64[nkeys,
    8]) makes blocks b < nblocks, block b with counter counters[k * nblocks
    + b] if counters (int64[nkeys * nblocks], < 2^32) is given, else
    (counter0 + b) mod 2^32, and the nonce words `nonces`; row k holds word
    w of its block b at w * nblocks + b, cut at nwords <= 16 nblocks.
    Counted in `chacha.blocks` (64 bytes each)."""
    tracing.count("chacha.blocks", keys.shape[0] * nblocks)
    if keys.device.type == "cpu":
        return _plain(keys, counters, nblocks, nwords, counter0, nonces)
    return _launch(keys, counters, nblocks, nwords, counter0, nonces)


def _keystream_words(key8: torch.Tensor, nwords: int, domain: int) -> torch.Tensor:
    """int64[nwords] of keystream under (key, domain), word-major across
    blocks (index = word * nblocks + block), as the JAX package orders it."""
    nblocks = -(-nwords // 16)
    return _keystream(key8[None], nwords, nblocks, nonces=(nblocks >> 32, 0, domain))[0]


def fold_in_batch(keys: torch.Tensor, datas: torch.Tensor) -> torch.Tensor:
    """Per-lane `fold_in`: keys int64[nb, 8], datas int64[nb] (< 2^32). Row i
    is bit-identical to `fold_in(keys[i], datas[i])`."""
    with tracing.span("chacha.draw"):
        return _keystream(keys, 8, 1, counters=datas, nonces=(0, 0, _DOMAIN_FOLD))


def keystream_words_batch(keys: torch.Tensor, nwords: int, domain: int) -> torch.Tensor:
    """int64[nb, nwords]: row i is bit-identical to
    `_keystream_words(keys[i], nwords, domain)` (the same word-major block
    order), computed as one flat batch of nb * nblocks blocks."""
    with tracing.span("chacha.draw"):
        return _keystream_words_batch(keys, nwords, domain)


def _keystream_words_batch(keys: torch.Tensor, nwords: int, domain: int) -> torch.Tensor:
    return _keystream(keys, nwords, -(-nwords // 16), nonces=(0, 0, domain))


def random_bits_batch(keys: torch.Tensor, shape: tuple, domain: int | None = None) -> torch.Tensor:
    """int64[nb, *shape] in [0, 2^32): row i is bit-identical to
    `random_bits(keys[i], shape)`."""
    n = math.prod(shape) if shape else 1
    with tracing.span("chacha.draw"):
        words = _keystream_words_batch(keys, n, _DOMAIN_BITS if domain is None else domain)
        return words.reshape((keys.shape[0],) + tuple(shape))


# ------------------------------------------------------------------ key API


def key_from_bytes(key_bytes: bytes, device="cuda") -> torch.Tensor:
    """Wrap a full 32-byte key as an int64[8] key tensor (no entropy loss)."""
    if len(key_bytes) != 32:
        raise ValueError("chacha key must be 32 bytes")
    words = np.frombuffer(key_bytes, dtype="<u4").astype(np.int64)
    return torch.from_numpy(words).to(device)


def fold_in(key8: torch.Tensor, data: int) -> torch.Tensor:
    """New key = first 8 keystream words of block(counter=data_lo,
    nonce0=data_hi, domain FOLD), for an integer 0 <= data < 2^64."""
    data = int(data)
    with tracing.span("chacha.draw"):
        return _keystream(key8[None], 8, 1, counter0=data & _M32,
                          nonces=(data >> 32, 0, _DOMAIN_FOLD))[0]


def split(key8: torch.Tensor, num: int = 2) -> torch.Tensor:
    """int64[num, 8] of derived keys (domain SPLIT keystream)."""
    with tracing.span("chacha.draw"):
        return _keystream_words(key8, num * 8, _DOMAIN_SPLIT).reshape(num, 8)


def split2(key8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    ks = split(key8, 2)
    return ks[0], ks[1]


def _u64_from_words(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The int64 with the bits of the uint64 hi * 2^32 + lo (two's
    complement), formed without overflowing a signed product."""
    return (hi - ((hi >> 31) << 32)) * (1 << 32) + lo


def random_bits(key8: torch.Tensor, shape: tuple, dtype: str = "uint32") -> torch.Tensor:
    """Uniform random bits under (key, BITS domain), as int64.

    dtype "uint32": values in [0, 2^32). dtype "uint64": the bits of the
    JAX package's uint64 draw, as two's-complement int64 (view them as
    uint64 with numpy to compare)."""
    n = math.prod(shape) if shape else 1
    if dtype not in ("uint32", "uint64"):
        raise ValueError(f"unsupported dtype {dtype}")
    with tracing.span("chacha.draw"):
        if dtype == "uint64":
            words = _keystream_words(key8, 2 * n, _DOMAIN_BITS)
            return _u64_from_words(words[0::2], words[1::2]).reshape(shape)
        return _keystream_words(key8, n, _DOMAIN_BITS).reshape(shape)


def normal(key8: torch.Tensor, shape: tuple, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normals via Box-Muller over the NORMAL-domain keystream."""
    n = math.prod(shape) if shape else 1
    pairs = -(-n // 2)
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"unsupported dtype {dtype}")
    with tracing.span("chacha.draw"):
        words = _keystream_words(key8, (4 if dtype == torch.float64 else 2) * pairs,
                                 _DOMAIN_NORMAL)
        return _box_muller(words, n, dtype).reshape(shape)


def _box_muller(words: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """n standard normals of `dtype` from the NORMAL-domain words of `normal`
    (2 per pair in float32, 4 in float64), in torch on the words' device."""
    if dtype == torch.float64:
        # (0, 1]: the top 53 bits of each uint64 word pair, +1 keeps log() finite
        top53 = (words[1::2] << 21) | (words[0::2] >> 11)
        u = (top53.to(torch.float64) + 1.0) * (2.0**-53)
    else:
        u = (words.to(torch.float32) + 1.0) * (2.0**-32)
    pairs = u.shape[0] // 2
    u1, u2 = u[:pairs], u[pairs:]
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * np.pi) * u2
    z = torch.cat([r * torch.cos(theta), r * torch.sin(theta)])
    return z[:n]


def self_test_vector(device="cuda") -> bool:
    """RFC 8439 §2.3.2 test vector for the block function."""
    key8 = key_from_bytes(bytes(range(32)), device)
    # RFC nonce = 00:00:00:09:00:00:00:4a:00:00:00:00, counter = 1
    blk = _keystream(key8[None], 16, 1, counter0=1, nonces=(0x09000000, 0x4A000000, 0))[0]
    expected = [
        0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3,
        0xC7F4D1C7, 0x0368C033, 0x9AAA2204, 0x4E6CD4C3,
        0x466482D2, 0x09AA9F07, 0x05D7C214, 0xA2028BD9,
        0xD19C12B5, 0xB94E16DE, 0xE883D0CB, 0x4E3C50A2,
    ]
    return blk.cpu().tolist() == expected
