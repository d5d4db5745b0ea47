"""The slice as a whole: mxx_tpu_torch's MP12 trapdoor and preimage against
mxx_tpu at the params of tests/test_sampler.py.

- trapdoor R, E and A equal the JAX package's bit for bit;
- preimages satisfy A x == U exactly, on the port's own trapdoor and on the
  JAX package's trapdoor carried over by `convert`;
- given identical standard normals, the G-lattice sampler and the p1 sampler
  match the JAX functions. Expected bit-exact; stated tolerance: at most one
  slot in 10^4 differs, by one rounding step (XLA may reorder float32 ops),
  and G z == syndrome holds exactly on every slot;
- importing the port never imports jax.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxx_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from mxx_tpu.matrix import PolyMatrix as JaxPolyMatrix
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.sampler import FinRingDist as JaxFinRingDist
from mxx_tpu.sampler import TrapdoorSampler as JaxTrapdoorSampler
from mxx_tpu.sampler import UniformSampler as JaxUniformSampler
from mxx_tpu.sampler import chacha as jax_chacha
from mxx_tpu.sampler import trapdoor as jax_trapdoor

from mxx_tpu_torch import convert
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import EVAL
from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler
from mxx_tpu_torch.sampler import trapdoor

ARGS = (16, 2, 20, 5)
SIGMA = 4.578
SLOTS = 10_000  # sampler slots per comparison: one may differ (1 in 10^4)


def _centered(x: np.ndarray, q: int) -> np.ndarray:
    x = x.astype(np.int64) % q
    return np.where(x > q // 2, x - q, x)


def _same(mine, theirs):
    assert mine.fmt == theirs.fmt
    np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))


@pytest.fixture
def normals_into_jax(monkeypatch):
    """Make the JAX package's `chacha.normal` return the given array (jit
    caches are cleared so that traced programs see the patch)."""

    def inject(arr: np.ndarray):
        def fake_normal(key, shape, dtype=jnp.float32):
            assert tuple(shape) == arr.shape, (shape, arr.shape)
            return jnp.asarray(arr, dtype=dtype)

        monkeypatch.setattr(jax_chacha, "normal", fake_normal)
        jax.clear_caches()

    yield inject
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("d", [1, 2])
def test_trapdoor_equal(d):
    p, jp = RingParams.new(*ARGS), JaxRingParams.new(*ARGS)
    td, a = TrapdoorSampler(p, SIGMA, seed=3, device="cpu").trapdoor(p, d)
    jtd, ja = JaxTrapdoorSampler(jp, SIGMA, seed=3).trapdoor(jp, d)
    _same(td.r, jtd.r)
    _same(td.e, jtd.e)
    _same(a, ja)


@pytest.mark.parametrize("d", [1, 2])
def test_preimage_on_own_trapdoor(d):
    p = RingParams.new(*ARGS)
    ts = TrapdoorSampler(p, SIGMA, seed=3, device="cpu")
    td, a = ts.trapdoor(p, d)
    k = p.modulus_digits
    target = UniformSampler(seed=5, device="cpu").sample_uniform(p, d, 3, FinRingDist())
    x = ts.preimage(p, td, a, target)
    assert x.shape == (d * (k + 2), 3) and x.fmt == EVAL
    assert (a @ x) == target
    # small entries: perturbation + digits + R/E products (tests/test_sampler.py bound)
    s = trapdoor.preimage_smoothing_parameter(p.base, SIGMA, d, p.n, k)
    lift = _centered(convert.to_numpy(x.to_coeff())[0], p.moduli[0])
    assert np.abs(lift).max() < 30 * s * math.sqrt(d * k * p.n)
    # a second call draws fresh randomness
    x2 = ts.preimage(p, td, a, target)
    assert (a @ x2) == target and not (x == x2)


@pytest.mark.parametrize("d", [1, 2])
def test_preimage_on_jax_trapdoor(d):
    p, jp = RingParams.new(*ARGS), JaxRingParams.new(*ARGS)
    jtd, ja = JaxTrapdoorSampler(jp, SIGMA, seed=11).trapdoor(jp, d)
    jtarget = JaxUniformSampler(seed=12).sample_uniform(jp, d, 4, JaxFinRingDist())
    td = convert.trapdoor_from_numpy(p, np.asarray(jtd.r.data), np.asarray(jtd.e.data), jtd.r.fmt, device="cpu")
    a = convert.poly_matrix_from_numpy(p, np.asarray(ja.data), ja.fmt, device="cpu")
    target = convert.poly_matrix_from_numpy(p, np.asarray(jtarget.data), jtarget.fmt, device="cpu")
    x = TrapdoorSampler(p, SIGMA, seed=13, device="cpu").preimage(p, td, a, target)
    assert (a @ x) == target
    # and the JAX package agrees that it is a preimage
    jx = JaxPolyMatrix(jnp.asarray(convert.to_numpy(x)), x.fmt, jp)
    assert (ja @ jx) == jtarget


def _gadget_residual(params, digits: np.ndarray, syndrome: np.ndarray) -> int:
    """Slots where G z != syndrome: per tower s, sum_j b^j z[s*dpt + j] must
    equal the syndrome mod q_s (row-major digits [r * L * dpt, cols, n])."""
    L, r, cols, n = syndrome.shape
    dpt = params.digits_per_tower
    z = digits.reshape(r, L, dpt, cols, n).astype(np.int64)
    bad = 0
    for s, q in enumerate(params.moduli):
        acc = sum(z[:, s, j] * (params.base**j % q) for j in range(dpt)) % q
        bad += int((acc != syndrome[s] % q).sum())
    return bad


@pytest.mark.parametrize("args", [ARGS, (16, 2, 20, 20), (16, 1, 24, 12)])
def test_gauss_samp_gq_equal_given_normals(args, normals_into_jax):
    """Tower digits from identical normals; dpt == 1 (20, 20) takes the
    direct coset path."""
    p = RingParams.new(*args)
    L, dpt, n = p.crt_depth, p.digits_per_tower, p.n
    cols = SLOTS // n // L
    rng = np.random.default_rng(sum(args))
    syn = np.stack([rng.integers(0, q, size=(1, cols, n), dtype=np.int64) for q in p.moduli])
    normals = rng.standard_normal((2, L, dpt, 1, cols, n)).astype(np.float32)
    c = trapdoor.preimage_c(p.base, SIGMA)
    kw = dict(base_bits=p.base_bits, dpt=dpt, moduli=tuple(p.moduli), sigma=SIGMA, c=c)
    got = trapdoor._gauss_samp_gq(torch.from_numpy(syn), torch.from_numpy(normals), **kw).numpy()
    normals_into_jax(normals)
    want = np.asarray(jax_trapdoor._gauss_samp_gq(jnp.asarray(syn.astype(np.uint32)),
                                                  jnp.zeros(8, jnp.uint32), **kw))
    assert got.shape == want.shape == (L * dpt, cols, n)
    assert _gadget_residual(p, got, syn) == 0
    assert _gadget_residual(p, want, syn) == 0
    per_slot = (got != want).reshape(L, dpt, cols * n).any(axis=1)
    assert per_slot.sum() <= max(1, per_slot.size // 10_000)
    # one rounding step moves a digit by at most b (own z) + 1 (neighbour's)
    # + the largest modulus digit (through z_last)
    assert np.abs(got.astype(np.int64) - want).max(initial=0) <= 2 * p.base


def test_sample_p1_ints_equal_given_normals(normals_into_jax):
    p = RingParams.new(*ARGS)
    ts = TrapdoorSampler(p, SIGMA, seed=31, device="cpu")
    td, a = ts.trapdoor(p, 1)
    k = p.modulus_digits
    s = trapdoor.preimage_smoothing_parameter(ts.base, SIGMA, 1, p.n, k)
    _, _, _, sqrt_var, upd = ts._operands(td, a, s)
    c_scale = -(ts.c**2) / (s * s - ts.c**2)
    cols = SLOTS // p.n
    rng = np.random.default_rng(7)
    tp2c = np.round(rng.normal(0, 3e4, size=(2, cols, p.n)))
    normals = rng.standard_normal((2, cols, p.n)).astype(np.float32)
    got = trapdoor._sample_p1_ints(torch.from_numpy(tp2c), sqrt_var, upd, c_scale,
                                   torch.from_numpy(normals)).numpy()
    normals_into_jax(normals)
    want = np.asarray(jax_trapdoor._sample_p1_ints(
        jnp.asarray(tp2c), jnp.asarray(sqrt_var.numpy()), jnp.asarray(upd.numpy()), c_scale,
        jnp.zeros(8, jnp.uint32)))
    assert got.shape == want.shape == (2, cols, p.n)
    per_slot = (got != want).any(axis=0)
    assert per_slot.sum() <= max(1, per_slot.size // 10_000)
    assert np.abs(got - want).max(initial=0) <= 1


def test_port_never_imports_jax():
    """Every module of mxx_tpu_torch imports with jax made unimportable, and
    none of them pulls in mxx_tpu."""
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import mxx_tpu_torch\n"
        "for m in pkgutil.walk_packages(mxx_tpu_torch.__path__, 'mxx_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'mxx_tpu' or k.startswith('mxx_tpu.') for k in sys.modules)\n"
        "assert 'mxx_tpu_torch.parallel.crt_collective' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for path in (root / "mxx_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "import mxx_tpu\n" not in text and "from mxx_tpu." not in text, path
