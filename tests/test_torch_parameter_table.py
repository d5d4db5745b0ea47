"""The port at the production depth, and its parameter-table entry points,
against the JAX package.

- `RingParams.new(65536, d, 28, 14)` has the JAX package's moduli for the
  table's depths d in {50, 51, 53, 55};
- the d=1 trapdoor at L=53 (k = 106 digits), n=16, is bit for bit the JAX
  package's from the same seeds, and the port's preimage there holds
  B x == U exactly on its own trapdoor and on the JAX package's;
- `mxx_tpu_torch/scripts/security100_parameter_table.py`: its measurer runs
  and checks its relation; `table_rows(anchors)` equals, field for field, the
  rows of `scripts/security100_parameter_table.py`'s `main()` (run with
  SKIP_TPU=1 in a temporary directory, since it writes `bench/` relative to
  the working directory) for the same anchors, and the CSVs have the same
  columns;
- (`slow`) `mxx_tpu_torch/scripts/diamond_io_bench_estimate.py`'s first row
  equals `scripts/diamond_io_bench_estimate.py`'s under the same fixed costs.
"""

import csv
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

import mxx_tpu  # noqa: F401
import mxx_tpu.bench_estimator
import mxx_tpu.io_protocols.bench_estimator
from mxx_tpu.matrix import PolyMatrix as JaxPolyMatrix
from mxx_tpu.ring.params import RingParams as JaxRingParams
from mxx_tpu.sampler import FinRingDist as JaxFinRingDist
from mxx_tpu.sampler import TrapdoorSampler as JaxTrapdoorSampler
from mxx_tpu.sampler import UniformSampler as JaxUniformSampler

import jax.numpy as jnp

from mxx_tpu_torch import convert
from mxx_tpu_torch.bench_estimator import GateCostModel
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import EVAL
from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler
from mxx_tpu_torch.scripts import diamond_io_bench_estimate as estimate_script
from mxx_tpu_torch.scripts import security100_parameter_table as table

ROOT = Path(__file__).resolve().parents[1]
PROD_DEPTH = (16, 53, 28, 14)  # the production depth at a toy ring degree
SIGMA = 4.578


def _jax_script(name: str, monkeypatch):
    """`scripts/<name>.py` as a module; it prepends "." to sys.path when it
    loads, which the monkeypatched copy of sys.path undoes after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed_dicts(module, monkeypatch) -> list:
    """Every dict the module's code prints (the scripts print each row)."""
    rows = []
    monkeypatch.setattr(module, "print",
                        lambda *a, **k: rows.extend(x for x in a if isinstance(x, dict)),
                        raising=False)
    return rows


def _same(mine, theirs):
    assert mine.fmt == theirs.fmt
    np.testing.assert_array_equal(convert.to_numpy(mine), np.asarray(theirs.data))


@pytest.mark.parametrize("depth", sorted(table.REF_DEPTHS.values()))
def test_production_moduli_equal(depth):
    p, jp = RingParams.new(65536, depth, 28, 14), JaxRingParams.new(65536, depth, 28, 14)
    assert tuple(p.moduli) == tuple(int(q) for q in jp.moduli)
    assert p.modulus == jp.modulus
    assert p.modulus_digits == jp.modulus_digits == 2 * depth


def test_trapdoor_at_production_depth_equal():
    p, jp = RingParams.new(*PROD_DEPTH), JaxRingParams.new(*PROD_DEPTH)
    td, a = TrapdoorSampler(p, SIGMA, seed=3, device="cpu").trapdoor(p, 1)
    jtd, ja = JaxTrapdoorSampler(jp, SIGMA, seed=3).trapdoor(jp, 1)
    assert a.shape == (1, 108)
    _same(td.r, jtd.r)
    _same(td.e, jtd.e)
    _same(a, ja)


@pytest.mark.parametrize("trapdoor_from", ["port", "jax"])
def test_preimage_at_production_depth(trapdoor_from):
    p = RingParams.new(*PROD_DEPTH)
    if trapdoor_from == "port":
        td, a = TrapdoorSampler(p, SIGMA, seed=3, device="cpu").trapdoor(p, 1)
        target = UniformSampler(seed=5, device="cpu").sample_uniform(p, 1, 3, FinRingDist())
    else:
        jp = JaxRingParams.new(*PROD_DEPTH)
        jtd, ja = JaxTrapdoorSampler(jp, SIGMA, seed=11).trapdoor(jp, 1)
        jtarget = JaxUniformSampler(seed=12).sample_uniform(jp, 1, 3, JaxFinRingDist())
        td = convert.trapdoor_from_numpy(p, np.asarray(jtd.r.data), np.asarray(jtd.e.data),
                                         jtd.r.fmt, device="cpu")
        a = convert.poly_matrix_from_numpy(p, np.asarray(ja.data), ja.fmt, device="cpu")
        target = convert.poly_matrix_from_numpy(p, np.asarray(jtarget.data), jtarget.fmt,
                                                device="cpu")
    x = TrapdoorSampler(p, SIGMA, seed=13, device="cpu").preimage(p, td, a, target)
    assert x.shape == (108, 3) and x.fmt == EVAL and x.data.shape == (53, 108, 3, 16)
    assert (a @ x) == target
    if trapdoor_from == "jax":  # and the JAX package agrees that it is a preimage
        jx = JaxPolyMatrix(jnp.asarray(convert.to_numpy(x)), x.fmt, jp)
        assert (ja @ jx) == jtarget


def test_measure_preimage_cols_per_s_on_cpu(monkeypatch):
    assert table.measure_preimage_cols_per_s(16, 53, 1, 2, device="cpu") > 0
    run = table.measure_preimage(16, 53, 1, 2, device="cpu")
    assert len(run["call_ms"]) == 2 and run["held_bytes"] == 0
    # a preimage that misses its relation raises: one more in x's entry of
    # B's identity column moves B x by one
    real = TrapdoorSampler.preimage

    def off_by_one(self, params, trapdoor, b, target):
        x = real(self, params, trapdoor, b, target)
        data = x.data.clone()
        data[0, 1, 0, 0] = (data[0, 1, 0, 0] + 1) % params.moduli[0]
        return PolyMatrix(data, x.fmt, params)

    monkeypatch.setattr(TrapdoorSampler, "preimage", off_by_one)
    with pytest.raises(RuntimeError, match="B x != U"):
        table.measure_preimage_cols_per_s(16, 53, 1, 2, device="cpu")


def _read_csv(path: Path):
    with path.open() as f:
        lines = f.read().splitlines()
    header = [ln for ln in lines if ln.startswith("#")]
    return header, list(csv.DictReader(ln for ln in lines if not ln.startswith("#")))


def test_table_rows_equal_the_jax_script(monkeypatch, tmp_path):
    jax_table = _jax_script("security100_parameter_table", monkeypatch)
    printed = _printed_dicts(jax_table, monkeypatch)
    monkeypatch.setenv("SKIP_TPU", "1")
    monkeypatch.chdir(tmp_path)
    jax_table.main()
    anchors = dict(jax_table.ANCHORS_DEFAULT)

    rows = table.table_rows(anchors, device="cpu")
    assert len(rows) == len(printed) == 4
    for mine, theirs in zip(rows, printed):
        assert list(mine) == list(theirs)
        for key in mine:
            assert mine[key] == theirs[key] and type(mine[key]) is type(theirs[key]), key
    for name in ("N_PROD", "CRT_BITS", "BASE_BITS", "PARALLELISM", "CONFIGS", "FIT_GRID"):
        assert getattr(table, name) == getattr(jax_table, name), name

    out = tmp_path / "port.csv"
    table.write_csv(rows, "given by the test", out)
    header, mine_csv = _read_csv(out)
    _, theirs_csv = _read_csv(tmp_path / "bench" / "security_bits_100_diamond_io_parameters.csv")
    assert mine_csv == theirs_csv  # same columns, same values as written
    assert "# anchors: given by the test" in header


def test_main_with_anchors_writes_under_out(tmp_path, capsys):
    out = tmp_path / "t.csv"
    table.main(["--anchors", "8192=30.5,16384=15.25", "--out", str(out), "--device", "cpu"])
    header, rows = _read_csv(out)
    assert header[1] == "# anchors: given by the caller (--anchors 8192=30.5,16384=15.25)"
    assert [int(r["crt_depth"]) for r in rows] == [50, 51, 53, 55]
    # cols/s halves per doubling of n: alpha = 1, so x4 in n is a quarter
    assert {r["extrapolated_cols_per_s_n65536"] for r in rows} == {str(round(15.25 / 4, 2))}
    assert "wrote" in capsys.readouterr().out
    assert table.DEFAULT_OUT.parent == ROOT / "build" / "mxx_tpu_torch"
    with pytest.raises(ValueError):
        table.parse_anchors("8192=1.0")


@pytest.mark.slow
def test_estimate_first_row_equals_the_jax_script(monkeypatch, tmp_path):
    """`scripts/diamond_io_bench_estimate.py`'s first row (4 inputs of 2
    bits, n=256, L=3) with both measurers replaced by the same fixed costs,
    against the port's `estimate_row` (minutes per package on the CPU)."""
    costs = {"Add": 0.001, "Sub": 0.002, "Mul": 0.01, "SmallScalarMul": 0.003,
             "LargeScalarMul": 0.02, "PubLut": 0.05}
    jax_est = _jax_script("diamond_io_bench_estimate", monkeypatch)
    assert estimate_script.CONFIGS == jax_est.CONFIGS
    monkeypatch.setattr(jax_est, "CONFIGS", jax_est.CONFIGS[:1])
    monkeypatch.setattr(mxx_tpu.io_protocols.bench_estimator, "measure_preimage_cost",
                        lambda params: 0.25)
    monkeypatch.setattr(mxx_tpu.bench_estimator, "measure_bgg_encoding_costs",
                        lambda params: mxx_tpu.bench_estimator.GateCostModel(
                            dict(costs), default_cost=0.007))
    printed = _printed_dicts(jax_est, monkeypatch)
    monkeypatch.chdir(tmp_path)
    jax_est.main()

    mine = estimate_script.estimate_row(estimate_script.CONFIGS[0], 0.25,
                                        GateCostModel(dict(costs), default_cost=0.007),
                                        device="cpu")
    assert printed == [mine]
    assert mine["injector_preimages"] > 0 and mine["artifact_bytes"] > 0
