"""CPU tests of the benchmark harness (`portbench/`).

Run from the root of the repository: `python -m pytest portbench/tests -q`.
The `cuda`-marked test runs one short cell on the card
(`python -m pytest portbench/tests -m cuda`); it decides in a fixture.
"""

from __future__ import annotations

import ast
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import circuits, roofline  # noqa: E402
from portbench.harness import forbidden_loaded, run_cell  # noqa: E402
from portbench.reference.ring import Ring  # noqa: E402
from portbench.spec import Spec, SpecError  # noqa: E402

MIXES = ("preimage_2col", "preimage_50col", "bgg_encoding_pass")
TINY_RING = {"ring_dimension": 1024, "crt_depth": 3, "crt_bits": 24, "base_bits": 12}
SEED = 2**31 + 12345


def tiny_bench(tmp: Path, mixes=MIXES) -> Spec:
    """A BENCHMARK.json in `tmp` with the real metrics and mixes over a tiny
    ring, and the cells' files beside it: added files only."""
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "cells").mkdir(exist_ok=True)
    cfg = json.loads((ROOT / "portbench/configs/upstream_bench_n16384_L10.json").read_text())
    cfg.update(name="tiny", ring=TINY_RING)
    (tmp / "configs/tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    real = {w["traffic"]: w["name"] for w in bench["workloads"]}
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": f"tiny.{m}", "config": "tiny", "traffic": m, "chips": 1,
                           "why": "test"} for m in mixes]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny." + w.split(".", 1)[1] for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for m in mixes:
        counts = json.loads((ROOT / f"portbench/cells/{real[m]}.json").read_text())
        counts["name"] = f"tiny.{m}"
        (tmp / f"cells/tiny.{m}.json").write_text(json.dumps(counts))
    return Spec(tmp / "BENCHMARK.json", [tmp])


def test_every_cell_loads_by_name():
    spec = Spec(ROOT / "BENCHMARK.json")
    assert spec.cells
    for name, cell in spec.cells.items():
        cfg = spec.config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert spec.traffic(cell["traffic"])["name"] == cell["traffic"]
        assert spec.cell_counts(name)["name"] == name
        assert {m["name"] for m in spec.end_to_end(name)} >= {"setup_s", "peak_device_gib"}
        assert len(spec.end_to_end(name)) >= 2 and spec.per_layer(name)
    for m in spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in spec.bench["end_to_end"]}
        for w in m.get("workloads", []):
            assert w in spec.cells and m["moves"] in {e["name"] for e in spec.end_to_end(w)}


def test_a_file_that_breaks_its_schema_is_refused(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["run_seconds"] = 52
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SpecError):
        Spec(tmp_path / "BENCHMARK.json")
    bench["run_seconds"] = 30
    bench["end_to_end"][0]["why"] = "a key the contract does not have"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SpecError):
        Spec(tmp_path / "BENCHMARK.json")


@pytest.mark.parametrize("mix", MIXES)
def test_mix_end_to_end_on_the_cpu(tmp_path, mix):
    """A tiny ring runs the mix through the program and the reference judges
    it correct; the control (one bit less) is judged not correct."""
    spec = tiny_bench(tmp_path, (mix,))
    r = run_cell(spec, f"tiny.{mix}", SEED, 0.3, False, device_type="cpu", control=True)
    assert r["correct"] and not r["control_correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end(f"tiny.{mix}")}
    assert r["checks"]["answers_judged"]["value"] >= 1


def test_traced_run_reports_per_layer_metrics(tmp_path):
    spec = tiny_bench(tmp_path, ("preimage_2col",))
    r = run_cell(spec, "tiny.preimage_2col", SEED, 0.3, True, device_type="cpu")
    assert r["correct"]
    assert set(r["metrics"]) <= {m["name"] for m in spec.per_layer("tiny.preimage_2col")}
    assert "samplers.chacha_ms.preimage.sec100" in r["metrics"]
    assert r["device"]["window_s"] > 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_new_config_mix_cell_and_metric_are_files_only(tmp_path):
    """A dummy configuration, mix, cell and per-layer metric added from a
    directory of their own, with no file of portbench/ edited."""
    spec = tiny_bench(tmp_path, ("preimage_2col",))
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    mix = json.loads((ROOT / "portbench/traffic/preimage_2col.json").read_text())
    mix.update(name="dummy_3col", cols=3)
    (tmp_path / "traffic/dummy_3col.json").write_text(json.dumps(mix))
    (tmp_path / "metrics/dummy.calls.py").write_text(
        "def read(trace):\n    return float(trace['calls'])\n")
    cfg = json.loads((tmp_path / "configs/tiny.json").read_text())
    cfg.update(name="dummy", ring=dict(TINY_RING, crt_depth=4))
    (tmp_path / "configs/dummy.json").write_text(json.dumps(cfg))
    counts = json.loads((tmp_path / "cells/tiny.preimage_2col.json").read_text())
    counts["name"] = "dummy.dummy_3col"
    (tmp_path / "cells/dummy.dummy_3col.json").write_text(json.dumps(counts))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "test", "file": "configs/dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.dummy_3col", "config": "dummy",
                               "traffic": "dummy_3col", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "preimage_cols_per_s.dummy", "unit": "cols/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy.dummy_3col"]})
    bench["per_layer"].append({"name": "dummy.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "preimage_cols_per_s.dummy",
                               "workloads": ["dummy.dummy_3col"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(tmp_path / "BENCHMARK.json", [tmp_path])
    r = run_cell(spec, "dummy.dummy_3col", SEED, 0.3, True, device_type="cpu")
    assert r["correct"] and r["metrics"]["dummy.calls"]["value"] == 2.0
    # the split quantity's reader serves the new cell too, with no file added
    assert "samplers.chacha_ms.preimage.dummy" not in r["metrics"]
    assert spec.reader("samplers.chacha_ms.preimage.dummy") is not None
    r = run_cell(spec, "dummy.dummy_3col", SEED, 0.3, False, device_type="cpu")
    assert r["correct"] and r["metrics"]["preimage_cols_per_s.dummy"]["value"] > 0


def test_roofline_arithmetic():
    # [53, 212, 65536]: 11,236 polys; 7 instructions x 32,768 x 16 products each
    # over 64 x 132 x 1.98e9 per s, above 8 bytes per residue over 3.35 TB/s
    shape = [53, 212, 65536]
    int_ms = 11236 * 32768 * 16 * 7 / (64 * 132 * 1.98e9) * 1e3
    bytes_ms = 8 * 11236 * 65536 / 3.35e12 * 1e3
    assert int_ms > bytes_ms
    assert math.isclose(roofline.transform_bound_ms(shape), int_ms)
    # a short transform is bound by bytes: [10, 1000, 256]
    assert math.isclose(roofline.transform_bound_ms([10, 1000, 256]),
                        8 * 10000 * 256 / 3.35e12 * 1e3)
    counts = {"transforms_per_call": [{"direction": "fwd", "shape": shape, "count": 2},
                                      {"direction": "inv", "shape": [10, 1000, 256], "count": 1}]}
    assert math.isclose(roofline.call_bound_ms(counts),
                        2 * int_ms + 8 * 10000 * 256 / 3.35e12 * 1e3)


def test_reference_ring_agrees_with_the_definition():
    """The reference's EVAL form is the program's; its products are the
    negacyclic products of the schoolbook; G^-1 then G is the identity."""
    from mxx_tpu_torch.ring.ntt import ntt_fwd
    from mxx_tpu_torch.ring.params import RingParams

    ring = Ring(16, 3, 24, 12, "cpu")
    params = RingParams.new(16, 3, 24, 12)
    assert ring.moduli == params.moduli
    g = torch.Generator().manual_seed(1)
    a = torch.randint(0, 2**40, (3, 4, 16), generator=g) % ring.qb(3)
    b = torch.randint(0, 2**40, (3, 4, 16), generator=g) % ring.qb(3)
    t = params.tables("cpu")
    assert torch.equal(ring.fwd(a), ntt_fwd(a, t.psi_rev, t.moduli))
    assert torch.equal(ring.inv(ring.fwd(a)), a)
    prod = ring.inv(ring.fwd(a) * ring.fwd(b) % ring.qb(3))
    for limb, q in enumerate(ring.moduli):
        want = [0] * 16
        for i in range(16):
            for j in range(16):
                s = 1 if i + j < 16 else -1
                want[(i + j) % 16] += s * int(a[limb, 0, i]) * int(b[limb, 0, j])
        assert prod[limb, 0].tolist() == [w % q for w in want]
    m = torch.randint(0, 2**40, (3, 1, 2, 16), generator=g) % ring.qb(4)
    digits = ring.fwd(ring.decompose(m))
    back = ring.matmul(ring.gadget(1), digits)
    assert torch.equal(back, ring.fwd(m))


def test_circuit_has_the_online_pass_shape():
    spec = circuits.online_pass()
    ops = [g["op"] for g in spec["gates"]]
    assert len(ops) == 51 and ops.count("mul") == 16 and ops.count("sub") == 4
    assert ops.count("small") == 8 and ops.count("large") == 8 and ops.count("add") == 15
    assert circuits.to_program(spec).gate_counts()["Mul"] == 16


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_jax_or_the_jax_package(tmp_path):
    """By top-level name, whole: `mxx_tpu_torch` is not `mxx_tpu`. The
    reference imports nothing of the program either."""
    bad = {"jax", "jaxlib", "flax", "mxx_tpu"}
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = _imports(path)
        assert not names & bad, path
        if "reference" in path.parts:
            assert "mxx_tpu_torch" not in names, path
    code = ("import sys; sys.path.insert(0, %r); import json, torch; from pathlib import Path;"
            "from portbench.tests.test_portbench_harness import tiny_bench, SEED;"
            "from portbench.harness import run_cell, forbidden_loaded;"
            "spec = tiny_bench(Path(sys.argv[1]), ('preimage_2col', 'bgg_encoding_pass'));"
            "[run_cell(spec, c, SEED, 0.2, False, device_type='cpu') for c in spec.cells];"
            "print(json.dumps(forbidden_loaded()))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True,
                         cwd=ROOT, env={k: v for k, v in os.environ.items()
                                        if k != "PYTHONPATH"}, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert not set(forbidden_loaded()) - {"jax", "jaxlib", "flax", "mxx_tpu"}


def test_jax_loaded_by_the_judgement_refuses_the_result(tmp_path):
    """The look for JAX and the JAX package comes after the reference's
    judgement: a stub `mxx_tpu` imported there makes the run exit 3 and
    print no result."""
    code = ("import sys, types; sys.path.insert(0, %r); from pathlib import Path;"
            "from portbench.tests.test_portbench_harness import tiny_bench, SEED;"
            "from portbench.drivers.preimage import PreimageDriver;"
            "from portbench import run;"
            "real = PreimageDriver.judge;"
            "PreimageDriver.judge = lambda self, c: (sys.modules.setdefault("
            "'mxx_tpu', types.ModuleType('mxx_tpu')), real(self, c))[1];"
            "spec = tiny_bench(Path(sys.argv[1]), ('preimage_2col',));"
            "sys.exit(10 + run.report(spec, 'tiny.preimage_2col', SEED, 0.2, False, 'cpu'))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 13, out.stderr[-2000:]
    assert out.stdout == "" and "mxx_tpu" in out.stderr


def test_cli_refuses_without_enough_cards_and_without_the_program(tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "upstream_bench_n16384_L10.preimage_50col", "--seed", str(SEED), "--seconds", "1"]
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card's machine with -m cuda")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_a_short_cell_on_the_card(card):
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "upstream_bench_n16384_L10.preimage_50col", "--seed", str(SEED), "--seconds", "2"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["kind"] == card
