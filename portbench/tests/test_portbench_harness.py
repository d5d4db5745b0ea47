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

from portbench import circuits, roofline, tracing  # noqa: E402
from portbench.harness import forbidden_loaded, run_cell  # noqa: E402
from portbench.reference.ring import Ring  # noqa: E402
from portbench.spec import Spec, SpecError  # noqa: E402

MIXES = ("preimage_2col", "preimage_50col", "bgg_encoding_pass", "preimage_mesh4")
TINY_RING = {"ring_dimension": 1024, "crt_depth": 3, "crt_bits": 24, "base_bits": 12}
# A tiny ring's trapdoor has ~10^4 coefficients where a cell's has ~10^7, and an
# RMS gap's noise grows as one over the root of the count: the tiny cells judge
# every RMS gap at the one-card preimage cells' limit (a sound tiny run reads
# 0.005-0.014, the planted faults 0.5 and more).
TINY_RMS_GAP_LIMIT = 0.05
SEED = 2**31 + 12345


def tiny_bench(tmp: Path, mixes=MIXES) -> Spec:
    """A BENCHMARK.json in `tmp` with the real metrics and mixes over a tiny
    ring (the keys of the configuration that the mixes' drivers read), each
    cell on as many chips as the real cell of its mix, and the cells' files
    beside it, their RMS gaps judged at TINY_RMS_GAP_LIMIT: added files only."""
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "cells").mkdir(exist_ok=True)
    real_spec = Spec(ROOT / "BENCHMARK.json")
    named = set(json.loads((ROOT / "portbench/schema/config.schema.json").read_text())
                ["properties"])
    for m in mixes:
        named |= set(real_spec.driver(real_spec.traffic(m)["driver"]).CONFIG_SCHEMA["properties"])
    cfg = json.loads((ROOT / "portbench/configs/upstream_bench_n16384_L10.json").read_text())
    cfg = {k: v for k, v in cfg.items() if k in named}
    cfg.update(name="tiny", ring=TINY_RING)
    (tmp / "configs/tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    real = {w["traffic"]: w for w in bench["workloads"]}
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": f"tiny.{m}", "config": "tiny", "traffic": m,
                           "chips": real[m]["chips"], "why": "test"} for m in mixes]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny." + w.split(".", 1)[1] for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for m in mixes:
        counts = json.loads((ROOT / f"portbench/cells/{real[m]['name']}.json").read_text())
        counts["name"] = f"tiny.{m}"
        for key in counts["limits"]:
            if key.endswith("_rms_gap"):
                counts["limits"][key] = TINY_RMS_GAP_LIMIT
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


ECHO_DRIVER = '''"""A dummy driver: request i returns a vector made from the seed and i,
`width` long (a key of its mix) and scaled by `echo_scale` (a key of its
configuration); every kept answer is judged exactly."""

import torch

from .common import sub_seed


class EchoDriver:
    MIX_SCHEMA = {"required": ["width"],
                  "properties": {"width": {"type": "integer", "minimum": 1}}}
    CONFIG_SCHEMA = {"required": ["echo_scale"],
                     "properties": {"echo_scale": {"type": "integer", "minimum": 1}}}

    def __init__(self, ctx):
        self.ctx = ctx
        self.setup_split_s, self.held_bytes, self.kept = {}, None, []

    def setup(self):
        pass

    def answer(self, i):
        base = sub_seed(self.ctx.seed, "echo", i) % 1000
        return (torch.arange(self.ctx.mix["width"]) + base) * self.ctx.cfg["echo_scale"]

    def request(self, i):
        return self.answer(i)

    def keep(self, i, x, force=False):
        if force or i % 4 == 0:
            self.kept.append((i, x.clone()))

    def end_to_end(self, window_s, done):
        return {"echo_per_s": done / window_s}

    def release(self):
        pass

    def judge(self, control):
        bad = sum(int((x - int(control) != self.answer(i)).sum()) for i, x in self.kept)
        return {"answers_judged": len(self.kept), "echo_mismatch": bad}


DRIVER = EchoDriver
'''


def add_echo(tmp: Path, mix_extra=None, config_extra=None) -> None:
    """The dummy driver, a mix, a configuration, a cell, an end-to-end and a
    per-layer metric of its own in `tmp`, beside a tiny_bench there."""
    for sub in ("drivers", "traffic", "metrics"):
        (tmp / sub).mkdir(exist_ok=True)
    (tmp / "drivers/dummy_echo.py").write_text(ECHO_DRIVER)
    (tmp / "traffic/echo_mix.json").write_text(json.dumps(dict(
        {"name": "echo_mix", "driver": "dummy_echo", "why": "test", "width": 5,
         "keep_every": 4, "keep_slots": 1, "stack_calls": 2, "trace_seconds": 0.2},
        **(mix_extra or {}))))
    (tmp / "configs/echo.json").write_text(json.dumps(dict(
        {"name": "echo", "source": "test", "deployment": "test", "reduced": {}, "assumed": {},
         "echo_scale": 3}, **(config_extra or {}))))
    (tmp / "cells/echo.echo_mix.json").write_text(json.dumps(
        {"name": "echo.echo_mix", "counted_at": "test", "limits": {"echo_mismatch": 0}}))
    (tmp / "metrics/echo.calls.py").write_text(
        "def read(trace):\n    return float(trace['window_calls'])\n")
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "echo", "source": "test", "file": "configs/echo.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "echo.echo_mix", "config": "echo",
                               "traffic": "echo_mix", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "echo_per_s", "unit": "calls/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["echo.echo_mix"]})
    bench["per_layer"].append({"name": "echo.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "echo_per_s", "workloads": ["echo.echo_mix"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_config_mix_cell_and_metric_are_files_only(tmp_path):
    """A dummy configuration, mix, cell and per-layer metric added from a
    directory of their own, with no file of portbench/ edited; and a dummy
    driver with a mix key and a configuration key of its own, with its own
    mix, configuration, cell and metrics."""
    before = _portbench_files()
    spec = tiny_bench(tmp_path, ("preimage_2col",))
    add_echo(tmp_path)
    spec = Spec(tmp_path / "BENCHMARK.json", [tmp_path])
    assert spec.config("echo")["echo_scale"] == 3
    r = run_cell(spec, "echo.echo_mix", SEED, 0.3, False, device_type="cpu", control=True)
    assert r["correct"] and not r["control_correct"], r["checks"]
    assert r["metrics"]["echo_per_s"]["value"] > 0 and r["checks"]["echo_mismatch"]["value"] == 0
    r = run_cell(spec, "echo.echo_mix", SEED, 0.3, True, device_type="cpu")
    assert r["correct"] and r["metrics"]["echo.calls"]["value"] >= 1
    (tmp_path / "traffic").mkdir(exist_ok=True)
    (tmp_path / "metrics").mkdir(exist_ok=True)
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
    assert _portbench_files() == before


def _portbench_files() -> dict:
    return {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("fault", ["unknown_driver", "unknown_mix_key", "unknown_config_key",
                                   "other_drivers_config_key", "missing_driver_key"])
def test_a_key_or_driver_that_no_file_names_is_refused(tmp_path, fault):
    """Validation moved into the drivers' fragments and got no looser: an
    unknown driver, a mix key or a configuration key that neither the shared
    schema nor the drivers of the configuration's cells name, and a key
    that a driver requires and the file lacks, are each refused."""
    tiny_bench(tmp_path, ("preimage_2col",))
    mix_extra, config_extra = {}, {}
    if fault == "unknown_driver":
        mix_extra = {"driver": "no_such_driver"}
    elif fault == "unknown_mix_key":
        mix_extra = {"widht": 5}
    elif fault == "unknown_config_key":
        config_extra = {"echo_scael": 3}
    elif fault == "other_drivers_config_key":
        config_extra = {"trapdoor_sigma": 4.578}  # the preimage driver's, not the echo's
    add_echo(tmp_path, mix_extra, config_extra)
    if fault == "missing_driver_key":
        cfg = json.loads((tmp_path / "configs/echo.json").read_text())
        del cfg["echo_scale"]
        (tmp_path / "configs/echo.json").write_text(json.dumps(cfg))
    spec = Spec(tmp_path / "BENCHMARK.json", [tmp_path])
    with pytest.raises(SpecError):
        run_cell(spec, "echo.echo_mix", SEED, 0.1, False, device_type="cpu")
    assert spec.config("tiny")["ring"] == TINY_RING  # the other cells still load


def test_busy_spread_arithmetic():
    read = Spec(ROOT / "BENCHMARK.json").reader("parallel.busy_spread_pct")
    assert math.isclose(read({"program_busy_s": [2.0, 1.5, 1.9, 1.0]}), 50.0)
    assert read({"program_busy_s": [0.8, 0.8, 0.8, 0.8]}) == 0.0
    assert read({"program_busy_s": [1.0]}) is None
    assert read({"program_busy_s": [0.0, 0.0]}) is None


def test_the_harness_copies_are_not_the_programs_busy_time():
    """A kept answer's copy into pinned memory counts in the device's busy
    time and not in the program's; the mesh cell's idle share and busy
    spread read the program's, the one-card cells' idle share every op's."""
    keep = tracing.HARNESS_COPIES[0]
    ms = 1_000_000
    events = [("kernel", 0, 100 * ms, True, 0), ("kernel", 50 * ms, 150 * ms, True, 0),
              (keep, 140 * ms, 400 * ms, True, 0), ("kernel", 0, 120 * ms, True, 1),
              ("Memcpy PtoP (Device -> Device)", 120 * ms, 130 * ms, True, 1)]
    assert all(math.isclose(a, b) for a, b in
               zip(tracing.busy_by_device(events, [0, 1]), [0.4, 0.13]))
    program = tracing.busy_by_device(events, [0, 1], tracing.HARNESS_COPIES)
    assert all(math.isclose(a, b) for a, b in zip(program, [0.15, 0.13]))
    spec = Spec(ROOT / "BENCHMARK.json")
    trace = {"driver": "preimage", "window_s": 0.5, "busy_s": [0.4, 0.13],
             "program_busy_s": program}
    assert math.isclose(spec.reader("device.idle_pct.preimage.mesh4")(trace), 72.0)
    assert math.isclose(spec.reader("device.idle_pct.preimage.sec100")(trace), 47.0)
    assert math.isclose(spec.reader("parallel.busy_spread_pct")(trace), 100 * 0.02 / 0.15)


def test_gather_reads_the_peer_copies_off_the_first_card():
    read = Spec(ROOT / "BENCHMARK.json").reader("parallel.gather_ms.mesh4")
    peer = "Memcpy PtoP (Device -> Device)"
    copies = [[peer, 0, 0.003], [peer, 1, 0.04], [peer, 3, 0.05],
              ["Memcpy DtoD (Device -> Device)", 2, 1.0], ["Memcpy HtoD (Pageable -> Device)", 1, 1.0]]
    trace = {"devices": [0, 1, 2, 3], "copies": copies, "window_calls": 10}
    assert math.isclose(read(trace), 9.0)
    assert read(dict(trace, copies=copies[:1])) is None


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
