"""CPU tests of `portbench/spans.py`: the gap attribution by span on
synthetic intervals, and the phases run over tiny cells through the program.

Run from the root of the repository: `python -m pytest portbench/tests -q`.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import spans  # noqa: E402
from portbench.harness import run_cell  # noqa: E402
from portbench.tests.test_portbench_harness import SEED, tiny_bench  # noqa: E402


def span(id_, name, start, end, parent=None):
    return SimpleNamespace(id=id_, name=name, start_ns=start, end_ns=end, parent=parent)


def test_the_innermost_span_takes_the_gap():
    tree = [span(1, "root", 0, 92), span(2, "child", 10, 60, 1),
            span(3, "grandchild", 20, 30, 2), span(4, "child", 70, 90, 1)]
    # device busy [0, 5], [12, 15], [22, 25], [35, 40], [65, 68], [75, 95], [120, 130]
    merged = [[0, 5], [12, 15], [22, 25], [35, 40], [65, 68], [75, 95], [120, 130]]
    got = spans.attribute(merged, tree)
    # gaps: 5-12 root, 15-22 child, 25-35 grandchild, 40-65 child, 68-75 root,
    # 95-120 begins after every span has closed
    assert got["by_name"] == {"root": 7 + 7, "child": 7 + 25, "grandchild": 10}
    assert got["in_roots"] == 56 and got["root_self"] == 14 and got["outside"] == 25


def test_a_gap_goes_to_the_span_open_at_its_start():
    tree = [span(1, "root", 0, 100), span(2, "a", 10, 50, 1), span(3, "b", 50, 90, 1)]
    got = spans.attribute([[0, 40], [80, 100]], tree)
    # the gap 40-80 begins in a and ends in b: all of it is a's
    assert got["by_name"] == {"a": 40}
    assert got["root_self"] == 0 and got["in_roots"] == 40


def test_timeline_is_disjoint_and_nests():
    tree = [span(1, "r", 0, 50), span(2, "c", 5, 20, 1), span(3, "c", 20, 30, 1),
            span(4, "r", 60, 70)]
    segs = [(a, b, s.name) for a, b, s in spans.timeline(tree)]
    assert segs == [(0, 5, "r"), (5, 20, "c"), (20, 30, "c"), (30, 50, "r"), (60, 70, "r")]


@pytest.mark.parametrize("mix", ["preimage_2col", "bgg_encoding_pass"])
def test_the_phases_over_a_tiny_cell(tmp_path, mix):
    """The counters and the set-up span are read on the CPU; an idle reading
    needs a device trace, and is left out here."""
    spec = tiny_bench(tmp_path, (mix,))
    r = spans.run_spans(spec, f"tiny.{mix}", SEED, 0.3, device_type="cpu", cost_calls=1,
                        cost_rounds=2)
    assert r["correct"], r["checks"]
    assert r["window_ms_per_call"] > 0 and len(r["recording_ms_per_call"]) == 2
    assert r["span_idle_ms_per_call"] is None and r["root_idle_in_children_pct"] is None
    calls = r["counters_per_call"]
    read = r["readings"]
    if mix == "preimage_2col":
        assert read["ntt.kernel_launches_per_call.preimage.sec100"] == 0
        assert calls["trapdoor.gq_towers"] == 3 and calls["chacha.blocks"] > 0
        assert calls["ntt.chain_fwd"] > 0 and calls["ntt.chain_inv"] > 0
        assert read["trapdoor.setup_s"] > 0
        assert set(r["setup_span_s"]) >= {"trapdoor.trapdoor", "trapdoor.sample_re",
                                          "trapdoor.public_matrix"}
        assert set(r["span_self_ms_per_call"]) >= {"trapdoor.preimage", "chacha.draw",
                                                   "trapdoor.gauss_samp_gq"}
        assert not any(k.startswith(("samplers.idle_ms", "trapdoor.gq_idle_ms")) for k in read)
    else:
        assert read == {"ntt.kernel_launches_per_call.bgg": 0}
        assert calls["ntt.chain_fwd"] > 0
        assert set(r["span_self_ms_per_call"]) == {"circuit.eval_batched", "circuit.stack",
                                                   "circuit.scalar_rows", "circuit.gate_rows"}


def test_the_traced_run_is_left_as_it_was(tmp_path, monkeypatch):
    """The harness's traced run opens no recording: its metrics are the
    accepted ones, and no span of the program is on through it."""
    from mxx_tpu_torch.utils import tracing

    def refuse(name, fields):
        raise AssertionError(f"span {name} was on in the traced run")

    monkeypatch.setattr(tracing, "_Span", refuse)
    spec = tiny_bench(tmp_path, ("preimage_2col",))
    r = run_cell(spec, "tiny.preimage_2col", SEED, 0.3, True, device_type="cpu")
    assert r["correct"] and "samplers.chacha_ms.preimage.sec100" in r["metrics"]
    assert set(r["metrics"]) <= {m["name"] for m in spec.per_layer("tiny.preimage_2col")}
