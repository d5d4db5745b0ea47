"""The port's tracer (`mxx_tpu_torch/utils/tracing.py`) and the spans and
counters it carries on the preimage and BGG+ paths.

- Off, a span records nothing and never waits on the device; on, it never
  calls `torch.cuda.synchronize` either.
- Nesting gives parent ids and one request id per root; a span's self time
  is its duration less the union of its children's.
- Counter deltas over a recording; exit fields; the MXX_TRACE exporter.
- The clock: under a `torch.profiler` CPU profile every `aten::` event of an
  op run inside a span lies within the span's recorded [start, end]. The
  `cuda`-marked twin checks the device trace's clock on the card
  (`python -m pytest --noconftest -m cuda tests/test_torch_tracing.py`).
- A preimage at n=1024 records the trapdoor spans under one request id, and
  a 51-gate BGG+ pass over encodings the circuit spans under another.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mxx_tpu_torch.bgg import BGGPublicKeySampler, BggEncoding
from mxx_tpu_torch.bgg.lift import lift_constants_batched
from mxx_tpu_torch.circuit import PolyCircuit
from mxx_tpu_torch.circuit.batched_eval import eval_batched
from mxx_tpu_torch.matrix import PolyMatrix
from mxx_tpu_torch.ring.params import RingParams
from mxx_tpu_torch.ring.poly import EVAL, Poly
from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler
from mxx_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
PREIMAGE_SPANS = {"trapdoor.preimage", "trapdoor.p2", "trapdoor.p1", "trapdoor.syndrome",
                  "trapdoor.gauss_samp_gq", "trapdoor.combine", "chacha.draw"}
CIRCUIT_SPANS = {"circuit.eval_batched", "circuit.stack", "circuit.scalar_rows",
                 "circuit.gate_rows"}


def _refuse(*args, **kwargs):
    raise AssertionError("the tracer waited on the whole device")


@pytest.fixture
def no_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)


def test_off_records_nothing_and_never_synchronises(no_sync):
    assert not tracing._on
    with tracing.span("off", a=1) as fields:
        fields["b"] = 2
        tracing.event("off.event", c=3)
    assert fields == {}
    with tracing.recording() as rec:
        pass
    assert rec.spans == [] and rec.events == []
    with tracing.recording() as rec:
        with tracing.span("on", a=1) as fields:
            fields["b"] = 2
    assert [(s.name, s.fields) for s in rec.spans] == [("on", {"a": 1, "b": 2})]
    assert not tracing._on


def test_nesting_parents_requests_and_self_time():
    with tracing.recording() as rec:
        for _ in range(2):
            with tracing.span("root"):
                time.sleep(0.002)
                with tracing.span("child"):
                    time.sleep(0.004)
                    with tracing.span("grandchild"):
                        time.sleep(0.003)
                with tracing.span("child"):
                    time.sleep(0.002)
                tracing.event("root.event", x=1)
    by_id = {s.id: s for s in rec.spans}
    roots = rec.named("root")
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    assert roots[0].request != roots[1].request
    for s in rec.spans:
        root = s
        while root.parent is not None:
            root = by_id[root.parent]
        assert s.request == root.id == root.request
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert [by_id[g.parent].name for g in rec.named("grandchild")] == ["child", "child"]
    assert [e.request for e in rec.events] == [r.id for r in roots]
    self_ns = rec.self_ns()
    for s in rec.spans:
        kids = [k for k in rec.spans if k.parent == s.id]
        assert self_ns[s.id] == s.end_ns - s.start_ns - sum(k.end_ns - k.start_ns
                                                             for k in kids)
    assert all(self_ns[r.id] >= 2e6 for r in roots)
    assert all(s.ms == pytest.approx((s.end_ns - s.start_ns) * 1e-6) for s in rec.spans)


def test_counter_deltas_over_a_recording():
    tracing.count("test.before", 5)
    with tracing.recording() as outer:
        tracing.count("test.a")
        with tracing.recording() as inner:
            tracing.count("test.a", 2)
            tracing.count("test.b", 7)
        tracing.count("test.b")
    tracing.count("test.a", 100)
    assert outer.counters["test.a"] == 3 and outer.counters["test.b"] == 8
    assert inner.counters["test.a"] == 2 and inner.counters["test.b"] == 7
    assert outer.counters["test.before"] == 0
    assert tracing.counters()["test.before"] >= 5


def test_spans_lie_on_the_profilers_clock():
    x = torch.ones(4096)
    with tracing.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with tracing.span("op", i=i):
                x = torch.mul(x, 1.0001)
            time.sleep(0.0005)
    spans = rec.named("op")
    ops = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mul")
    assert len(ops) == len(spans) == 20
    ends = {e.start_ns(): e.start_ns() + e.duration_ns()
            for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul"}
    for s, start in zip(spans, ops):
        assert s.start_ns <= start and ends[start] <= s.end_ns, (s, start)


def test_the_stderr_exporter():
    code = ("from mxx_tpu_torch.utils import tracing\n"
            "with tracing.span('export.me', k=2):\n    tracing.event('export.event', z=1)\n")
    env = {**os.environ, "MXX_TRACE": "1", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "export.event z=1" in out.stderr
    assert "export.me finished elapsed_ms=" in out.stderr and "k=2" in out.stderr


def test_a_preimage_records_its_spans_under_one_request(no_sync):
    params = RingParams.new(1024, 3, 24, 12)
    ts = TrapdoorSampler(params, 4.578, seed=5, device="cpu")
    with tracing.recording() as setup:
        td, a = ts.trapdoor(params, 1)
    (trap,) = setup.named("trapdoor.trapdoor")
    kids = {s.name for s in setup.spans if s.parent == trap.id}
    assert kids == {"trapdoor.sample_re", "trapdoor.public_matrix"}
    target = UniformSampler(seed=6, device="cpu").sample_uniform(params, 1, 2, FinRingDist())
    calls = []
    for _ in range(2):
        with tracing.recording() as rec:
            x = ts.preimage(params, td, a, target)
        assert (a @ x) == target
        calls.append(rec)
    first, second = calls
    (root,) = first.named("trapdoor.preimage")
    assert root.parent is None and root.fields == {"cols": 2, "shards": 1}
    assert {s.name for s in first.spans} == PREIMAGE_SPANS | {"trapdoor.operands"}
    assert {s.request for s in first.spans} == {root.id}
    assert {s.name for s in second.spans} == PREIMAGE_SPANS
    assert second.named("trapdoor.preimage")[0].request != root.id
    # the children a gap can be put down to: every span but the root is one
    assert all(s.parent == root.id for s in first.spans
               if s.name.startswith("trapdoor.") and s is not root)
    assert first.counters["trapdoor.operand_cache_miss"] == 1
    assert second.counters["trapdoor.operand_cache_miss"] == 0
    assert second.counters["trapdoor.gq_towers"] == params.crt_depth
    assert second.counters["chacha.blocks"] > 0
    # on the CPU every transform takes the chain, and no kernel launches
    assert second.counters["ntt.chain_fwd"] > 0 and second.counters["ntt.chain_inv"] > 0
    assert sum(second.counters[k] for k in ("ntt.k1", "ntt.k2", "ntt.k3_head",
                                            "ntt.k3_whole")) == 0
    # where one draw entry calls another, only the outer one is a span
    by_id = {s.id: s for s in second.spans}
    assert all(by_id[d.parent].name != "chacha.draw" for d in second.named("chacha.draw"))


def _online_pass(n_in: int = 16) -> PolyCircuit:
    """51 gates: 8 small and 8 large scalar muls of the public inputs, their
    inner product with the secret inputs, and four differences."""
    c = PolyCircuit()
    ins = c.input(2 * n_in)
    ids = list(range(ins.start, ins.start + ins.count))
    pub, sec = ids[:n_in], ids[n_in:]
    scaled = [c.small_scalar_mul(pub[i], [i + 1]) for i in range(8)]
    scaled += [c.large_scalar_mul(pub[i], [2**20 + i]) for i in range(8, n_in)]
    acc = c.mul_gate(scaled[0], sec[0])
    for p, s in zip(scaled[1:], sec[1:]):
        acc = c.add_gate(acc, c.mul_gate(p, s))
    c.output([acc] + [c.sub_gate(scaled[j], scaled[j + 4]) for j in range(4)])
    return c


def test_a_bgg_pass_records_its_spans_under_one_request(no_sync):
    params = RingParams.new(16, 2, 24, 12)
    circuit = _online_pass()
    one = BGGPublicKeySampler(bytes([3] * 32), 1, device="cpu").sample(params, b"pass", [])[0]
    s = UniformSampler(seed=9, device="cpu").sample_uniform(params, 1, 1, FinRingDist())
    g = PolyMatrix.gadget_matrix(params, 1, "cpu")
    one_enc = BggEncoding(s @ (one.matrix - g), one, Poly.one(params, "cpu"))
    ins = lift_constants_batched(params, one_enc, list(range(3, 35)))
    ts = TrapdoorSampler(params, 4.578, seed=1, device="cpu")
    td, a = ts.trapdoor(params, 1)
    with tracing.recording() as rec:
        ts.preimage(params, td, a, PolyMatrix(a.data[:, :, :1], EVAL, params))
        outs = eval_batched(circuit, params, one_enc, ins)
    assert len(outs) == 5
    (pre,) = rec.named("trapdoor.preimage")
    (root,) = rec.named("circuit.eval_batched")
    assert root.parent is None and root.fields == {"gates": circuit.num_gates()}
    passing = [s for s in rec.spans if s.start_ns >= root.start_ns]
    assert {s.name for s in passing} == CIRCUIT_SPANS
    assert {s.request for s in passing} == {root.id} and pre.request == pre.id != root.id
    batches = rec.named("circuit.gate_rows")
    assert sum(b.fields["gates"] for b in batches) == 51
    assert all(b.parent == root.id for b in batches)
    # one batch per kind and level
    assert len({(b.fields["kind"], b.fields["level"]) for b in batches}) == len(batches)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_lie_on_the_device_traces_clock(cuda_device, monkeypatch):
    x = torch.ones(1 << 22, device=cuda_device)
    done = torch.cuda.Event()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the profiler synchronises as it stops; the tracer never does
        with monkeypatch.context() as m, tracing.recording() as rec:
            m.setattr(torch.cuda, "synchronize", _refuse)
            for i in range(10):
                with tracing.span("kernels", i=i):
                    for _ in range(5):
                        x = x * 1.0001
                    done.record()
                    done.synchronize()  # the span's device work ends inside it
                time.sleep(0.002)
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type().name == "CUDA")
    spans = rec.named("kernels")
    assert len(kernels) >= 50
    for k0, k1 in kernels:
        owner = [s for s in spans if s.start_ns <= k0 and k1 <= s.end_ns]
        assert len(owner) == 1, (k0, k1)
    for s in spans:
        assert s.start_ns - 200_000 <= s.device_start_ns <= s.device_end_ns <= s.end_ns + 200_000
        mine = [k for k in kernels if s.start_ns <= k[0] and k[1] <= s.end_ns]
        assert len(mine) == 5
        assert s.device_start_ns - 200_000 <= mine[0][0] and mine[-1][1] <= s.device_end_ns + 200_000
