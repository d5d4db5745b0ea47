"""The program's own spans and counters over one cell of the benchmark.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with the cell's cards. It runs the
cell's driver as `run.py` does, with these phases:

1. set-up inside `tracing.recording()` (the program's `utils/tracing.py`),
   which gives the trapdoor's set-up split;
2. the window: a closed loop of `seconds` with tracing off, as `--trace 0`
   measures it (ms per call);
3. `cost_rounds` rounds of `cost_calls` calls with tracing off and as many
   inside a recording, in turns, and `cost_calls` calls under a profile of
   device activity alone: the cost of tracing when on (the rounds' medians)
   and that of the profile (against the window's ms per call);
4. the mix's `stack_calls` calls inside a recording under a profile of
   device activity alone: `span_profile` puts each idle gap of the card
   down to the innermost span open on the host when the gap began, and
   reports per call the self ms and the idle ms by span name and the
   counter deltas.

Then the reference judges the answers kept in the window, as in a run of
the benchmark. The last line of standard output is one JSON object: the
result, the readings by span, and the values of the per-layer metrics that
read them (`readings`), none of which `BENCHMARK.json` lists yet: the
harness's traced run does not open a recording (PERF.md, open questions).
This file imports the program's tracer, which a program without one lacks.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL_COUNTERS = ("ntt.k1", "ntt.k2", "ntt.k3_head", "ntt.k3_whole")


def timeline(spans) -> list:
    """Disjoint (start_ns, end_ns, span) segments, in order: the innermost
    span open over each stretch of host time. Spans nest (one thread)."""
    segs, stack, cursor = [], [], None

    def advance(upto):
        nonlocal cursor
        if stack and cursor is not None and cursor < upto:
            segs.append((cursor, upto, stack[-1]))
        cursor = upto if cursor is None else max(cursor, upto)

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            advance(stack[-1].end_ns)
            stack.pop()
        advance(s.start_ns)
        stack.append(s)
    while stack:
        advance(stack[-1].end_ns)
        stack.pop()
    return segs


def gaps(merged) -> list:
    """(start_ns, length_ns) of each gap between merged device intervals."""
    return [(e0, s1 - e0) for (_, e0), (s1, _) in zip(merged, merged[1:]) if s1 > e0]


def attribute(merged, spans) -> dict:
    """Idle ns of the gaps between the merged device intervals: by the name
    of the innermost span open when each gap began (the whole gap goes
    there, wherever it ends), and the gaps that began inside a root span
    (a span with no parent among `spans`) with those that began in no
    child of it."""
    segs = timeline(spans)
    starts = [s[0] for s in segs]
    ids = {s.id for s in spans}
    by_id = {s.id: s for s in spans}
    by_name: dict = defaultdict(int)
    in_roots = root_self = outside = 0
    for g0, length in gaps(merged):
        i = bisect.bisect_right(starts, g0) - 1
        if i < 0 or g0 >= segs[i][1]:
            outside += length
            continue
        span = segs[i][2]
        by_name[span.name] += length
        root = span
        while root.parent in ids:
            root = by_id[root.parent]
        in_roots += length
        root_self += length if root is span else 0
    return {"by_name": dict(by_name), "in_roots": in_roots, "root_self": root_self,
            "outside": outside}


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span_profile(calls, n_calls: int, device_type: str, device: int) -> dict:
    """Run `calls()` (n_calls calls, ending in a synchronise) inside a
    recording under a profile of device activity alone. Per call: self ms
    and idle ms by span name, counter deltas, the phase's wall ms; the idle
    inside root spans and the share of it put down to a child span. Where
    the profile has no device activity (the CPU) the idle readings are
    None."""
    from torch.profiler import ProfilerActivity, profile

    from mxx_tpu_torch.utils import tracing

    acts = [ProfilerActivity.CUDA] if device_type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof, tracing.recording() as rec:
        t0 = time.perf_counter()
        calls()
        wall = time.perf_counter() - t0
    device_ivs = [(e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type().name == "CUDA" and e.device_index() == device]
    self_ns = rec.self_ns()
    self_by_name: dict = defaultdict(int)
    for s in rec.spans:
        self_by_name[s.name] += self_ns[s.id]
    out = {"wall_ms_per_call": wall * 1e3 / n_calls,
           "span_self_ms_per_call": {k: v * 1e-6 / n_calls for k, v in self_by_name.items()},
           "counters_per_call": {k: v / n_calls for k, v in sorted(rec.counters.items())},
           "span_idle_ms_per_call": None, "idle_ms_per_call": None,
           "root_idle_ms_per_call": None, "root_idle_in_children_pct": None,
           "outside_spans_idle_ms_per_call": None}
    if device_ivs:
        merged = _merge(device_ivs)
        a = attribute(merged, rec.spans)
        total = sum(length for _, length in gaps(merged))
        out.update(
            span_idle_ms_per_call={k: v * 1e-6 / n_calls for k, v in a["by_name"].items()},
            idle_ms_per_call=total * 1e-6 / n_calls,
            root_idle_ms_per_call=a["in_roots"] * 1e-6 / n_calls,
            root_idle_in_children_pct=(100.0 * (1 - a["root_self"] / a["in_roots"])
                                       if a["in_roots"] else None),
            outside_spans_idle_ms_per_call=a["outside"] * 1e-6 / n_calls)
    return out


def readings(driver: str, qualifier: str, setup_rec, phase: dict) -> dict:
    """The per-layer metrics that read the program's spans and counters,
    under their names; an idle reading is left out where the phase had no
    device trace."""
    per_call = phase["counters_per_call"]
    idle = phase["span_idle_ms_per_call"]
    out = {f"ntt.kernel_launches_per_call.{qualifier}":
           sum(per_call.get(k, 0) for k in KERNEL_COUNTERS)}
    if driver == "preimage":
        traps = setup_rec.named("trapdoor.trapdoor")
        if traps:
            out["trapdoor.setup_s"] = sum(s.ms for s in traps) * 1e-3
        if idle is not None:
            out[f"samplers.idle_ms.{qualifier}"] = idle.get("chacha.draw", 0.0)
            out[f"trapdoor.gq_idle_ms.{qualifier}"] = idle.get("trapdoor.gauss_samp_gq", 0.0)
    elif idle is not None:
        out[f"circuit.idle_ms.{qualifier}"] = sum(v for k, v in idle.items()
                                                  if k.startswith("circuit."))
    return out


def qualifier_of(spec, cell: str, driver: str) -> str:
    """The dotted qualifier the cell's metrics carry: `bgg`, or the
    preimage rate's (`preimage.sec100`, `preimage.bench`)."""
    if driver != "preimage":
        return "bgg"
    rate = next(m["name"] for m in spec.end_to_end(cell)
                if m["name"].startswith("preimage_cols_per_s."))
    return "preimage." + rate.split(".", 1)[1]


def run_spans(spec, name: str, seed: int, seconds: float, device_type: str = "cuda",
              cost_calls: int = 4, cost_rounds: int = 5) -> dict:
    """The phases of the module notes, and the reference's judgement."""
    import torch

    from mxx_tpu_torch.utils import tracing
    from portbench.harness import Context, _checks, _passed, process_age_s

    cell = spec.cell(name)
    mix = spec.traffic(cell["traffic"])
    ctx = Context(spec.config(cell["config"]), mix, seed, device_type, cell["chips"])
    if device_type == "cuda":
        for j in ctx.indices:
            torch.empty(0, device=ctx.device(j))
    driver = spec.driver(mix["driver"])(ctx)
    with tracing.recording() as setup_rec:
        driver.setup()
    setup_s = process_age_s()

    attempted, last = 0, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        last = (attempted, driver.request(attempted))  # held while the next runs
        driver.keep(*last)
        attempted += 1
    ctx.sync()
    window_s = time.perf_counter() - t0
    driver.keep(*last, force=True)
    ctx.sync()
    last = None

    def calls(count: int, base: int):
        def run():
            for j in range(count):
                driver.request(base - j)
            ctx.sync()
        return run

    def timed(run) -> float:
        t = time.perf_counter()
        run()
        return time.perf_counter() - t

    off, on = [], []
    for r in range(cost_rounds):
        off.append(timed(calls(cost_calls, -2000 - 100 * r)))
        with tracing.recording():
            on.append(timed(calls(cost_calls, -2050 - 100 * r)))
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device_type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts):
        prof_s = timed(calls(cost_calls, -3000))
    n = mix.get("stack_calls", 2)
    phase = span_profile(calls(n, -1000), n, device_type, ctx.indices[0])
    driver.release()
    if device_type == "cuda":
        torch.cuda.empty_cache()
    counts = spec.cell_counts(name)
    checks = _checks(driver.judge(False), counts["limits"])
    window_ms = window_s * 1e3 / attempted
    result = {
        "cell": name, "correct": _passed(checks), "attempted": attempted,
        "device": {"kind": (torch.cuda.get_device_name(0) if device_type == "cuda"
                            else device_type), "count": ctx.chips},
        "setup_s": setup_s, "setup_split_s": driver.setup_split_s,
        "setup_span_s": {k: sum(s.ms for s in setup_rec.named(k)) * 1e-3
                         for k in sorted({s.name for s in setup_rec.spans})},
        "setup_counters": dict(setup_rec.counters),
        "window_ms_per_call": window_ms,
        "off_ms_per_call": [t * 1e3 / cost_calls for t in off],
        "recording_ms_per_call": [t * 1e3 / cost_calls for t in on],
        "tracing_cost_pct": 100.0 * (statistics.median(on) / statistics.median(off) - 1),
        "profile_ms_per_call": prof_s * 1e3 / cost_calls,
        **{f"phase_{k}" if k == "wall_ms_per_call" else k: v for k, v in phase.items()},
        "readings": readings(mix["driver"], qualifier_of(spec, name, mix["driver"]),
                             setup_rec, phase),
        "checks": checks,
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from portbench.spec import Spec

    spec = Spec(ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell(
            args.workload)["chips"]:
        print("portbench/spans.py: the cell's CUDA devices are missing", file=sys.stderr)
        return 2
    result = run_spans(spec, args.workload, args.seed, args.seconds)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
