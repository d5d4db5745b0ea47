"""One run of one cell: set-up, the measured window, the judgement.

`run_cell` is the whole run but for the look for a card, which `run.py`
makes before it: the tests drive it on the CPU at tiny sizes. The window is a
closed loop (one request in flight) for `seconds` of host clock, ending in a
synchronise of every card the cell uses; a rate counts all the work of the
window over all its time. With `trace`, the window is a profiled one of
`trace_seconds` (the mix's), and a few more calls run with Python stacks for
the device time by stage. Once the window has closed the peak memory is
read, the program's state is dropped, and the reference judges the kept
answers.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
import traceback

import torch

from . import roofline, tracing
from .spec import Spec, dotted_prefixes

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mxx_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


class Context:
    """The run's configuration, mix, seed and devices."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device_type: str, chips: int):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device_type, self.chips = device_type, chips

    def device(self, j: int) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", j)
        return torch.device(self.device_type)

    @property
    def indices(self) -> list[int]:
        return list(range(self.chips))

    def sync(self) -> None:
        tracing.sync(self.device_type, self.indices)

    def memory_allocated(self) -> list[int]:
        if self.device_type != "cuda":
            return [0] * self.chips
        return [torch.cuda.memory_allocated(j) for j in self.indices]

    def memory_peak(self) -> int:
        if self.device_type != "cuda":
            return 0
        return max(torch.cuda.max_memory_allocated(j) for j in self.indices)


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
             device_type: str = "cuda", control: bool = False) -> dict:
    """The result of one run (the dict the last line prints). With `control`,
    the kept answers are judged a second time as the control, every output
    of the program held with one bit less (`control_checks`)."""
    cell = spec.cell(name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    counts = spec.cell_counts(name)
    ctx = Context(cfg, mix, seed, device_type, cell["chips"])
    if device_type == "cuda":
        for j in ctx.indices:
            torch.empty(0, device=ctx.device(j))  # the device's allocator, before its stats
            torch.cuda.reset_peak_memory_stats(j)
    driver = spec.driver(mix["driver"])(ctx)
    driver.setup()
    setup_s = process_age_s()

    state = {"attempted": 0, "failed": 0, "last": None}

    def loop(duration: float) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < duration:
            i = state["attempted"]
            state["attempted"] += 1
            try:
                # the last answer is held while the next is computed
                state["last"] = (i, driver.request(i))
            except Exception:  # a request that fails is counted, and ends the window
                state["failed"] += 1
                traceback.print_exc(file=sys.stderr)
                break
            driver.keep(i, state["last"][1])
        ctx.sync()
        return time.perf_counter() - t0

    profiled = None
    if trace:
        profiled = tracing.window_profile(lambda: loop(min(seconds, mix["trace_seconds"])),
                                          device_type, ctx.indices)
        window_s = profiled["window_s"]
    else:
        window_s = loop(seconds)
    if state["last"] is not None:
        # the window's last answer is judged too, so that a short window
        # always has one; it is copied once the window has closed
        driver.keep(*state["last"], force=True)
        ctx.sync()
        state["last"] = None
    attempted, failed = state["attempted"], state["failed"]
    done = attempted - failed
    peak = ctx.memory_peak()
    e2e = driver.end_to_end(window_s, done)
    e2e["peak_device_gib"] = peak / 2**30
    e2e["setup_s"] = setup_s

    stages = None
    if trace:
        calls = mix.get("stack_calls", 2)

        def extra():
            for j in range(calls):
                driver.request(-1000 - j)
            ctx.sync()

        stages, idle_gaps = tracing.stage_profile(extra, device_type, ctx.indices[0])
    driver.release()
    if device_type == "cuda":
        torch.cuda.empty_cache()
    checks = _checks(driver.judge(False), counts["limits"])
    correct = failed == 0 and done > 0 and _passed(checks)

    units = {m["name"]: m["unit"] for m in spec.bench["end_to_end"] + spec.bench["per_layer"]}
    if trace:
        data = {"cell": name, "driver": mix["driver"], "calls": mix.get("stack_calls", 2),
                "stage_ms": stages, "busy_s": profiled["busy_s"],
                "program_busy_s": profiled["program_busy_s"], "window_s": window_s,
                "window_calls": done, "devices": ctx.indices, "copies": profiled["copies"],
                "held_bytes": driver.held_bytes,
                "transform_bound_ms": (roofline.call_bound_ms(counts)
                                       if counts.get("transforms_per_call") else None)}
        values = {}
        for m in spec.per_layer(name):
            v = spec.reader(m["name"])(data)
            if v is not None:
                values[m["name"]] = v
    else:
        wanted = {m["name"]: next((p for p in dotted_prefixes(m["name"]) if p in e2e), None)
                  for m in spec.end_to_end(name)}
        missing = [m for m, base in wanted.items() if base is None]
        if missing:
            raise ValueError(f"cell {name} lists end-to-end metrics its driver lacks: {missing}")
        values = {m: e2e[base] for m, base in wanted.items()}
    device = {"platform": "gpu" if device_type == "cuda" else device_type,
              "kind": (torch.cuda.get_device_name(0) if device_type == "cuda" else device_type),
              "count": ctx.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
              "device": device}
    if trace:
        device["busy_s"] = statistics.fmean(profiled["busy_s"])
        device["window_s"] = window_s
        result["breakdown"] = {"device_ops": profiled["device_ops"], "idle_gaps": idle_gaps}
        # every stage of the stacked calls, for PERF.md's "where the time goes"
        result["stage_ms_per_call"] = {k: v / data["calls"] for k, v in stages.items()}
        result["window_copies_s"] = profiled["copies"]
        result["window_busy_s"] = {"every_op": profiled["busy_s"],
                                   "program": profiled["program_busy_s"]}
    result["setup_split_s"] = driver.setup_split_s  # for PERF.md; the driver ignores it
    if control:
        result["control_checks"] = cc = _checks(driver.judge(True), counts["limits"])
        result["control_correct"] = _passed(cc)
    result["checks"] = checks
    return result


def _checks(numbers: dict, limits: dict) -> dict:
    """Each number compared beside its limit."""
    checks = {"answers_judged": {"value": numbers.pop("answers_judged"), "limit": 1,
                                 "pass_if": ">="}}
    for key, value in numbers.items():
        checks[key] = {"value": value, "limit": limits[key], "pass_if": "<="}
    return checks


def _passed(checks: dict) -> bool:
    return all(c["value"] >= c["limit"] if c["pass_if"] == ">=" else c["value"] <= c["limit"]
               for c in checks.values())
