"""What the traced run reads from `torch.profiler`.

Two profiles, because recording host operations slows the host:

- `window_profile`: the traced window with device activity alone. The
  device's busy time is the union of the intervals in which a kernel, copy or
  fill ran on it; the program's busy time leaves out the harness's own copies
  of the judged answers (`HARNESS_COPIES`); the breakdown's `device_ops` are
  the operations that took most device time.
- `stage_profile`: a few more calls with host operations and Python stacks,
  for device time by stage and for the breakdown's `idle_gaps`: each gap
  between device operations goes to the innermost function of the program on
  the stack of the last host operation that started before the gap ended. A
  kernel belongs to the innermost module of the program on the stack of the
  op that launched it (`STAGE_FILES`, a frozen copy of the attribution
  chip_smoke.py made, with `matrix/poly_matrix.py` added to the elementwise
  stage); the hand-written NTT kernels are launched through ctypes, outside
  any torch op, and are found by name.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

STAGE_FILES = [
    ("mxx_tpu_torch/ops/four_step.py", "transforms"),
    ("mxx_tpu_torch/ops/hybrid_ntt.py", "transforms"),
    ("mxx_tpu_torch/ring/ntt.py", "transforms"),
    ("mxx_tpu_torch/ops/decompose.py", "digit_decompose"),
    ("mxx_tpu_torch/ops/zq_matmul.py", "zq_matmul"),
    ("mxx_tpu_torch/ops/elementwise.py", "elementwise"),
    ("mxx_tpu_torch/matrix/poly_matrix.py", "elementwise"),
    ("mxx_tpu_torch/sampler/chacha.py", "chacha20"),
    ("mxx_tpu_torch/sampler/", "samplers (other)"),
    ("mxx_tpu_torch/lookup/", "lookup (other)"),
    ("mxx_tpu_torch/bgg/", "bgg wires (other)"),
    ("mxx_tpu_torch/circuit/batched_eval.py", "batched_eval stacking"),
]
OTHER = "other device work"
NTT_KERNELS = ("four_step_kernel", "radix_ntt_fwd_kernel")
# the keeper's copies of judged answers into pinned host buffers
# (`drivers/common.py`); the program allocates no pinned memory
HARNESS_COPIES = ("Memcpy DtoH (Device -> Pinned)",)


def _activities(device_type: str, host: bool):
    if device_type != "cuda":
        return [ProfilerActivity.CPU]
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]


def _is_device(e) -> bool:
    return e.device_type.name == "CUDA"


def _raw_events(prof):
    """(name, start_ns, end_ns, on_device, device_index, stack) of every
    event, read from kineto's results directly: building the profiler's
    FunctionEvent tree takes minutes for a window of a few hundred thousand."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns(), e.device_type().name == "CUDA",
                    e.device_index(), e.stack()))
    return out


def kernel_stage(stack) -> str:
    for frame in stack:
        for path, stage in STAGE_FILES:
            if path in frame:
                return stage
    return OTHER


def _merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _program_frame(stack) -> str | None:
    """`module.py: function` of the innermost frame of the program."""
    for frame in stack:
        at = frame.find("mxx_tpu_torch/")
        if at >= 0:
            path, _, func = frame[at + len("mxx_tpu_torch/"):].partition(": ")
            return f"{path.split('(')[0]}: {func}"
    return None


def _gaps_by_host(merged, host):
    """Seconds of the gaps between merged device intervals, by the program's
    function on the stack of the last host operation started before each
    gap ended; `host` is [(start_ns, name)] in order of start."""
    starts = [h[0] for h in host]
    out = defaultdict(float)
    for (_, g0), (g1, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(starts, g1) - 1
        out[host[i][1] if i >= 0 else "before the first host operation"] += (g1 - g0) * 1e-9
    return out


def _top(d: dict, n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def busy_by_device(events, devices: list[int], leave_out=()) -> list[float]:
    """Seconds of each device's union of intervals of `events` (name,
    start_ns, end_ns, on_device, device_index, ...), but those named in
    `leave_out`."""
    return [sum(b - a for a, b in _merge((e[1], e[2]) for e in events
                                         if e[4] == idx and e[0] not in leave_out)) * 1e-9
            for idx in devices]


def window_profile(loop, device_type: str, devices: list[int]) -> dict:
    """Run `loop()` (the traced window, which returns its wall seconds) under
    a profile of device activity alone; busy seconds per device, with every
    operation and without the harness's copies, the device operations that
    took most time, and the seconds of the memory copies by name and by the
    device that ran them."""
    with profile(activities=_activities(device_type, host=False)) as prof:
        window_s = loop()
    device = [e for e in _raw_events(prof) if e[3]]
    busy = busy_by_device(device, devices)
    program_busy = busy_by_device(device, devices, HARNESS_COPIES)
    ops = defaultdict(float)
    copies = defaultdict(float)
    for e in device:
        ops[e[0]] += (e[2] - e[1]) * 1e-9
        if e[0].startswith("Memcpy"):
            copies[e[0], e[4]] += (e[2] - e[1]) * 1e-9
    return {"window_s": window_s, "busy_s": busy, "program_busy_s": program_busy,
            "device_ops": _top(ops),
            "copies": [[name, idx, s] for (name, idx), s in sorted(copies.items())]}


def stage_profile(calls, device_type: str, device: int) -> tuple[dict, list]:
    """Device milliseconds by stage over `calls()`, run under a profile with
    host operations and Python stacks, and the idle gaps of `device` there by
    the program's function that the host was in."""
    config = torch._C._profiler._ExperimentalConfig(verbose=True)  # Python frames
    with profile(activities=_activities(device_type, host=True), with_stack=True,
                 experimental_config=config) as prof:
        calls()
    events = prof.events()
    stages = dict.fromkeys([s for _, s in STAGE_FILES] + [OTHER], 0.0)
    stages["transforms"] = sum(e.time_range.elapsed_us() for e in events if _is_device(e)
                               and any(k in e.name for k in NTT_KERNELS)) * 1e-3
    for e in events:
        if not _is_device(e) and e.kernels:
            stages[kernel_stage(e.stack)] += sum(
                k.duration for k in e.kernels if not any(n in k.name for n in NTT_KERNELS)) * 1e-3
    raw = _raw_events(prof)
    merged = _merge((e[1], e[2]) for e in raw if e[3] and e[4] == device)
    host = sorted((e[1], _program_frame(e[5])) for e in raw if not e[3] and e[5])
    host = [(t, name) for t, name in host if name is not None]
    return stages, _top(_gaps_by_host(merged, host))


def sync(device_type: str, devices: list[int]) -> None:
    if device_type == "cuda":
        for idx in devices:
            torch.cuda.synchronize(idx)
