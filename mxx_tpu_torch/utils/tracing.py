"""The port's one tracer: spans and counters at the layer boundaries of the
program, kept in memory by a recording, on the clock of the device trace.

Off by default. A span then checks one module flag and hands back a shared
no-op context: no clock read, no logging lookup, no wait on the device.
`count(name, n)` always adds n to a process-wide integer (what the kernels'
launch counts cost); a recording reports the deltas over its lifetime.

Turn spans on with a recording::

    with tracing.recording() as rec:
        ...
    rec.spans      # closed spans, in the order they closed
    rec.events     # one-shot events
    rec.counters   # counter deltas over the recording (a Counter)

or with MXX_TRACE=1 in the environment: spans are then on for the whole
process, and each closed span (host milliseconds) and each event is written
as one line to stderr through the "mxx_tpu_torch" logger, the operator's
view; nothing is kept unless a recording is open.

A recorded span holds its name and fields (a caller may add exit fields to
the dict the span yields), its id, its parent's id, a request id (the id of
the outermost span open when it started, so the spans of one preimage call
or one circuit pass share it), its start and end on the host and, where
CUDA is in use, a `torch.cuda.Event` pair recorded on the current stream.
No span waits on the device: the events are read when the recording
closes, after waiting for each span's end event (the work each span
queued, not the whole device).

The clock. Host times are Unix-epoch nanoseconds, the clock of the events
that `torch.profiler` reports: one anchor (`time.time_ns`) is taken when
the outermost recording opens, and every later time is the anchor plus the
advance of a monotonic clock (`time.perf_counter_ns`), so a step of the
wall clock cannot tear a span. A device time is the host time of an anchor
event, recorded on the device when the recording opens or when a span first
meets the device, plus the events' elapsed time from it: exact where the
device had finished its queued work at the anchor, as after the synchronise
that ends a benchmark window.
"""

from __future__ import annotations

import logging
import os
import time
from collections import Counter
from dataclasses import dataclass, field

import torch

logger = logging.getLogger("mxx_tpu_torch")

# the flag every span checks: a recording is open, or MXX_TRACE is set
_on = False
_export = bool(os.environ.get("MXX_TRACE"))
_counts: Counter = Counter()
_recordings: list["Recording"] = []
_stack: list["SpanRecord"] = []  # open spans, innermost last
_next_id = 0
# the clock of the outermost recording (or of MXX_TRACE): epoch and
# monotonic nanoseconds taken together, and per device an anchor event with
# its host time
_anchor = (0, 0)
_device_anchors: dict = {}

if _export:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    _on = True
    _anchor = (time.time_ns(), time.perf_counter_ns())


def _now_ns() -> int:
    """Unix-epoch nanoseconds on the tracer's clock (see the module notes)."""
    return _anchor[0] + time.perf_counter_ns() - _anchor[1]


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`; on whether or not tracing is."""
    _counts[name] += n


def counters() -> Counter:
    """A copy of every counter's total in this process."""
    return Counter(_counts)


def _fmt_fields(fields: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in fields.items())


@dataclass
class SpanRecord:
    name: str
    fields: dict
    id: int
    parent: int | None
    request: int
    start_ns: int
    end_ns: int = 0
    # CUDA events while open; read into device_*_ns when the recording closes
    events: tuple | None = None
    device_start_ns: int | None = None
    device_end_ns: int | None = None

    @property
    def ms(self) -> float:
        """Milliseconds from when both the host had entered the span and the
        device had reached it, to when both had finished it: the span's
        time including the device work it queued."""
        if self.device_end_ns is None:
            return (self.end_ns - self.start_ns) * 1e-6
        start = max(self.start_ns, self.device_start_ns)
        return max(0, max(self.end_ns, self.device_end_ns) - start) * 1e-6


@dataclass
class EventRecord:
    name: str
    fields: dict
    t_ns: int
    request: int | None


@dataclass
class Recording:
    """What spans, events and counters recorded while it was open."""

    spans: list = field(default_factory=list)
    events: list = field(default_factory=list)
    counts_at_open: Counter = field(default_factory=Counter)
    counts_at_close: Counter | None = None

    @property
    def counters(self) -> Counter:
        """Counter deltas over the recording (so far, while it is open)."""
        now = _counts if self.counts_at_close is None else self.counts_at_close
        return Counter({k: v - self.counts_at_open.get(k, 0) for k, v in now.items()
                        if v != self.counts_at_open.get(k, 0)})

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def self_ns(self) -> dict:
        """Each span's host duration less the union of its children's
        intervals, by span id."""
        kids: dict = {}
        for s in self.spans:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
        out = {}
        for s in self.spans:
            covered, reach = 0, s.start_ns
            for a, b in sorted(kids.get(s.id, ())):
                a, b = max(a, reach), min(b, s.end_ns)
                if b > a:
                    covered += b - a
                    reach = b
            out[s.id] = s.end_ns - s.start_ns - covered
        return out


class _Discard(dict):
    """The exit-field dict of a span that is off: writes go nowhere."""

    def __setitem__(self, key, value):
        pass


class _Off:
    __slots__ = ()
    _fields = _Discard()

    def __enter__(self):
        return self._fields

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _anchor_device(dev: int) -> None:
    anchor = torch.cuda.Event(enable_timing=True)
    anchor.record(torch.cuda.current_stream(dev))
    _device_anchors[dev] = (anchor, _now_ns())


def _device_start():
    """(device, start event) recorded on the device's current stream, or None
    where CUDA is not in use; anchors a device on first meeting."""
    if not torch.cuda.is_initialized():
        return None
    dev = torch.cuda.current_device()
    if dev not in _device_anchors:
        _anchor_device(dev)
    start = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(dev))
    return dev, start


class _Span:
    __slots__ = ("rec", "exit_fields")

    def __init__(self, name: str, fields: dict):
        global _next_id
        _next_id += 1
        parent = _stack[-1] if _stack else None
        self.exit_fields: dict = {}
        self.rec = SpanRecord(name, fields, _next_id, parent.id if parent else None,
                              parent.request if parent else _next_id, 0)

    # the host times bracket the span's own events, so that the tracer's
    # cost falls inside the span it measures and not in its parent's self
    # time
    def __enter__(self):
        rec = self.rec
        rec.start_ns = _now_ns()
        _stack.append(rec)
        rec.events = _device_start() if _recordings else None
        return self.exit_fields

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(rec.events[0]))
            rec.events += (end,)
        rec.end_ns = _now_ns()
        if _stack and _stack[-1] is rec:
            _stack.pop()
        elif rec in _stack:
            _stack.remove(rec)
        if self.exit_fields:
            rec.fields = {**rec.fields, **self.exit_fields}
        for r in _recordings:
            r.spans.append(rec)
        if _export:
            logger.info("%s finished elapsed_ms=%.1f %s", rec.name,
                        (rec.end_ns - rec.start_ns) * 1e-6, _fmt_fields(rec.fields))
        return False


def span(name: str, **fields):
    """A span around a layer's work: `with span("layer.step", key=val) as f:`.
    Off, it costs one check of a module flag. The yielded dict takes exit
    fields (`f["built"] = True`)."""
    if not _on:
        return _OFF
    return _Span(name, fields)


def event(name: str, **fields) -> None:
    """A one-shot event: recorded by open recordings, written by MXX_TRACE."""
    if not _on:
        return
    ev = EventRecord(name, fields, _now_ns(), _stack[-1].request if _stack else None)
    for r in _recordings:
        r.events.append(ev)
    if _export:
        logger.info("%s %s", name, _fmt_fields(fields))


class recording:
    """Context manager: spans on while it is open, kept in its `Recording`.
    Recordings nest; each keeps what happened while it was open."""

    def __enter__(self) -> Recording:
        global _on, _anchor
        if not _recordings and not _export:
            _anchor = (time.time_ns(), time.perf_counter_ns())
            _device_anchors.clear()
            if torch.cuda.is_initialized():
                # the one wait: for the work queued before the recording
                # opened, so that the anchor runs as it is recorded
                dev = torch.cuda.current_device()
                queued = torch.cuda.Event()
                queued.record(torch.cuda.current_stream(dev))
                queued.synchronize()
                _anchor_device(dev)
        self.rec = Recording(counts_at_open=Counter(_counts))
        _recordings.append(self.rec)
        _on = True
        return self.rec

    def __exit__(self, *exc):
        global _on
        rec = self.rec
        _recordings.remove(rec)
        _on = bool(_recordings) or _export
        rec.counts_at_close = Counter(_counts)
        for s in rec.spans:
            if s.events is not None and len(s.events) == 3:
                dev, start, end = s.events
                anchor, host = _device_anchors[dev]
                end.synchronize()
                s.device_start_ns = host + round(anchor.elapsed_time(start) * 1e6)
                s.device_end_ns = host + round(anchor.elapsed_time(end) * 1e6)
                s.events = None
        return False
