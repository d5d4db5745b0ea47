"""Phase tracing spans: a copy of `mxx_tpu/utils/tracing.py` under the
"mxx_tpu_torch" logger.

`span("phase", key=val)` logs entry at DEBUG and exit with elapsed_ms at
INFO. Enable with e.g.::

    import logging
    logging.getLogger("mxx_tpu_torch").setLevel(logging.INFO)
    logging.basicConfig()

or MXX_TRACE=1 in the environment (installs a stderr handler at import).
A disabled span costs one isEnabledFor check. An enabled span synchronizes
the CUDA device (when one is in use) at entry and exit, so elapsed_ms holds
the device work the phase queued and not only its enqueue. For handlers
that collect timings, a span's exit record carries `span`, `elapsed_ms` and
`fields` attributes, an event's record `event` and `fields`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("mxx_tpu_torch")

if os.environ.get("MXX_TRACE"):
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.DEBUG if os.environ.get("MXX_TRACE") == "2" else logging.INFO)


def _fmt_fields(fields: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in fields.items())


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str, **fields):
    """Timed phase span; logs `name started` (DEBUG) and `name finished
    elapsed_ms=...` (INFO). Yields a dict that callers may add exit fields to."""
    if not logger.isEnabledFor(logging.INFO):
        yield {}
        return
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("%s started %s", name, _fmt_fields(fields))
    _sync()
    started = time.monotonic()
    exit_fields: dict = {}
    try:
        yield exit_fields
    finally:
        _sync()
        elapsed_ms = (time.monotonic() - started) * 1e3
        merged = {**fields, **exit_fields}
        logger.info("%s finished elapsed_ms=%.1f %s", name, elapsed_ms, _fmt_fields(merged),
                    extra={"span": name, "elapsed_ms": elapsed_ms, "fields": merged})


def event(name: str, **fields):
    """One-shot INFO event; its record carries `event` and `fields`."""
    if logger.isEnabledFor(logging.INFO):
        logger.info("%s %s", name, _fmt_fields(fields), extra={"event": name, "fields": fields})
