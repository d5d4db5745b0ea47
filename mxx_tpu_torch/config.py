"""Environment-variable configuration: the knobs of the circuit evaluator,
the matrix layer, the LUT path and the artifact store, copied from
`mxx_tpu/config.py` with the same variable names and defaults."""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def circuit_live_bytes_budget() -> int:
    """Device-resident wire budget for the batched circuit evaluator; idle
    wires beyond it spill to host compact bytes. 0 = unbounded."""
    return _env_int("MXX_CIRCUIT_LIVE_BYTES_BUDGET", 0)


def lut_preimage_chunk_size() -> int:
    """Preimage requests per call of `preimage_batched_chunked`."""
    return _env_int("LUT_PREIMAGE_CHUNK_SIZE", 16)


def aux_sampling_chunk_width() -> int:
    """Column width of the chunks a stored GGH15 preimage is split into."""
    return _env_int("AUX_SAMPLING_CHUNK_WIDTH", 1 << 12)


def mul_decompose_column_chunk_width() -> int:
    """Column width of the chunks `PolyMatrix.mul_decompose` decomposes and
    multiplies one at a time; 0 = no chunking."""
    return _env_int("MXX_MUL_DECOMPOSE_COLUMN_CHUNK_WIDTH", 0)


def lut_bytes_limit() -> int:
    """Largest batch file of the artifact store; bigger buffers split."""
    return _env_int("LUT_BYTES_LIMIT", 1 << 30)


def offload_budget_bytes() -> int:
    """Device-resident budget for accumulated LWE K_high preimage targets:
    beyond it, assembled targets spill to host/disk memmaps
    (matrix/offload.py) and rehydrate chunk by chunk inside the batched
    preimage pass. 0 = unbounded."""
    return _env_int("MXX_OFFLOAD_BUDGET_BYTES", 0)


def lut_index_sync_every() -> int:
    """Flush the storage JSON index every N batch-file writes."""
    return _env_int("LUT_INDEX_SYNC_EVERY", 64)
