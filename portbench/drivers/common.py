"""What the drivers share: seeds, devices and the keeper of judged answers."""

from __future__ import annotations

import hashlib

import torch


# the configuration keys of a DCRT ring, as the drivers' CONFIG_SCHEMA name them
RING_SCHEMA = {
    "type": "object",
    "required": ["ring_dimension", "crt_depth", "crt_bits", "base_bits"],
    "additionalProperties": False,
    "properties": {
        "ring_dimension": {"type": "integer", "minimum": 2},
        "crt_depth": {"type": "integer", "minimum": 1},
        "crt_bits": {"type": "integer", "minimum": 2, "maximum": 30},
        "base_bits": {"type": "integer", "minimum": 1},
    },
}


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def uniform_residues(moduli: torch.Tensor, shape: tuple, g: torch.Generator) -> torch.Tensor:
    """Uniform residues [L, *shape] (a 62-bit draw mod q: bias below 2^-31)."""
    x = torch.randint(0, 1 << 62, (moduli.shape[0],) + tuple(shape), generator=g,
                      dtype=torch.int64, device=moduli.device)
    return x % moduli.reshape((-1,) + (1,) * len(shape))


class Keeper:
    """Copies of the answers to be judged once the window has closed.

    Request i is kept when i % every == offset, the offset drawn from the
    seed; the copies go to `slots` host buffers in turn (pinned, allocated in
    set-up), by a copy stream that waits for the request's work, so the
    window neither waits for them nor holds them on the device. The last
    `slots` kept answers are judged."""

    def __init__(self, device: torch.device, every: int, slots: int, offset: int):
        self.device, self.every, self.slots, self.offset = device, every, slots, offset
        self.bufs: list[list[torch.Tensor]] = []
        self.meta: list = [None] * slots
        self.count = 0
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def allocate(self, like: list[torch.Tensor]) -> None:
        pin = self.device.type == "cuda"
        self.bufs = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for t in like]
                     for _ in range(self.slots)]

    def wants(self, i: int) -> bool:
        return i % self.every == self.offset

    def keep(self, meta, tensors: list[torch.Tensor]) -> None:
        if self.count and self.meta[(self.count - 1) % self.slots] == meta:
            return  # kept already
        slot = self.count % self.slots
        self.count += 1
        self.meta[slot] = meta
        if self.stream is None:
            for buf, t in zip(self.bufs[slot], tensors):
                buf.copy_(t)
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for buf, t in zip(self.bufs[slot], tensors):
                buf.copy_(t, non_blocking=True)
                t.record_stream(self.stream)

    def kept(self) -> list:
        """(meta, host tensors) of the kept answers, oldest first; call after
        the device has been synchronised."""
        n = min(self.count, self.slots)
        order = [(self.count - n + j) % self.slots for j in range(n)]
        return [(self.meta[s], self.bufs[s]) for s in order]
