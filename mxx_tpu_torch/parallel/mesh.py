"""Device meshes: limb/column sharding for DCRT polynomial matrices.

The port's counterpart of `mxx_tpu/parallel/mesh.py`. CRT limbs are
independent moduli, so the limb axis shards with no communication; matrix
column blocks shard like tensor parallelism; batches of preimage requests
shard data-parallel over columns. CRT reconstruction folds the limb shards
together (`crt_collective.py`).

The mesh is single-controller, as the JAX mesh is: one process holds a 2-D
array of `torch.device`s with axis names ("limb", "col"). A shard's tensors
live on its device and its local work runs there with an explicit device; a
reduction brings the per-shard partials to one device and adds them in
shard order, which is written out because float64 sums depend on it.
`torch.distributed`'s DeviceMesh and DTensor are not used: they are
multi-process SPMD, need a launcher, and NCCL refuses two ranks on one GPU,
so they could run neither on the CPU nor on a machine with one card. Here a
mesh may repeat a device (as `jax.sharding.Mesh` may): several logical
shards then share it, which is how the CPU tests and a one-card machine run
the sharded logic.

The JAX package's `pcast_varying` has no counterpart: it exists only for
JAX's varying-axis typing under `shard_map`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch

LIMB_AXIS = "limb"
COL_AXIS = "col"


def factor_devices(n_devices: int) -> tuple[int, int]:
    """Split n_devices into (limb_shards, col_shards), preferring 2D."""
    nl = 1
    m = n_devices
    while m % 2 == 0 and nl < 4:
        nl *= 2
        m //= 2
    return nl, n_devices // nl


def _device(d) -> torch.device:
    """`d` as a torch.device with an index on CUDA, so that a shard's device
    compares equal to the device of the tensors placed there."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 2-D array of devices with named axes; a device may repeat."""

    def __init__(self, devices, axis_names: tuple[str, ...] = (LIMB_AXIS, COL_AXIS)):
        rows = [[_device(d) for d in row] for row in devices]
        if len(axis_names) != 2 or not rows or any(len(r) != len(rows[0]) or not r
                                                    for r in rows):
            raise ValueError("a mesh is a non-empty 2-D array of devices with two axis names")
        self.devices = rows
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, (len(self.devices), len(self.devices[0]))))

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def device(self, **index: int) -> torch.device:
        """The device at the given axis indices (omitted axes: index 0)."""
        unknown = set(index) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no axis {sorted(unknown)} in {self.axis_names}")
        i, j = (index.get(a, 0) for a in self.axis_names)
        return self.devices[i][j]

    def __repr__(self):
        return f"Mesh({self.shape}, {[[str(d) for d in r] for r in self.devices]})"


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A (limb, col) mesh of n_devices shards over the devices of `device`'s
    type, taken in order as `jax.devices()[:n]`; past the last device the
    shards go round-robin, so on "cpu" every shard is the one CPU device
    (the counterpart of XLA's forced host device count). n_devices=None: one
    shard per device (on the card's machine, `torch.cuda.device_count()`)."""
    kind = torch.device(device).type
    if kind == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(kind)]
    if not devs:
        raise RuntimeError(f"no {kind} device for a mesh")
    n = len(devs) if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    nl, nc = factor_devices(n)
    return Mesh([[devs[(i * nc + j) % len(devs)] for j in range(nc)] for i in range(nl)])


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: `spec[k]` names the mesh axis that dim k
    is split over, or None (replicated over every axis no dim names)."""

    mesh: Mesh
    spec: tuple

    def _blocks(self, shape, index: dict[str, int]) -> tuple:
        sizes = self.mesh.shape
        out = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                out.append(slice(None))
                continue
            parts = sizes[axis]
            if shape[dim] % parts:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split into {parts} "
                                 f"{axis} shards")
            w = shape[dim] // parts
            out.append(slice(index[axis] * w, (index[axis] + 1) * w))
        return tuple(out)

    def _positions(self):
        nl, nc = (len(self.mesh.devices), len(self.mesh.devices[0]))
        names = self.mesh.axis_names
        for i, j in itertools.product(range(nl), range(nc)):
            yield i, j, {names[0]: i, names[1]: j}

    def split(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        """The local tensor of every shard, [limb][col], each on its device."""
        out = [[None] * len(self.mesh.devices[0]) for _ in self.mesh.devices]
        for i, j, index in self._positions():
            block = x[self._blocks(x.shape, index)]
            out[i][j] = block.to(self.mesh.devices[i][j]).contiguous()
        return out

    def join(self, shards: list[list[torch.Tensor]], device=None) -> torch.Tensor:
        """The whole tensor from the shards' local tensors, on `device`
        (default: the device of the first shard). Replicated positions are
        read from index 0 of their axis."""
        device = torch.device(device) if device is not None else self.mesh.devices[0][0]
        names = self.mesh.axis_names
        split_axes = [a for a in self.spec if a is not None]
        sizes = self.mesh.shape
        local = shards[0][0]
        shape = list(local.shape)
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                shape[dim] *= sizes[axis]
        out = torch.empty(shape, dtype=local.dtype, device=device)
        for i, j, index in self._positions():
            if any(index[a] for a in names if a not in split_axes):
                continue
            out[self._blocks(shape, index)] = shards[i][j].to(device)
        return out


def matrix_sharding(mesh: Mesh, shard_cols: bool = False) -> Sharding:
    """Sharding for int64[L, r, c, n]: limbs always split; columns optional."""
    return Sharding(mesh, (LIMB_AXIS, None, COL_AXIS if shard_cols else None, None))


def table_sharding(mesh: Mesh) -> Sharding:
    """Sharding for per-limb tables int64[L, ...]."""
    return Sharding(mesh, (LIMB_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
