"""Device mesh and row sharding.

Counterpart of `sirius_tpu/parallel/mesh.py`.  A mesh is one `rows` axis:
an ordered tuple of torch devices.  A device may appear more than once,
which makes a virtual mesh (four shards on `cuda:0`, eight on the CPU): the
counterpart of the JAX tests' `--xla_force_host_platform_device_count=8`.
One process drives every device of a mesh, as the JAX package's single
controller does: a shard is a row block placed on its device, and moving
rows between devices is a device-to-device copy (no `torch.distributed`).

A tensor sharded over a mesh is a list of contiguous row blocks, one per
mesh entry in order (`shard_rows`); the blocks may be uneven, and a block
may be empty where there are fewer rows than entries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

ROWS_AXIS = "rows"


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along the `rows` axis."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices, each once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))

    def describe(self) -> str:
        """E.g. '4 shards on 1 device (cuda:0)'."""
        devs = self.distinct
        return (f"{self.size} shard{'s' * (self.size != 1)} on {len(devs)} device{'s' * (len(devs) != 1)} "
                f"({', '.join(map(str, devs))})")


def _device(spec) -> torch.device:
    dev = torch.device(spec)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = torch.cuda.current_device() if dev.index is None and count else dev.index
    if index is None or index >= count:
        raise RuntimeError(f"the mesh names {spec}, but {count} CUDA device(s) are visible")
    return torch.device("cuda", index)


def make_mesh(n_devices: int | None = None, devices: Sequence | None = None) -> Mesh:
    """The first `n_devices` CUDA devices (all of them when None), or the
    explicit `devices` (repeats allowed: a virtual mesh).  Asking for more
    CUDA devices than are visible raises; so does naming one that is not."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices {n_devices} disagrees with the {len(devices)} devices given")
        return Mesh(tuple(_device(d) for d in devices))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is available for a mesh: pass devices=[...] (e.g. ['cpu'] * 8)")
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} devices asked for, {count} CUDA device(s) visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def row_blocks(n: int, size: int) -> list[tuple[int, int]]:
    """[start, stop) of the `size` contiguous blocks of n rows, in order: the
    first n % size blocks one row longer (numpy's `array_split`)."""
    base, extra = divmod(n, size)
    bounds, start = [], 0
    for i in range(size):
        stop = start + base + (i < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> list[torch.Tensor]:
    """x cut along `axis` into the mesh's row blocks, block i on mesh entry
    i's device: a view where that device is x's own, else a copy."""
    return [x.narrow(axis, start, stop - start).to(dev)
            for (start, stop), dev in zip(row_blocks(x.shape[axis], mesh.size), mesh.devices)]


def gather_rows(mesh: Mesh, blocks: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    """The row blocks of `shard_rows` joined along `axis` on the mesh's first
    device."""
    if len(blocks) != mesh.size:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size}")
    return torch.cat([b.to(mesh.first) for b in blocks], axis)
