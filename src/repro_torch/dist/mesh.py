"""Device meshes (port-only): the counterpart of `jax.sharding.Mesh` and
`repro.jaxcompat.make_mesh`.

A `Mesh` is an array of `torch.device`s shaped by named axes, `("data",)`
or `("data", "pod")`. Positions are numbered row-major over the mesh axes
(`coords`, `device`). A sharded fit splits rows over `data_axes` in the
reference runner's order: `lin = lin * size + index` over the data axes
(`shard_index`, `shards`), so shard s holds rows [s * n_local,
(s + 1) * n_local).

`make_mesh` puts one position on each card when there are enough cards.
Asked with `device=`, it puts every position on that one device: that is
how the CPU tests and a one-card machine run 2, 4 or 8 shards, as the
reference's tests run virtual CPU devices.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


def _index(dev: torch.device) -> torch.device:
    """A CUDA device with its index (the current card's when none is given)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An array of devices shaped by named axes; `shape` maps each axis name
    to its size, as `jax.sharding.Mesh.shape` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [_index(torch.device(d)) for d in np.asarray(devices, dtype=object).flat]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(np.asarray(devices, dtype=object)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names must differ, got {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, position: int) -> torch.device:
        return self.devices.flat[position]

    def coords(self, position: int) -> dict[str, int]:
        """Each axis's index of a position."""
        idx = np.unravel_index(position, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def shard_index(self, position: int, axes: Sequence[str]) -> int:
        """The runner's linear index of a position over `axes`."""
        c = self.coords(position)
        lin = 0
        for a in axes:
            lin = lin * self.shape[a] + c[a]
        return lin

    def shards(self, axes: Sequence[str]) -> tuple[int, list[int], list[int]]:
        """(shards over `axes`, each position's shard, each shard's first
        position): a position outside `axes`' extent repeats its shard."""
        n = math.prod(self.shape[a] for a in axes)
        shard_of = [self.shard_index(p, axes) for p in range(self.size)]
        return n, shard_of, [shard_of.index(s) for s in range(n)]

    def group(self, position: int, axes: Sequence[str]) -> list[int]:
        """The positions that reduce together with `position` over `axes`
        (those that share its index on every other axis), in linear order
        over `axes`."""
        axes = tuple(axes)
        c = self.coords(position)
        members = [p for p in range(self.size)
                   if all(self.coords(p)[a] == c[a]
                          for a in self.axis_names if a not in axes)]
        return sorted(members, key=lambda p: self.shard_index(p, axes))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], device=None) -> Mesh:
    """A mesh of `axis_shapes` named `axis_names`. With `device=None`, one
    position on each card (cuda:0, cuda:1, ...): it raises when the
    machine has fewer cards than positions. With `device` ("cpu", "cuda",
    "cuda:1"), every position on that device."""
    shape = tuple(int(s) for s in axis_shapes)
    if len(shape) != len(tuple(axis_names)) or any(s < 1 for s in shape):
        raise ValueError(f"axis_shapes {shape} must be positive, one per axis of "
                         f"{tuple(axis_names)}")
    n = math.prod(shape)
    if device is None:
        resolve_device(None)  # raises without a card
        cards = torch.cuda.device_count()
        if cards < n:
            raise ValueError(
                f"a mesh of {n} positions needs {n} cards, this machine has {cards}; "
                "pass device= (for example 'cuda:0' or 'cpu') to put every "
                "position on one device")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [_index(resolve_device(device))] * n
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)
