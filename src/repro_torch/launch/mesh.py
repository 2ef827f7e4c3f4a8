"""Production meshes; counterpart of `repro.launch.mesh`.

A function, not a module-level constant: importing this module touches no
device. Single pod: (data=16, model=16), 256 positions. Multi-pod: (pod=2,
data=16, model=16), 512 positions; `pod` is the outer data-parallel axis.
The meshes are `dist.make_mesh` meshes: with `device=None` one position a
card (it raises on a machine with fewer cards); with `device=` every
position on that one device, as the CPU tests and a one-card machine run
them.
"""
from __future__ import annotations

from repro_torch.dist.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes used for batch data parallelism."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def seq_axes_long(mesh: Mesh) -> tuple[str, ...]:
    """Axes used to shard the KV cache sequence dim for long_500k (batch=1)."""
    return ("pod", "data", "model") if "pod" in mesh.axis_names else ("data", "model")
