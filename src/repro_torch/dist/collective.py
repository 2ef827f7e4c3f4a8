"""Pluggable collectives for the sharded histogram allreduce; counterpart
of `repro.dist.collective` (DESIGN.md §15).

The per-level histogram allreduce is the distributed hot path of
Algorithm 1 (the paper's NCCL AllReduceHistograms). A `Collective` is the
strategy object `Booster.fit(mesh=, collective=)` picks, with optional
compressed payloads (f16 or int16 fixed point) and an error check that
falls back to the exact f32 reduction.

The positions of a mesh run as threads of `group.spmd`; a collective posts
each position's tensor at a rendezvous and every position reduces what it
needs in a fixed position order on its own device, so each holds the same
result:

  * ``psum`` — the members' tensors summed in position order.
  * ``ring`` — the reference's segmented reduce-scatter + all-gather over
    2·(p−1) hops of ⌈N/p⌉-element segments: each hop sends a segment in
    the wire dtype to the next position and adds it in the accumulation
    dtype, so f32 and f16 hops add the same two operands in the same order
    as the reference's `ppermute` ring. As there, an f16 ring leaves a
    segment's owner its f32 total and hands the others its f16 copy: its
    result is the same on every position only up to that rounding.
  * ``hier`` — a psum within groups of contiguous positions, a ring over
    the groups' lane 0, and a grouped psum that broadcasts lane 0's totals
    (or, on a 2-axis mesh, a psum over the inner axis and a ring over the
    outer one). Compression applies to the ring's hops only.

Compression (``compression=``): ``"f16"`` sends float16 bin sums; ``"q16"``
scales by the shared ``m_sum / 32766`` (``m_sum`` = psum of each
position's max |x|, so no partial sum leaves int16) and reduces integers,
exactly and in any order, so every strategy gives the same result bit for
bit. The error bound is ``psum(max |decode(encode(x)) − x|)``; a level
whose bound exceeds ``tolerance · m_sum + 1e-30`` takes the exact f32
reduction instead. The reference branches with `lax.cond`; here both
results are computed and `torch.where` selects, so no level reads its
predicate on the host, and the fallback tally is a device counter a
round (`fallback_count`), read with the chunk's metrics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.dist import group as G

_COMPRESSIONS = (None, "f16", "q16")
Q16_LEVELS = 32766.0  # |q| <= 32766 keeps a sum of partials inside int16


def _check_compression(compression):
    if compression not in _COMPRESSIONS:
        raise ValueError(
            f"compression must be one of {_COMPRESSIONS}, got {compression!r}"
        )


_psum = G.psum_members


def _ring_allreduce(shard: G.Shard, x: torch.Tensor | None, members: list[int],
                    pos: int, wire: torch.dtype, acc: torch.dtype,
                    hops: int | None = None) -> torch.Tensor | None:
    """`repro.dist.collective._ring_allreduce`: segmented ring
    reduce-scatter + all-gather. `members` is the ring in order, `pos` this
    shard's place in it; the shard receives from members[pos - 1]. A shard
    outside the ring passes x=None and `hops` (the ring's 2·(n−1)), posting
    nothing at each of them."""
    if x is None:
        for _ in range(hops):
            shard.exchange(None, "collective-permute")
        return None
    n = len(members)
    if n == 1:
        return x.to(acc)
    shape, numel = x.shape, x.numel()
    flat = x.reshape(-1).to(acc)
    flat = torch.nn.functional.pad(flat, (0, (-numel) % n))
    segs = flat.reshape(n, -1).clone()
    pred = members[(pos - 1) % n]
    for t in range(n - 1):  # reduce-scatter
        recv = shard.exchange(segs[(pos - t) % n].to(wire, copy=True),
                              "collective-permute")[pred]
        segs[(pos - t - 1) % n] += recv.to(shard.device).to(acc)
    for t in range(n - 1):  # all-gather
        recv = shard.exchange(segs[(pos + 1 - t) % n].to(wire, copy=True),
                              "collective-permute")[pred]
        segs[(pos - t) % n] = recv.to(shard.device).to(acc)
    return segs.reshape(-1)[:numel].reshape(shape)


class Collective:
    """Reduction strategy for shard-partial tensors inside `group.spmd`.

    Subclasses implement `_reduce_exact` (exact allreduce, any dtype) and
    `_reduce_wire` (allreduce whose wire dtype is `wire`, accumulating in
    `acc`), plus the analytic `bytes_allreduce` wire model. The compressed
    encode / check / fallback is shared here in `allreduce_hist`.
    """

    name = "?"

    def __init__(self, mesh, data_axes: Sequence[str] = ("data",), *,
                 compression: str | None = None, tolerance: float = 0.05):
        _check_compression(compression)
        if tolerance < 0:
            raise ValueError(f"tolerance must be >= 0, got {tolerance}")
        self.mesh = mesh
        self.axes = tuple(data_axes)
        self.sizes = tuple(mesh.shape[a] for a in self.axes)
        self.n_devices = math.prod(self.sizes)
        self.compression = compression
        self.tolerance = float(tolerance)
        self._tally: dict[int, list] = {}  # position -> this round's fallback flags
        self._groups: dict = {}

    # --- identity ----------------------------------------------------------
    @property
    def key(self):
        return (type(self).__name__, self.axes, self.compression, self.tolerance)

    def _group(self, position: int, axes: Sequence[str]) -> list[int]:
        k = (position, tuple(axes))
        if k not in self._groups:
            self._groups[k] = self.mesh.group(position, axes)
        return self._groups[k]

    def _index(self, position: int, axis: str) -> int:
        return self.mesh.coords(position)[axis]

    # --- the fallback tally, a device counter ------------------------------
    def begin_round(self) -> None:
        """Reset this shard's fallback tally (at the top of a round)."""
        shard = G.current()
        if shard is None:
            self._tally = {}
        else:
            self._tally[shard.position] = []

    def fallback_count(self) -> torch.Tensor:
        """This round's count of compressed allreduces that fell back to
        f32, a 0-d int32 tensor on the shard's device (0 without
        compression); every position holds the same count."""
        shard = G.current_shard()
        flags = self._tally.get(shard.position)
        if not flags:
            return torch.zeros((), dtype=torch.int32, device=shard.device)
        return torch.stack(flags).sum().to(torch.int32)

    # --- reduction entry points (inside a shard) ----------------------------
    def psum(self, x: torch.Tensor, axes: Sequence[str] | None = None) -> torch.Tensor:
        """`jax.lax.psum` over `axes` (default: the data axes): the members'
        tensors summed in position order."""
        shard = G.current_shard()
        return _psum(shard, x, self._group(shard.position, self.axes if axes is None else axes))

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        """Exact allreduce (root sums, the sentinel's count, fallbacks)."""
        return self._reduce_exact(x)

    def allreduce_hist(self, hist: torch.Tensor) -> torch.Tensor:
        """The per-level histogram allreduce: compressed when configured,
        with the error check and the f32 fallback chosen on the device."""
        if self.compression is None:
            return self._reduce_exact(hist)
        dev = hist.device
        m_local = hist.abs().max()
        if self.compression == "f16":
            comp = hist.to(torch.float16)
            err_local = (comp.to(torch.float32) - hist).abs().max()
            # One small collective: [max magnitude, this shard's error].
            m_sum, err_bound = self.psum(torch.stack([m_local, err_local]))
            compressed = self._reduce_wire(hist, torch.float16, torch.float32)
        else:  # q16 fixed point
            m_sum = self.psum(m_local)
            # |sum_s x_s| <= sum_s max|x_s| = m_sum elementwise, so a scale
            # of m_sum / 32766 keeps every partial sum inside int16. Divide
            # by tensors: torch divides by a Python number as a multiply by
            # its reciprocal.
            scale = (torch.clamp_min(m_sum, 1e-30)
                     / torch.full((), Q16_LEVELS, dtype=torch.float32, device=dev))
            q = torch.clamp(torch.round(hist / scale), -32767.0, 32767.0).to(torch.int32)
            err_local = (q.to(torch.float32) * scale - hist).abs().max()
            err_bound = self.psum(err_local)
            compressed = self._reduce_wire(q, torch.int16, torch.int32).to(torch.float32) * scale
        ok = err_bound <= self.tolerance * m_sum + 1e-30
        out = torch.where(ok, compressed, self._reduce_exact(hist))
        shard = G.current_shard()
        if shard.position in self._tally:
            self._tally[shard.position].append(torch.where(ok, 0, 1).to(torch.int32))
        return out

    # --- strategy internals -------------------------------------------------
    def _reduce_exact(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _reduce_wire(self, x, wire, acc) -> torch.Tensor:
        raise NotImplementedError

    # --- analytic wire model (DESIGN.md §15) --------------------------------
    def wire_bytes_elem(self) -> int:
        """Bytes per element moved by a compressed hist allreduce (4 when
        the strategy cannot shrink its wire dtype)."""
        return 4

    def bytes_allreduce(self, n_elems: int, elem_bytes: int = 4) -> int:
        """Total wire bytes (summed over every device) for one allreduce of
        n_elems, under the bandwidth-optimal 2·(p−1)/p-per-device model."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        comp = f", compression={self.compression}" if self.compression else ""
        return f"{type(self).__name__}({self.n_devices} devices{comp})"


class PsumCollective(Collective):
    """The members' sum in position order (the reference's `jax.lax.psum`).

    f16 compression sums the f16 tensors in f16. q16 sums int32 (psum
    carries no int16 partials), so its wire bytes stay 4: pick ``ring`` or
    ``hier`` for narrower q16 transport.
    """

    name = "psum"

    def _reduce_exact(self, x):
        return self.psum(x)

    def _reduce_wire(self, x, wire, acc):
        if wire == torch.int16:  # psum cannot carry int16 partials
            return self.psum(x.to(torch.int32))
        return self.psum(x.to(wire)).to(acc)

    def wire_bytes_elem(self) -> int:
        return 2 if self.compression == "f16" else 4

    def bytes_allreduce(self, n_elems, elem_bytes=4):
        p = self.n_devices
        return 2 * (p - 1) * n_elems * elem_bytes


class RingCollective(Collective):
    """Explicit segmented ring over one data axis: 2·(p−1)/p of the payload
    a device an allreduce, compressed dtypes on the wire (f16 hops
    accumulate in f32; q16 hops are int16 with int32 accumulation, exact)."""

    name = "ring"

    def __init__(self, mesh, data_axes=("data",), **kw):
        super().__init__(mesh, data_axes, **kw)
        if len(self.axes) != 1:
            raise ValueError(
                f"ring collective runs over exactly one mesh axis, got "
                f"{self.axes}; use 'hier' for multi-axis meshes"
            )

    def _ring(self, x, wire, acc):
        shard = G.current_shard()
        members = self._group(shard.position, self.axes)
        return _ring_allreduce(shard, x, members, self._index(shard.position, self.axes[0]),
                               wire, acc)

    def _reduce_exact(self, x):
        return self._ring(x, x.dtype, x.dtype)

    def _reduce_wire(self, x, wire, acc):
        return self._ring(x.to(acc), wire, acc)

    def wire_bytes_elem(self) -> int:
        return 2 if self.compression in ("f16", "q16") else 4

    def bytes_allreduce(self, n_elems, elem_bytes=4):
        p = self.n_devices
        seg = -(-n_elems // p)  # padded segment length
        return 2 * (p - 1) * p * seg * elem_bytes


class HierarchicalCollective(Collective):
    """Two-level reduction: intra-host psum, inter-host ring, intra-host
    broadcast.

    On a two-axis mesh ``(inter, intra)`` the groups are the mesh's; on one
    axis of size p the positions are factored into contiguous groups of
    ``group_size`` (default: the largest divisor <= sqrt(p)). Only lane 0 of
    each group joins the inter-host ring, and a grouped psum of lane 0's
    totals (the other lanes add zeros) broadcasts them group-wide.
    Compression applies to the ring's hops only; the intra-host psum stays
    f32 / int32.
    """

    name = "hier"

    def __init__(self, mesh, data_axes=("data",), *, group_size=None, **kw):
        super().__init__(mesh, data_axes, **kw)
        if len(self.axes) == 2:
            self.n_hosts, self.group_size = self.sizes
            if group_size is not None and group_size != self.group_size:
                raise ValueError(
                    f"group_size={group_size} conflicts with the inner mesh "
                    f"axis {self.axes[1]} of size {self.sizes[1]}"
                )
        elif len(self.axes) == 1:
            p = self.n_devices
            if group_size is None:
                group_size = max(
                    (d for d in range(1, int(math.isqrt(p)) + 1) if p % d == 0),
                    default=1,
                )
            if p % group_size != 0:
                raise ValueError(
                    f"group_size={group_size} must divide the "
                    f"{p}-device data axis"
                )
            self.group_size, self.n_hosts = group_size, p // group_size
        else:
            raise ValueError(
                f"hier collective supports 1- or 2-axis meshes, got {self.axes}"
            )

    @property
    def key(self):
        return super().key + (self.group_size,)

    def _two_level(self, x, wire, acc):
        shard = G.current_shard()
        p = shard.position
        g, h = self.group_size, self.n_hosts
        if len(self.axes) == 2:
            y = self.psum(x.to(acc), self.axes[1:])
            ring = self._group(p, self.axes[:1])  # this inner lane's ring
            return _ring_allreduce(shard, y, ring, self._index(p, self.axes[0]), wire, acc)
        # One axis, factored groups: intra reduce -> lane-0 ring -> intra
        # broadcast. The members of the axis in order, then this position's
        # group of g and the ring of each group's lane 0.
        line = self._group(p, self.axes)
        idx = line.index(p)
        lane, host = idx % g, idx // g
        intra = line[host * g:(host + 1) * g]
        y = _psum(shard, x.to(acc), intra)
        if lane == 0:
            t = _ring_allreduce(shard, y, line[::g], host, wire, acc)
        else:  # outside the ring: its hops post nothing, its total is zeros
            _ring_allreduce(shard, None, [], 0, wire, acc, hops=2 * (h - 1) if h > 1 else 0)
            t = torch.zeros_like(y)
        return _psum(shard, t, intra)

    def _reduce_exact(self, x):
        return self._two_level(x, x.dtype, x.dtype).to(x.dtype)

    def _reduce_wire(self, x, wire, acc):
        return self._two_level(x.to(acc), wire, acc)

    def wire_bytes_elem(self) -> int:
        # Blended per-element cost: intra hops stay 4 B, inter hops shrink.
        return 2 if self.compression in ("f16", "q16") else 4

    def bytes_allreduce(self, n_elems, elem_bytes=4):
        g, h = self.group_size, self.n_hosts
        seg = -(-n_elems // h)
        intra = 2 * h * 2 * (g - 1) * n_elems * 4  # reduce + broadcast, f32
        inter = 2 * (h - 1) * h * seg * elem_bytes  # lane-0 ring
        return intra + inter


_REGISTRY: dict[str, type[Collective]] = {
    "psum": PsumCollective,
    "ring": RingCollective,
    "hier": HierarchicalCollective,
    "hierarchical": HierarchicalCollective,
}


def register_collective(name: str, cls: type[Collective]) -> type[Collective]:
    """Register a Collective strategy under a `fit(collective=...)` name."""
    if not (isinstance(cls, type) and issubclass(cls, Collective)):
        raise TypeError(f"{cls} must subclass Collective")
    _REGISTRY[name] = cls
    return cls


def collective_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_collective(spec, mesh, data_axes: Sequence[str] = ("data",), *,
                   compression: str | None = None, tolerance: float = 0.05,
                   **kw) -> Collective:
    """Resolve `fit(collective=...)`: a registry name, a Collective
    subclass, or a constructed Collective (returned as it is)."""
    if isinstance(spec, Collective):
        return spec
    if isinstance(spec, type) and issubclass(spec, Collective):
        return spec(mesh, data_axes, compression=compression, tolerance=tolerance, **kw)
    if isinstance(spec, str):
        cls = _REGISTRY.get(spec)
        if cls is None:
            raise ValueError(
                f"unknown collective {spec!r}; registered: "
                f"{', '.join(collective_names())}"
            )
        return cls(mesh, data_axes, compression=compression, tolerance=tolerance, **kw)
    raise TypeError(
        f"collective must be a name, Collective subclass or instance, "
        f"got {type(spec)}"
    )


# --- per-round communication accounting (DESIGN.md §15) ---------------------


@dataclasses.dataclass(frozen=True)
class CommStats:
    """Analytic per-round communication profile of a sharded fit: bytes
    are wire totals over all devices under the strategy's model;
    `fallback_events` is measured and filled in after the fit."""

    collective: str
    compression: str | None
    devices: int
    bytes_per_round: int
    bytes_per_round_f32: int
    collective_calls_per_round: int
    hist_bytes_per_level: tuple[int, ...]
    fallback_events: int = 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hist_bytes_per_level"] = list(self.hist_bytes_per_level)
        return d


def round_comm_stats(collective: Collective, *, max_depth: int, n_features: int,
                     max_bins: int, n_trees_per_round: int = 1,
                     sentinel: bool = False) -> CommStats:
    """Bytes and collective calls of ONE boosting round under Algorithm 1:
    per tree a root-sum allreduce and one histogram allreduce a level
    (sharded growth builds every level in full), plus the compression's
    scale and error scalars and the numeric sentinel's count."""
    comp = collective.compression
    wire = collective.wire_bytes_elem()
    per_level, per_level_f32 = [], []
    calls = 0
    for level in range(max_depth):
        n_elems = (2 ** level) * n_features * max_bins * 2
        per_level.append(collective.bytes_allreduce(n_elems, wire))
        per_level_f32.append(collective.bytes_allreduce(n_elems, 4))
        calls += 1
        if comp == "f16":
            calls += 1  # stacked [max, err] scalar psum
        elif comp == "q16":
            calls += 2  # max psum, then err psum (scale-dependent)
    overhead = 0
    if comp is not None:
        # The scale and error scalars travel by plain psum (not the
        # strategy): bandwidth-optimal model 2·(p−1)·N·B.
        scalars = 2 * max_depth
        overhead = 2 * (collective.n_devices - 1) * scalars * 4
    root = collective.bytes_allreduce(2, 4)
    k = n_trees_per_round
    bytes_round = k * (sum(per_level) + overhead + root)
    bytes_round_f32 = k * (sum(per_level_f32) + root)
    calls = k * (calls + 1)  # +1 root sum per tree
    if sentinel:
        bytes_round += collective.bytes_allreduce(1, 4)
        bytes_round_f32 += collective.bytes_allreduce(1, 4)
        calls += 1
    return CommStats(
        collective=collective.name,
        compression=comp,
        devices=collective.n_devices,
        bytes_per_round=int(bytes_round),
        bytes_per_round_f32=int(bytes_round_f32),
        collective_calls_per_round=int(calls),
        hist_bytes_per_level=tuple(int(b) for b in per_level),
    )
