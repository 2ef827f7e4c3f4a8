"""The SPMD executor (port-only): what `shard_map` is to the reference.

`spmd(mesh, fn, *per_position_args)` runs `fn` once per mesh position, each
call in a thread of its own under `torch.cuda.device(position's device)`
and on the caller's current stream of that device, as
`torch.nn.parallel.parallel_apply` runs replicas. Every position runs the
port's ordinary per-shard code (one `grow_tree`, its kernels launched once
a shard); only the collectives see the other positions.

A collective meets the others at a rendezvous: `exchange(x)` posts this
position's tensor, waits at a barrier until every position has posted, and
returns the posted tensors of all positions in linear order. Each position
tallies the bytes it posts by kind of collective ("all-reduce",
"all-gather", "collective-permute": the names XLA's HLO gives them), read
after a run through `Shard.posted()`: the port's wire model, one dict
update an exchange and no host read. Slots are
double buffered, so one barrier a call suffices: a position can post into
a buffer again only after every position has passed the next barrier, by
which time each has read the previous exchange. Each position then reduces
what it needs in a fixed position order, on its own device, so every
position holds the same result.

A position that raises aborts the barrier: the others leave their wait
with `BrokenBarrierError`, and `spmd` raises the first real exception in
position order. A position that never reaches a rendezvous breaks it
after `BARRIER_TIMEOUT_S`, so a run never hangs.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, NamedTuple, Sequence

import torch

# Seconds a position waits at a rendezvous for the others before the run fails.
BARRIER_TIMEOUT_S = 300.0

_local = threading.local()


class Shard(NamedTuple):
    """The calling thread's place in a run: its group, position, device."""

    group: "ShardGroup"
    position: int
    device: torch.device

    def exchange(self, x, kind: str = "all-reduce") -> list:
        return self.group.exchange(self.position, x, kind)

    def posted(self) -> dict[str, int]:
        """Bytes this position has posted so far in the run, by kind."""
        return dict(self.group.posted[self.position])


def current() -> Shard | None:
    """The calling thread's shard, or None outside `spmd`."""
    return getattr(_local, "shard", None)


def current_shard() -> Shard:
    shard = current()
    if shard is None:
        raise RuntimeError("a collective runs inside a shard of dist.spmd(mesh, fn, ...)")
    return shard


def all_gather(x: torch.Tensor, axes) -> torch.Tensor:
    """`jax.lax.all_gather(x, axes, tiled=True)`: the members' tensors over
    `axes` concatenated along dim 0 in the runner's linear order, on the
    calling shard's device."""
    shard = current_shard()
    xs = shard.exchange(x, "all-gather")
    return torch.cat([xs[m].to(shard.device) for m in shard.group.members(shard.position, axes)])


def psum_members(shard: Shard, x: torch.Tensor, members: list[int]) -> torch.Tensor:
    """The members' tensors summed in position order, on this shard's
    device (every position posts, so each call is one rendezvous): the one
    summation order every psum of the port uses, so every member holds the
    same sum."""
    xs = shard.exchange(x)
    acc = xs[members[0]].to(shard.device)
    for m in members[1:]:
        acc = acc + xs[m].to(shard.device)
    return acc


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """`jax.lax.psum(x, axes)`: the members' tensors over `axes` (a name or
    names) summed in the runner's linear order."""
    shard = current_shard()
    return psum_members(shard, x, shard.group.members(shard.position, axes))


class ShardGroup:
    """The rendezvous of one `spmd` run over a mesh's positions."""

    def __init__(self, mesh, timeout: float = BARRIER_TIMEOUT_S):
        self.mesh = mesh
        self.size = mesh.size
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._slots = [[None] * self.size, [None] * self.size]
        self._turn = [0] * self.size  # each position's count of exchanges
        self.posted: list[dict[str, int]] = [{} for _ in range(self.size)]
        self._members: dict = {}

    def members(self, position: int, axes) -> list[int]:
        """`mesh.group(position, axes)`, cached: the positions that reduce
        with `position` over `axes` (a name or names), in linear order."""
        key = (position, (axes,) if isinstance(axes, str) else tuple(axes))
        if key not in self._members:
            self._members[key] = self.mesh.group(*key)
        return self._members[key]

    def exchange(self, position: int, x, kind: str = "all-reduce") -> list:
        """Post `x`, tally its bytes under `kind` (a tensor's; nothing for
        any other value), wait for every position, return all posted
        values."""
        nbytes = x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0
        tally = self.posted[position]
        tally[kind] = tally.get(kind, 0) + nbytes
        if self.size == 1:
            return [x]
        buf = self._slots[self._turn[position] & 1]
        self._turn[position] += 1
        buf[position] = x
        self._barrier.wait()
        return list(buf)

    def abort(self) -> None:
        self._barrier.abort()


def _stream_guard(dev: torch.device, stream):
    if dev.type != "cuda":
        return contextlib.nullcontext()
    guard = contextlib.ExitStack()
    guard.enter_context(torch.cuda.device(dev))
    guard.enter_context(torch.cuda.stream(stream))
    return guard


def spmd(mesh, fn: Callable, *args: Sequence[Any],
         timeout: float = BARRIER_TIMEOUT_S) -> list:
    """Run `fn(args[0][p], args[1][p], ...)` at every position p of `mesh`,
    each in its own thread on the position's device; return the results in
    position order. Each argument is a sequence with one entry a position."""
    if current() is not None:
        raise RuntimeError("dist.spmd does not nest")
    n = mesh.size
    for a in args:
        if len(a) != n:
            raise ValueError(f"each argument needs one entry a position ({n}), got {len(a)}")
    group = ShardGroup(mesh, timeout)
    # The caller's stream on each device, so that the shards' work is
    # ordered after what the caller queued there.
    streams = {d: torch.cuda.current_stream(d) for d in set(mesh.devices.flat)
               if d.type == "cuda"}
    results: list = [None] * n
    errors: list = [None] * n

    def run(p: int) -> None:
        dev = mesh.device(p)
        _local.shard = Shard(group, p, dev)
        try:
            with _stream_guard(dev, streams.get(dev)):
                results[p] = fn(*(a[p] for a in args))
        except BaseException as exc:  # noqa: BLE001 - re-raised by the caller
            errors[p] = exc
            group.abort()
        finally:
            _local.shard = None

    if n == 1:
        run(0)
    else:
        threads = [threading.Thread(target=run, args=(p,), name=f"shard-{p}", daemon=True)
                   for p in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    real = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    if any(e is not None for e in errors):
        raise RuntimeError(
            f"a shard did not reach a collective within {timeout} s; the run was stopped")
    return results
