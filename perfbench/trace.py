"""The traced stretch: what the device ran, and what the host did meanwhile.

`traced(fn)` runs `fn` once under `torch.profiler` (CPU and CUDA
activities, no shapes, no stacks), inside a span of the benchmark's own
("perfbench.traced"), and keeps the tables in memory: no trace file is
written. `Trace` holds, in the span's time base (microseconds):

- `kernels`: (name, start, end) of every device kernel;
- `copies`: (name, start, end) of every device copy and set;
- `host`: (name, start, end) of every host-side op and span;
- `start`, `end`: the span.

Reductions: the union of busy intervals, the idle gaps between them named
by the innermost host op running at their middle, device time by kernel.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

SPAN = "perfbench.traced"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class Trace:
    start: float = 0.0
    end: float = 0.0
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """Merged busy intervals of kernels and copies, clipped to the span."""
        spans = sorted((max(s, self.start), min(e, self.end))
                       for _, s, e in self.kernels + self.copies
                       if e > self.start and s < self.end)
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list[tuple[str, float]]:
        """(host op running at the gap's middle, seconds) of every gap in the
        device's work inside the span."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for se in busy for x in se] + [self.end]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        long = [h for h in host if h[2] - h[1] > 1000]  # outer ops and spans, > 1 ms
        gaps = []
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e <= s:
                continue
            mid = (s + e) / 2
            k = bisect.bisect_right(starts, mid)
            covering = [h for h in host[max(0, k - 256):k] + long if h[1] <= mid <= h[2]]
            name = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "python"
            gaps.append((name, (e - s) / 1e6))
        return gaps

    def device_s_by_kernel(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, s, e in self.kernels:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out


def _us(ev) -> tuple[float, float]:
    return float(ev.time_range.start), float(ev.time_range.end)


def traced(fn) -> Trace:
    """Run `fn()` once under the profiler; its result is dropped."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # The profiler's own start-up on the card (its first activity
        # buffers) falls before the span, not inside it.
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with record_function(SPAN):
            fn()
            torch.cuda.synchronize()
    t = Trace()
    for ev in prof.events():
        s, e = _us(ev)
        if ev.device_type == DeviceType.CUDA:
            if ev.name == SPAN or getattr(ev, "is_user_annotation", False):
                continue  # the span's own mark on the device's timeline
            (t.copies if ev.name.startswith(COPY_PREFIXES) else t.kernels).append((ev.name, s, e))
        elif ev.name == SPAN:
            t.start, t.end = s, e
        else:
            t.host.append((ev.name, s, e))
    if not t.kernels:
        raise RuntimeError("the profiler recorded no device kernel in the traced stretch")
    return t


def top(pairs, k: int = 10) -> list[list]:
    """The k largest (name, seconds) totals by name."""
    acc: dict[str, float] = {}
    for name, s in pairs:
        acc[name] = acc.get(name, 0.0) + s
    return [[n, v] for n, v in sorted(acc.items(), key=lambda kv: -kv[1])[:k]]
