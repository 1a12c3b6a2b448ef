"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's operations as (name, start, end) intervals, the host's
spans, the union of the device intervals over a window, and the breakdown
of device time and idle gaps that the result line carries."""

from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class Trace:
    """Device operations and host spans of one traced window, in ns on the
    profiler's clock. ``ops``: (name, start, end) of every kernel, copy and
    fill on the device; ``spans``: (name, start, end) of the harness's
    ``record_function`` spans; ``window``: (start, end) of the traced
    solves."""

    ops: list
    spans: list
    window: tuple

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def from_profiler(prof, span_prefix: str) -> Trace:
    """The trace of a finished ``torch.profiler.profile``: device events by
    their device type, spans by their name's prefix. The window runs from
    the first span named ``<prefix>solve`` to the end of the last."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            # The device timeline also carries the host spans' ranges.
            if not e.is_user_annotation() and not name.startswith(span_prefix):
                ops.append((name, e.start_ns(), e.end_ns()))
        elif name.startswith(span_prefix):
            spans.append((name, e.start_ns(), e.end_ns()))
    solves = [s for s in spans if s[0] == span_prefix + "solve"]
    if not solves:
        raise RuntimeError("the trace holds no solve span")
    window = (min(s[1] for s in solves), max(s[2] for s in solves))
    return Trace(ops=ops, spans=spans, window=window)


def union(intervals, lo: int, hi: int) -> tuple:
    """(covered ns, gaps) of ``intervals`` (start, end) clipped to [lo, hi]:
    the length of their union and the uncovered stretches as (start, end)."""
    ivs = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                 if b > lo and a < hi)
    covered, gaps, cur = 0, [], lo
    for a, b in ivs:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            covered += b - max(a, cur)
            cur = b
    if cur < hi:
        gaps.append((cur, hi))
    return covered, gaps


def busy_s(tr: Trace) -> float:
    covered, _ = union(((a, b) for _, a, b in tr.ops), *tr.window)
    return covered / 1e9


def device_ops(tr: Trace, top: int = 10) -> list:
    """[[name, seconds], ...]: the device operations that took most time
    inside the window, summed by name."""
    total = collections.Counter()
    lo, hi = tr.window
    for name, a, b in tr.ops:
        if b > lo and a < hi:
            total[name] += (min(b, hi) - max(a, lo)) / 1e9
    return [[n, s] for n, s in total.most_common(top)]


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """[[host span, seconds], ...]: the device's idle time inside the
    window, summed by the innermost harness span the host was in at each
    gap's middle (``outside`` where it was in none)."""
    _, gaps = union(((a, b) for _, a, b in tr.ops), *tr.window)
    total = collections.Counter()
    for a, b in gaps:
        mid = (a + b) // 2
        inner = [s for s in tr.spans if s[1] <= mid < s[2]]
        name = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "outside"
        total[name] += (b - a) / 1e9
    return [[n, s] for n, s in total.most_common(top)]


def kernel_time_s(tr: Trace, patterns) -> tuple:
    """(seconds, launches) of the device operations inside the window whose
    name contains any of ``patterns``."""
    lo, hi = tr.window
    secs, count = 0.0, 0
    for name, a, b in tr.ops:
        if b > lo and a < hi and any(p in name for p in patterns):
            secs += (min(b, hi) - max(a, lo)) / 1e9
            count += 1
    return secs, count
