"""The device trace of a window: ``torch.profiler`` over the card and the
host, reduced to what the per-layer readers and the ``breakdown`` need.

The window opens and closes on a ``synchronize``, so every device
operation of the calls made inside it runs inside it, and none of an
earlier call does.  ``busy_s`` is the union of the device operations'
intervals (kernels, copies, sets) within the window; an idle gap is named
by what the host was doing at its middle: the innermost of the harness's
``bench.*`` labels and the innermost host operation open there.  The
profiler's own cost lengthens the host's work, so the idle share of a
traced window is an upper bound.
"""
from __future__ import annotations

import bisect
import dataclasses
import sys
import time
from typing import Dict, List, Tuple

import torch

SCAN = 200      # host events looked back over to name a gap


@dataclasses.dataclass
class TraceSummary:
    """One traced window, reduced."""
    window_s: float
    busy_s: float
    ops: List[Tuple[str, int, int]]          # (name, start ns, duration ns)
    gaps: List[Tuple[str, float]]            # (host activity, seconds)

    def kernel_s(self, name: str) -> float:
        """Device seconds of the operations whose name contains ``name``."""
        return sum(d for n, _, d in self.ops if name in n) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_op: Dict[str, float] = {}
        for n, _, d in self.ops:
            by_op[n] = by_op.get(n, 0.0) + d / 1e9
        by_gap: Dict[str, float] = {}
        for n, s in self.gaps:
            by_gap[n] = by_gap.get(n, 0.0) + s
        rank = lambda d: sorted(([k, v] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {'device_ops': rank(by_op), 'idle_gaps': rank(by_gap)}


class Tracer:
    """``start()`` ... ``stop()`` around the traced part of a window."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None
        self._t0 = 0.0

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def prime(self) -> float:
        """One short traced region during set-up: the profiler's first
        start on a card takes seconds, which must not fall in a window.
        Returns its seconds."""
        t0 = time.perf_counter()
        with self._profile():
            torch.zeros(1, device=self.device).add_(1)
            self._sync()
        return time.perf_counter() - t0

    def start(self) -> None:
        self._sync()
        self._prof = self._profile()
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since the traced window opened."""
        return time.perf_counter() - self._t0

    def stop(self) -> TraceSummary:
        self._sync()
        window_s = time.perf_counter() - self._t0
        t0 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        t1 = time.perf_counter()
        summary = summarize(events, window_s)
        print(f'trace: {window_s:.3f} s traced, {len(summary.ops)} device '
              f'operations; closing the profiler {t1 - t0:.2f} s, reading '
              f'its events {time.perf_counter() - t1:.2f} s',
              file=sys.stderr)
        return summary


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _innermost(starts, events, t: int) -> str:
    """The latest-starting event of ``events`` (sorted by start) open at
    ``t``, or ''."""
    k = bisect.bisect_right(starts, t)
    for j in range(k - 1, max(-1, k - 1 - SCAN), -1):
        s, e, name = events[j]
        if e >= t:
            return name
    return ''


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce the profiler's raw events (``kineto_results.events()``)."""
    from torch.autograd import DeviceType
    ops, host, labels = [], [], []
    t_first = None
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and d > 0:
                ops.append((e.name(), s, d))
        else:
            t_first = s if t_first is None else min(t_first, s)
            (labels if e.is_user_annotation() else host).append(
                (s, s + d, e.name()))
    host.sort()
    labels.sort()
    h_starts = [h[0] for h in host]
    l_starts = [l[0] for l in labels]
    w0 = t_first if t_first is not None else min((s for _, s, _ in ops),
                                                 default=0)
    w1 = w0 + int(window_s * 1e9)
    busy = _union([(max(s, w0), min(s + d, w1)) for _, s, d in ops
                   if s + d > w0 and s < w1])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) // 2
            label = _innermost(l_starts, labels, mid) or 'untraced'
            op = _innermost(h_starts, host, mid) or 'python'
            gaps.append((f'{label}/{op}', (b - a) / 1e9))
    return TraceSummary(window_s=window_s, busy_s=busy_s, ops=ops, gaps=gaps)
