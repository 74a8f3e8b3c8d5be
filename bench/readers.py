"""What the metric readers under ``bench/metrics/`` share.

A reader gets a ``Context``: the cell's files, the set-up time, the
measured window (host clock), the network's operations a frame, the drive
loop's whole result and, in a traced run, the trace summary and the
program calls made inside the traced window.  It returns a number, or None
when it finds nothing to read (the harness then leaves the metric out); a
share of a roofline or a peak is never 0 for want of data.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from . import yardstick


@dataclasses.dataclass
class Traced:
    """The program's calls inside the traced window: (T, B, live frames)
    of each chunk or batch call."""
    calls: List[Tuple[int, int, int]]

    @property
    def frames(self) -> int:
        return sum(live for _, _, live in self.calls)


@dataclasses.dataclass
class Context:
    config: dict
    cell: dict
    setup_s: float
    window_s: Optional[float] = None         # the measured window
    frames: Optional[int] = None             # frames committed in it
    ops_per_frame: Optional[float] = None    # the reference's 2 x MACs
    trace: object = None                     # trace.TraceSummary
    traced: Optional[Traced] = None
    run: dict = dataclasses.field(default_factory=dict)   # the loop's result


def kernel_roofline(ctx: Context, kernel: str,
                    bound_s: Callable[[tuple, dict], float]
                    ) -> Optional[float]:
    """The calls' frozen bound over ``kernel``'s traced device time, in %:
    ``bound_s(call, config)`` of each call of the traced window (from the
    yardstick), summed."""
    if ctx.trace is None or ctx.traced is None or not ctx.traced.calls:
        return None
    busy = ctx.trace.kernel_s(kernel)
    if busy <= 0:
        return None
    bound = sum(bound_s(call, ctx.config) for call in ctx.traced.calls)
    return 100.0 * bound / busy


def idle_share(ctx: Context) -> Optional[float]:
    """1 - the device's busy union over the traced window, in %."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def ops_per_kframe(ctx: Context) -> Optional[float]:
    """Device operations of the traced window per thousand frames its
    calls committed."""
    if ctx.trace is None or ctx.traced is None or not ctx.traced.frames:
        return None
    return len(ctx.trace.ops) / (ctx.traced.frames / 1000.0)


def mfu(ctx: Context) -> Optional[float]:
    """The traced window's committed frames times the network's operations
    a frame, over the window and the peak of the configuration's type, in
    %."""
    if (ctx.trace is None or ctx.traced is None or not ctx.traced.frames
            or not ctx.ops_per_frame):
        return None
    peak = yardstick.PEAK_OPS_PER_S[ctx.config['dtype']]
    return (100.0 * ctx.traced.frames * ctx.ops_per_frame
            / ctx.trace.window_s / peak)
