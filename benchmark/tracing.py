"""Reduce a ``torch.profiler`` trace of the traced window to what the
per-layer metrics read.

The raw Kineto events are read once (``kineto_results.events()``, without
building a Python event per record; a hand iteration holds about 100k kernel
records). Host ranges are the harness's own ``record_function`` ranges:

- ``bench.window``: the window, from the first traced iteration to the
  ``synchronize`` after the last;
- ``<layer>`` or ``<layer>.<part>``: the layer ranges the adapter installs
  around the agent's methods (``env``, ``replay``, ``learner``); they do not
  nest in one another.

A device record (kernel, copy or set) belongs to the layer whose range held
the host call that launched it (matched by correlation id); a kernel of a
CUDA graph to the range that held the graph's launch. What no layer range
holds belongs to ``iteration`` (the draws and the loop's own work).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaLaunchCooperativeKernel")
LAYERS = ("env", "replay", "learner")
FLUSH_EVENTS = ("Buffer Flush", "Buffer_Flush")  # the profiler's own stalls while it drains its record buffers


@dataclass
class Summary:
    iters: int
    window_s: float = 0.0
    busy_s: float = 0.0
    device_s_by_layer: dict = field(default_factory=dict)
    launches_by_layer: dict = field(default_factory=dict)
    host_s_by_range: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    flush_gap_s: float = 0.0
    flops_per_iter: float | None = None
    peak_flops: float | None = None
    untraced_s_per_iter: float | None = None  # wall seconds of an iteration without the profiler

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(busy: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The idle intervals of [lo, hi] around the merged busy intervals."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


class RangeIndex:
    """Non-overlapping named host intervals, searchable by time."""

    def __init__(self, ranges: list[tuple[int, int, str]]):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: int) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.ranges[i][1] >= t:
            return self.ranges[i][2]
        return None


def layer_of(range_name: str | None) -> str:
    return "iteration" if range_name is None else range_name.split(".", 1)[0]


def summarize(prof, iters: int, ranges=()) -> Summary:
    """The window's summary; each host range named in ``ranges`` has to
    appear at least once per traced iteration."""
    import numpy as np
    from torch.autograd import DeviceType

    window = None
    layer_ranges, runtime, device, cpu_ops = [], {}, [], []
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, start + dur, name, e.correlation_id()))
            continue
        if e.is_user_annotation():
            if name == "bench.window":
                window = (start, start + dur)
            elif layer_of(name) in LAYERS:
                layer_ranges.append((start, start + dur, name))
            continue
        if name.startswith(("cuda", "cu")):
            runtime[e.correlation_id()] = (start, name)
        cpu_ops.append((start, start + dur, name))
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = window
    s = Summary(iters=iters, window_s=(w1 - w0) / 1e9)
    index = RangeIndex(layer_ranges)
    counts = {}
    for a, b, name in layer_ranges:
        s.host_s_by_range[name] = s.host_s_by_range.get(name, 0.0) + (b - a) / 1e9
        counts[name] = counts.get(name, 0) + 1
    short = {r: counts.get(r, 0) for r in ranges if counts.get(r, 0) < iters}
    if short:
        raise RuntimeError(f"ranges the adapter installed ran fewer than {iters} times in the traced window: {short}")

    for corr, (t, name) in runtime.items():
        if name in LAUNCH_CALLS and w0 <= t <= w1:
            layer = layer_of(index.at(t))
            s.launches_by_layer[layer] = s.launches_by_layer.get(layer, 0) + 1

    inside = []
    by_op = {}
    for a, b, name, corr in device:
        ca, cb = max(a, w0), min(b, w1)
        if cb <= ca:
            continue
        inside.append((ca, cb))
        launch = runtime.get(corr)
        layer = layer_of(index.at(launch[0])) if launch is not None else "iteration"
        s.device_s_by_layer[layer] = s.device_s_by_layer.get(layer, 0.0) + (cb - ca) / 1e9
        by_op[name] = by_op.get(name, 0.0) + (cb - ca) / 1e9
    busy = union(inside)
    s.busy_s = sum(b - a for a, b in busy) / 1e9
    s.device_ops = [[n, v] for n, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]]

    idle = gaps(busy, w0, w1)
    if cpu_ops:
        ops = np.array([(a, b) for a, b, _ in cpu_ops], dtype=np.int64)
        names = [n for _, _, n in cpu_ops]
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:10]:
        what = ""
        if cpu_ops:
            held = np.nonzero((ops[:, 0] <= a) & (ops[:, 1] >= a))[0]
            if held.size:
                what = names[held[np.argmax(ops[held, 0])]]
        s.idle_gaps.append([f"{layer_of(index.at(a))}/{what}" if what else layer_of(index.at(a)), (b - a) / 1e9])
    s.flush_gap_s = idle_overlap([(a, b) for a, b, n in cpu_ops if n in FLUSH_EVENTS], idle) / 1e9
    return s


def idle_overlap(spans: list[tuple[int, int]], idle: list[tuple[int, int]]) -> int:
    """Nanoseconds of ``idle`` (sorted, disjoint) that ``spans`` cover (counted once)."""
    starts, total = [g[0] for g in idle], 0
    for a, b in union(spans):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(idle) and idle[i][0] < b:
            total += max(min(b, idle[i][1]) - max(a, idle[i][0]), 0)
            i += 1
    return total
