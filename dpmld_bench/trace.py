"""The traced span: ``torch.profiler`` (host and device) over a few steps,
reduced to what the per-layer readers read.

- kernels: (name, start us, end us) of every device operation (kernels,
  copies, sets) inside the span;
- launches: the host's kernel-launch runtime calls in the span;
- busy: the union of the device operations' intervals, and the span's wall
  time (the span's own host range, closed by a synchronise);
- the breakdown: the device operations that took most time, and the idle
  gaps of the device, each put to what the host was doing at its middle
  (the harness's span and the outermost operator there).
- program: ``spans.reduce`` over the span, the device's idle intervals in
  it as its gaps: each of the program's ``eeg.*`` spans and layers with its
  device ms, launches, host self ms and idle ms, and the coverage;
- counters: the change over the span of the encoder part's ``counters()``.

A session that sees no device event is profiled again, up to three times,
each time with a line on standard error.
"""
from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict

import torch

from . import spans

LAUNCHES = {"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel"}
SPAN = "bench.span"
TOP = 10


def profile(run, device, counters=dict, attempts: int = 3):
    """Run ``run()`` (which returns the rows it served) under the profiler;
    returns the span's summary with ``program``, ``rows``, and ``counters``:
    each number of ``counters()``, read just before and just after the
    profiled span, less its value before."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx, record_function

    for attempt in range(attempts):
        torch.cuda.synchronize(device)
        before = counters()
        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(SPAN):
                rows = run()
                torch.cuda.synchronize(device)
        after = counters()
        t0 = time.perf_counter()
        events = prof.events()
        t1 = time.perf_counter()
        summary = summarize(events)
        if summary["kernels"]:
            summary["program"] = program(events, summary["kernels"])
            print(f"trace: the profiler's events took {t1 - t0!r} s, their summary "
                  f"{time.perf_counter() - t1!r} s", file=sys.stderr, flush=True)
            summary["rows"] = rows
            summary["counters"] = {k: v - before.get(k, 0) for k, v in after.items()}
            return summary
        print(f"trace: profiler session {attempt + 1} saw no device event; profiling again",
              file=sys.stderr, flush=True)
    raise RuntimeError(f"{attempts} profiler sessions saw no device event")


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _bounds(events):
    """The harness's span's start and end in ``events``."""
    cpu = torch.autograd.DeviceType.CPU
    span = next(e for e in events if e.name == SPAN and e.device_type == cpu)
    return span.time_range.start, span.time_range.end


def _idle(t0, t1, busy):
    """The intervals of (t0, t1) outside the merged ``busy`` intervals."""
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def summarize(events):
    t0, t1 = _bounds(events)
    kernels, launches, host_ops, marks = [], 0, [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the device's copies of the harness's ranges are no operations
            if start >= t0 and end <= t1 and not e.name.startswith("bench."):
                kernels.append((e.name, start, end))
            continue
        if e.name in LAUNCHES:
            launches += t0 <= start <= t1
        elif e.name.startswith("bench."):
            if e.name != SPAN:
                marks.append((start, end, e.name))
        elif e.name.startswith("aten::") and (e.cpu_parent is None
                                               or not e.cpu_parent.name.startswith("aten::")):
            host_ops.append((start, end, e.name))
    busy = _union((s, e) for _, s, e in kernels)
    by_name = defaultdict(float)
    for name, s, e in kernels:
        by_name[name] += (e - s) * 1e-6
    gaps = defaultdict(float)
    host_ops.sort()
    marks.sort()
    for a, b in _idle(t0, t1, busy):
        gaps[_label((a + b) / 2, marks, host_ops)] += (b - a) * 1e-6
    return {
        "kernels": kernels, "launches": launches,
        "busy_s": sum(e - s for s, e in busy) * 1e-6, "wall_s": (t1 - t0) * 1e-6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP],
    }


def program(events, kernels):
    """``spans.reduce`` over the span of ``events``, with the device's idle
    intervals between ``kernels`` (``summarize``'s) as its gaps."""
    t0, t1 = _bounds(events)
    busy = _union((s, e) for _, s, e in kernels)
    return spans.reduce(events, t0, t1, LAUNCHES, _idle(t0, t1, busy))


def _covering(t, intervals):
    """The name of the interval that covers ``t``, of intervals sorted by
    start that do not nest (the last two started before ``t``: a range
    cut by the span's start can overlap its successor's start)."""
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    for j in (i, i - 1):
        if j >= 0 and intervals[j][1] >= t:
            return intervals[j][2]
    return None


def _label(t, marks, host_ops):
    mark = _covering(t, marks) or "bench"
    op = _covering(t, host_ops) or "python"
    return f"{mark}/{op}"
