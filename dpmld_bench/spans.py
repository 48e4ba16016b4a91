"""The program's own spans in a profiled span: the ``eeg.*`` ranges of
``eeg_multimodal_torch`` (``utils/profiling.span``), and each device
operation, kernel launch and idle gap of the device put down to the span and
the layer that caused it. Every time is on the profiler's one clock.

- A host event's span is the innermost ``eeg.*`` range open around it on its
  own thread; where its thread opened none (autograd's device thread on the
  card), the innermost one open at its start on any thread.
- A host event's layer: inside an autograd node
  (``autograd::engine::evaluate_function: ...``), the layer of the forward
  operator with the node's ``sequence_nr``, so that a backward is put down to
  the layer whose forward caused it; else its span's layer (``LAYERS``, a
  kernel wrapper's span taking its caller's).
- A device operation takes the span and layer of the runtime call that put
  it on the device (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...: CUPTI
  gives both one correlation id, the events' ``id``; torch 2.11's events
  carry no ``linked_correlation_id``); a launch (a runtime call named in
  ``launches``), its own; an idle gap of the device, those of the host event
  that covers its middle, an autograd node's first where one covers it.

``reduce`` gives, by span name and by layer, the device ms, launches, host
self ms (a span's time less its child spans') and idle ms over the profiled
span, and the share of the device time put down to some span (coverage).
``trace.summarize`` hands it a profiled span's ``prof.events()``, the span's
bounds, ``trace.LAUNCHES`` and the device's idle intervals in the span, and
the readers find the result as ``ctx["span"]["program"]``
(``metrics/program_spans.py``).
"""
from __future__ import annotations

from collections import defaultdict

import torch

PREFIX = "eeg."
NODE = "autograd::engine::evaluate_function: "
RUNTIME = ("cuda", "cu")  # the CUDA runtime's and driver's calls
# a span's layer by the start of its name; any other span (a kernel
# wrapper's ``eeg.kernel.<name>``) takes its caller's
LAYERS = (("eeg.model.encoder", "encoder"), ("eeg.model.decoder", "decoder"),
          ("eeg.model.dp_block", "DP block"), ("eeg.model.head", "head"),
          ("eeg.optim.", "optimizer"), ("eeg.step", "step"), ("eeg.backward", "step"),
          ("eeg.eval", "eval"), ("eeg.epoch.", "epoch loop"), ("eeg.data.", "epoch loop"))
FIELDS = ("device_ms", "launches", "host_self_ms", "idle_ms")


def _own_layer(name):
    return next((layer for prefix, layer in LAYERS if name.startswith(prefix)), None)


def _innermost(events, times, strict=False):
    """For each of the ascending ``times``, the index into ``events`` (sorted
    by start, longest first) of the latest-started event open at that time
    (started before it, where ``strict``), or None: the innermost where they
    nest."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and (events[i].time_range.start < t if strict
                                   else events[i].time_range.start <= t):
            stack.append(i)
            i += 1
        while stack and events[stack[-1]].time_range.end < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _by_time(ranges, events, strict):
    """For each of ``events``, the innermost of the (sorted) ``ranges`` open
    at its start, on any thread."""
    order = sorted(range(len(events)), key=lambda k: events[k].time_range.start)
    found = _innermost(ranges, [events[k].time_range.start for k in order], strict)
    out = [None] * len(events)
    for k, j in zip(order, found):
        out[k] = j
    return out


class _Host:
    """The host events of the span, each with its span (``eeg``: the index
    of its innermost ``eeg.*`` range, itself for a range) and its layer."""

    def __init__(self, host):
        by_thread = defaultdict(list)
        for e in host:
            by_thread[e.thread].append(e)
        self.events, self.eeg, self.node, self.up = [], [], [], []
        for events in by_thread.values():
            events.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
            stack = []
            for e in events:
                while stack and self.events[stack[-1]].time_range.end <= e.time_range.start:
                    stack.pop()
                parent = stack[-1] if stack else None
                i = len(self.events)
                self.events.append(e)
                self.up.append(None if parent is None else self.eeg[parent])
                self.eeg.append(i if e.name.startswith(PREFIX) else self.up[i])
                self.node.append(e.sequence_nr if e.name.startswith(NODE)
                                 else None if parent is None else self.node[parent])
                stack.append(i)
        # where its thread opened no range around it (autograd's device
        # thread): the innermost range open on any thread, for an event at
        # its start, for a range (the caller of a kernel wrapper's span there)
        # before it
        ranges = sorted((i for i in range(len(self.events)) if self.eeg[i] == i),
                        key=lambda i: (self.events[i].time_range.start,
                                       -self.events[i].time_range.end))
        ranged = [self.events[i] for i in ranges]
        lone = [i for i in range(len(self.events)) if self.eeg[i] is None]
        for i, j in zip(lone, _by_time(ranged, [self.events[i] for i in lone], False)):
            self.eeg[i] = None if j is None else ranges[j]
        top = [i for i in ranges if self.up[i] is None]
        for i, j in zip(top, _by_time(ranged, [self.events[i] for i in top], True)):
            self.up[i] = None if j is None else ranges[j]
        # each range's layer; a caller starts before its callees
        self.span_layer = {}
        for i in ranges:
            up = self.up[i]
            self.span_layer[i] = _own_layer(self.events[i].name) or (
                None if up is None else self.span_layer[up])
        # the forward operators' layers by sequence number: an operator
        # records the number its node would take, so of those that share one
        # the node's maker is the last to start (its thread's, in start order)
        self.forward = {}
        for i, e in enumerate(self.events):
            if e.sequence_nr >= 0 and self.node[i] is None and self.eeg[i] is not None:
                self.forward[e.sequence_nr] = self.span_layer[self.eeg[i]]

    def span(self, i):
        j = self.eeg[i]
        return None if j is None else self.events[j].name

    def layer(self, i):
        seq = self.node[i]
        if seq is not None and seq >= 0 and seq in self.forward:
            return self.forward[seq]
        j = self.eeg[i]
        return None if j is None else self.span_layer[j]


def reduce(events, t0, t1, launches, gaps):
    """The program's figures over the profiled span [t0, t1] (us) of
    ``events`` (``prof.events()``, or objects with the fields read here):
    ``launches`` the runtime calls that launch kernels, ``gaps`` the device's
    idle intervals. Returns {"spans": {name: figures}, "layers": {layer:
    figures}, "device_ms", "coverage" (None without device time), "gaps":
    the span of each gap or None}; figures are the totals over the span of
    ``FIELDS``. A span or layer appears only where the span ran."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cpu and t0 <= start <= t1:
            host.append(e)
        elif (e.device_type == cuda and start >= t0 and end <= t1
              and not e.name.startswith(("bench.", PREFIX))):
            device.append(e)
    h = _Host(host)
    spans = defaultdict(lambda: dict.fromkeys(FIELDS, 0.0))
    layers = defaultdict(lambda: dict.fromkeys(FIELDS, 0.0))

    def add(i, field, value):
        name, layer = h.span(i), h.layer(i)
        if name is not None:
            spans[name][field] += value
        if layer is not None:
            layers[layer][field] += value
        return name is not None

    # a span's host self time: its time less that of the spans it holds on
    # its own thread
    held = defaultdict(float)
    for i, e in enumerate(h.events):
        if e.name in launches:
            add(i, "launches", 1)
        if h.eeg[i] == i and h.up[i] is not None and h.events[h.up[i]].thread == e.thread:
            held[h.up[i]] += e.time_range.end - e.time_range.start
    for i, e in enumerate(h.events):
        if h.eeg[i] == i:
            add(i, "host_self_ms", (e.time_range.end - e.time_range.start - held[i]) * 1e-3)
    runtime = {e.id: i for i, e in enumerate(h.events) if e.name.startswith(RUNTIME)}
    total = covered = 0.0
    for e in device:
        ms = (e.time_range.end - e.time_range.start) * 1e-3
        total += ms
        i = runtime.get(e.id)
        if i is not None and add(i, "device_ms", ms):
            covered += ms
    gap_spans = _gaps(h, gaps, add)
    return {"spans": dict(spans), "layers": dict(layers), "device_ms": total,
            "coverage": covered / total if total else None, "gaps": gap_spans}


def _gaps(h, gaps, add):
    """Each gap's span, its idle ms added to its span and layer: those of the
    innermost host event over its middle, on a thread where that event is
    inside an autograd node if there is one, else the latest started."""
    order = sorted(range(len(gaps)), key=lambda g: gaps[g][0] + gaps[g][1])
    mids = [(gaps[g][0] + gaps[g][1]) / 2 for g in order]
    by_thread = defaultdict(list)
    for i, e in enumerate(h.events):
        by_thread[e.thread].append(i)
    best = [None] * len(order)
    for idx in by_thread.values():  # already sorted by start within a thread
        found = _innermost([h.events[i] for i in idx], mids)
        for k, j in enumerate(found):
            if j is None:
                continue
            i, b = idx[j], best[k]
            if b is None or ((h.node[i] is not None, h.events[i].time_range.start)
                             > (h.node[b] is not None, h.events[b].time_range.start)):
                best[k] = i
    out = [None] * len(gaps)
    for k, g in enumerate(order):
        if best[k] is not None:
            a, b = gaps[g]
            add(best[k], "idle_ms", (b - a) * 1e-3)
            out[g] = h.span(best[k])
    return out
