"""The port's tracing (``span``), NaN/inf guards and the card's busy time.

The port's tracing is :func:`span`: a range of ``torch.profiler``'s
RecordFunction around each layer of a step (the ``eeg.*`` names at their
call sites), recorded only while a ``torch.profiler`` session runs. Its
ranges lie on the profiler's one timeline with the device's CUPTI events, so
a trace puts each kernel, launch and idle gap of the card down to the range
that caused it. With no profiler running, a span is one C call and a shared
no-op context (about 0.5 us on the H100's host). The JAX package's
``StepTimer`` (a synchronise every step) and ``trace`` (a chrome-trace
writer) have no counterpart here: a ``torch.profiler`` session records the
spans and exports its own trace.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast

from .trees import tree_items

_OFF = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` while a ``torch.profiler`` session records, else
    the one shared no-op context.

    The range is the C++ RecordFunction that ``torch.profiler.record_function``
    also opens, without its Python wrapper and its user-annotation copies on
    the device: on an H100, in one process, a traced S = 80 train step took a
    median 18 ms longer than one without spans with ``record_function``
    spans, and none longer with these."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


def assert_finite(tree, name: str = "tree"):
    """Raise ``FloatingPointError`` at the first floating leaf of ``tree``
    holding a NaN or an infinity (one host sync a leaf; debug runs)."""
    for path, leaf in tree_items(tree):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name} at {path}")


def debug_nan_check(enable: bool = True):
    """Turn autograd's anomaly detection on or off for the process.

    It catches a NaN that a backward function returns, and names the
    forward operation whose backward made it (with that operation's
    traceback). It does not check forward outputs: a NaN made in a forward
    and never differentiated, or one in ``torch.no_grad`` code (the eval),
    passes, and so do infinities. The JAX package's ``jax_debug_nans``
    checks every primitive's output, forward included; for a forward, call
    :func:`assert_finite` on its outputs."""
    torch.autograd.set_detect_anomaly(enable)


def device_busy_us(fn) -> Optional[float]:
    """The card's busy time over one call of ``fn``, in us: the summed
    durations of the CUDA kernels, copies and sets that ``torch.profiler``
    records (one stream, so they do not overlap). None when three profiles
    saw no device event, as a session now and then does."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy:
            return float(busy)
    return None
