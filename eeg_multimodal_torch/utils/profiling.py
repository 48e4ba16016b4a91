"""Step timing, profiler traces and NaN/inf guards.

Port of the JAX package's ``utils/profiling.py`` (the reference's only
tracing is per-epoch ``time.time()`` deltas in the records,
base_train.py:176,234-235).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from .trees import tree_items


class StepTimer:
    """Wall-clock step times, synchronised with the device; keeps a history
    and its median for steps/s."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self, *sync_on):
        """End a step: wait for the devices of the tensors ``sync_on`` (the
        step's outputs: PyTorch returns before a CUDA kernel ends), then
        record and return the seconds since :meth:`start`."""
        for dev in {t.device for t in sync_on if t.is_cuda}:
            torch.cuda.synchronize(dev)
        dt = time.time() - self._t0
        self.times.append(dt)
        return dt

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0

    def steps_per_sec(self, steps_per_call: int = 1) -> float:
        return steps_per_call / self.median if self.median else 0.0


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (the host, and the card where
    there is one), written to ``log_dir``/trace.json; a no-op at None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
