"""The DP forward's thread layout on the card: the shipped ``dp_fwd_kernel``
(``csrc/dp_block.cu``: 256-thread blocks, one element per thread, a row in
ceil(F / 256) blocks) against the layout first named for it, one block per
row with a group of four per thread (``tools/dp_fwd_row.cu``).

    python3 -m eeg_multimodal_torch.tools.dp_fwd_layouts

Builds both from this checkout with one nvcc call, holds each bit for bit
against ``dp_block_plain`` with ``laplace_plain``'s noise at (8, 2304),
(5, 1000) and (5, 1001), then prints each one's device time
(``torch.profiler``) and CUDA-event time per call at (8, 2304), in turns
(shipped, row, row, shipped), under the card's name and power limit. Needs
one CUDA device; exits non-zero on any failure.
"""
import ctypes
import math
import os
import subprocess
import sys
import time

import torch

from ..ops import _build
from ..ops import dp_fused as K

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dp_fwd_row.cu")
EPS = 0.1
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build():
    """The probe's library (the shipped DP kernels and the row layout) and
    nvcc's seconds, 0 when cached."""
    cu, cuh = _build.sources()
    deps = [SOURCE] + [p for p in cu if p.endswith("dp_block.cu")] + cuh
    out_dir = os.path.join(_build.CACHE, "dp_fwd_layouts-" + _build._digest(deps))
    lib = os.path.join(out_dir, "libdp_fwd_layouts.so")
    seconds = 0.0
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        cmd = [_build._nvcc(), *_build.FLAGS, "-I", _build.CSRC, "-o", lib, SOURCE]
        t0 = time.time()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.time() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {res.returncode}:\n{res.stderr}")
    handle = ctypes.CDLL(lib)
    # f, dp, seed, exp_eps vector, out, M, B, F, exp_eps, r0, stream
    handle.eeg_dp_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]
    handle.probe_dp_fwd_row.argtypes = [_P, _P, _P, _P, _I, _I, _F, _P]
    handle.eeg_dp_fwd.restype = handle.probe_dp_fwd_row.restype = _I
    handle.probe_error_string.argtypes = [_I]
    handle.probe_error_string.restype = ctypes.c_char_p
    return handle, seconds


def launcher(lib, name, f, dp, seed, out):
    fn = getattr(lib, name)
    B, F = f.shape
    if name == "probe_dp_fwd_row":
        args = (f.data_ptr(), dp.data_ptr(), seed.data_ptr(), out.data_ptr(), B, F,
                math.exp(EPS))
    else:  # one member, e^eps from the host, rows from 0
        args = (f.data_ptr(), dp.data_ptr(), seed.data_ptr(), None, out.data_ptr(), 1, B, F,
                math.exp(EPS), 0)
    args += (_build.current_stream(f.device),)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} ({lib.probe_error_string(err).decode()})")
    return launch


def event_us(fn, iters=200, reps=7):
    """Median us per call over ``reps`` runs of ``iters`` back-to-back calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / iters)
    return sorted(times)[reps // 2]


def device_us(fn, n=50):
    """Device time per call in us (torch.profiler), None if none was seen."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then reports no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total:
            return total / n
    return None


def main():
    if not torch.cuda.is_available():
        sys.exit("dp_fwd_layouts: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no answer")
    lib, seconds = build()
    print(f"nvcc {seconds:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    seed = torch.tensor([1234], dtype=torch.int64, device=dev)
    names = {"shipped": "eeg_dp_fwd", "row": "probe_dp_fwd_row"}
    for B, F in ((8, 2304), (5, 1000), (5, 1001)):
        f = torch.randn(B, F, generator=gen, device=dev)
        dp = torch.randn(1, F, generator=gen, device=dev)
        plain = K.dp_block_plain(f, dp, EPS, K.laplace_plain(1234, (B, F), dev))
        for label, name in names.items():
            out = torch.full_like(f, float("nan"))
            launcher(lib, name, f, dp, seed, out)()
            err = float((out - plain).abs().max())
            print(f"({B}, {F}) {label}: max|kernel - plain| {err:.3g}")
            if not torch.equal(out, plain):
                sys.exit(f"dp_fwd_layouts: the {label} layout differs from dp_block_plain")
    f = torch.randn(8, 2304, generator=gen, device=dev)
    dp = torch.randn(1, 2304, generator=gen, device=dev)
    out = torch.empty_like(f)
    for label in ("shipped", "row", "row", "shipped"):
        launch = launcher(lib, names[label], f, dp, seed, out)
        d = device_us(launch)
        device = "not measured" if d is None else f"{d:.3f} us"
        print(f"(8, 2304) {label}: device {device}, event {event_us(launch):.2f} us")


if __name__ == "__main__":
    main()
