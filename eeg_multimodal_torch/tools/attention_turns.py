"""The f32 attention kernels of this checkout beside those of another
checkout's CUDA sources on the card, in turns.

    python3 -m eeg_multimodal_torch.tools.attention_turns [OTHER_CSRC]

Builds this checkout's kernels (``ops/_build.py``) and, given the ``csrc``
directory of another checkout (e.g. one unpacked with ``git archive``), its
sources into a temporary directory with the same nvcc flags, one nvcc
process a source, started together. Holds this checkout's f32 forward and
backward against ``attention_plain`` and ``attention_bwd_plain`` within the
JAX attention tests' tolerances at S = 17 to 512, D = 64 and 128, both
dropout rates. Then, at the main paths' shapes, prints each build's device
time per kernel (``torch.profiler``) in turns (other, this, this, other),
cuDNN's SDPA beside them, and this checkout's CUDA-event time per call,
under the card's name and power limit. Needs one CUDA device; exits
non-zero on any failure.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops import _build
from ..ops import attention as A

NEG = float(np.finfo(np.float32).min)
FWD_TOL, BWD_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=2e-3, atol=1e-4)
CHECKS = ((2, 3, 17, 64), (2, 3, 50, 64), (2, 3, 65, 64), (2, 3, 80, 64), (2, 3, 197, 64),
          (8, 12, 512, 64), (2, 3, 65, 128), (2, 3, 197, 128), (1, 2, 512, 128))
# (B, H, S, D, dropout rate): path 2's S = 512 (with and without dropout),
# path 1's S = 80, the ViT's S = 50 and 197, and D = 128
TIMED = ((8, 12, 512, 64, 0.1), (8, 12, 512, 64, 0.0), (8, 12, 80, 64, 0.1),
         (16, 12, 50, 64, 0.0), (16, 12, 197, 64, 0.0), (1, 2, 512, 128, 0.1))


def build_other(csrc: str, out_dir: str):
    """The library of the sources in ``csrc``, built in ``out_dir``."""
    nvcc = _build._nvcc()
    flags = [f for f in _build.FLAGS if f != "-shared"]
    cu = sorted(os.path.join(csrc, n) for n in os.listdir(csrc) if n.endswith(".cu"))
    objs = [os.path.join(out_dir, os.path.basename(src) + ".o") for src in cu]
    procs = [subprocess.Popen([nvcc, *flags, "-I", csrc, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for obj, src in zip(objs, cu)]
    for proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{out[-6000:]}")
    lib = os.path.join(out_dir, _build.LIB_NAME)
    res = subprocess.run([nvcc, *_build.FLAGS, *objs, "-o", lib], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"the link failed:\n{res.stderr[-6000:]}")
    return typed(ctypes.CDLL(lib))


def typed(lib):
    lib.eeg_attn_fwd.argtypes = A._COMMON + [A._P, A._P, A._P]
    lib.eeg_attn_bwd.argtypes = A._COMMON + [A._P, A._P, A._P, A._I64, A._I64, A._I64, A._P,
                                             A._P, A._P, A._P, A._P]
    lib.eeg_attn_fwd.restype = lib.eeg_attn_bwd.restype = ctypes.c_int
    return lib


def inputs(gen, dev, B, H, S, D, masked=True):
    """Packed-QKV views q, k, v, a bias (a partly masked row, a row with
    every key masked, when ``masked``) and an output gradient."""
    qkv = torch.randn(B, S, 3, H, D, generator=gen, device=dev)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.zeros(B, S, device=dev)
    if masked:
        bias[0, S // 2 + 3:] = NEG
        if B > 1:
            bias[1] = NEG
    return q, k, v, bias, torch.randn(B, H, S, D, generator=gen, device=dev)


def calls(lib, q, k, v, bias, seed, rate):
    """The forward and backward C calls of ``lib`` on fresh buffers."""
    B, H, S, D = q.shape
    args = A._common_args(q, k, v, bias, seed, rate, A.Block().resolve(B, H))
    stream = _build.current_stream(q.device)
    out = torch.empty((B, S, H, D), device=q.device)
    stats = torch.empty((2, B, H, S), device=q.device)
    grads = [torch.empty((B, S, H, D), device=q.device) for _ in range(3)]
    delta = torch.empty(B * H * (S * 4 + (-(-S // 64)) ** 2 * 128), device=q.device)

    def fwd():
        _build.raise_on_error(lib.eeg_attn_fwd(*args, out.data_ptr(), stats.data_ptr(), stream),
                              "attn_fwd")

    def bwd(dout):
        _build.raise_on_error(lib.eeg_attn_bwd(
            *args, out.data_ptr(), stats.data_ptr(), dout.data_ptr(), *dout.stride()[:3],
            delta.data_ptr(), *(g.data_ptr() for g in grads), stream), "attn_bwd")

    return fwd, bwd, out.transpose(1, 2), [g.transpose(1, 2) for g in grads]


def check(gen, dev):
    """This checkout's f32 kernels against the plain versions; raises on a
    miss."""
    lib = typed(_build.library()[0])
    for B, H, S, D in CHECKS:
        q, k, v, bias, dout = inputs(gen, dev, B, H, S, D)
        for rate in (0.0, 0.1):
            seed = torch.tensor([1000 + S + D], dtype=torch.int64, device=dev)
            fwd, bwd, out, grads = calls(lib, q, k, v, bias, seed, rate)
            fwd()
            bwd(dout)
            keep = A.attn_dropout_mask(seed, B, H, S, rate).bool() if rate else None
            plain = A.attention_plain(q, k, v, bias, keep, rate)
            plain_g = A.attention_bwd_plain(q, k, v, bias, keep, rate, dout)
            torch.testing.assert_close(out, plain, **FWD_TOL)
            for name, g, pg in zip("qkv", grads, plain_g):
                torch.testing.assert_close(g, pg, **BWD_TOL, msg=lambda m: f"d{name}: {m}")
            e_bwd = max(float((g - pg).abs().max()) for g, pg in zip(grads, plain_g))
            print(f"{(B, H, S, D)} p={rate}: max|out - plain| "
                  f"{float((out - plain).abs().max()):.3g}, max|grad - plain| {e_bwd:.3g}")


def device_us(fn, n=20):
    """Device time per call of ``fn`` by kernel (``torch.profiler``);
    empty when three sessions saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = re.sub(r"^.*::(attn_\w+_kernel).*$", r"\1", e.name)[:40]
                by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / n
        if by:
            return by
    return {}


def event_us(fn, iters=50, reps=5):
    for _ in range(5):
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
        times.append(start.elapsed_time(end) / iters * 1e3)
    return float(np.median(times))


def total(by):
    return f"{sum(by.values()):.1f}" if by else "not measured"


def time_in_turns(gen, dev, libs):
    """Device us by kernel of every build, in turns, at each TIMED shape."""
    order = list(libs) + list(libs)[::-1]
    for B, H, S, D, rate in TIMED:
        q, k, v, bias, dout = inputs(gen, dev, B, H, S, D, masked=False)
        if rate:
            bias[:, 65:] = NEG  # the padded keys past the rows' 65 tokens
        seed = torch.tensor([5], dtype=torch.int64, device=dev)
        readings = {name: [] for name in libs}
        for name in order:
            fwd, bwd, _, _ = calls(libs[name], q, k, v, bias, seed, rate)
            fwd()
            readings[name].append((device_us(fwd), device_us(lambda: bwd(dout))))
        mask = bias[:, None, None, :]
        sdpa = device_us(lambda: TF.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                 dropout_p=rate))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa_fb = device_us(lambda: torch.autograd.grad(TF.scaled_dot_product_attention(
            *leaves, attn_mask=mask, dropout_p=rate), leaves, dout))
        out, stats = A.attn_fwd(q, k, v, bias, seed, rate)
        ev_f = event_us(lambda: A.attn_fwd(q, k, v, bias, seed, rate))
        ev_b = event_us(lambda: A.attn_bwd(q, k, v, bias, seed, rate, out, stats, dout))
        print(f"{(B, H, S, D)} p={rate}, device us (forward, backward) in turns: " + "; ".join(
            f"{name} " + ", ".join(f"({total(f)}, {total(b)})" for f, b in runs)
            for name, runs in readings.items())
            + f"; SDPA forward {total(sdpa)}, forward + backward {total(sdpa_fb)}; this "
            f"checkout's event us: forward {ev_f:.1f}, backward {ev_b:.1f}")
        for name, runs in readings.items():
            f, b = runs[0]
            print(f"  {name} by kernel: " + ", ".join(
                f"{k} {x:.1f}" for k, x in sorted({**f, **b}.items())))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", nargs="?", help="another checkout's csrc directory")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("attention_turns: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no answer")
    gen = torch.Generator(device=dev).manual_seed(0)
    work = tempfile.mkdtemp()
    try:
        libs = {}
        if args.other:
            libs["other"] = build_other(args.other, work)
        libs["this"] = typed(_build.library()[0])
        check(gen, dev)
        time_in_turns(gen, dev, libs)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
