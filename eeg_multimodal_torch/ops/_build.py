"""Build the port's CUDA C++ sources with nvcc and load them with ctypes.

The ``.cu`` files under ``eeg_multimodal_torch/csrc/`` expose a plain C
interface. At first use they are compiled, one nvcc process per source, all
started together, and linked into one shared library for Hopper
(``sm_90a``), under
``.cache/kernels/<hash of the sources and flags>/`` at the checkout's root
(git-ignored), and loaded with ``ctypes``. A later call with the same
sources loads the cached library. A failed build raises with nvcc's stderr:
there is no other way to the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
CACHE = os.path.join(os.path.dirname(_PKG), ".cache", "kernels")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libeeg_kernels.so"


def sources():
    """The ``.cu`` sources, sorted; ``.cuh`` headers count in the hash."""
    names = sorted(os.listdir(CSRC))
    return ([os.path.join(CSRC, n) for n in names if n.endswith(".cu")],
            [os.path.join(CSRC, n) for n in names if n.endswith(".cuh")])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in files:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(cmds) -> str:
    """Run the commands at once, one process each; returns their output,
    each led by a line with its wall seconds, or raises with the first
    failed one's stderr."""
    def run(cmd):
        t0 = time.time()
        res = subprocess.run(cmd, capture_output=True, text=True)
        return res, time.time() - t0

    with ThreadPoolExecutor(len(cmds)) as pool:
        results = list(pool.map(run, cmds))
    for cmd, (res, _) in zip(cmds, results):
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {res.returncode}:\n{' '.join(cmd)}\n"
                               f"{res.stderr}")
    return "".join(f"nvcc {os.path.basename(cmd[-1])}: {s:.1f} s\n{res.stdout}{res.stderr}"
                   for cmd, (res, s) in zip(cmds, results))


@functools.lru_cache(maxsize=None)
def library():
    """The loaded library: ``(ctypes.CDLL, build log, seconds spent)``. The
    log is each nvcc process's wall seconds and ptxas's register and
    shared-memory report; the seconds are 0 when the cached library was
    loaded."""
    cu, cuh = sources()
    out_dir = os.path.join(CACHE, _digest(cu + cuh))
    lib = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "build.log")
    seconds = 0.0
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        work = tempfile.mkdtemp(dir=out_dir)  # the objects; removed however the build ends
        try:
            tmp = os.path.join(work, LIB_NAME)
            objs = [os.path.join(work, os.path.basename(src) + ".o") for src in cu]
            nvcc = _nvcc()
            compile_flags = [f for f in FLAGS if f != "-shared"]
            t0 = time.time()
            out = _run([[nvcc, *compile_flags, "-I", CSRC, "-c", "-o", obj, src]
                        for obj, src in zip(objs, cu)])
            out += _run([[nvcc, *FLAGS, *objs, "-o", tmp]])  # the link
            seconds = time.time() - t0
            with open(log_path, "w") as f:
                f.write(out)
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        finally:
            shutil.rmtree(work, ignore_errors=True)
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    return ctypes.CDLL(lib), log, seconds


def raise_on_error(err: int, name: str):
    """Raise if a C function of the library returned a CUDA error code (each
    returns ``cudaGetLastError()`` after its launches)."""
    if err != 0:
        fn = library()[0].eeg_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {err} ({fn(err).decode()})")


def current_stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the pointer the C
    functions take. Read with PyTorch's raw getter (the one its generated
    kernel launchers call): it builds no ``torch.cuda.Stream`` object, the
    costliest step of a launch through ``torch.cuda.current_stream()``."""
    return torch._C._cuda_getCurrentRawStream(device.index)
