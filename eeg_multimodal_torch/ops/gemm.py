"""f32 matrix products of the linear layers on the tensor cores: one
hand-written CUDA C++ kernel for Hopper, ``csrc/gemm_f32.cu``.

Replaces no TPU kernel: the JAX package leaves its products to XLA at
``Precision.HIGHEST``. On the H100, cuBLAS computes an f32 product with TF32
off on the CUDA cores, and at BERT-base's widths those products were most
of the f32 step's device time (PERF.md). The kernel computes, with f32
accumulation and f32 accuracy, in one launch,

    FWD  y  = x @ kernel + bias      x (M, K), kernel (K, N), bias (N,)
    DX   dx = dy @ kernel^T          dy (M, N)
    DW   dk = x^T @ dy               a reduction over the M rows

as error-compensated 3xTF32 products on ``wgmma``: each operand element
split x = hi + lo (both TF32), a b = hi.hi + hi.lo + lo.hi, summed in f32
(the source notes the arithmetic, the tiles and what bounds them). That is
the one exception to "no TF32" that the attention kernels already make; a
plain TF32 product runs nowhere.

:func:`linear_f32` is a linear layer's forward and backward (an autograd
Function; the bias gradient the row sum, as autograd's of ``F.linear``). On
a CUDA tensor it launches the kernel; on the CPU its plain twin,
``torch.matmul`` (:func:`gemm_plain`), runs in the kernel's place.

:func:`takes` is ``models/layers.py::linear``'s route, a function of what
``linear`` sees alone: f32 x and kernel on the card, a 2-D kernel, a product
of at least ``FLOOR_FLOPS`` operations, and operands the kernel's 16-byte
loads can read without a copy. Every other product keeps its ``F.linear``
(cuBLAS).

Counts: ``gemm_f32.launches`` and ``.by_dtype`` (as every
``KernelWrapper``'s; each call the span ``eeg.kernel.gemm_f32``), and
``gemm_f32.declined``, the f32 products on the card with a 2-D kernel that
:func:`takes` sent to cuBLAS (below the floor, or misaligned).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .dp_fused import KernelWrapper

FWD, DX, DW = 0, 1, 2  # the C interface's layouts
TILE_M = TILE_N = 128  # C a block, one block an SM
STAGE_K = 32  # the reduction a stage
MAX_SPLITS = 8
# 2 M N K at and above which the kernel takes an f32 product (2^30, 1.07
# GFLOP): below it cuBLAS's f32 GEMM, device and host time together, was as
# fast on the H100 (the decoder's 640-row products, 0.75 GFLOP, even;
# 1024 rows faster by a quarter; PERF.md)
FLOOR_FLOPS = 1 << 30
# split-K's cost model, in a stage's time: a tile's fixed cost (its first
# loads, its epilogue) and, with more than one split, the fixup's (the
# partial tile written, the last block's reads), fitted to the H100's times
TILE_STAGES = 0.5
FIXUP_STAGES = 3.5

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with the GEMM's argument types set."""
    lib = _build.library()[0]
    # layout, M, N, K, a, lda, b, ldb, bias, c, ldc, splits, ws, counters, stream
    lib.eeg_gemm_f32.argtypes = [_I, _I, _I, _I, _P, _I64, _P, _I64, _P, _P, _I64, _I, _P, _P,
                                 _P]
    lib.eeg_gemm_f32_splits.argtypes = [_I, _I]
    lib.eeg_gemm_f32.restype = lib.eeg_gemm_f32_splits.restype = _I
    return lib


# ---------------------------------------------------------------------------
# The plain version (the CPU path, and the yardstick of the kernel)
# ---------------------------------------------------------------------------

def dims(layout: int, a, b):
    """(M, N, K) of the product ``layout`` makes of ``a`` and ``b``: C is
    M x N, the reduction K long."""
    if layout == FWD:
        return a.shape[0], b.shape[1], a.shape[1]
    if layout == DX:
        return a.shape[0], b.shape[0], a.shape[1]
    return a.shape[1], b.shape[1], a.shape[0]


def gemm_plain(layout: int, a, b, bias=None):
    """What the kernel computes, in torch.matmul: a @ b (FWD), a @ b^T (DX) or
    a^T @ b (DW), plus ``bias`` if given."""
    if layout == FWD:
        out = torch.matmul(a, b)
    elif layout == DX:
        out = torch.matmul(a, b.t())
    else:
        out = torch.matmul(a.t(), b)
    return out if bias is None else out + bias


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def loadable(t) -> bool:
    """Whether the kernel's 16-byte loads read the matrix ``t`` as it lies: a
    unit column stride, a row stride and a data pointer that are multiples
    of 16 bytes, a width that is a multiple of 4."""
    return (t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0
            and t.shape[1] % 4 == 0)


@functools.lru_cache(maxsize=None)
def splits_for(M: int, N: int, K: int, sms: int) -> int:
    """Split-K's share of the reduction for an M x N x K product on a card
    of ``sms`` SMs (one block each): the least modelled time,
    waves of blocks times the stages each takes, plus a tile's fixed cost and
    the fixup's where there is more than one split. The C interface deals
    the stages out as this does."""
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    stages = -(-K // STAGE_K)
    best, best_cost = 1, math.inf
    for s in range(1, min(MAX_SPLITS, stages) + 1):
        chunks = -(-stages // s)
        if -(-stages // chunks) != s:
            continue  # the same deal as a smaller s
        waves = -(-tiles * s // sms)
        cost = waves * (chunks + TILE_STAGES + (FIXUP_STAGES if s > 1 else 0.0))
        if cost < best_cost:
            best, best_cost = s, cost
    return best


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS = {}


def _counters(device, tiles: int):
    """Split-K's tile counters on ``device``: zeros, which every launch leaves
    zeros (the last block of a tile resets its own), made once and grown
    when a product has more tiles."""
    have = _COUNTERS.get(device.index)
    if have is None or have.numel() < tiles:
        have = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = have
    return have


def _check(layout, a, b, bias):
    if not a.is_cuda or b.device != a.device:
        raise ValueError("the GEMM kernel takes CUDA tensors on one device")
    if a.dtype != torch.float32 or b.dtype != torch.float32 or a.dim() != 2 or b.dim() != 2:
        raise ValueError("the GEMM kernel takes 2-D float32 operands")
    if layout not in (FWD, DX, DW):
        raise ValueError(f"layout {layout} not in (FWD, DX, DW)")
    M, N, K = dims(layout, a, b)
    want = {FWD: (K, N), DX: (N, K), DW: (K, N)}[layout]
    if tuple(b.shape) != want or min(M, N, K) == 0:
        raise ValueError(f"b has shape {tuple(b.shape)}, expected {want}, all non-empty")
    if not (loadable(a) and loadable(b)):
        raise ValueError("the GEMM kernel reads 16-byte vectors: each operand needs a unit "
                         "column stride, a row stride, data pointer and width that are "
                         "multiples of 16 bytes")
    if bias is not None and (tuple(bias.shape) != (N,) or bias.dtype != torch.float32
                             or bias.stride(0) != 1 or bias.data_ptr() % 8
                             or bias.device != a.device):
        raise ValueError(f"bias must be a float32 vector of {N} on {a.device}, 8-byte aligned")


def _launch(a, b, bias=None, layout: int = FWD, check: bool = True, splits=None):
    """Launch the kernel: ``gemm_plain(layout, a, b, bias)`` into a fresh
    contiguous f32 (M, N). ``check=False`` when the caller has checked the
    operands (:func:`takes`, and the forward's for its backward).
    ``splits``: split-K's share (the C interface's rule), else
    :func:`splits_for`'s."""
    if check:
        _check(layout, a, b, bias)
    M, N, K = dims(layout, a, b)
    dev = a.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if splits is None:
        splits = splits_for(M, N, K, _sms(dev.index))
    else:
        splits = _lib().eeg_gemm_f32_splits(K, splits)
    ws = counters = None
    if splits > 1:
        tiles = -(-M // TILE_M) * -(-N // TILE_N)
        ws = torch.empty(splits * tiles * TILE_M * TILE_N, dtype=torch.float32, device=dev)
        counters = _counters(dev, tiles)
    err = _lib().eeg_gemm_f32(layout, M, N, K, a.data_ptr(), a.stride(0), b.data_ptr(),
                              b.stride(0), None if bias is None else bias.data_ptr(),
                              out.data_ptr(), N, splits, None if ws is None else ws.data_ptr(),
                              None if counters is None else counters.data_ptr(),
                              _build.current_stream(dev))
    _build.raise_on_error(err, "gemm_f32")
    return out


class GemmWrapper(KernelWrapper):
    """The kernel's wrapper, with the route's count of declined products."""

    def reset(self):
        super().reset()
        self.declined = 0


gemm_f32 = GemmWrapper("gemm_f32", _launch)
KERNELS = (gemm_f32,)


def gemm(layout: int, a, b, bias=None, check: bool = True):
    """``gemm_plain(layout, a, b, bias)``: the kernel on CUDA tensors, the
    plain version on the CPU."""
    if a.is_cuda:
        return gemm_f32(a, b, bias, layout, check=check)
    return gemm_plain(layout, a, b, bias)


# ---------------------------------------------------------------------------
# The route and the autograd Function
# ---------------------------------------------------------------------------

def rows_of(x, K: int):
    """x as a 2-D (rows, K) view, or None where that takes a copy."""
    if x.dim() == 2:
        return x
    return x.view(-1, K) if x.dim() > 2 and x.is_contiguous() else None


def decline(x, kernel, bias):
    """Why the kernel does not take ``x @ kernel + bias`` (device aside):
    None if it does, else "dtype" (not f32 both), "stacked" (a kernel that
    is not 2-D), "floor" (fewer than ``FLOOR_FLOPS`` operations) or
    "alignment" (an operand the kernel would need copied)."""
    if x.dtype != torch.float32 or kernel.dtype != torch.float32:
        return "dtype"
    if kernel.dim() != 2:
        return "stacked"
    K, N = kernel.shape
    if x.dim() < 2 or x.shape[-1] != K or 2 * (x.numel() // max(K, 1)) * N * K < FLOOR_FLOPS:
        return "floor"
    x2 = rows_of(x, K)
    if x2 is None or not loadable(x2) or not loadable(kernel) or bias is None \
            or bias.dim() != 1 or bias.stride(0) != 1 or bias.data_ptr() % 8:
        return "alignment"
    return None


def takes(x, kernel, bias) -> bool:
    """Whether ``linear`` sends ``x @ kernel + bias`` to the kernel: on the
    card, where :func:`decline` finds nothing; an f32 product with a 2-D
    kernel declined there counts in ``gemm_f32.declined``."""
    if not x.is_cuda:
        return False
    why = decline(x, kernel, bias)
    if why in ("floor", "alignment"):
        gemm_f32.declined += 1
    return why is None


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        return gemm(FWD, x, kernel, bias, check=False)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        need_x, need_kernel, need_bias = ctx.needs_input_grad
        if g.is_cuda and not loadable(g):  # autograd's layout; the BERT paths hand a loadable one
            g = g.clone(memory_format=torch.contiguous_format)  # fresh, so 16-byte aligned
        dx = gemm(DX, g, kernel, check=False) if need_x else None
        dk = gemm(DW, x, g, check=False) if need_kernel else None
        return dx, dk, g.sum(0) if need_bias else None


def linear_f32(x, kernel, bias):
    """``x @ kernel + bias`` for f32 x (..., K), kernel (K, N), bias (N,) that
    :func:`takes` accepts (on the CPU, any whose rows are a view), and its
    gradients: the kernel's three layouts on the card, ``gemm_plain`` on the
    CPU. Without a gradient to record, one launch and no Function."""
    K, N = kernel.shape
    x2 = rows_of(x, K)
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad
                                    or bias.requires_grad):
        y = _Linear.apply(x2, kernel, bias)
    else:
        y = gemm(FWD, x2, kernel, bias, check=False)
    return y if x.dim() == 2 else y.view(*x.shape[:-1], N)
