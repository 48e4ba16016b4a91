"""The fused DP block as two hand-written CUDA C++ kernels for Hopper.

Replaces the JAX package's Pallas TPU kernels in ``ops/dp_pallas.py``:
``_dp_fwd_kernel`` (forward) and ``_dp_bwd_kernel`` (backward), both
launched through ``_call``'s ``pallas_call``. The kernels are in
``eeg_multimodal_torch/csrc/dp_block.cu`` (built by ``ops/_build.py`` with
the attention kernels; the source notes what bounds them and how they are
laid out). One pass over the raw fused concat ``f`` (B, F) computes

    norm    = (f - min_row f) / (max_row f - min_row f)      # models.py:70-72
    w       = sigmoid(DP); eps_hat = 1 / log((e^eps - w) / (1 - w))
    noise   = Laplace(0, 1) from counter-based random bits
    out     = norm + noise * eps_hat                         # models.py:74-76

and the backward regenerates the same noise from the seed instead of
storing it. The noise is :func:`laplace_plain`'s, a function of the seed and
the flat index alone, on the card and on the CPU alike: the TPU's bits and
JAX's threefry are other streams, so tests hand both sides the same noise.

Beside the kernels stand their plain PyTorch versions (``dp_block_plain``,
``dp_block_bwd_plain``, ``laplace_plain``): ``fused_lap_dropout`` takes
them only for tensors on the CPU. On a CUDA tensor the wrappers launch the
kernels or raise.
"""
import ctypes
import functools
import math

import torch

from . import _build
from . import dp as dp_ops
from .dp import laplace_from_bits
from .philox import philox_words


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the yardstick of the kernels on the card)
# ---------------------------------------------------------------------------

def laplace_plain(seed: int, shape, device="cpu"):
    """The kernels' exact noise for ``seed`` over ``shape``: element n (its
    flat index) takes word n & 3 of Philox4x32-10 at counter n & ~3, keyed by
    the 64-bit seed, through :func:`laplace_from_bits`. A function of
    (seed, n) alone, whatever F, so the CPU path and the card draw the same
    noise."""
    numel = math.prod(shape)
    counters = torch.arange(0, numel, 4, dtype=torch.int64, device=device)
    return laplace_from_bits(philox_words(counters, seed).reshape(-1)[:numel]).reshape(shape)


def dp_block_plain(f, dp, epsilon: float, noise):
    """Forward of the fused block given its noise: minmax(f) + noise * eps_hat."""
    return dp_ops.lap_dropout_fast(
        dp_ops.minmax_normalize(f), dp, epsilon, noise
    )


def dp_block_bwd_plain(f, dp, epsilon: float, noise, g):
    """Hand-derived backward of :func:`dp_block_plain`: (df (B, F), dDP (1, F)).

    df goes through the row min-max; the min and max gradients are split
    evenly among tied argmin / argmax elements, as XLA's autodiff of
    min/max does. dDP = sum_B(g * noise) * d eps_hat / dw * w (1 - w).
    """
    fmin = f.amin(-1, keepdim=True)
    fmax = f.amax(-1, keepdim=True)
    span = fmax - fmin
    norm = (f - fmin) / span
    g_fmin = (g * (norm - 1.0) / span).sum(-1, keepdim=True)
    g_fmax = (g * -norm / span).sum(-1, keepdim=True)
    is_min = (f == fmin).to(f.dtype)
    is_max = (f == fmax).to(f.dtype)
    is_min = is_min / is_min.sum(-1, keepdim=True)
    is_max = is_max / is_max.sum(-1, keepdim=True)
    df = g / span + g_fmin * is_min + g_fmax * is_max

    w = torch.sigmoid(dp)
    ew = math.exp(epsilon) - w
    one_w = 1.0 - w
    log_term = torch.log(ew / one_w)
    deps_hat = -(-1.0 / ew + 1.0 / one_w) / (log_term * log_term)
    ddp = (g * noise).sum(0, keepdim=True) * deps_hat * w * one_w
    return df, ddp


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with the DP functions' argument types set."""
    lib = _build.library()[0]
    lib.eeg_dp_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _F, _P]  # f, dp, seed, out
    lib.eeg_dp_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P]  # ..., df, ddp
    lib.eeg_dp_fwd.restype = lib.eeg_dp_bwd.restype = _I
    return lib


def _check(f, dp, seed, g=None):
    """Raise unless the kernels take these tensors; returns f's device."""
    if not f.is_cuda:
        raise ValueError("the DP kernels take CUDA tensors")
    if f.dim() != 2 or min(f.shape) == 0:
        raise ValueError(f"feature_raw has shape {tuple(f.shape)}, expected non-empty (B, F)")
    B, F = f.shape
    dev = f.device
    for name, t, shape in (("feature_raw", f, (B, F)), ("dp_param", dp, (1, F)),
                           ("grad", g, (B, F))):
        if t is None:
            continue
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if seed.numel() != 1 or seed.dtype != torch.int64 or seed.device != dev:
        raise ValueError(f"seed must be one int64 element on {dev}")
    return dev


class KernelWrapper:
    """A hand-written kernel's wrapper: checks inputs, launches, counts.

    ``launches`` grows by one at each launch of the kernel, and nowhere else;
    ``by_dtype`` splits that count by the dtype of the first argument, i.e.
    by the instantiation launched.
    """

    def __init__(self, name, launch):
        self.name = name
        self._launch = launch
        self.reset()

    def reset(self):
        """Set the counts to 0."""
        self.launches = 0
        self.by_dtype = {}

    def __call__(self, *args, **kwargs):
        out = self._launch(*args, **kwargs)
        self.launches += 1
        dtype = str(args[0].dtype).replace("torch.", "")
        self.by_dtype[dtype] = self.by_dtype.get(dtype, 0) + 1
        return out


def _launch_fwd(f, dp, epsilon: float, seed):
    """Launch ``dp_fwd_kernel`` on CUDA tensors: returns minmax(f) +
    laplace_plain(seed) * eps_hat(sigmoid(dp), epsilon)."""
    dev = _check(f, dp, seed)
    B, F = f.shape
    out = torch.empty_like(f)
    err = _lib().eeg_dp_fwd(f.data_ptr(), dp.data_ptr(), seed.data_ptr(), out.data_ptr(),
                            B, F, math.exp(epsilon), _build.current_stream(dev))
    _build.raise_on_error(err, "dp_fwd")
    return out


def _launch_bwd(f, dp, epsilon: float, seed, g, need_df=True, need_ddp=True):
    """Launch ``dp_bwd_kernel`` on CUDA tensors for the output gradient
    ``g``: returns (df or None, dDP or None), leaving out of the grid what is
    not needed."""
    if not (need_df or need_ddp):
        raise ValueError("nothing to compute: need_df and need_ddp are both False")
    dev = _check(f, dp, seed, g)
    B, F = f.shape
    df = torch.empty_like(f) if need_df else None
    ddp = torch.empty_like(dp) if need_ddp else None
    err = _lib().eeg_dp_bwd(f.data_ptr(), g.data_ptr(), dp.data_ptr(), seed.data_ptr(),
                            df.data_ptr() if need_df else None,
                            ddp.data_ptr() if need_ddp else None,
                            B, F, math.exp(epsilon), _build.current_stream(dev))
    _build.raise_on_error(err, "dp_bwd")
    return df, ddp


dp_fwd = KernelWrapper("dp_fwd", _launch_fwd)
dp_bwd = KernelWrapper("dp_bwd", _launch_bwd)
KERNELS = (dp_fwd, dp_bwd)


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------

class _FusedLapDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feature_raw, dp_param, epsilon, seed, noise):
        ctx.epsilon = epsilon
        if feature_raw.is_cuda:
            if noise is not None:
                raise ValueError("on the card the noise is drawn in the kernel")
            out = dp_fwd(feature_raw, dp_param, epsilon, seed)
        else:
            drawn = noise if noise is not None else laplace_plain(
                int(seed.reshape(-1)[0]), feature_raw.shape)
            out = dp_block_plain(feature_raw, dp_param, epsilon, drawn)
        # the seed, not the noise: the backward regenerates it
        ctx.save_for_backward(feature_raw, dp_param, seed,
                              *(() if noise is None else (noise,)))
        return out

    @staticmethod
    def backward(ctx, g):
        f, dp, seed, *given = ctx.saved_tensors
        need_df, need_ddp = ctx.needs_input_grad[:2]
        if f.is_cuda:
            df, ddp = dp_bwd(f, dp, ctx.epsilon, seed, g.contiguous(),
                             need_df=need_df, need_ddp=need_ddp)
        else:
            noise = given[0] if given else laplace_plain(int(seed.reshape(-1)[0]), f.shape)
            df, ddp = dp_block_bwd_plain(f, dp, ctx.epsilon, noise, g)
            df = df if need_df else None
            ddp = ddp if need_ddp else None
        return df, ddp, None, None, None


def fused_lap_dropout(feature_raw, dp_param, epsilon: float, seed, noise=None):
    """min-max normalize + learned per-feature Laplace noise, one kernel each
    way on the card.

    feature_raw : (B, F) raw fused concat, f32; dp_param : (1, F) f32;
    epsilon : float; seed : one-element int64 tensor on the same device
    (read in the kernel, so drawing it costs no host sync); the noise is
    ``laplace_plain(seed, feature_raw.shape)`` on either device. ``noise``
    (CPU only) replaces the seed's draw with a given Laplace(0, 1) array, so
    that tests can hand the port the JAX reference's noise.
    """
    return _FusedLapDropout.apply(feature_raw, dp_param, float(epsilon), seed, noise)
