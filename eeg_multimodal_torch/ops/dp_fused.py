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

Sweep members (``train/sweep.py``): f may hold M members' rows, (M B, F)
with member m's B rows the m-th block, each with its own DP row (``DP``
(M, F)), epsilon (an (M,) tensor) and seed (an (M,) tensor). One launch
each way then serves every member, and member m's rows get exactly what a
call over its rows alone, with its seed and its float epsilon, gives: its
noise is ``laplace_plain`` of its seed over its own (B, F), and dDP (M, F)
is each member's sum over its own rows.

Beside the kernels stand their plain PyTorch versions (``dp_block_plain``,
``dp_block_bwd_plain``, ``laplace_plain``), with the same member axis:
``fused_lap_dropout`` takes them only for tensors on the CPU. On a CUDA
tensor the wrappers launch the kernels or raise.
"""
import ctypes
import functools
import math

import torch

from . import _build
from . import dp as dp_ops
from .dp import laplace_from_bits, member_exp
from .philox import philox_words


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the yardstick of the kernels on the card)
# ---------------------------------------------------------------------------

def laplace_plain(seed, shape, device="cpu"):
    """The kernels' exact noise for ``seed`` over ``shape``: element n (its
    flat index) takes word n & 3 of Philox4x32-10 at counter n & ~3, keyed by
    the 64-bit seed, through :func:`laplace_from_bits`. A function of
    (seed, n) alone, whatever F, so the CPU path and the card draw the same
    noise. A sequence of M seeds (the sweep's members) gives M blocks of
    shape[0] / M rows, block m the noise of seed m over its rows alone."""
    if isinstance(seed, (list, tuple)):
        seeds = [int(s) for s in seed]
        rows = (shape[0] // len(seeds), *shape[1:])
        return torch.cat([laplace_plain(s, rows, device) for s in seeds])
    numel = math.prod(shape)
    counters = torch.arange(0, numel, 4, dtype=torch.int64, device=device)
    return laplace_from_bits(philox_words(counters, seed).reshape(-1)[:numel]).reshape(shape)


def _each_member(fn, f, dp, epsilon, *rows):
    """``fn(f, dp, epsilon, *rows)`` for one member; for M (an (M, F) ``dp``),
    ``fn`` over each member's rows with its DP row and float epsilon, the
    outputs stacked member after member: M single calls exactly (the CPU's
    elementwise math rounds alike only in the same layout)."""
    M = dp.reshape(-1, dp.shape[-1]).shape[0]
    if M == 1:
        return fn(f, dp, float(epsilon) if dp_ops.per_member(epsilon) else epsilon, *rows)
    eps = epsilon.tolist() if dp_ops.per_member(epsilon) else [epsilon] * M
    outs = [fn(*(x.reshape(M, -1, x.shape[-1])[m] for x in (f, dp)), e,
               *(x.reshape(M, -1, x.shape[-1])[m] for x in rows))
            for m, e in enumerate(eps)]
    return torch.cat(outs) if torch.is_tensor(outs[0]) else tuple(map(torch.cat, zip(*outs)))


def dp_block_plain(f, dp, epsilon, noise):
    """Forward of the fused block given its noise: minmax(f) + noise * eps_hat;
    per member with an (M, F) ``dp`` and an (M,) ``epsilon``, each as a call
    of its own."""
    return _each_member(
        lambda f, dp, e, noise: dp_ops.lap_dropout_fast(dp_ops.minmax_normalize(f), dp, e, noise),
        f, dp, epsilon, noise)


def dp_block_bwd_plain(f, dp, epsilon, noise, g):
    """Hand-derived backward of :func:`dp_block_plain`: (df (B, F), dDP (1, F)),
    or dDP (M, F) for M members, each over its own rows as a call of its own.

    df goes through the row min-max; the min and max gradients are split
    evenly among tied argmin / argmax elements, as XLA's autodiff of
    min/max does. dDP = sum_B(g * noise) * d eps_hat / dw * w (1 - w).
    """
    return _each_member(_bwd_plain, f, dp, epsilon, noise, g)


def _bwd_plain(f, dp, epsilon: float, noise, g):
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
    # f, dp, seed, exp_eps vector, out, M, B, F, exp_eps, stream
    lib.eeg_dp_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
    # f, g, dp, seed, exp_eps vector, df, ddp, M, B, F, exp_eps, stream
    lib.eeg_dp_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
    lib.eeg_dp_fwd.restype = lib.eeg_dp_bwd.restype = _I
    return lib


def _exp_eps(epsilon, dev):
    """(device vector of e^eps or None, host e^eps): a float epsilon goes to
    the kernel as a host float, a per-member one as an (M,) f32 vector,
    each e^eps of the float64 value rounded once to f32."""
    if dp_ops.per_member(epsilon):
        if epsilon.device != dev:
            raise ValueError(f"epsilon must be on {dev}")
        return member_exp(epsilon).reshape(-1), 0.0
    return None, math.exp(epsilon)


def _check(f, dp, seed, epsilon, g=None):
    """Raise unless the kernels take these tensors; returns (device, M, B),
    M members of B rows each."""
    if not f.is_cuda:
        raise ValueError("the DP kernels take CUDA tensors")
    if f.dim() != 2 or min(f.shape) == 0:
        raise ValueError(f"feature_raw has shape {tuple(f.shape)}, expected non-empty (M B, F)")
    N, F = f.shape
    M = dp.shape[0] if dp.dim() == 2 else 0
    if M == 0 or N % M:
        raise ValueError(f"dp_param has shape {tuple(dp.shape)}: expected (M, {F}), M "
                         f"dividing the {N} rows")
    dev = f.device
    for name, t, shape in (("feature_raw", f, (N, F)), ("dp_param", dp, (M, F)),
                           ("grad", g, (N, F))):
        if t is None:
            continue
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if seed.shape != (M,) or seed.dtype != torch.int64 or seed.device != dev:
        raise ValueError(f"seed must be {M} int64 elements on {dev}, one per member")
    if dp_ops.per_member(epsilon) and epsilon.numel() != M:
        raise ValueError(f"epsilon has {epsilon.numel()} values for {M} members")
    return dev, M, N // M


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


def _launch_fwd(f, dp, epsilon, seed):
    """Launch ``dp_fwd_kernel`` on CUDA tensors: returns minmax(f) +
    laplace_plain(seed) * eps_hat(sigmoid(dp), epsilon), per member for
    (M, F) ``dp``, (M,) ``epsilon`` and (M,) ``seed``."""
    dev, M, B = _check(f, dp, seed, epsilon)
    exp_vec, exp_host = _exp_eps(epsilon, dev)
    out = torch.empty_like(f)
    err = _lib().eeg_dp_fwd(f.data_ptr(), dp.data_ptr(), seed.data_ptr(),
                            None if exp_vec is None else exp_vec.data_ptr(), out.data_ptr(),
                            M, B, f.shape[1], exp_host, _build.current_stream(dev))
    _build.raise_on_error(err, "dp_fwd")
    return out


def _launch_bwd(f, dp, epsilon, seed, g, need_df=True, need_ddp=True):
    """Launch ``dp_bwd_kernel`` on CUDA tensors for the output gradient
    ``g``: returns (df or None, dDP or None), leaving out of the grid what is
    not needed; dDP is (M, F), each member's over its own rows."""
    if not (need_df or need_ddp):
        raise ValueError("nothing to compute: need_df and need_ddp are both False")
    dev, M, B = _check(f, dp, seed, epsilon, g)
    exp_vec, exp_host = _exp_eps(epsilon, dev)
    df = torch.empty_like(f) if need_df else None
    ddp = torch.empty_like(dp) if need_ddp else None
    err = _lib().eeg_dp_bwd(f.data_ptr(), g.data_ptr(), dp.data_ptr(), seed.data_ptr(),
                            None if exp_vec is None else exp_vec.data_ptr(),
                            df.data_ptr() if need_df else None,
                            ddp.data_ptr() if need_ddp else None,
                            M, B, f.shape[1], exp_host, _build.current_stream(dev))
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
            drawn = noise if noise is not None else laplace_plain(seed.reshape(-1).tolist(),
                                                                  feature_raw.shape)
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
            noise = given[0] if given else laplace_plain(seed.reshape(-1).tolist(), f.shape)
            df, ddp = dp_block_bwd_plain(f, dp, ctx.epsilon, noise, g)
            df = df if need_df else None
            ddp = ddp if need_ddp else None
        return df, ddp, None, None, None


def fused_lap_dropout(feature_raw, dp_param, epsilon, seed, noise=None):
    """min-max normalize + learned per-feature Laplace noise, one kernel each
    way on the card.

    feature_raw : (B, F) raw fused concat, f32; dp_param : (1, F) f32;
    epsilon : float; seed : one-element int64 tensor on the same device
    (read in the kernel, so drawing it costs no host sync); the noise is
    ``laplace_plain(seed, feature_raw.shape)`` on either device. For M
    sweep members: (M B, F) rows, (M, F) ``dp_param``, an (M,) float64
    ``epsilon`` and (M,) seeds on the device. ``noise`` (CPU only) replaces
    the seed's draw with a given Laplace(0, 1) array, so that tests can
    hand the port the JAX reference's noise.
    """
    if not dp_ops.per_member(epsilon):
        epsilon = float(epsilon)
    return _FusedLapDropout.apply(feature_raw, dp_param, epsilon, seed, noise)
