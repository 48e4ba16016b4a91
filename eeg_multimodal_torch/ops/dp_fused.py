"""The fused DP block as two hand-written Triton kernels for Hopper.

Replaces the JAX package's Pallas TPU kernels in ``ops/dp_pallas.py``:
``_dp_fwd_kernel`` (forward) and ``_dp_bwd_kernel`` (backward), both
launched through ``_call``'s ``pallas_call``. One pass over the raw fused
concat ``f`` (B, F) computes

    norm    = (f - min_row f) / (max_row f - min_row f)      # models.py:70-72
    w       = sigmoid(DP); eps_hat = 1 / log((e^eps - w) / (1 - w))
    noise   = Laplace(0, 1) from counter-based random bits
    out     = norm + noise * eps_hat                         # models.py:74-76

and the backward regenerates the same noise from the seed instead of
storing it. Beside the kernels stand their plain PyTorch versions
(``dp_block_plain``, ``dp_block_bwd_plain``, ``laplace_from_bits``): the
wrapper takes them only for tensors on the CPU, where the noise comes from
a ``torch.Generator`` seeded with the seed. On a CUDA tensor the wrapper
launches the kernel or raises.

The noise on the card is a Philox stream, not the TPU's bits nor JAX's
threefry: compare distributions, or hand both sides the same noise.
"""
import functools
import math
import os

import torch

from . import dp as dp_ops

_U23 = 1.0 / (1 << 23)
# Triton compiles at first launch; its cache stays inside the checkout
# (git-ignored) unless the caller points TRITON_CACHE_DIR elsewhere.
_TRITON_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache", "triton",
)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the yardstick of the kernels on the card)
# ---------------------------------------------------------------------------

def random_bits(shape, generator: torch.Generator, device="cpu"):
    """Uniform 32-bit draws, held in int64 (torch has no uint32 sampler)."""
    return torch.randint(0, 1 << 32, shape, generator=generator,
                         dtype=torch.int64, device=device)


def laplace_from_bits(bits):
    """Laplace(0, 1) by the inverse CDF of U(-1/2, 1/2): -sign(u) log1p(-2|u|).

    The top 23 of 32 bits plus a half step keep u01 strictly inside (0, 1):
    ``k + 0.5`` is exact in f32 for ``k < 2**23``, so |u| <= 1/2 - 2**-24
    and the noise is bounded by ln(2**23) ~ 15.9. A draw of exactly 0 (as
    ``tl.rand`` can return) would give log1p(-1) = -inf: the bug pinned by
    ``tools/repro_fused_dp_scan_nan.py`` of the JAX package.
    """
    k = torch.bitwise_right_shift(bits, 9).to(torch.float32)
    u = (k + 0.5) * _U23 - 0.5
    return -torch.sign(u) * torch.log1p(-2.0 * u.abs())


def seeded_noise(seed: int, shape):
    """The CPU path's noise for ``seed``: the same draw in forward and backward."""
    gen = torch.Generator().manual_seed(seed)
    return laplace_from_bits(random_bits(shape, gen))


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
# The Triton kernels
# ---------------------------------------------------------------------------

# Bound at build time: the kernels read ``tl`` and ``_laplace`` from the
# module's globals (every Triton version resolves names there), and the CPU
# tests import this module where there is no triton.
tl = None
_laplace = None


@functools.lru_cache(maxsize=None)
def _build():
    """Import triton and define the kernels (compiled at first launch)."""
    global tl, _laplace
    os.environ.setdefault("TRITON_CACHE_DIR", _TRITON_CACHE)
    import triton
    import triton.language as tl

    @triton.jit
    def _laplace(seed, offs):
        # Philox bits of (seed, flat element index); top 23 bits + 1/2
        bits = tl.randint(seed, offs)
        u = ((bits >> 9).to(tl.float32) + 0.5) * (1.0 / 8388608.0) - 0.5
        mag = tl.log(1.0 - 2.0 * tl.abs(u))  # 1 - 2|u| is exact in f32
        return tl.where(u > 0, -mag, mag)

    @triton.jit
    def dp_fwd_kernel(f_ptr, dp_ptr, seed_ptr, out_ptr, F, eps,
                      BLOCK_F: tl.constexpr):
        """Forward of the fused DP block; replaces ``_dp_fwd_kernel`` of the
        JAX package (ops/dp_pallas.py). Bound on the H100: bytes, 2*B*F*4 +
        F*4 (f read once, out written once; the noise never touches
        memory): 157 KB, 0.05 us at 3.35 TB/s at the flagship's (8, 2304),
        so a launch (a few us) bounds it in practice. Design: one program
        per row, the whole row in registers (BLOCK_F = next_pow2(F),
        masked, so any F, not only multiples of 128 as on the TPU), one
        pass: row min/max, eps_hat, Philox noise, store."""
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK_F)
        m = cols < F
        f = tl.load(f_ptr + row * F + cols, mask=m, other=0.0)
        fmin = tl.min(tl.where(m, f, float("inf")), axis=0)
        fmax = tl.max(tl.where(m, f, float("-inf")), axis=0)
        norm = (f - fmin) / (fmax - fmin)
        w = tl.sigmoid(tl.load(dp_ptr + cols, mask=m, other=0.0))
        eps_hat = 1.0 / tl.log((tl.exp(eps) - w) / (1.0 - w))
        noise = _laplace(tl.load(seed_ptr), row * F + cols)
        tl.store(out_ptr + row * F + cols, norm + noise * eps_hat, mask=m)

    @triton.jit
    def dp_bwd_kernel(f_ptr, g_ptr, dp_ptr, seed_ptr, df_ptr, ddp_ptr,
                      B, F, eps, N_ROW_PROGRAMS,
                      BLOCK_F: tl.constexpr, BLOCK_C: tl.constexpr):
        """Backward of the fused DP block; replaces ``_dp_bwd_kernel`` of the
        JAX package (ops/dp_pallas.py). Bound on the H100: bytes, 3*B*F*4 +
        2*F*4 with both outputs (f, g read; df written; dp read, dDP
        written): 230 KB, 0.07 us at (8, 2304), so launch-bound in practice.
        Design: the first N_ROW_PROGRAMS programs each take one row's df
        through its min-max (tie-split min/max gradient); the rest each take
        a BLOCK_C block of columns of dDP, looping over the B rows and
        regenerating the noise from (seed, row * F + col), so the sum over
        B needs no atomics and is deterministic. The wrapper leaves either
        half out of the grid when autograd does not need its output."""
        pid = tl.program_id(0)
        # (Triton wants a name bound in both branches to have one type, so
        # the two halves use their own names)
        if pid < N_ROW_PROGRAMS:
            # df of one row through its min-max
            row = pid
            rcols = tl.arange(0, BLOCK_F)
            rm = rcols < F
            f = tl.load(f_ptr + row * F + rcols, mask=rm, other=0.0)
            gr = tl.load(g_ptr + row * F + rcols, mask=rm, other=0.0)
            fmin = tl.min(tl.where(rm, f, float("inf")), axis=0)
            fmax = tl.max(tl.where(rm, f, float("-inf")), axis=0)
            span = fmax - fmin
            norm = (f - fmin) / span
            g_fmin = tl.sum(tl.where(rm, gr * (norm - 1.0) / span, 0.0), axis=0)
            g_fmax = tl.sum(tl.where(rm, -gr * norm / span, 0.0), axis=0)
            is_min = tl.where(rm & (f == fmin), 1.0, 0.0)
            is_max = tl.where(rm & (f == fmax), 1.0, 0.0)
            df = (gr / span + g_fmin * is_min / tl.sum(is_min, axis=0)
                  + g_fmax * is_max / tl.sum(is_max, axis=0))
            tl.store(df_ptr + row * F + rcols, df, mask=rm)
        else:
            # dDP of one column block: loop over the rows, regenerating the
            # noise, so the sum over B needs no atomics and is deterministic
            ccols = (pid - N_ROW_PROGRAMS) * BLOCK_C + tl.arange(0, BLOCK_C)
            cm = ccols < F
            seed = tl.load(seed_ptr)
            acc = tl.zeros([BLOCK_C], dtype=tl.float32)
            for r in range(0, B):
                gc = tl.load(g_ptr + r * F + ccols, mask=cm, other=0.0)
                acc += gc * _laplace(seed, r * F + ccols)
            w = tl.sigmoid(tl.load(dp_ptr + ccols, mask=cm, other=0.0))
            ew = tl.exp(eps) - w
            one_w = 1.0 - w
            log_term = tl.log(ew / one_w)
            deps_hat = -(-1.0 / ew + 1.0 / one_w) / (log_term * log_term)
            tl.store(ddp_ptr + ccols, acc * deps_hat * w * one_w, mask=cm)

    return triton, dp_fwd_kernel, dp_bwd_kernel


_BLOCK_C = 256
_MAX_F = 1 << 16  # one row lives in registers of one program


def _check(f, dp, seed, g=None):
    if not f.is_cuda:
        raise ValueError("the DP kernels take CUDA tensors")
    B, F = f.shape if f.dim() == 2 else (None, None)
    for name, t, shape in (("feature_raw", f, (B, F)), ("dp_param", dp, (1, F)),
                           ("grad", g, (B, F))):
        if t is None:
            continue
        if t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected (B, F) / (1, F)")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != f.device:
            raise ValueError(f"{name} must be contiguous float32 on {f.device}")
    if seed.numel() != 1 or seed.dtype not in (torch.int32, torch.int64) \
            or seed.device != f.device:
        raise ValueError(f"seed must be one int32/int64 element on {f.device}")
    if not 0 < F <= _MAX_F or B == 0:
        raise ValueError(f"feature width {F} outside (0, {_MAX_F}] or empty batch")


def _num_warps(block):
    return min(16, max(4, block // 512))


class KernelWrapper:
    """A hand-written kernel's wrapper: checks inputs, launches, counts.

    ``launches`` grows by one at each launch of the kernel, and nowhere else.
    """

    def __init__(self, name, launch):
        self.name = name
        self.launches = 0
        self._launch = launch

    def __call__(self, *args, **kwargs):
        out = self._launch(*args, **kwargs)
        self.launches += 1
        return out


def _launch_fwd(f, dp, epsilon: float, seed):
    """Launch ``dp_fwd_kernel`` on CUDA tensors: returns minmax(f) +
    noise(seed) * eps_hat(sigmoid(dp), epsilon)."""
    _check(f, dp, seed)
    triton, fwd, _ = _build()
    B, F = f.shape
    out = torch.empty_like(f)
    block = triton.next_power_of_2(F)
    fwd[(B,)](f, dp, seed, out, F, float(epsilon), BLOCK_F=block,
              num_warps=_num_warps(block))
    return out


def _launch_bwd(f, dp, epsilon: float, seed, g, need_df=True, need_ddp=True):
    """Launch ``dp_bwd_kernel`` on CUDA tensors for the output gradient
    ``g``: returns (df or None, dDP or None), leaving out what is not
    needed."""
    if not (need_df or need_ddp):
        raise ValueError("nothing to compute: need_df and need_ddp are both False")
    _check(f, dp, seed, g)
    triton, _, bwd = _build()
    B, F = f.shape
    df = torch.empty_like(f) if need_df else None
    ddp = torch.empty_like(dp) if need_ddp else None
    n_rows = B if need_df else 0
    n_cols = triton.cdiv(F, _BLOCK_C) if need_ddp else 0
    block = triton.next_power_of_2(F)
    bwd[(n_rows + n_cols,)](
        f, g, dp, seed, df if need_df else g, ddp if need_ddp else dp,
        B, F, float(epsilon), n_rows, BLOCK_F=block, BLOCK_C=_BLOCK_C,
        num_warps=_num_warps(block),
    )
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
            drawn = noise if noise is not None else seeded_noise(
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
            noise = given[0] if given else seeded_noise(int(seed.reshape(-1)[0]), f.shape)
            df, ddp = dp_block_bwd_plain(f, dp, ctx.epsilon, noise, g)
            df = df if need_df else None
            ddp = ddp if need_ddp else None
        return df, ddp, None, None, None


def fused_lap_dropout(feature_raw, dp_param, epsilon: float, seed, noise=None):
    """min-max normalize + learned per-feature Laplace noise, one kernel each
    way on the card.

    feature_raw : (B, F) raw fused concat, f32; dp_param : (1, F) f32;
    epsilon : float; seed : one-element int tensor on the same device (read
    in the kernel, so drawing it costs no host sync). ``noise`` (CPU only)
    replaces the seed's draw with a given Laplace(0, 1) array, so that tests
    can hand the port the JAX reference's noise.
    """
    return _FusedLapDropout.apply(feature_raw, dp_param, float(epsilon), seed, noise)
