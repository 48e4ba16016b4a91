"""Fused BERT self-attention, forward and backward, as CUDA C++ kernels.

Replaces the JAX package's Pallas TPU kernels in ``ops/attention.py``:
``_fwd_kernel`` and ``_bwd_kernel``. The kernels are in
``eeg_multimodal_torch/csrc/``: ``attention_f32.cu`` (f32, 3xTF32 on
wgmma), ``attention_bf16.cu`` (bf16, wgmma and TMA), behind the C interface
of ``attention.cu`` (built by ``ops/_build.py``; each source notes what
bounds its kernels and how they are tiled). They compute

    out = dropout(softmax(q k^T / sqrt(D) + bias)) v

over (B, H, S, D) with f32 scores, a (B, S) additive key bias (0 or
finfo(f32).min), and prob dropout kept where ``(bits >> 8) < (1 - p) 2^24``
and scaled by 1 / (1 - p), the JAX kernel's rule. The backward regenerates
the mask from the seed instead of storing it. The seed may be a vector of G
seeds, G dividing B: batch row b then takes seed b // (B / G) and draws the
mask its row b mod (B / G) would draw in a call of its own, so one call over
G stacked batches equals G calls, one per batch and seed (the paired phase
encode's 2B forward).

A call may be one block of a larger one: a rank's shard under a (data, model)
mesh (``parallel/``) holds rows b0 .. of ``batch`` and heads h0 .. of
``heads``. Given that block (:class:`Block`), the mask takes the global row
and head, so each block draws exactly its slice of the global call's mask;
the seed vector is the global call's. ``Block()`` is the call of its own.

Beside them stand their plain PyTorch versions (``attention_plain``,
``attention_bwd_plain``, with an explicit keep mask, and
``keep_mask_plain``, the kernels' exact mask). The wrappers take the plain
versions only for tensors on the CPU, where the mask comes from a
``torch.Generator`` seeded with the seed. On a CUDA tensor they launch the
kernels or raise. The card's mask is a Philox stream, not the TPU's bits
nor JAX's threefry: compare distributions, or hand both sides the same mask.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .dp import random_bits
from .dp_fused import KernelWrapper
from .philox import philox_words

HEAD_DIMS = (64, 128)  # the head widths the kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_available(S: int, D: int) -> bool:
    """Whether self-attention at (S, D) dispatches to the kernels: at every
    S, for D in ``HEAD_DIMS`` (64 and 128, which hold every BERT head
    width); at another D the plain branch runs.

    The H100's gate, set from ``chip_smoke.py``'s timings of the kernels
    against the plain branch (forward + backward through autograd, 8 x 12
    heads, f32, p = 0.1): the kernels were faster at S = 80, 128 and 512 in
    every run (PERF.md). The JAX package's gate (S a multiple of 128, at
    least 512, one head under 8 MB of VMEM) came from TPU timings; the
    flagship's truncated S = 80 now runs the kernels here, and the plain
    einsum branch there.
    """
    return S > 0 and D in HEAD_DIMS


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the yardstick of the kernels on the card)
# ---------------------------------------------------------------------------

class Block(tuple):
    """(b0, batch, h0, heads): the call's rows are rows b0 .. of ``batch``
    global rows, its heads heads h0 .. of ``heads``; ``batch`` / ``heads``
    None mean the call's own B / H (then b0 / h0 must be 0)."""

    def __new__(cls, b0: int = 0, batch=None, h0: int = 0, heads=None):
        return super().__new__(cls, (int(b0), batch, int(h0), heads))

    def resolve(self, B: int, H: int):
        """(b0, batch, h0, heads) with the counts filled in for a (B, H) call;
        raises unless the call fits in them."""
        b0, batch, h0, heads = self
        batch = B if batch is None else int(batch)
        heads = H if heads is None else int(heads)
        if b0 < 0 or h0 < 0 or b0 + B > batch or h0 + H > heads:
            raise ValueError(f"block rows {b0}..{b0 + B} of {batch}, heads {h0}..{h0 + H} of "
                             f"{heads}: outside the global call")
        return b0, batch, h0, heads


def keep_threshold(dropout_rate: float) -> int:
    """The 24-bit keep threshold of the JAX kernel: (1 - p) * 2^24."""
    return int((1.0 - dropout_rate) * (1 << 24))


def _seeds(seed):
    """An int, a sequence of ints or a CPU tensor of seeds as a list of
    ints."""
    return [int(s) for s in torch.as_tensor(seed).reshape(-1).tolist()]


def seeded_keep(seed, shape, dropout_rate: float, block=Block()):
    """The CPU path's keep mask for ``seed``: the same draw in forward and
    backward, by the kernels' rule on torch's uniform 32-bit draws. G seeds
    split the batch axis into G groups, each drawn as a call of its own.
    ``block``: the call is that block of the global call, whose mask is
    drawn and sliced."""
    B, H = shape[:2]
    b0, batch, h0, heads = Block(*block).resolve(B, H)
    seeds = _seeds(seed)
    rows = batch // len(seeds)
    bits = torch.cat([random_bits((rows, heads, *shape[2:]), torch.Generator().manual_seed(s))
                      for s in seeds])
    return torch.bitwise_right_shift(bits[b0:b0 + B, h0:h0 + H], 8) < keep_threshold(dropout_rate)


def mask_groups(S: int):
    """The kernels' grouping of a head's (S, S) mask, as (S, S) int64
    tensors (i0, j0, word): element (i, j) takes word ``word`` of the Philox
    call at counter ((b H + h) S + i0) S + j0, with i0 = (i & ~15) | (i & 7)
    and j0 = j & ~1. A call serves rows {i0, i0 + 8} x columns {j0, j0 + 1},
    the four elements one thread holds in an m16n8 C fragment."""
    i = torch.arange(S, dtype=torch.int64)[:, None]
    j = torch.arange(S, dtype=torch.int64)[None, :]
    i0 = ((i & ~15) | (i & 7)).expand(S, S)
    j0 = (j & ~1).expand(S, S)
    return i0, j0, 2 * ((i >> 3) & 1) + (j & 1)


def keep_mask_plain(seed, B: int, H: int, S: int, dropout_rate: float, device="cpu",
                    block=Block()):
    """The kernels' exact keep mask for (B, H, S, S), as bool: Philox4x32-10
    keyed by the 64-bit ``seed``, grouped as :func:`mask_groups` says, kept
    where ``(bits >> 8) < (1 - p) 2^24``. A function of (seed, b, h, i, j)
    alone; the forward, both backward kernels and ``attn_dropout_mask`` draw
    this mask on the card. G seeds (a sequence) split the batch into G
    groups of B / G rows, each group the mask of a call of its own.
    ``block`` (:class:`Block`): the rows and heads are the global call's
    b0 + b and h0 + h, so the mask is that block of the global mask."""
    b0, batch, h0, heads = Block(*block).resolve(B, H)
    seeds = _seeds(seed)
    per_seed = batch // len(seeds)
    i0, j0, word = (x.to(device) for x in mask_groups(S))
    rows = i0[:, 0][(torch.arange(S, device=device) & 8) == 0]  # the distinct i0
    cols = torch.arange(0, S, 2, dtype=torch.int64, device=device)
    b = b0 + torch.arange(B, dtype=torch.int64, device=device)
    h = h0 + torch.arange(H, dtype=torch.int64, device=device)
    bh = (b % per_seed)[:, None] * heads + h[None, :]  # (B, H)
    counters = (bh[..., None, None] * S + rows[:, None]) * S + cols  # (B, H, rows, cols)
    group = b // per_seed  # each row's seed
    words = torch.empty((*counters.shape, 4), dtype=torch.int64, device=device)
    for g in group.unique().tolist():
        words[group == g] = philox_words(counters[group == g], seeds[g])
    # element (i, j) reads its group's word: row i0 is rows[pos], column j0 cols[j0 // 2]
    pos = torch.searchsorted(rows, i0[:, 0].contiguous())
    bits = words[:, :, pos[:, None], (j0[0] // 2)[None, :], word]
    return (bits >> 8).lt(keep_threshold(dropout_rate))


def _mask_shape(q):
    B, H, S, _ = q.shape
    return (B, H, S, S)


def _bias2d(bias):
    """(B, S) from the JAX package's (B, 1, S) or a (B, S) bias."""
    return bias[:, 0, :] if bias.dim() == 3 else bias


def _scores_probs(q, k, bias):
    """f32 scores q k^T * scale + bias and their stable softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + _bias2d(bias).float()[:, None, None, :]
    return torch.softmax(s, dim=-1)


def _drop(x, keep, dropout_rate):
    return torch.where(keep, x / (1.0 - dropout_rate), torch.zeros((), dtype=x.dtype))


def attention_plain(q, k, v, bias, keep=None, dropout_rate: float = 0.0):
    """softmax(q k^T / sqrt(D) + bias) v over (B, H, S, D), dropout by the
    boolean (B, H, S, S) ``keep``. f32 scores and softmax; P is rounded to
    the input dtype before P.V, which accumulates in f32."""
    if dropout_rate > 0.0 and keep is None:
        raise ValueError("dropout needs the keep mask")
    p = _scores_probs(q, k, bias)
    if dropout_rate > 0.0:
        p = _drop(p, keep, dropout_rate)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def attention_bwd_plain(q, k, v, bias, keep, dropout_rate: float, dout):
    """Hand-derived backward of :func:`attention_plain` for the output
    gradient ``dout``: (dq, dk, dv), as the JAX kernel computes it.

    dV = P_drop^T dO;  dP = dO V^T, masked and scaled;
    dS = P (dP - rowsum(dP P));  dQ = dS K / sqrt(D);  dK = dS^T Q / sqrt(D).
    P_drop, dO and dS are rounded to the input dtype before their products.
    """
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _scores_probs(q, k, bias)
    p_drop = _drop(p, keep, dropout_rate) if dropout_rate > 0.0 else p
    do = dout.to(dt).float()
    dv = torch.matmul(p_drop.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    if dropout_rate > 0.0:
        dp = _drop(dp, keep, dropout_rate)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# dtype, D, B, H, S, then q, k, v each as a pointer and (b, h, s) strides,
# bias, seed, number of seeds, the block (b0, B_all, h0, H_all), scale,
# threshold, keep probability, dropout on
_COMMON = [_I] * 5 + [_P, _I64, _I64, _I64] * 3 + [_P, _P, _I] + [_I] * 4 + [_F, _I, _F, _I]


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with every C function's argument types set."""
    lib = _build.library()[0]
    lib.eeg_attn_fwd.argtypes = _COMMON + [_P, _P, _P]  # out, stats, stream
    # out, stats, dout + strides, delta, dq, dk, dv, stream
    lib.eeg_attn_bwd.argtypes = _COMMON + [_P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _P, _P]
    lib.eeg_attn_dropout_mask.argtypes = [_I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P]
    for fn in (lib.eeg_attn_fwd, lib.eeg_attn_bwd, lib.eeg_attn_dropout_mask):
        fn.restype = _I
    return lib


def _check_seed(seed, device, B):
    """A seed tensor: G int64 elements on ``device``, G dividing ``B`` (the
    global call's rows)."""
    if seed.dim() != 1 or seed.dtype != torch.int64 or seed.device != device \
            or seed.numel() == 0 or B % seed.numel() or not seed.is_contiguous():
        raise ValueError(f"seed must be a contiguous vector of G int64 elements on {device}, "
                         f"G dividing B = {B}; got {tuple(seed.shape)} {seed.dtype}")


def _aligned(t) -> bool:
    """Whether the data pointer and the (b, h, s) strides (of axes longer
    than 1) of the (B, H, S, D) view ``t`` are multiples of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * size % 16 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def vector_loadable(dout):
    """``dout`` itself if the kernels' 16-byte loads can read it, else a
    contiguous copy in fresh (aligned) memory. For the output gradient that
    autograd hands the backward, which the caller never sees: q, k and v
    are checked instead, never copied."""
    if dout.stride(-1) == 1 and _aligned(dout):
        return dout
    return dout.clone(memory_format=torch.contiguous_format)


def check_vector_loads(name, t):
    """Raise unless the kernels' 16-byte loads can read ``t``, a (B, H, S, D)
    view: a unit last stride, a data pointer and (b, h, s) strides (of axes
    longer than 1) that are multiples of 16 bytes. The packed QKV views of
    the BERT path are; nothing is copied to make another view so."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit stride along D")
    if not _aligned(t):
        size = t.element_size()
        raise ValueError(
            f"{name}: the attention kernels load 16-byte vectors, so the data pointer and "
            f"the (b, h, s) strides must be multiples of 16 bytes; got pointer % 16 = "
            f"{t.data_ptr() % 16}, strides {tuple(t.stride()[:3])} of {size}-byte elements")


def _check(q, k, v, bias, seed, dropout_rate, block, dout=None):
    """Raise unless the kernels take these tensors; returns the resolved
    block (b0, B_all, h0, H_all)."""
    if not q.is_cuda:
        raise ValueError("the attention kernels take CUDA tensors")
    if q.dim() != 4:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected (B, H, S, D)")
    B, H, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if t is None:
            continue
        if tuple(t.shape) != (B, H, S, D) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {(B, H, S, D)} {q.dtype} on {q.device}")
        check_vector_loads(name, t)
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {list(_DTYPES)}")
    if D not in HEAD_DIMS or min(B, H, S) == 0:
        raise ValueError(f"head width {D} not in {HEAD_DIMS}, or an empty axis")
    if tuple(bias.shape) != (B, S) or bias.dtype != torch.float32 \
            or not bias.is_contiguous() or bias.device != q.device:
        raise ValueError(f"bias must be contiguous (B, S) = {(B, S)} float32 on {q.device}")
    block = Block(*block).resolve(B, H)
    _check_seed(seed, q.device, block[1])
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout rate {dropout_rate} outside [0, 1)")
    return block


def _common_args(q, k, v, bias, seed, dropout_rate, block):
    B, H, S, D = q.shape
    args = [_DTYPES[q.dtype], D, B, H, S]
    for t in (q, k, v):
        args += [t.data_ptr(), *t.stride()[:3]]
    return args + [bias.data_ptr(), seed.data_ptr(), seed.numel(), *block, 1.0 / math.sqrt(D),
                   keep_threshold(dropout_rate), 1.0 - dropout_rate, int(dropout_rate > 0.0)]


def _launch_fwd(q, k, v, bias, seed, dropout_rate: float = 0.0, block=Block()):
    """Launch the forward kernel on CUDA tensors. q, k, v: (B, H, S, D)
    views that :func:`check_vector_loads` accepts; bias (B, S) f32; seed G
    int64 elements, G dividing the global rows; ``block`` the call's place
    in the global call (:class:`Block`).
    Returns (out, stats): out a (B, H, S, D) view of a (B, S, H, D) buffer;
    stats (2, B, H, S) f32, each row's softmax max m and sum l, for the
    backward."""
    block = _check(q, k, v, bias, seed, dropout_rate, block)
    B, H, S, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, B, H, S), dtype=torch.float32, device=q.device)
    err = _lib().eeg_attn_fwd(*_common_args(q, k, v, bias, seed, dropout_rate, block),
                              out.data_ptr(), stats.data_ptr(), _build.current_stream(q.device))
    _build.raise_on_error(err, "attn_fwd")
    return out.transpose(1, 2), stats


def _launch_bwd(q, k, v, bias, seed, dropout_rate, out, stats, dout, block=Block()):
    """Launch the backward kernels (the rowsum(dO O) pre-pass, dQ, dK/dV)
    on CUDA tensors, given the forward's ``out`` and ``stats`` and the output
    gradient ``dout``. Returns (dq, dk, dv), (B, H, S, D) views of
    (B, S, H, D) buffers."""
    block = _check(q, k, v, bias, seed, dropout_rate, block, dout)
    B, H, S, D = q.shape
    if tuple(out.shape) != (B, H, S, D) or not out.transpose(1, 2).is_contiguous() \
            or out.dtype != q.dtype:
        raise ValueError("out must be the forward's (B, H, S, D) view of a (B, S, H, D) buffer")
    if tuple(stats.shape) != (2, B, H, S) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise ValueError("stats must be the forward's contiguous (2, B, H, S) float32")
    # the backward's scratch: each row's (m, 1 / l, delta, 0), then the
    # dropout mask's keep bits that the dQ kernel leaves for dK/dV, 512
    # bytes per head and pair of 64-row tiles
    tiles = -(-S // 64)
    delta = torch.empty(B * H * (S * 4 + tiles * tiles * 128), dtype=torch.float32,
                        device=q.device)
    dq, dk, dv = (torch.empty((B, S, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    err = _lib().eeg_attn_bwd(*_common_args(q, k, v, bias, seed, dropout_rate, block),
                              out.data_ptr(), stats.data_ptr(), dout.data_ptr(),
                              *dout.stride()[:3], delta.data_ptr(), dq.data_ptr(),
                              dk.data_ptr(), dv.data_ptr(), _build.current_stream(q.device))
    _build.raise_on_error(err, "attn_bwd")
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


attn_fwd = KernelWrapper("attn_fwd", _launch_fwd)
attn_bwd = KernelWrapper("attn_bwd", _launch_bwd)
KERNELS = (attn_fwd, attn_bwd)


def attn_dropout_mask(seed, B: int, H: int, S: int, dropout_rate: float, block=Block()):
    """The kernels' keep mask for (B, H, S, S) as uint8, drawn by the same
    device function, for a seed vector of G elements (G dividing the global
    rows), the call ``block`` of the global one: a test hook that hands the
    plain version the kernels' exact mask. Nothing on the training path
    calls it."""
    if not seed.is_cuda:
        raise ValueError("the mask kernel takes a CUDA seed")
    block = Block(*block).resolve(B, H)
    _check_seed(seed, seed.device, block[1])
    out = torch.empty((B, H, S, S), dtype=torch.uint8, device=seed.device)
    err = _lib().eeg_attn_dropout_mask(B, H, S, seed.data_ptr(), seed.numel(), *block,
                                       keep_threshold(dropout_rate), out.data_ptr(),
                                       _build.current_stream(seed.device))
    _build.raise_on_error(err, "attn_dropout_mask")
    return out


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------

class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, dropout_rate, keep, block):
        ctx.dropout_rate, ctx.block = dropout_rate, block
        if q.is_cuda:
            if keep is not None:
                raise ValueError("on the card the mask is drawn in the kernel")
            out, stats = attn_fwd(q, k, v, bias, seed, dropout_rate, block)
            ctx.save_for_backward(q, k, v, bias, seed, out, stats)
            return out
        drawn = keep
        if dropout_rate > 0.0 and keep is None:
            drawn = seeded_keep(seed, _mask_shape(q), dropout_rate, block)
        # the seed, not the mask: the backward regenerates it
        ctx.save_for_backward(q, k, v, bias, seed, *(() if keep is None else (keep,)))
        return attention_plain(q, k, v, bias, drawn, dropout_rate)

    @staticmethod
    def backward(ctx, dout):
        rate = ctx.dropout_rate
        if dout.is_cuda:
            q, k, v, bias, seed, out, stats = ctx.saved_tensors
            dq, dk, dv = attn_bwd(q, k, v, bias, seed, rate, out, stats, vector_loadable(dout),
                                  ctx.block)
        else:
            q, k, v, bias, seed, *given = ctx.saved_tensors
            keep = given[0] if given else None
            if rate > 0.0 and keep is None:
                keep = seeded_keep(seed, _mask_shape(q), rate, ctx.block)
            dq, dk, dv = attention_bwd_plain(q, k, v, bias, keep, rate, dout)
        return dq, dk, dv, None, None, None, None, None


def fused_attention(q, k, v, bias, seed, dropout_rate: float = 0.0, keep=None, block=Block()):
    """softmax(q k^T / sqrt(D) + bias) v with prob dropout, one kernel each
    way on the card.

    q, k, v : (B, H, S, D) f32 or bf16, with a unit last stride and, on
    the card, a data pointer and (b, h, s) strides that are multiples of 16
    bytes (the packed QKV views go in without copies); bias : (B, S) or the JAX
    package's (B, 1, S) f32 additive key bias; seed : a vector of G int64
    elements on the same device, G dividing B, read in the kernel (batch
    row b takes seed b // (B / G), as in a call of its own over its group);
    dropout_rate in [0, 1). Returns
    (B, H, S, D), a view of a (B, S, H, D) buffer on the card. ``keep``
    (CPU only) replaces the seed's draw with a given boolean (B, H, S, S)
    mask, so that tests can hand the port the JAX reference's mask. No
    gradient flows to the bias or the seed. ``block`` (:class:`Block`): the
    call is that block of rows and heads of a global call, and draws its
    slice of the global mask (a rank's shard under a mesh).
    """
    return _FusedAttention.apply(q, k, v, _bias2d(bias), seed, float(dropout_rate), keep,
                                 Block(*block))
