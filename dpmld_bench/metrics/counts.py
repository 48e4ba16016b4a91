"""Operations and bytes of the work a configured step defines, counted from
the model's structure (never from the implementation's launches), and the
card's peaks. The text encoder's products and attention calls are its
part's (``reference/encoders/<model_type>.py``); the rest are counted here.

A product is (count, m, k, n, part): ``count`` (m x k) @ (k x n) products,
2 count m k n operations, reading count (m k + k n) and writing count m n
elements. A step is two forwards of the whole model, phase 1's backward
through the head to ``DP`` (each head product's input gradient), and phase
2's backward through every other parameter (each product's weight
gradient, and its input gradient wherever the input depends on a
parameter: all but the act encoder's). A backward product has the operands
and output of its forward product's shape, so it costs the same. An eval
epoch is one forward over its real rows. Padding rows count nothing.

``tests/test_dpmld_bench_counts.py`` holds :func:`step_flops` equal to
``torch.utils.flop_counter.FlopCounterMode``'s count over the plain
reference's step.
"""
from __future__ import annotations

import json
import os

from ..reference import encoders
from ..reference.encoders import ATTN, ENCODER

# parts of the model beside the encoder's dense products (ENCODER) and its
# attention (ATTN): the act encoder, the decoder, the head
VISUAL, DECODER, HEAD = "visual", "decoder", "head"

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def peak_flops(dtype: str) -> float:
    """The card's dense peak for products of ``dtype``: bf16's for
    "bfloat16", TF32's (the highest rate at which the card computes any
    product finer than bf16) for "float32"."""
    return PEAKS["flops"][dtype]


def forward_products(cfg: dict, S: int, rows: int):
    """The products of one forward over ``rows`` rows at sequence length
    ``S``."""
    enc = encoders.of(cfg)
    H = enc.width(cfg)
    fz = cfg["fusion"]
    F, C, Vin, Fd = fz["feature_width"], fz["classes"], fz["visual_in"], fz["cross_ffn"]
    ch = fz["cross_heads"]
    Dc = H // ch
    t = rows * S
    out = enc.products(cfg, S, rows)
    out.append((1, rows, Vin, H, VISUAL))
    for _ in range(fz["cross_layers"]):
        # self-attention over the one act token
        out += [(1, rows, H, H, DECODER)] * 3
        out += [(rows * ch, 1, Dc, 1, DECODER), (rows * ch, 1, 1, Dc, DECODER)]
        out.append((1, rows, H, H, DECODER))
        # cross-attention: the act token's query over the S EEG positions
        out += [(1, rows, H, H, DECODER), (1, t, H, H, DECODER), (1, t, H, H, DECODER)]
        out += [(rows * ch, 1, Dc, S, DECODER), (rows * ch, 1, S, Dc, DECODER)]
        out.append((1, rows, H, H, DECODER))
        out += [(1, rows, H, Fd, DECODER), (1, rows, Fd, H, DECODER)]
    out += [(1, rows, F, F, HEAD), (1, rows, F, H, HEAD), (1, rows, H, C, HEAD)]
    return out


def step_products(cfg: dict, S: int, rows: int):
    """The products of one alternating step over ``rows`` rows."""
    fwd = forward_products(cfg, S, rows)
    phase1 = [p for p in fwd if p[4] == HEAD]  # through the head alone, to DP
    # phase 2: each weight gradient, and each input gradient but the act
    # encoder's (its input is data); the attention's two operands each
    phase2 = [p for p in fwd if p[4] != ATTN] * 2 + [p for p in fwd if p[4] == ATTN] * 2
    phase2.remove(next(p for p in fwd if p[4] == VISUAL))
    return fwd * 2 + phase1 + phase2


def flops(products, parts=None) -> float:
    return float(sum(2 * c * m * k * n for c, m, k, n, part in products
                     if parts is None or part in parts))


def step_flops(cfg: dict, S: int, rows: int) -> float:
    return flops(step_products(cfg, S, rows))


def eval_flops(cfg: dict, S: int, rows: int) -> float:
    return flops(forward_products(cfg, S, rows))


def element_bytes(cfg: dict, part: str) -> int:
    """Bytes of an operand of ``part`` in the program's compute dtype: the
    text encoder runs in it; the act encoder, the decoder (its query is the
    f32 act stream) and the head compute in f32."""
    if part in (ENCODER, ATTN) and cfg["program"]["compute_dtype"] == "bfloat16":
        return 2
    return 4


def product_bound_s(cfg: dict, product) -> float:
    """The least time the card could take for a product: max(operations /
    peak, bytes / bandwidth), at the peak of its operands' dtype."""
    c, m, k, n, part = product
    es = element_bytes(cfg, part)
    dtype = "bfloat16" if es == 2 else "float32"
    return max(2 * c * m * k * n / peak_flops(dtype),
               c * (m * k + k * n + m * n) * es / PEAKS["bytes_per_s"])


def attention_calls(cfg: dict, train: bool):
    """(forward calls, backward calls) of the text encoder's attention
    kernels for one step (two forwards, phase 2's backward) or one eval
    forward."""
    L = encoders.of(cfg).attention(cfg)["calls"]
    return (2 * L, L) if train else (L, 0)


def attention_bound_s(cfg: dict, S: int, rows: int, forward: bool) -> float:
    """max(operations / peak, bytes / bandwidth) of one attention call over
    ``rows`` rows: the forward's two products, reading q, k, v and the key
    bias and writing the output and each row's softmax statistics (max and
    sum); the backward's four (dV, dP, dQ, dK), reading q, k, v, the output,
    its gradient, the statistics and the bias and writing dQ, dK, dV. A
    causal part's products count the S (S + 1) / 2 query-key pairs of a
    causal kernel, an other's all S x S."""
    a = encoders.of(cfg).attention(cfg)
    pairs = S * (S + 1) // 2 if a.get("causal") else S * S
    nh = a["heads"]
    es = element_bytes(cfg, ATTN)
    dtype = "bfloat16" if es == 2 else "float32"
    qk = rows * S * nh * a["qk"] * es  # q, k, dQ or dK
    v = rows * S * nh * a["v"] * es  # v, the output, its gradient or dV
    stats = 2 * rows * nh * S * 4
    bias = rows * S * 4
    ops = 2 * rows * nh * pairs * (a["qk"] + a["v"])
    if forward:
        nbytes = 2 * qk + 2 * v + stats + bias
    else:
        ops, nbytes = 2 * ops, 4 * qk + 4 * v + stats + bias
    return max(ops / peak_flops(dtype), nbytes / PEAKS["bytes_per_s"])
