"""Torch-semantics transformer primitives as plain functions on tensors.

Port of the JAX package's ``models/layers.py``. Parameters are nested dicts
of tensors with the JAX package's names and layouts: a linear ``kernel`` is
stored (in, out) and applied as ``x @ kernel + bias``, so the JAX tree loads
as it is (``models/convert.py``). All layouts are batch-first (B, S, E).
Randomness (dropout) comes from an explicit ``torch.Generator``; ``None``
turns it off. A tuple of G generators (a group) draws for G stacked batches
along the first axis, each from its own generator, so a forward over the
stack draws what G forwards over one batch each would (the paired phase
encode's two phases in one 2B forward).

Stacked weights. A weight with a leading axis of M (a (M, in, out) linear
kernel, a (M, E) LayerNorm scale) holds M weight sets, and the input's rows
fall into M equal groups, group m (rows m N / M .. (m + 1) N / M - 1) going
through weight set m: the batched sweep's members, each its own model over
its copy of the batch (M groups of B rows), and the DP-SGD step's
per-example leaves (M = B groups of one row). No weight is copied per row.

The reference builds its cross-attention block from ``nn.TransformerDecoder``
(python/src/custom_models/models.py:44-45), and TISC's single-stream block
from ``nn.TransformerEncoder`` (:235-236): post-LN, ReLU FFN of width 2048,
dropout 0.1 (at four sites of an encoder layer, six of a decoder layer),
key-padding masks that send masked scores to -inf.

Under a bf16 compute cast the functions keep the JAX package's dtype trail
(layers.py:80-143 there): a linear accumulates in f32, adds its bias in f32
and rounds once to its input's dtype; LayerNorm runs in f32; dropout keeps
the dtype; attention computes q/k/v, scores, softmax and P.V in f32 and
casts to the query's dtype. Where an f32 activation meets bf16 weights,
JAX promotes the product to f32; ``F.linear`` refuses mixed dtypes, so the
functions cast up explicitly.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.seeding import grouped
from ..utils.trees import tree_map

FFN_DIM = 2048  # torch TransformerDecoderLayer default dim_feedforward
P_DROP = 0.1  # torch default dropout


# ---------------------------------------------------------------------------
# Initializers (torch defaults in distribution)
# ---------------------------------------------------------------------------

def _uniform(shape, bound, gen, device):
    return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * bound


def linear_init(gen, in_features: int, out_features: int, device):
    """torch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(in_features)
    return {
        "kernel": _uniform((in_features, out_features), bound, gen, device),
        "bias": _uniform((out_features,), bound, gen, device),
    }


def layer_norm_init(dim: int, device):
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def xavier_uniform(gen, shape, device):
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    return _uniform(shape, bound, gen, device)


def mha_init(gen, embed_dim: int, device):
    """torch nn.MultiheadAttention init: xavier in_proj/out_proj, zero biases."""
    return {
        "in_proj_kernel": xavier_uniform(gen, (embed_dim, 3 * embed_dim), device),
        "in_proj_bias": torch.zeros(3 * embed_dim, device=device),
        "out_proj": {
            "kernel": xavier_uniform(gen, (embed_dim, embed_dim), device),
            "bias": torch.zeros(embed_dim, device=device),
        },
    }


# ---------------------------------------------------------------------------
# Forward primitives
# ---------------------------------------------------------------------------

def linear(params, x):
    """``x @ kernel + bias`` in the promoted dtype of x and the kernel,
    rounded once to x's dtype. A bf16 GEMM accumulates in f32 and adds the
    bias before that rounding (cuBLAS's bias epilogue, or beta = 1 on the
    bias), as ``preferred_element_type=float32`` does there.

    A stacked weight, a (M, in, out) kernel and a (M, out) bias, takes the
    m-th of M equal groups of x's rows, (N, in) or (N, S, in), through kernel
    m: x viewed as (M, N / M * S, in), one batched GEMM. M = B is the DP-SGD
    step's per-example leaves (``dp/dpsgd.py``), M members the sweep's
    (``train/sweep.py``)."""
    dt = torch.promote_types(x.dtype, params["kernel"].dtype)
    kernel, bias = params["kernel"].to(dt), params["bias"].to(dt)
    if kernel.dim() == 3:
        M = kernel.shape[0]
        y = torch.baddbmm(bias.unsqueeze(1), x.to(dt).reshape(M, -1, x.shape[-1]), kernel)
        return y.reshape(*x.shape[:-1], kernel.shape[-1]).to(x.dtype)
    return F.linear(x.to(dt), kernel.t(), bias).to(x.dtype)


def layer_norm(params, x, eps: float = 1e-5):
    """torch LayerNorm (biased variance over the last dim), computed in f32
    and cast back to x's dtype. A stacked (M, E) scale and bias scale and
    shift the m-th of M equal groups of x's rows, (N, ..., E), by their row
    m."""
    f32 = torch.float32
    scale, bias = params["scale"].to(f32), params["bias"].to(f32)
    if scale.dim() == 1:
        y = F.layer_norm(x.to(f32), x.shape[-1:], scale, bias, eps)
    else:
        M = scale.shape[0]
        groups = (M, -1) + x.shape[1:]
        rows = (M,) + (1,) * (x.dim() - 1) + (x.shape[-1],)
        y = F.layer_norm(x.to(f32), x.shape[-1:], None, None, eps).reshape(groups)
        y = (y * scale.view(rows) + bias.view(rows)).reshape(x.shape)
    return y.to(x.dtype)


def grouped_rand(shape, gen, device):
    """``torch.rand(shape)`` from ``gen``; from a group of G generators, G
    draws of shape[0] / G rows each, one per generator, stacked along the
    first axis (``utils/seeding.grouped``)."""
    return grouped(lambda s, g: torch.rand(s, generator=g, device=device), shape, gen)


def draw_seeds(gen, device):
    """One int31 seed per generator of ``gen``, as an int64 vector on
    ``device`` (drawn there: no host sync)."""
    n = 1 if gen is None or isinstance(gen, torch.Generator) else len(gen)
    return grouped(lambda s, g: torch.randint(0, 2**31 - 1, s, generator=g, device=device),
                   (n,), gen)


def dropout(x, rate: float, gen):
    """Inverted dropout (torch semantics), the mask drawn along x's first
    (batch) axis by :func:`grouped_rand`. Identity when ``gen`` is None."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = grouped_rand(x.shape, gen, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def multi_head_attention(
    params,
    query,  # (B, Sq, E)
    key_value,  # (B, Sk, E)
    num_heads: int,
    key_padding_mask=None,  # (B, Sk) bool: True = ignore this key position
    dropout_rate: float = 0.0,
    gen=None,
):
    """torch nn.MultiheadAttention forward (batch-first, need_weights=False);
    masked keys get -inf scores (layers.py:136-138 of the JAX package).
    Everything up to the output projection runs in f32, whatever the dtypes
    of the inputs and weights; the output projection's input is cast to
    the query's dtype. Stacked (M, E, 3E) / (M, 3E) in-projections take M
    groups of rows, as :func:`linear` does."""
    B, Sq, E = query.shape
    Sk = key_value.shape[1]
    H = num_heads
    D = E // H
    f32 = torch.float32
    w, b = params["in_proj_kernel"].to(f32), params["in_proj_bias"].to(f32)

    def proj(x, i):  # the i-th of the q, k, v projections
        return linear({"kernel": w[..., i * E:(i + 1) * E], "bias": b[..., i * E:(i + 1) * E]},
                      x.to(f32))

    q, k, v = proj(query, 0), proj(key_value, 1), proj(key_value, 2)
    q = q.reshape(B, Sq, H, D).transpose(1, 2)  # (B, H, Sq, D)
    k = k.reshape(B, Sk, H, D).transpose(1, 2)
    v = v.reshape(B, Sk, H, D).transpose(1, 2)

    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    attn = dropout(torch.softmax(scores, dim=-1), dropout_rate, gen)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Sq, E).to(query.dtype)
    return linear(params["out_proj"], out)


# ---------------------------------------------------------------------------
# TransformerDecoderLayer / TransformerEncoderLayer (torch post-LN defaults)
# ---------------------------------------------------------------------------

def decoder_layer_init(gen, d_model: int, device):
    return {
        "self_attn": mha_init(gen, d_model, device),
        "cross_attn": mha_init(gen, d_model, device),
        "linear1": linear_init(gen, d_model, FFN_DIM, device),
        "linear2": linear_init(gen, FFN_DIM, d_model, device),
        "norm1": layer_norm_init(d_model, device),
        "norm2": layer_norm_init(d_model, device),
        "norm3": layer_norm_init(d_model, device),
    }


def decoder_layer(
    params, tgt, memory, num_heads: int,
    tgt_key_padding_mask=None, memory_key_padding_mask=None,
    gen=None, dropout_rate: float = P_DROP,
):
    """torch nn.TransformerDecoderLayer (norm_first=False, relu)."""
    x = tgt
    sa = multi_head_attention(
        params["self_attn"], x, x, num_heads,
        key_padding_mask=tgt_key_padding_mask, dropout_rate=dropout_rate, gen=gen,
    )
    x = layer_norm(params["norm1"], x + dropout(sa, dropout_rate, gen))
    ca = multi_head_attention(
        params["cross_attn"], x, memory, num_heads,
        key_padding_mask=memory_key_padding_mask, dropout_rate=dropout_rate, gen=gen,
    )
    x = layer_norm(params["norm2"], x + dropout(ca, dropout_rate, gen))
    h = dropout(torch.relu(linear(params["linear1"], x)), dropout_rate, gen)
    h = linear(params["linear2"], h)
    return layer_norm(params["norm3"], x + dropout(h, dropout_rate, gen))


def _copies(layer, num_layers: int):
    """torch nn.TransformerDecoder / nn.TransformerEncoder(layer, num_layers)
    deep-copy one layer, so every layer starts identical (ref:
    models.py:45, :236)."""
    return {"layers": [tree_map(torch.clone, layer) for _ in range(num_layers)]}


def decoder_init(gen, d_model: int, num_layers: int, device):
    return _copies(decoder_layer_init(gen, d_model, device), num_layers)


def decoder(
    params, tgt, memory, num_heads: int,
    tgt_key_padding_mask=None, memory_key_padding_mask=None,
    gen=None, dropout_rate: float = P_DROP,
):
    x = tgt
    for layer_params in params["layers"]:
        x = decoder_layer(
            layer_params, x, memory, num_heads,
            tgt_key_padding_mask=tgt_key_padding_mask,
            memory_key_padding_mask=memory_key_padding_mask,
            gen=gen, dropout_rate=dropout_rate,
        )
    return x


def encoder_layer_init(gen, d_model: int, device):
    return {
        "self_attn": mha_init(gen, d_model, device),
        "linear1": linear_init(gen, d_model, FFN_DIM, device),
        "linear2": linear_init(gen, FFN_DIM, d_model, device),
        "norm1": layer_norm_init(d_model, device),
        "norm2": layer_norm_init(d_model, device),
    }


def encoder_layer(params, src, num_heads: int, src_key_padding_mask=None, gen=None,
                  dropout_rate: float = P_DROP):
    """torch nn.TransformerEncoderLayer (norm_first=False, relu), the TISC
    single-stream block (ref: models.py:235-236)."""
    x = src
    sa = multi_head_attention(
        params["self_attn"], x, x, num_heads,
        key_padding_mask=src_key_padding_mask, dropout_rate=dropout_rate, gen=gen,
    )
    x = layer_norm(params["norm1"], x + dropout(sa, dropout_rate, gen))
    h = dropout(torch.relu(linear(params["linear1"], x)), dropout_rate, gen)
    h = linear(params["linear2"], h)
    return layer_norm(params["norm2"], x + dropout(h, dropout_rate, gen))


def encoder_init(gen, d_model: int, num_layers: int, device):
    return _copies(encoder_layer_init(gen, d_model, device), num_layers)


def encoder(params, src, num_heads: int, src_key_padding_mask=None, gen=None,
            dropout_rate: float = P_DROP):
    x = src
    for layer_params in params["layers"]:
        x = encoder_layer(layer_params, x, num_heads,
                          src_key_padding_mask=src_key_padding_mask, gen=gen,
                          dropout_rate=dropout_rate)
    return x
