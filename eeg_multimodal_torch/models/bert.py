"""BERT-base encoder as plain functions on tensors, HF ``BertModel`` semantics.

Port of the JAX package's ``models/bert.py``: word + absolute position +
token-type embeddings with LayerNorm eps 1e-12, post-LN layers with an erf
GELU FFN, the HF additive attention mask ``(1 - m) * finfo(f32).min``, and
the tanh pooler. ``apply`` returns ``(sequence_output, pooled_output)`` as
``BertModel(..., return_dict=False)`` does (ref: models.py:59-61).

The activations take the dtype of the parameters: under the trainer's bf16
compute cast the embeddings, the packed QKV (f32 accumulation, one rounding)
and every layer's output are bf16, each LayerNorm runs in f32, and the
(B, H, S, D) bf16 q/k/v go to the attention kernels with an f32 bias, as
``bert.py:101-173`` of the JAX package has it.

Stacked members (``train/sweep.py``): every leaf of the tree may carry a
leading member axis M ((M, V, E) word table, (M, E, E) kernels), the input
then holding M groups of rows, member after member. Each group reads its
own member's embedding tables and goes through its weights
(``models/layers.py``); a group of M generators gives each member its own
dropout masks and attention seed (the kernels' seed vector, G = M).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops import attention as fused
from .layers import draw_seeds, dropout, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02

    # bert-base-uncased and bert-base-cased differ only in vocab size
    @staticmethod
    def for_coef(coef: str) -> "BertConfig":
        if "cased" in coef and "uncased" not in coef:
            return BertConfig(vocab_size=28996)
        return BertConfig()


def init(gen: torch.Generator, config: BertConfig, device):
    """HF BERT init: normal(0, 0.02) weights, zero biases, unit LayerNorms."""
    H, I = config.hidden_size, config.intermediate_size
    std = config.initializer_range

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device) * std

    def dense(fan_in, fan_out):
        return {"kernel": normal((fan_in, fan_out)),
                "bias": torch.zeros(fan_out, device=device)}

    def ln():
        return {"scale": torch.ones(H, device=device),
                "bias": torch.zeros(H, device=device)}

    params = {
        "embeddings": {
            "word": normal((config.vocab_size, H)),
            "position": normal((config.max_position_embeddings, H)),
            "token_type": normal((config.type_vocab_size, H)),
            "ln": ln(),
        },
        "layers": [],
        "pooler": dense(H, H),
    }
    for _ in range(config.num_layers):
        params["layers"].append({
            "attn": {"query": dense(H, H), "key": dense(H, H),
                     "value": dense(H, H), "output": dense(H, H), "ln": ln()},
            "ffn": {"intermediate": dense(H, I), "output": dense(I, H), "ln": ln()},
        })
    return params


def _attention(q, k, v, attn_bias, attn_drop, gen):
    """softmax(QK^T/sqrt(D) + bias) V over (B, H, S, D).

    The one dispatch point of self-attention, as ``bert.py:156-172`` of the
    JAX package: where ``attention_available(S, D)`` (on the H100 every S
    at BERT's head width, the flagship's truncated S = 80 and the 512-token
    path alike) the fused CUDA kernels run, with a dropout seed drawn per
    layer from ``gen`` as a one-element device tensor (no host sync), or one
    per generator of a group, each for its own slice of the batch;
    elsewhere (a head width the kernels are not built for) the plain
    branch. The JAX package's gate sends S = 80 to its einsum branch, which
    multiplies f32 probabilities by V; the kernels, like the JAX kernel, round
    P to the input dtype first (one bf16 rounding under the compute cast).
    """
    S, D = q.shape[-2:]
    if fused.attention_available(S, D):
        bias = attn_bias[:, 0, 0, :]  # (B, S)
        if gen is not None and attn_drop > 0.0:
            return fused.fused_attention(q, k, v, bias, draw_seeds(gen, q.device), attn_drop)
        seed = torch.zeros(1, dtype=torch.int64, device=q.device)
        return fused.fused_attention(q, k, v, bias, seed, 0.0)
    return attention_unfused(q, k, v, attn_bias, attn_drop, gen)


def attention_unfused(q, k, v, attn_bias, attn_drop, gen):
    """The plain branch: (B, H, S, S) f32 scores and probs in device memory;
    returns f32, which the caller casts to the activations' dtype."""
    q, k, v = q.float(), k.float(), v.float()
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores + attn_bias, dim=-1)  # additive mask, HF-style
    return torch.matmul(dropout(probs, attn_drop, gen), v)


def _self_attention(p, x, attn_bias, num_heads, attn_drop, gen):
    B, S, H = x.shape
    D = H // num_heads
    # packed QKV: one (H, 3H) matmul instead of three (bert.py:124-148 there);
    # the tree keeps the separate torch-shaped q/k/v entries
    packed = {name: torch.cat([p[m][name] for m in ("query", "key", "value")], dim=-1)
              for name in ("kernel", "bias")}
    qkv = linear(packed, x)
    # strided (B, H, S, D) views of qkv: the kernels take them without copies
    q, k, v = (
        qkv[..., i * H:(i + 1) * H].reshape(B, S, num_heads, D).transpose(1, 2)
        for i in range(3)
    )
    ctx = _attention(q, k, v, attn_bias, attn_drop, gen)
    return linear(p["output"], ctx.transpose(1, 2).reshape(B, S, H).to(x.dtype))


def _member_embeddings(emb, input_ids, token_type_ids):
    """The embedding sum for M stacked members: group m of the (M B, S)
    ids reads member m's word, position and token-type tables."""
    M, S = emb["word"].shape[0], input_ids.shape[1]
    member = torch.arange(M, device=input_ids.device)[:, None]
    ids = input_ids.reshape(M, -1)  # (M, B S)
    x = emb["word"][member, ids].reshape(M, -1, S, emb["word"].shape[-1])
    x = x + emb["position"][:, None, :S, :]
    if token_type_ids is None:
        x = x + emb["token_type"][:, 0][:, None, None, :]
    else:
        x = x + emb["token_type"][member, token_type_ids.reshape(M, -1)].reshape(x.shape)
    return x.reshape(input_ids.shape + x.shape[-1:])


def apply(
    params,
    input_ids,  # (B, S) int64
    attention_mask,  # (B, S) {0,1}
    config: BertConfig = BertConfig(),
    gen=None,
    token_type_ids=None,
):
    """Forward pass; returns ``(sequence_output, pooled_output)``. Dropout
    draws from ``gen`` (a generator or a group, ``layers.py``) and is off
    when it is None."""
    S = input_ids.shape[1]
    emb = params["embeddings"]
    if emb["word"].dim() == 3:
        x = _member_embeddings(emb, input_ids, token_type_ids)
    else:
        x = emb["word"][input_ids] + emb["position"][:S][None, :, :]
        if token_type_ids is None:
            x = x + emb["token_type"][0][None, None, :]
        else:
            x = x + emb["token_type"][token_type_ids]
    x = layer_norm(emb["ln"], x, config.layer_norm_eps)
    x = dropout(x, config.hidden_dropout, gen)

    # HF extended attention mask: (1 - m) * dtype_min added to the logits
    neg = torch.finfo(torch.float32).min
    attn_bias = (1.0 - attention_mask[:, None, None, :].to(torch.float32)) * neg

    for layer in params["layers"]:
        attn_out = _self_attention(
            layer["attn"], x, attn_bias, config.num_heads,
            config.attention_dropout, gen,
        )
        attn_out = dropout(attn_out, config.hidden_dropout, gen)
        x = layer_norm(layer["attn"]["ln"], x + attn_out, config.layer_norm_eps)
        h = F.gelu(linear(layer["ffn"]["intermediate"], x))  # erf GELU
        h = dropout(linear(layer["ffn"]["output"], h), config.hidden_dropout, gen)
        x = layer_norm(layer["ffn"]["ln"], x + h, config.layer_norm_eps)

    pooled = torch.tanh(linear(params["pooler"], x[:, 0]))
    return x, pooled

