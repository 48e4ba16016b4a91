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

Under a (data, model) mesh (``parallel/``) ``apply`` takes a ``layout`` and
runs on the rank's rows and Megatron shards: the packed QKV concatenates the
rank's query, key and value columns, 12 / model whole heads, which go to the
attention kernels as their block of the global call (rows b0 .., heads h0 ..
of 12), so each rank draws its slice of the global mask; the attention and
FFN outputs are row-parallel, their biases added once after the sum.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops import attention as fused
from ..utils.device import resolve_device
from .layers import column_parallel, draw_seeds, dropout, layer_norm, linear, row_parallel


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


def _attention(q, k, v, attn_bias, attn_drop, gen, layout=None, num_heads=None):
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
    Under a ``layout`` the call is the block (rows b0 .., heads
    model_rank H .. of ``num_heads``) of the global call.
    """
    B, H, S, D = q.shape
    block = fused.Block()
    if layout is not None:
        block = fused.Block(layout.b0, layout.rows, layout.mesh.model_rank * H, num_heads)
    if fused.attention_available(S, D):
        bias = attn_bias[:, 0, 0, :]  # (B, S)
        if gen is not None and attn_drop > 0.0:
            return fused.fused_attention(q, k, v, bias, draw_seeds(gen, q.device), attn_drop,
                                         block=block)
        seed = torch.zeros(1, dtype=torch.int64, device=q.device)
        return fused.fused_attention(q, k, v, bias, seed, 0.0, block=block)
    return attention_unfused(q, k, v, attn_bias, attn_drop, gen, layout)


def attention_unfused(q, k, v, attn_bias, attn_drop, gen, layout=None):
    """The plain branch: (B, H, S, S) f32 scores and probs in device memory;
    returns f32, which the caller casts to the activations' dtype."""
    q, k, v = q.float(), k.float(), v.float()
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores + attn_bias, dim=-1)  # additive mask, HF-style
    return torch.matmul(dropout(probs, attn_drop, gen, layout, 1), v)


def _self_attention(p, x, attn_bias, num_heads, attn_drop, gen, layout=None):
    B, S, H = x.shape
    D = H // num_heads
    W = p["query"]["kernel"].shape[-1]  # this rank's query columns: W / D whole heads
    # packed QKV: one (H, 3W) matmul instead of three (bert.py:124-148 there);
    # the tree keeps the separate torch-shaped q/k/v entries
    packed = {name: torch.cat([p[m][name] for m in ("query", "key", "value")], dim=-1)
              for name in ("kernel", "bias")}
    qkv = column_parallel(packed, x, layout)
    # strided (B, H, S, D) views of qkv: the kernels take them without copies
    q, k, v = (
        qkv[..., i * W:(i + 1) * W].reshape(B, S, W // D, D).transpose(1, 2)
        for i in range(3)
    )
    ctx = _attention(q, k, v, attn_bias, attn_drop, gen, layout, num_heads)
    return row_parallel(p["output"], ctx.transpose(1, 2).reshape(B, S, W).to(x.dtype), layout)


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
    layout=None,
):
    """Forward pass; returns ``(sequence_output, pooled_output)``. Dropout
    draws from ``gen`` (a generator or a group, ``layers.py``) and is off
    when it is None. ``layout``: the rank's place on a mesh (module
    docstring)."""
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
    x = dropout(x, config.hidden_dropout, gen, layout)

    # HF extended attention mask: (1 - m) * dtype_min added to the logits
    neg = torch.finfo(torch.float32).min
    attn_bias = (1.0 - attention_mask[:, None, None, :].to(torch.float32)) * neg

    for layer in params["layers"]:
        attn_out = _self_attention(
            layer["attn"], x, attn_bias, config.num_heads,
            config.attention_dropout, gen, layout,
        )
        attn_out = dropout(attn_out, config.hidden_dropout, gen, layout)
        x = layer_norm(layer["attn"]["ln"], x + attn_out, config.layer_norm_eps)
        h = F.gelu(column_parallel(layer["ffn"]["intermediate"], x, layout))  # erf GELU
        h = dropout(row_parallel(layer["ffn"]["output"], h, layout), config.hidden_dropout,
                    gen, layout)
        x = layer_norm(layer["ffn"]["ln"], x + h, config.layer_norm_eps)

    pooled = torch.tanh(linear(params["pooler"], x[:, 0]))
    return x, pooled



def from_torch_state_dict(state_dict, config: BertConfig = BertConfig(), prefix: str = "",
                          device=None):
    """An HF ``BertModel`` state dict -> the port's f32 BERT tree on
    ``device`` (the card unless "cpu"), as the JAX package's
    ``models/bert.py::from_torch_state_dict`` reads it (``:228-277`` there).

    Values may be tensors or numpy arrays. ``prefix`` handles nesting, e.g.
    ``"bert."`` for the reference's fusion checkpoints. The keys are read as
    given (no wrapper is stripped and no name is mapped): a key the layout
    needs and the state dict lacks raises ``KeyError`` naming it. The reader
    is ``train/checkpoint.py``'s, the one ``fusion_from_torch_state_dict``
    uses."""
    from ..train.checkpoint import _Reader  # checkpoint imports the models

    return _Reader(state_dict, resolve_device(device)).bert(config, prefix)
