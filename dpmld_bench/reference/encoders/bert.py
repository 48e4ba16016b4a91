"""BERT as the text encoder, in plain PyTorch: HF ``BertModel`` semantics
(post-LN, erf GELU, the additive mask ``(1 - m) * finfo(f32).min``, a tanh
pooler on [CLS]) at the configuration's widths, and its weights: HF BERT's
normal(0, initializer_range) kernels and tables, zero biases, unit
LayerNorms. The part's interface is ``reference/encoders/__init__.py``'s.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..model import layer_norm, linear
from . import ATTN, ENCODER

KEY = "bert"
# [CLS] and [SEP] of bert-base-uncased's vocabulary; the word pool is drawn
# from its ordinary word pieces
TOKENS = {"first": 101, "last": 102, "words": (1000, 30000)}
F32_MIN = torch.finfo(torch.float32).min


def width(cfg: dict) -> int:
    return cfg["hidden_size"]


def plan(cfg: dict):
    H, I, std = cfg["hidden_size"], cfg["intermediate_size"], cfg["initializer_range"]
    normals = [(cfg["vocab_size"], H), (cfg["max_position_embeddings"], H),
               (cfg["type_vocab_size"], H)]
    for _ in range(cfg["num_hidden_layers"]):
        normals += [(H, H)] * 4 + [(H, I), (I, H)]
    normals.append((H, H))  # the pooler
    return [(s, std) for s in normals], []


def build(cfg: dict, take):
    H = cfg["hidden_size"]

    def ln():
        return {"scale": take.ones(H), "bias": take.zeros(H)}

    def dense(n_out):
        return {"kernel": take.normal(), "bias": take.zeros(n_out)}

    bert = {"embeddings": {"word": take.normal(), "position": take.normal(),
                           "token_type": take.normal(), "ln": ln()},
            "layers": []}
    for _ in range(cfg["num_hidden_layers"]):
        attn = {"query": dense(H), "key": dense(H), "value": dense(H), "output": dense(H),
                "ln": ln()}
        ffn = {"intermediate": dense(cfg["intermediate_size"]), "output": dense(H), "ln": ln()}
        bert["layers"].append({"attn": attn, "ffn": ffn})
    bert["pooler"] = dense(H)
    return bert


def forward(p, ids, mask, cfg, draws, prec):
    """(sequence output, pooled output) of HF ``BertModel``."""
    B, S = ids.shape
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    D = H // nh
    eps = cfg["layer_norm_eps"]
    emb = p["embeddings"]
    x = emb["word"][ids] + emb["position"][:S][None] + emb["token_type"][0]
    x = draws.dropout(layer_norm(emb["ln"], x, eps))
    bias = (1.0 - mask[:, None, None, :].float()) * F32_MIN

    def heads(t):
        return t.reshape(B, S, nh, D).transpose(1, 2)

    for layer in p["layers"]:
        a = layer["attn"]
        q, k, v = (heads(linear(a[n], x, prec)) for n in ("query", "key", "value"))
        probs = torch.softmax(prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(D) + bias, -1)
        keep = draws.attention_keep(B, nh, S)
        if keep is not None:
            rate = draws.attn_p
            probs = torch.where(keep, probs / (1.0 - rate), torch.zeros((), device=x.device))
        ctx = prec.matmul(probs, v).transpose(1, 2).reshape(B, S, H)
        x = layer_norm(a["ln"], x + draws.dropout(linear(a["output"], ctx, prec)), eps)
        f = layer["ffn"]
        h = F.gelu(linear(f["intermediate"], x, prec))
        x = layer_norm(f["ln"], x + draws.dropout(linear(f["output"], h, prec)), eps)
    return x, torch.tanh(linear(p["pooler"], x[:, 0], prec))


def products(cfg: dict, S: int, rows: int):
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    nh = cfg["num_attention_heads"]
    D = H // nh
    t = rows * S
    out = []
    for _ in range(cfg["num_hidden_layers"]):
        out += [(1, t, H, H, ENCODER)] * 4 + [(1, t, H, I, ENCODER), (1, t, I, H, ENCODER)]
        out += [(rows * nh, S, D, S, ATTN), (rows * nh, S, S, D, ATTN)]
    out.append((1, rows, H, H, ENCODER))  # the pooler, on [CLS]
    return out


def attention(cfg: dict):
    nh = cfg["num_attention_heads"]
    D = cfg["hidden_size"] // nh
    return {"calls": cfg["num_hidden_layers"], "heads": nh, "qk": D, "v": D}
