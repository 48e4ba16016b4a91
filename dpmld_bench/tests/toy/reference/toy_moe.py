"""A toy reference part for the tests: a causal encoder with routed
experts, of which a chip holds a share. It holds what the contract check,
the counts and the ``tiny`` fixture read: the counts a cut may change with
their floors, its products and attention calls, and its CPU cut."""
from __future__ import annotations

from dpmld_bench.reference.encoders import ATTN, ENCODER

KEY = "toy_moe"


def cuts(published: dict) -> dict:
    """The layers (the leading dense ones and four expert layers, whose
    period is one), 8 routed experts, an eighth of the vocabulary."""
    return {"num_hidden_layers": published["first_k_dense_replace"] + 4,
            "n_routed_experts": 8, "vocab_size": -(-published["vocab_size"] // 8)}


def width(cfg: dict) -> int:
    return cfg["hidden_size"]


def products(cfg: dict, S: int, rows: int):
    """The attention's two products, and each held expert's two at the
    expected load: tokens x experts a token takes / routed experts."""
    H, E, nh = cfg["hidden_size"], cfg["expert_width"], cfg["num_attention_heads"]
    D = H // nh
    load = rows * S * cfg["num_experts_per_tok"] // cfg["published"]["n_routed_experts"]
    out = []
    for _ in range(cfg["num_hidden_layers"]):
        out += [(rows * nh, S, D, S, ATTN), (rows * nh, S, S, D, ATTN)]
        out += [(cfg["n_routed_experts"], load, H, E, ENCODER),
                (cfg["n_routed_experts"], load, E, H, ENCODER)]
    return out


def attention(cfg: dict):
    return {"calls": cfg["num_hidden_layers"], "heads": cfg["num_attention_heads"],
            "qk": cfg["qk_width"], "v": cfg["v_width"], "causal": True}


def tiny(cfg: dict):
    """The leading dense layer and one expert layer."""
    cfg["num_hidden_layers"] = 2
