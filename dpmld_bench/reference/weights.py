"""The weights of a run, made from the seed by the benchmark.

Both sides get them from here: the program through the harness, the
reference by calling this again after the window. The distributions are the
reference model's (HF BERT's normal(0, initializer_range) weights with zero
biases and unit LayerNorms; torch ``nn.Linear``'s U(+-1/sqrt(fan_in)) for
the act encoder, the decoder's feed-forward layers and the head; xavier
U(+-sqrt(6 / (fan_in + fan_out))) with zero biases for each
``nn.MultiheadAttention``; the decoder's layers deep copies of one, as
``nn.TransformerDecoder`` makes them; ``DP`` zeros). The tree has the
program's names and (in, out) kernel layout.

All normal draws are one ``torch.randn`` and all uniform draws one
``torch.rand``, on the run's device, from a generator seeded from the seed.
"""
from __future__ import annotations

import math

import torch

from .draws import derive_seed, generator


def _plan(cfg: dict):
    """(normal shapes, uniform (shape, bound) pairs) in draw order."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    fz = cfg["fusion"]
    F, C, V = fz["feature_width"], fz["classes"], fz["visual_in"]
    normals = [(cfg["vocab_size"], H), (cfg["max_position_embeddings"], H),
               (cfg["type_vocab_size"], H)]
    for _ in range(cfg["num_hidden_layers"]):
        normals += [(H, H)] * 4 + [(H, I), (I, H)]
    normals.append((H, H))  # the pooler

    def lin(i, o):
        return [((i, o), 1 / math.sqrt(i)), ((o,), 1 / math.sqrt(i))]

    xav = math.sqrt(6.0 / (H + 3 * H)), math.sqrt(6.0 / (2 * H))
    uniforms = lin(V, H)
    uniforms += [((H, 3 * H), xav[0]), ((H, H), xav[1])] * 2  # self, cross in_proj / out_proj
    uniforms += lin(H, fz["cross_ffn"]) + lin(fz["cross_ffn"], H)
    uniforms += lin(F, F) + lin(F, H) + lin(H, C)
    return normals, uniforms


def make_weights(cfg: dict, seed: int, device):
    """The f32 tree of ``cfg`` for ``seed`` on ``device``."""
    device = torch.device(device)
    normals, uniforms = _plan(cfg)
    gen = generator(derive_seed(seed, "weights"), device)
    n_normal = sum(math.prod(s) for s in normals)
    n_uniform = sum(math.prod(s) for s, _ in uniforms)
    flat_n = torch.randn(n_normal, generator=gen, device=device) * cfg["initializer_range"]
    flat_u = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    parts_n = iter(t.reshape(s).clone() for t, s in
                   zip(flat_n.split([math.prod(s) for s in normals]), normals))
    parts_u = iter(t.reshape(s) * b for t, (s, b) in
                   zip(flat_u.split([math.prod(s) for s, _ in uniforms]), uniforms))
    del flat_n, flat_u
    H = cfg["hidden_size"]

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ln(n=H):
        return {"scale": torch.ones(n, device=device), "bias": zeros(n)}

    def dense(n_out):
        return {"kernel": next(parts_n), "bias": zeros(n_out)}

    bert = {"embeddings": {"word": next(parts_n), "position": next(parts_n),
                           "token_type": next(parts_n), "ln": ln()},
            "layers": []}
    for _ in range(cfg["num_hidden_layers"]):
        attn = {"query": dense(H), "key": dense(H), "value": dense(H), "output": dense(H),
                "ln": ln()}
        ffn = {"intermediate": dense(cfg["intermediate_size"]), "output": dense(H), "ln": ln()}
        bert["layers"].append({"attn": attn, "ffn": ffn})
    bert["pooler"] = dense(H)

    def linear():
        return {"kernel": next(parts_u), "bias": next(parts_u)}

    visual = linear()
    mha = [{"in_proj_kernel": next(parts_u), "in_proj_bias": zeros(3 * H),
            "out_proj": {"kernel": next(parts_u), "bias": zeros(H)}} for _ in range(2)]
    layer = {"self_attn": mha[0], "cross_attn": mha[1], "linear1": linear(),
             "linear2": linear(), "norm1": ln(), "norm2": ln(), "norm3": ln()}

    def copy(t):
        return {k: copy(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()

    fz = cfg["fusion"]
    return {"bert": bert, "visual_encoder": visual,
            "cross": {"layers": [copy(layer) for _ in range(fz["cross_layers"])]},
            "fc1": linear(), "fc2": linear(), "classifier": linear(),
            "DP": zeros(1, fz["feature_width"])}


def leaves(tree, prefix=""):
    """(path, tensor) pairs of a tree in its order, paths '/'-joined."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaves(v, f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in leaves(v, f"{prefix}/{i}" if prefix else str(i))]
    return [(prefix, tree)]
