"""The weights of a run, made from the seed by the benchmark.

Both sides get them from here: the program through the harness, the
reference by calling this again after the window. The text encoder's
subtree and its distributions are its part's (``encoders/<model_type>.py``:
BERT's are HF BERT's normal(0, initializer_range) weights with zero biases
and unit LayerNorms). The rest are the reference model's: torch
``nn.Linear``'s U(+-1/sqrt(fan_in)) for the act encoder, the decoder's
feed-forward layers and the head; xavier U(+-sqrt(6 / (fan_in + fan_out)))
with zero biases for each ``nn.MultiheadAttention``; the decoder's layers
deep copies of one, as ``nn.TransformerDecoder`` makes them; ``DP`` zeros.
The tree has the program's names and (in, out) kernel layout.

All normal draws are one ``torch.randn`` and all uniform draws one
``torch.rand``, on the run's device, from a generator seeded from the seed:
the encoder's shapes first, then the fusion's.
"""
from __future__ import annotations

import math

import torch

from . import encoders
from .draws import derive_seed, generator


def _fusion_plan(cfg: dict):
    """The uniform (shape, bound) pairs of everything after the encoder, in
    draw order, at the encoder's width."""
    H = encoders.of(cfg).width(cfg)
    fz = cfg["fusion"]
    F, C, V = fz["feature_width"], fz["classes"], fz["visual_in"]

    def lin(i, o):
        return [((i, o), 1 / math.sqrt(i)), ((o,), 1 / math.sqrt(i))]

    xav = math.sqrt(6.0 / (H + 3 * H)), math.sqrt(6.0 / (2 * H))
    uniforms = lin(V, H)
    uniforms += [((H, 3 * H), xav[0]), ((H, H), xav[1])] * 2  # self, cross in_proj / out_proj
    uniforms += lin(H, fz["cross_ffn"]) + lin(fz["cross_ffn"], H)
    uniforms += lin(F, F) + lin(F, H) + lin(H, C)
    return uniforms


class Take:
    """The plan's tensors in its order, and constant leaves, on one device."""

    def __init__(self, normals, uniforms, device):
        self._normals, self._uniforms, self.device = normals, uniforms, device

    def normal(self):
        return next(self._normals)

    def uniform(self):
        return next(self._uniforms)

    def zeros(self, *shape):
        return torch.zeros(shape, device=self.device)

    def ones(self, *shape):
        return torch.ones(shape, device=self.device)


def make_weights(cfg: dict, seed: int, device):
    """The f32 tree of ``cfg`` for ``seed`` on ``device``."""
    device = torch.device(device)
    enc = encoders.of(cfg)
    normals, enc_uniforms = enc.plan(cfg)
    uniforms = enc_uniforms + _fusion_plan(cfg)
    gen = generator(derive_seed(seed, "weights"), device)
    n_normal = sum(math.prod(s) for s, _ in normals)
    n_uniform = sum(math.prod(s) for s, _ in uniforms)
    flat_n = torch.randn(n_normal, generator=gen, device=device)
    flat_u = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    parts_n = iter(t.reshape(s) * std for t, (s, std) in
                   zip(flat_n.split([math.prod(s) for s, _ in normals]), normals))
    parts_u = iter(t.reshape(s) * b for t, (s, b) in
                   zip(flat_u.split([math.prod(s) for s, _ in uniforms]), uniforms))
    del flat_n, flat_u
    take = Take(parts_n, parts_u, device)
    encoder = enc.build(cfg, take)
    H = enc.width(cfg)

    def ln(n=H):
        return {"scale": take.ones(n), "bias": take.zeros(n)}

    def linear():
        return {"kernel": take.uniform(), "bias": take.uniform()}

    visual = linear()
    mha = [{"in_proj_kernel": take.uniform(), "in_proj_bias": take.zeros(3 * H),
            "out_proj": {"kernel": take.uniform(), "bias": take.zeros(H)}} for _ in range(2)]
    layer = {"self_attn": mha[0], "cross_attn": mha[1], "linear1": linear(),
             "linear2": linear(), "norm1": ln(), "norm2": ln(), "norm3": ln()}

    def copy(t):
        return {k: copy(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()

    fz = cfg["fusion"]
    return {enc.KEY: encoder, "visual_encoder": visual,
            "cross": {"layers": [copy(layer) for _ in range(fz["cross_layers"])]},
            "fc1": linear(), "fc2": linear(), "classifier": linear(),
            "DP": take.zeros(1, fz["feature_width"])}


def leaves(tree, prefix=""):
    """(path, tensor) pairs of a tree in its order, paths '/'-joined."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaves(v, f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in leaves(v, f"{prefix}/{i}" if prefix else str(i))]
    return [(prefix, tree)]
