"""CLIP's visual transformer (ViT-B/32, ViT-B/16) as plain functions on tensors.

Port of the JAX package's ``models/vit.py``. The reference encodes the
sensor images with ``clip.load(coef).encode_image`` (get_embedding.py:62-71),
the visual tower alone fed raw TransferToImage tensors: a stride-P conv
patch embedding (here a reshape and one matmul, as the JAX package computes
it), a class token and learned positions, pre-LN blocks with QuickGELU MLPs,
``ln_post`` on the class token and the 512-d projection. The tree has the
JAX package's names and layouts (a linear ``kernel`` is (in, out); ``conv``
is (W, 3, P, P)), so ``params_from_jax`` copies it leaf by leaf;
``from_clip_state_dict`` reads an OpenAI CLIP state dict.

Self-attention goes through the attention kernel (``ops/attention.py``,
``attn_fwd_f32_kernel`` on the card at f32) with a zero key bias, a zero seed and rate
0, where ``attention_available`` says so (the ViT-B head width, 64); the JAX
package runs einsum attention here. q, k and v are strided views of the
packed (B, S, 3W) projection, as BERT's are: no copy. ``GetEmbedding`` runs
the tower under ``torch.inference_mode()``; ``train/contrastive.py`` trains
it, and then the kernel's backward runs too.

The activations take the dtype of the parameters and images, as in the JAX
package (vit.py:94-142 there): under a bf16 cast every product and sum is
bf16, each LayerNorm runs in f32 and casts back to the activations' dtype,
and the MLP's and output projection's linears accumulate in f32 and round
once. JAX's einsum attention computes bf16 scores there; the kernel takes
bf16 q, k, v and computes f32 scores (and the CPU's plain version too), so
bf16 is held against JAX's own bf16 distance from f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops import attention as fused
from ..utils.device import resolve_device
from ..utils.trees import tree_map
from .layers import layer_norm, linear


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 32  # 16 for ViT-B/16
    width: int = 768
    layers: int = 12
    heads: int = 12
    image_size: int = 224
    output_dim: int = 512

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1

    @staticmethod
    def for_coef(coef: str) -> "ViTConfig":
        return ViTConfig(patch_size=16 if "16" in coef else 32)


def init(gen: torch.Generator, cfg: ViTConfig = ViTConfig(), device=None):
    """Random init at the JAX package's scales: normal(0, W^-1/2) for the
    conv, class token, positions, projections and MLP kernels; zero biases;
    unit LayerNorms. Drawn from ``gen`` on its device, then moved to
    ``device`` (the card unless "cpu"): a CPU generator gives the same tree
    on either."""
    dev = resolve_device(device)
    W = cfg.width
    scale = W ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device) * scale

    def zeros(n):
        return torch.zeros(n, device=gen.device)

    def ln():
        return {"scale": torch.ones(W, device=gen.device), "bias": zeros(W)}

    params = {
        "conv": normal(W, 3, cfg.patch_size, cfg.patch_size),
        "class_embedding": normal(W),
        "positional_embedding": normal(cfg.seq_len, W),
        "ln_pre": ln(),
        "ln_post": ln(),
        "proj": normal(W, cfg.output_dim),
        "blocks": [],
    }
    for _ in range(cfg.layers):
        params["blocks"].append({
            "ln_1": ln(),
            "attn": {"in_proj_kernel": normal(W, 3 * W), "in_proj_bias": zeros(3 * W),
                     "out_proj": {"kernel": normal(W, W), "bias": zeros(W)}},
            "ln_2": ln(),
            "mlp": {"c_fc": {"kernel": normal(W, 4 * W), "bias": zeros(4 * W)},
                    "c_proj": {"kernel": normal(4 * W, W), "bias": zeros(W)}},
        })
    return tree_map(lambda t: t.to(dev), params)


def quick_gelu(x):
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v over (B, H, S, D) views: the kernel where
    ``attention_available(S, D)`` (a zero (B, S) key bias, a zero seed, rate
    0), else the plain branch in f32."""
    B, _, S, D = q.shape
    if fused.attention_available(S, D):
        bias = torch.zeros(B, S, dtype=torch.float32, device=q.device)
        seed = torch.zeros(1, dtype=torch.int64, device=q.device)
        return fused.fused_attention(q, k, v, bias, seed, 0.0)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def _attn(p, x, heads):
    B, S, W = x.shape
    D = W // heads
    # a product in x's dtype, then the bias (vit.py:103-105 there): under a
    # bf16 cast two roundings, not linear's one
    qkv = torch.matmul(x, p["in_proj_kernel"]) + p["in_proj_bias"]
    q, k, v = (qkv[..., i * W:(i + 1) * W].reshape(B, S, heads, D).transpose(1, 2)
               for i in range(3))
    o = attention(q, k, v).transpose(1, 2).reshape(B, S, W)
    return linear(p["out_proj"], o)


def block(p, x, heads):
    """One CLIP ResidualAttentionBlock: pre-LN attention, then a pre-LN
    QuickGELU MLP, each added to its input."""
    x = x + _attn(p["attn"], layer_norm(p["ln_1"], x), heads)
    h = quick_gelu(linear(p["mlp"]["c_fc"], layer_norm(p["ln_2"], x)))
    return x + linear(p["mlp"]["c_proj"], h)


def encode_image(params, images, cfg: ViTConfig = ViTConfig()):
    """(B, 3, H, W) f32 -> (B, output_dim), CLIP ``encode_image``."""
    B = images.shape[0]
    P, W, g = cfg.patch_size, cfg.width, cfg.grid
    # the stride-P conv as a per-patch flatten and one matmul
    x = images.reshape(B, 3, g, P, g, P).permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, 3 * P * P)
    x = torch.matmul(x, params["conv"].reshape(W, 3 * P * P).t())  # (B, g g, W)
    cls = params["class_embedding"].expand(B, 1, W)
    x = torch.cat([cls, x], dim=1) + params["positional_embedding"]
    x = layer_norm(params["ln_pre"], x)
    for blk in params["blocks"]:
        x = block(blk, x, cfg.heads)
    pooled = layer_norm(params["ln_post"], x[:, 0])
    return torch.matmul(pooled, params["proj"])


def _check_shapes(params, cfg: ViTConfig):
    W, P = cfg.width, cfg.patch_size
    want = {"conv": (W, 3, P, P), "class_embedding": (W,),
            "positional_embedding": (cfg.seq_len, W), "proj": (W, cfg.output_dim)}
    for name, shape in want.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(params[name].shape)}, expected {shape}")
    if len(params["blocks"]) != cfg.layers:
        raise ValueError(f"{len(params['blocks'])} blocks, the config has {cfg.layers}")
    for i, blk in enumerate(params["blocks"]):
        if tuple(blk["attn"]["in_proj_kernel"].shape) != (W, 3 * W):
            raise ValueError(f"block {i}: in_proj_kernel is not ({W}, {3 * W})")
    return params


def params_from_jax(tree, cfg: ViTConfig = ViTConfig(), device=None):
    """The JAX package's ``vit.init`` tree (numpy leaves, or anything
    ``np.asarray`` takes) as the port's f32 tree on ``device`` (the card
    unless "cpu"); raises ``ValueError`` where a shape is not ``cfg``'s."""
    dev = resolve_device(device)
    params = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), tree)
    return _check_shapes(params, cfg)


def _to_numpy(v):
    return v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v, np.float32)


def from_clip_state_dict(sd, cfg: Optional[ViTConfig] = None, device=None):
    """OpenAI CLIP state dict (the full model or the visual tower alone;
    torch or numpy leaves) -> ``(params, cfg)`` on ``device`` (the card
    unless "cpu"). Keys: visual.conv1.weight, visual.class_embedding,
    visual.positional_embedding, visual.ln_pre/post.{weight,bias},
    visual.transformer.resblocks.N.{ln_1,attn,ln_2,mlp.c_fc,mlp.c_proj}.*,
    visual.proj. Without ``cfg`` the patch size and width come from the conv.
    """
    def get(name):
        for key in (f"visual.{name}", name):
            if key in sd:
                return _to_numpy(sd[key])
        raise KeyError(name)

    conv = get("conv1.weight")
    if cfg is None:
        cfg = ViTConfig(patch_size=int(conv.shape[-1]), width=int(conv.shape[0]))

    def ln(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    def dense(name):
        return {"kernel": get(name + ".weight").T, "bias": get(name + ".bias")}

    tree = {
        "conv": conv,
        "class_embedding": get("class_embedding"),
        "positional_embedding": get("positional_embedding"),
        "ln_pre": ln("ln_pre"),
        "ln_post": ln("ln_post"),
        "proj": get("proj"),
        "blocks": [],
    }
    for i in range(cfg.layers):
        base = f"transformer.resblocks.{i}."
        tree["blocks"].append({
            "ln_1": ln(base + "ln_1"),
            "attn": {"in_proj_kernel": get(base + "attn.in_proj_weight").T,
                     "in_proj_bias": get(base + "attn.in_proj_bias"),
                     "out_proj": dense(base + "attn.out_proj")},
            "ln_2": ln(base + "ln_2"),
            "mlp": {"c_fc": dense(base + "mlp.c_fc"), "c_proj": dense(base + "mlp.c_proj")},
        })
    return params_from_jax(tree, cfg, device), cfg
