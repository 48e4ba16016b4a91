"""Carry parameters across from the JAX package.

The port keeps the JAX package's parameter tree as it is: the same nested
dict/list structure and names, and the same layouts (a linear ``kernel`` is
(in, out), applied as ``x @ kernel``; embeddings are (vocab, hidden); ``DP``
is (1, F)). So the conversion is a leaf-by-leaf copy into tensors, and the
tests can feed one weight set to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.trees import tree_map
from . import fusion


def params_from_jax(tree, config: fusion.FusionConfig, device=None):
    """The JAX package's ``fusion.init`` tree for ``config``'s class (or its
    ``legacy_pri_gumbel_init`` tree), with numpy leaves (the caller converts
    with ``np.asarray``), as the port's f32 parameter tree on ``device``
    (the card unless "cpu"). Raises ``ValueError`` where the tree's parts,
    shapes or layer counts are not the class's."""
    dev = resolve_device(device)
    params = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), tree)
    width = config.concat_width
    parts = ["fc1", "fc2", "classifier"]
    expect = {"fc1/kernel": (width, width), "fc2/kernel": (width, fusion.D_MODEL)}
    if config.uses_bert:
        bert_cfg = config.bert_cfg()
        parts.append("bert")
        expect["bert/embeddings/word"] = (bert_cfg.vocab_size, bert_cfg.hidden_size)
    if config.uses_visual:
        parts.append("visual_encoder")
        expect["visual_encoder/kernel"] = (fusion.VISUAL_IN, fusion.D_MODEL)
    if config.with_cross_attention:
        parts.append("cross")
    if config.dp_mode == "lapacian_dropout":
        parts.append("DP")
        expect["DP"] = (1, width)
    if config.dp_mode == "pri_gumbel" or "w" in params:
        parts.append("w")
        expect["w"] = (fusion.D_MODEL,)
    if sorted(params) != sorted(parts):
        raise ValueError(f"the tree has parts {sorted(params)}, {config.name} has {sorted(parts)}")
    for path, shape in expect.items():
        leaf = params
        for key in path.split("/"):
            leaf = leaf[key]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{path} has shape {tuple(leaf.shape)}, expected {shape}")
    if config.uses_bert and len(params["bert"]["layers"]) != bert_cfg.num_layers:
        raise ValueError("the BERT layer count differs from the config")
    if config.with_cross_attention:
        layers = params["cross"]["layers"]
        encoder = config.cross_atn_type == "single_stream"
        if len(layers) != fusion.N_CROSS_LAYERS or any(
                ("cross_attn" in layer) == encoder for layer in layers):
            raise ValueError("the cross block's layers differ from the config's "
                             + ("encoder" if encoder else "decoder"))
    return params


def params_to_numpy(params):
    """The inverse of :func:`params_from_jax`: the same tree, numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
