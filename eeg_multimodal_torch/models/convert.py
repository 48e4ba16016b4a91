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
    """The JAX package's ``fusion.init`` tree, with numpy leaves (the caller
    converts with ``np.asarray``), as the port's f32 parameter tree on
    ``device`` (the card unless "cpu")."""
    fusion.check_ported(config)
    dev = resolve_device(device)
    params = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), tree)
    bert_cfg = config.bert_cfg()
    expect = {
        "DP": (1, config.concat_width),
        "fc1/kernel": (config.concat_width, config.concat_width),
        "bert/embeddings/word": (bert_cfg.vocab_size, bert_cfg.hidden_size),
    }
    for path, shape in expect.items():
        leaf = params
        for key in path.split("/"):
            leaf = leaf[key]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{path} has shape {tuple(leaf.shape)}, expected {shape}")
    if len(params["bert"]["layers"]) != bert_cfg.num_layers or \
            len(params["cross"]["layers"]) != fusion.N_CROSS_LAYERS:
        raise ValueError("layer counts differ from the config")
    return params


def params_to_numpy(params):
    """The inverse of :func:`params_from_jax`: the same tree, numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
