"""ResNet-34 feature extractor as plain functions on tensors.

Port of the JAX package's ``models/resnet.py`` (ref: get_embedding.py:72-84:
torchvision's resnet34 with ``fc = Identity``, the 512-d pooled features).
BasicBlocks in layers of [3, 4, 6, 3], inference BatchNorm from the running
statistics, a 3x3 stride-2 max pool, a global mean. The convolutions are
``F.conv2d`` (cuDNN on the card, in true f32: ``resolve_device`` turns TF32
off for cuDNN too); the JAX package's ``conv_general_dilated`` is outside any
Pallas kernel. The tree has the JAX package's names and (O, I, kH, kW)
kernels, so ``params_from_jax`` copies it leaf by leaf;
``from_torchvision_state_dict`` reads a torchvision state dict.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.trees import tree_map

LAYERS = (3, 4, 6, 3)  # resnet34
CHANNELS = (64, 128, 256, 512)
BN_EPS = 1e-5


def _strides():
    """(layer, block, stride, has a downsample) of every BasicBlock."""
    in_c = 64
    for li, (n_blocks, c) in enumerate(zip(LAYERS, CHANNELS)):
        for b in range(n_blocks):
            stride = 2 if (li > 0 and b == 0) else 1
            yield li, b, stride, stride != 1 or in_c != c
            in_c = c


def init(gen: torch.Generator, device=None):
    """He-normal convolutions (std sqrt(2 / fan_in)), BatchNorm at scale 1,
    bias 0, mean 0, var 1, as the JAX package's init. Drawn from ``gen`` on
    its device, then moved to ``device`` (the card unless "cpu")."""
    dev = resolve_device(device)

    def conv(out_c, in_c, k):
        std = math.sqrt(2.0 / (in_c * k * k))
        return torch.randn((out_c, in_c, k, k), generator=gen, device=gen.device) * std

    def bn(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c),
                "var": torch.ones(c)}

    params = {"conv1": conv(64, 3, 7), "bn1": bn(64), "layers": [[] for _ in LAYERS]}
    in_c = 64
    for li, _, stride, down in _strides():
        c = CHANNELS[li]
        block = {"conv1": conv(c, in_c, 3), "bn1": bn(c), "conv2": conv(c, c, 3), "bn2": bn(c)}
        if down:
            block["downsample"] = {"conv": conv(c, in_c, 1), "bn": bn(c)}
        params["layers"][li].append(block)
        in_c = c
    return tree_map(lambda t: t.to(dev), params)


def _bn(p, x):
    """Inference BatchNorm: (x - mean) / sqrt(var + eps) * scale + bias."""
    return F.batch_norm(x, p["mean"], p["var"], p["scale"], p["bias"], False, 0.0, BN_EPS)


def _basic_block(p, x, stride):
    identity = x
    out = torch.relu(_bn(p["bn1"], F.conv2d(x, p["conv1"], stride=stride, padding=1)))
    out = _bn(p["bn2"], F.conv2d(out, p["conv2"], padding=1))
    if "downsample" in p:
        identity = _bn(p["downsample"]["bn"], F.conv2d(x, p["downsample"]["conv"], stride=stride))
    return torch.relu(out + identity)


def features(params, images):
    """(B, 3, H, W) f32 -> (B, 512): resnet34 with fc = Identity
    (ref get_embedding.py:77)."""
    x = torch.relu(_bn(params["bn1"], F.conv2d(images, params["conv1"], stride=2, padding=3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for li, b, stride, _ in _strides():
        x = _basic_block(params["layers"][li][b], x, stride)
    return x.mean(dim=(2, 3))  # adaptive average pool to 1x1


def _check_shapes(params):
    if tuple(params["conv1"].shape) != (64, 3, 7, 7):
        raise ValueError(f"conv1 has shape {tuple(params['conv1'].shape)}, expected (64, 3, 7, 7)")
    if [len(blocks) for blocks in params["layers"]] != list(LAYERS):
        raise ValueError(f"layers of {[len(b) for b in params['layers']]} blocks, "
                         f"resnet34 has {list(LAYERS)}")
    in_c = 64
    for li, b, _, down in _strides():
        block, c = params["layers"][li][b], CHANNELS[li]
        if tuple(block["conv1"].shape) != (c, in_c, 3, 3) or ("downsample" in block) != down:
            raise ValueError(f"layer {li + 1} block {b} is not resnet34's")
        in_c = c
    return params


def params_from_jax(tree, device=None):
    """The JAX package's ``resnet.init`` tree (numpy leaves, or anything
    ``np.asarray`` takes) as the port's f32 tree on ``device`` (the card
    unless "cpu"); raises ``ValueError`` where it is not resnet34's."""
    dev = resolve_device(device)
    params = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), tree)
    return _check_shapes(params)


def from_torchvision_state_dict(sd, device=None):
    """A torchvision resnet34 state dict (torch or numpy leaves) -> params on
    ``device`` (the card unless "cpu"). ``fc`` is not read."""
    def get(name):
        v = sd[name]
        return v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v)

    def bn(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias"),
                "mean": get(name + ".running_mean"), "var": get(name + ".running_var")}

    tree = {"conv1": get("conv1.weight"), "bn1": bn("bn1"), "layers": [[] for _ in LAYERS]}
    for li, b, _, _ in _strides():
        base = f"layer{li + 1}.{b}."
        block = {"conv1": get(base + "conv1.weight"), "bn1": bn(base + "bn1"),
                 "conv2": get(base + "conv2.weight"), "bn2": bn(base + "bn2")}
        if base + "downsample.0.weight" in sd:
            block["downsample"] = {"conv": get(base + "downsample.0.weight"),
                                   "bn": bn(base + "downsample.1")}
        tree["layers"][li].append(block)
    return params_from_jax(tree, device)
