"""Best-F1 checkpoints in the reference's torch state-dict format.

Port of the JAX package's ``train/checkpoint.py:82-257`` (with the BERT part
of ``models/bert.py:228-314``) for every class of the model zoo. The
reference checkpoints ``torch.save(model.state_dict(), ...best_f1.pickle)``
on F1 improvement (base_train.py:250-255); both packages write the same
file: a plain pickle of numpy arrays in torch layout (a linear's weight is
(out, in)) under the reference's nn.Module key names, each part where the
class has it,

  bert.embeddings.*, bert.encoder.layer.N.*, bert.pooler.dense.*  (HF BertModel;
  a ``t`` stream),
  visual_encoder.weight/.bias  (an ``i`` stream),
  multi_head_decoderlayer.* (the prototype submodule, a copy of layer 0) and
  multi_head_decoder.layers.N.{self_attn,multihead_attn,linear1,linear2,
  norm1,norm2,norm3}.*  (models.py:44-45; double stream), or
  multi_head_encoderlayer.* and multi_head_encoder.layers.N.{self_attn,
  linear1,linear2,norm1,norm2}.*  (models.py:235-236; TISC), none for DPSGD,
  fc_layers.{0,2}.weight/.bias, classifier.weight/.bias,
  DP (models.py:46-53; lapacian_dropout), w (the PriGumbel head),

so a checkpoint written by either package loads in the other, and in
``torch.load(weights_only=False)``. This module is the one place that knows
the format.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from ..models.fusion import N_CROSS_LAYERS, FusionConfig
from ..utils.device import resolve_device

# (tree path under a BERT layer, state-dict name under encoder.layer.N.)
_BERT_LAYER = (
    (("attn", "query"), "attention.self.query"),
    (("attn", "key"), "attention.self.key"),
    (("attn", "value"), "attention.self.value"),
    (("attn", "output"), "attention.output.dense"),
    (("attn", "ln"), "attention.output.LayerNorm"),
    (("ffn", "intermediate"), "intermediate.dense"),
    (("ffn", "output"), "output.dense"),
    (("ffn", "ln"), "output.LayerNorm"),
)
# (tree key, state-dict name) of a decoder layer's and an encoder layer's
# attention blocks, and their linears and norms
_CROSS_LAYER = {
    "decoder": ((("self_attn", "self_attn."), ("cross_attn", "multihead_attn.")),
                ("linear1", "linear2", "norm1", "norm2", "norm3")),
    "encoder": ((("self_attn", "self_attn."),), ("linear1", "linear2", "norm1", "norm2")),
}


def _cross_kind(config: FusionConfig) -> str:
    return "encoder" if config.cross_atn_type == "single_stream" else "decoder"


def normalize_torch_keys(sd: Dict) -> Dict:
    """Strip Opacus/DataParallel wrappers: '_module.' / 'module.' prefixes."""
    out = {}
    for k, v in sd.items():
        for pre in ("_module.", "module."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# -- tree -> state dict -------------------------------------------------------

def _put(out, name, p):
    """A linear ({kernel (in, out), bias}) or a LayerNorm ({scale, bias})."""
    if "kernel" in p:
        out[name + ".weight"] = _np(p["kernel"]).T
    else:
        out[name + ".weight"] = _np(p["scale"])
    out[name + ".bias"] = _np(p["bias"])


def _put_mha(out, base, p):
    out[base + "in_proj_weight"] = _np(p["in_proj_kernel"]).T
    out[base + "in_proj_bias"] = _np(p["in_proj_bias"])
    _put(out, base + "out_proj", p["out_proj"])


def _put_cross_layer(out, kind, base, p):
    attn, rest = _CROSS_LAYER[kind]
    for key, name in attn:
        _put_mha(out, base + name, p[key])
    for n in rest:
        _put(out, base + n, p[n])


def bert_to_torch_state_dict(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """A BERT tree as an HF ``BertModel`` state dict (``bert.py::
    to_torch_state_dict`` of the JAX package)."""
    out: Dict[str, np.ndarray] = {}
    emb = params["embeddings"]
    for key in ("word", "position", "token_type"):
        out[f"{prefix}embeddings.{key}_embeddings.weight"] = _np(emb[key])
    _put(out, prefix + "embeddings.LayerNorm", emb["ln"])
    for i, layer in enumerate(params["layers"]):
        for (part, mod), name in _BERT_LAYER:
            _put(out, f"{prefix}encoder.layer.{i}.{name}", layer[part][mod])
    _put(out, prefix + "pooler.dense", params["pooler"])
    return out


def fusion_to_torch_state_dict(params, config: FusionConfig) -> Dict[str, np.ndarray]:
    """The port's tree -> the reference's state-dict names, numpy arrays in
    torch layout, in the JAX package's key order. The prototype layer
    (multi_head_decoderlayer.* or multi_head_encoderlayer.*) is a copy of
    layer 0, as torch registers it (models.py:44-45)."""
    out: Dict[str, np.ndarray] = {k: _np(params[k]) for k in ("DP", "w") if k in params}
    if config.uses_bert:
        out.update(bert_to_torch_state_dict(params["bert"], prefix="bert."))
    if config.uses_visual:
        _put(out, "visual_encoder", params["visual_encoder"])
    if config.with_cross_attention:
        kind = _cross_kind(config)
        layers = params["cross"]["layers"]
        _put_cross_layer(out, kind, f"multi_head_{kind}layer.", layers[0])
        for i, lp in enumerate(layers):
            _put_cross_layer(out, kind, f"multi_head_{kind}.layers.{i}.", lp)
    _put(out, "fc_layers.0", params["fc1"])
    _put(out, "fc_layers.2", params["fc2"])
    _put(out, "classifier", params["classifier"])
    return out


# -- state dict -> tree -------------------------------------------------------

class _Reader:
    """Reads a state dict's entries as f32 tensors on one device."""

    def __init__(self, sd, device):
        self.sd, self.device = sd, device

    def get(self, name, transpose=False):
        a = np.asarray(_np(self.sd[name]), np.float32)
        return torch.tensor(a.T if transpose else a, device=self.device)

    def linear(self, base):
        return {"kernel": self.get(base + ".weight", True), "bias": self.get(base + ".bias")}

    def ln(self, base):
        return {"scale": self.get(base + ".weight"), "bias": self.get(base + ".bias")}

    def mha(self, base):
        return {"in_proj_kernel": self.get(base + "in_proj_weight", True),
                "in_proj_bias": self.get(base + "in_proj_bias"),
                "out_proj": self.linear(base + "out_proj")}

    def cross_layer(self, kind, base):
        attn, rest = _CROSS_LAYER[kind]
        layer = {key: self.mha(base + name) for key, name in attn}
        layer.update({n: (self.ln if n.startswith("norm") else self.linear)(base + n)
                      for n in rest})
        return layer

    def bert(self, config, prefix):
        emb = {key: self.get(f"{prefix}embeddings.{key}_embeddings.weight")
               for key in ("word", "position", "token_type")}
        emb["ln"] = self.ln(prefix + "embeddings.LayerNorm")
        layers = []
        for i in range(config.num_layers):
            layer = {"attn": {}, "ffn": {}}
            for (part, mod), name in _BERT_LAYER:
                read = self.ln if mod == "ln" else self.linear
                layer[part][mod] = read(f"{prefix}encoder.layer.{i}.{name}")
            layers.append(layer)
        return {"embeddings": emb, "layers": layers,
                "pooler": self.linear(prefix + "pooler.dense")}


def fusion_from_torch_state_dict(sd: Dict, config: FusionConfig, device=None):
    """A reference state dict (tensors or numpy arrays) -> the port's f32
    tree on ``device`` (the card unless "cpu"): the parts ``config``'s class
    has, and ``DP`` and ``w`` where the state dict holds them, as the JAX
    package reads them (checkpoint.py:158-185 there)."""
    sd = normalize_torch_keys(sd)
    r = _Reader(sd, resolve_device(device))
    params = {}
    if config.uses_bert:
        params["bert"] = r.bert(config.bert_cfg(), "bert.")
    if config.uses_visual:
        params["visual_encoder"] = r.linear("visual_encoder")
    if config.with_cross_attention:
        kind = _cross_kind(config)
        params["cross"] = {"layers": [r.cross_layer(kind, f"multi_head_{kind}.layers.{i}.")
                                      for i in range(N_CROSS_LAYERS)]}
    params["fc1"] = r.linear("fc_layers.0")
    params["fc2"] = r.linear("fc_layers.2")
    params["classifier"] = r.linear("classifier")
    params.update({k: r.get(k) for k in ("DP", "w") if k in sd})
    return params


def save_torch_checkpoint(path: str, params, config: FusionConfig) -> None:
    """Write a best_f1.pickle: a plain pickle of the numpy state dict
    (``torch.load(weights_only=False)`` reads it too)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(fusion_to_torch_state_dict(params, config), f)


def load_torch_checkpoint(path: str, config: FusionConfig, device=None):
    """Read a best_f1.pickle (this format, or a torch-saved state dict) as
    the port's tree on ``device``."""
    try:
        with open(path, "rb") as f:
            sd = pickle.load(f)
    except pickle.UnpicklingError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    return fusion_from_torch_state_dict(sd, config, device)
