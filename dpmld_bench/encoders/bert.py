"""BERT as the program's text encoder: ``models/bert.py`` set up from the
configuration's HF keys."""
from __future__ import annotations

import torch

from eeg_multimodal_torch.models import fusion
from eeg_multimodal_torch.models import layers as L
from eeg_multimodal_torch.models.bert import BertConfig


def check_widths(cfg: dict):
    """Raise unless the program's fixed widths are the configuration's."""
    fz = cfg["fusion"]
    fixed = {"hidden_size": fusion.D_MODEL, "cross_heads": fusion.N_HEADS,
             "cross_layers": fusion.N_CROSS_LAYERS, "cross_ffn": L.FFN_DIM,
             "visual_in": fusion.VISUAL_IN, "classes": fusion.N_CLASSES,
             "feature_width": 3 * fusion.D_MODEL}
    for key, value in fixed.items():
        got = cfg[key] if key in cfg else fz[key]
        if got != value:
            raise ValueError(f"configuration {key}={got}, the program runs {value}")


def fusion_settings(cfg: dict, vocab_size: int) -> dict:
    return {"bert_config": BertConfig(
        vocab_size=vocab_size, hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"], layer_norm_eps=cfg["layer_norm_eps"],
        hidden_dropout=cfg["hidden_dropout_prob"],
        attention_dropout=cfg["attention_probs_dropout_prob"],
        initializer_range=cfg["initializer_range"])}


def cut_to_vocab(params: dict, vocab, device) -> dict:
    emb = params["bert"]["embeddings"]
    keep = torch.as_tensor(vocab.new_to_old, dtype=torch.int64, device=device)
    emb["word"] = emb["word"].index_select(0, keep)
    return params
