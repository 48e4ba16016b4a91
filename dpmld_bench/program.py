"""The system under test, set up from a configuration and a traffic mix.

A frozen copy of ``eeg_multimodal_torch/bench.py::configure`` (rows
truncated to the longest valid row rounded up to 16, the compact vocab,
the ``FusionConfig`` and ``TrainConfig`` of the configuration), driven by
the configuration file instead of environment switches. The weights are
the benchmark's (``reference/weights.py``), made on the device from the seed
and handed to the program; a compact vocab takes the rows of the word table
it keeps.
"""
from __future__ import annotations

import dataclasses

import torch

from eeg_multimodal_torch.data import datasets as D
from eeg_multimodal_torch.data.compact_vocab import build_compact_vocab, remap_pairing
from eeg_multimodal_torch.models import fusion
from eeg_multimodal_torch.models import layers as L
from eeg_multimodal_torch.models.bert import BertConfig
from eeg_multimodal_torch.train.trainer import TrainConfig

from . import rows as R
from .reference.weights import make_weights


@dataclasses.dataclass
class Program:
    train: D.MultiModalArrays
    test: D.MultiModalArrays
    fusion_cfg: fusion.FusionConfig
    train_cfg: TrainConfig
    vocab: object
    seq_len: int

    def weights(self, cfg, seed, device):
        """The run's f32 weights on ``device``, the word table cut to the
        compact vocab's rows where the program keeps one."""
        params = make_weights(cfg, seed, device)
        if self.vocab is not None:
            emb = params["bert"]["embeddings"]
            keep = torch.as_tensor(self.vocab.new_to_old, dtype=torch.int64, device=device)
            emb["word"] = emb["word"].index_select(0, keep)
        return params


def _pairing(split):
    return D.build_pairing("ti", split["labels"],
                           eeg_txt={"input_ids": split["input_ids"],
                                    "attention_mask": split["attention_mask"]},
                           act_img=split["act"])


def check_widths(cfg):
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


def build(cfg: dict, traffic: dict, seed: int) -> Program:
    check_widths(cfg)
    train_rows, test_rows = R.make_rows(seed, traffic)
    train, test = _pairing(train_rows), _pairing(test_rows)
    if traffic["truncate"]:
        train, test = D.truncate_pair(train, test)
    bert = BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"], layer_norm_eps=cfg["layer_norm_eps"],
        hidden_dropout=cfg["hidden_dropout_prob"],
        attention_dropout=cfg["attention_probs_dropout_prob"],
        initializer_range=cfg["initializer_range"])
    prog = cfg["program"]
    vocab = None
    if prog["compact_vocab"]:
        vocab = build_compact_vocab([train.eeg_input, test.eeg_input], cfg["vocab_size"])
        train, test = remap_pairing(train, vocab), remap_pairing(test, vocab)
        bert = dataclasses.replace(bert, vocab_size=vocab.size)
    fz = cfg["fusion"]
    fc = dataclasses.replace(fusion.config_for(fz["multimodal_type"], fz["dp_mode"]),
                             bert_config=bert, fused_dp_kernel=prog["fused_dp_kernel"])
    tr = cfg["train"]
    tc = TrainConfig(batch_size=tr["batch_size"], learning_rate=tr["learning_rate"], seed=seed,
                     compute_dtype=prog["compute_dtype"], adam_mu_dtype=prog["adam_mu_dtype"],
                     adam_nu_dtype=prog["adam_nu_dtype"], precast_params=prog["precast_params"])
    return Program(train, test, fc, tc, vocab, train.eeg_input.shape[1])
