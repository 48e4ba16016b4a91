"""The system under test, set up from a configuration and a traffic mix.

A frozen copy of ``eeg_multimodal_torch/bench.py::configure`` (rows
truncated to the longest valid row rounded up to 16, the compact vocab,
the ``FusionConfig`` and ``TrainConfig`` of the configuration), driven by
the configuration file instead of environment switches. The text encoder's
settings, widths and word table are its part's (``encoders/<model_type>.py``).
The weights are the benchmark's (``reference/weights.py``), made on the
device from the seed and handed to the program; a compact vocab takes the
rows of the word table it keeps.
"""
from __future__ import annotations

import dataclasses

from eeg_multimodal_torch.data import datasets as D
from eeg_multimodal_torch.data.compact_vocab import build_compact_vocab, remap_pairing
from eeg_multimodal_torch.models import fusion
from eeg_multimodal_torch.train.trainer import TrainConfig

from . import encoders
from . import rows as R
from .reference import encoders as ref_encoders
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
            params = encoders.of(cfg).cut_to_vocab(params, self.vocab, device)
        return params


def _pairing(split):
    return D.build_pairing("ti", split["labels"],
                           eeg_txt={"input_ids": split["input_ids"],
                                    "attention_mask": split["attention_mask"]},
                           act_img=split["act"])


def build(cfg: dict, traffic: dict, seed: int) -> Program:
    enc = encoders.of(cfg)
    enc.check_widths(cfg)
    train_rows, test_rows = R.make_rows(seed, traffic, ref_encoders.of(cfg).TOKENS)
    train, test = _pairing(train_rows), _pairing(test_rows)
    if traffic["truncate"]:
        train, test = D.truncate_pair(train, test)
    prog = cfg["program"]
    vocab, vocab_size = None, cfg["vocab_size"]
    if prog["compact_vocab"]:
        vocab = build_compact_vocab([train.eeg_input, test.eeg_input], cfg["vocab_size"])
        train, test = remap_pairing(train, vocab), remap_pairing(test, vocab)
        vocab_size = vocab.size
    fz = cfg["fusion"]
    fc = dataclasses.replace(fusion.config_for(fz["multimodal_type"], fz["dp_mode"]),
                             fused_dp_kernel=prog["fused_dp_kernel"],
                             **enc.fusion_settings(cfg, vocab_size))
    tr = cfg["train"]
    tc = TrainConfig(batch_size=tr["batch_size"], learning_rate=tr["learning_rate"], seed=seed,
                     compute_dtype=prog["compute_dtype"], adam_mu_dtype=prog["adam_mu_dtype"],
                     adam_nu_dtype=prog["adam_nu_dtype"], precast_params=prog["precast_params"])
    return Program(train, test, fc, tc, vocab, train.eeg_input.shape[1])
