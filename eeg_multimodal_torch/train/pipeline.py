"""Pretrain -> finetune pipelines and resumable training state.

Port of the JAX package's ``train/pipeline.py``. The reference's legacy
flow (main_0425.py / main_0430.py): pretrain the ConcatModel plainly,
checkpoint, resume with ``load_state_dict(..., strict=False)``
(main_0425.py:271, main_0430.py:137-139) and finetune under a DP scheme
('feature_all_lap', per-sample Laplace). Also the full train state saved
every epoch, and a trainer that resumes from it.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict, Optional

import torch

from ..data.datasets import MultiModalArrays
from ..models import fusion
from ..ops.optim import AdamState
from ..utils.trees import tree_items, tree_map
from . import checkpoint as ckpt
from .trainer import TrainConfig, Trainer


def _leaves(params, dp: bool):
    """The leaves one of the trainer's optimizers updates: ``DP``'s, or the
    model's, in the tree's order."""
    return [t for path, t in tree_items(params) if fusion.dp_param_predicate(path) == dp]


def save_train_state(path: str, trainer: Trainer, epoch: int) -> None:
    """The durable full state: params, both optimizer states, the epoch."""
    ckpt.save_pytree(path, {
        "params": trainer.params,
        "dp_os": None if trainer.dp_os is None else trainer.dp_os.to_tree(),
        "model_os": trainer.model_os.to_tree(),
        "epoch": epoch,
    })


def load_train_state(path: str, trainer: Trainer) -> int:
    """Load a :func:`save_train_state` file into ``trainer`` (on its
    device): the params, and optimizer states whose packed bf16 moments are
    views of their buffers again. Returns the epoch saved."""
    state = ckpt.load_pytree(path, trainer.device)
    trainer.params = state["params"]
    trainer.dp_os = (None if state["dp_os"] is None
                     else AdamState.from_tree(state["dp_os"], _leaves(trainer.params, True)))
    trainer.model_os = AdamState.from_tree(state["model_os"], _leaves(trainer.params, False))
    return int(state["epoch"])


class ResumableTrainer(Trainer):
    """A trainer that saves its full state after every epoch and resumes
    from the latest state file of ``log_path`` if there is one (a sweep can
    skip a finished run by its presence, as the reference skips logged
    ones, visualization/plot.py:147-149)."""

    STATE_FILE = "train_state.pickle"

    def fit(self, train_data, test_data, epsilon, log_path=None, model_path=None, echo=True,
            **kw):
        state_path = os.path.join(log_path, self.STATE_FILE) if log_path else None
        start_epoch = 0
        if state_path and os.path.exists(state_path):
            start_epoch = load_train_state(state_path, self) + 1
            if echo:
                print(f"resuming from epoch {start_epoch}")
        if start_epoch >= self.train_cfg.epochs:
            return {"history": [], "best": None, "f1_best": None, "resumed_complete": True}
        hook = (lambda epoch: save_train_state(state_path, self, epoch)) if state_path else None
        return super().fit(train_data, test_data, epsilon, log_path=log_path,
                           model_path=model_path, echo=echo, start_epoch=start_epoch,
                           epoch_end_hook=hook)


@dataclasses.dataclass
class PipelineConfig:
    epsilon: float = 0.1  # the finetune's epsilon (main_0425.py fixes 0.1)
    pretrain_epochs: int = 30  # ref train_val.py:172, main_0425's pretrain
    finetune_epochs: int = 50
    batch_size: int = 8
    learning_rate: float = 1e-6
    compute_dtype: str = "float32"


def pretrain_finetune(
    train_data: MultiModalArrays,
    test_data: MultiModalArrays,
    out_root: str,
    cfg: PipelineConfig = PipelineConfig(),
    bert_params=None,
    echo: bool = True,
    load_stat: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """main_0430.py:129-235: (1) a plain pretrain of the concat trunk (NDP),
    (2) a finetune with per-sample feature Laplace ('feature_all_lap') from
    the pretrained params (the same trunk; the reference's strict=False
    load). ``load_stat`` skips (1) and reads that state dict (a pickle or a
    ``torch.save`` file) instead. On the card unless ``device="cpu"``."""
    pre_cfg = fusion.config_for("ti", "NDP", dtype=cfg.compute_dtype)
    fin_cfg = fusion.config_for("ti", "feature_all_lap", dtype=cfg.compute_dtype)

    def train_cfg(epochs):
        return TrainConfig(batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
                           epochs=epochs, compute_dtype=cfg.compute_dtype)

    if load_stat is None:
        pre_trainer = Trainer(pre_cfg, train_cfg(cfg.pretrain_epochs), bert_params=bert_params,
                              device=device)
        pre_out = pre_trainer.fit(
            train_data, test_data, epsilon=0.0, log_path=os.path.join(out_root, "pretrain"),
            model_path=os.path.join(out_root, "pretrain", "best_f1.pickle"), echo=echo)
        # a copy: the finetune updates its params in place
        pre_params = tree_map(torch.clone, pre_trainer.params)
    else:
        pre_out = None
        pre_params = ckpt.fusion_from_torch_state_dict(
            ckpt.normalize_torch_keys(_load_any(load_stat)), pre_cfg, device)

    fin_trainer = Trainer(fin_cfg, train_cfg(cfg.finetune_epochs), params=pre_params,
                          device=device)
    fin_out = fin_trainer.fit(
        train_data, test_data, epsilon=cfg.epsilon,
        log_path=os.path.join(out_root, "fineturn"),  # the reference's spelling
        model_path=os.path.join(out_root, "fineturn", "best_f1.pickle"), echo=echo)
    return {"pretrain": pre_out, "finetune": fin_out}


def _load_any(path: str):
    """A pickled state dict, or a ``torch.save`` one."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)
