"""The legacy root scripts' drivers: the eps experiment, the feawei
extraction, the alpha sweep and the log rewrite.

Port of the JAX package's ``experiments/legacy_drivers.py``:

- :func:`eps_experiment_epsilons` / :class:`EpsExperiment`: ref past_acc.py
  __main__ (:254-258), epsilon from round(logspace(log10(0.01), log10(5.0),
  20), 3) chosen by index, trained with the alternating optimizers into
  model_dict/eps_experiment/<eps>/; ``run_all_vmapped`` trains the whole grid
  as one batched sweep (``train/sweep.py``).
- :func:`extract_feawei`: ref past_acc_feawei.py:131-148, the normalized
  (N, 2304) fused features of a split, pickled to feawei.pkl for the
  feature-magnitude DP init (``ops/dp_inits.feawei``).
- :class:`AlphaSweep`: ref train_val.py:524-543, the PriGumbel pretrainer
  over the privacy-regularized loss's alpha grid.
- :func:`rewrite_val_to_test`: ref 1224.py:12-31, 'Val' -> 'Test' across
  record trees.

Each trains on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..data.datasets import MultiModalArrays, gather_batch
from ..models import fusion
from ..train.legacy import PriGumbelConfig, PriGumbelPretrainer, alpha_sweep_values
from ..train.sweep import SweepMember, SweepRunner
from ..train.trainer import TrainConfig, Trainer
from ..utils.device import resolve_device
from ..utils.trees import tree_map


def eps_experiment_epsilons() -> np.ndarray:
    """round(logspace(log10(0.01), log10(5.0), 20), 3) (past_acc.py:255-256)."""
    return np.around(np.logspace(np.log10(0.01), np.log10(5.0), 20), decimals=3)


class EpsExperiment:
    """ref past_acc.py main2: the TICA_LapDropout trunk with the alternating
    optimizers, one run per epsilon index, records under
    <out_root>/<eps>/."""

    def __init__(self, fusion_cfg: Optional[fusion.FusionConfig] = None,
                 train_cfg: Optional[TrainConfig] = None,
                 out_root: str = "model_dict/eps_experiment", device=None):
        self.fusion_cfg = fusion_cfg or fusion.config_for("ti", "lapacian_dropout")
        self.train_cfg = train_cfg or TrainConfig()
        self.out_root = out_root
        self.device = resolve_device(device)

    def run_index(self, i: int, train_data, test_data, dp_init=None):
        """The run of epsilon ``i``; ``dp_init`` (1, F), e.g. from
        ``ops/dp_inits``, replaces the ``DP`` leaf's zeros."""
        eps = float(eps_experiment_epsilons()[i])
        suffix = f"{eps}/"
        trainer = Trainer(self.fusion_cfg, self.train_cfg, device=self.device)
        if dp_init is not None:
            with torch.no_grad():
                trainer.params["DP"].copy_(torch.as_tensor(dp_init))
        return trainer.fit(
            train_data, test_data, eps,
            log_path=os.path.join(self.out_root, suffix),
            model_path=os.path.join(self.out_root, suffix, "best_f1.pickle"),
        )

    def run_all_vmapped(self, train_data, test_data, log_root=None, **kw):
        """All 20 epsilons as one batched sweep, members labelled by their
        epsilon (chunks of ``max_members_in_flight``, 10 by default)."""
        members = [SweepMember(float(e), label=str(e)) for e in eps_experiment_epsilons()]
        runner = SweepRunner(self.fusion_cfg, self.train_cfg, members, device=self.device, **kw)
        return runner.run(train_data, test_data, log_root=log_root or self.out_root)


@torch.no_grad()
def extract_feawei(
    params,
    fusion_cfg: fusion.FusionConfig,
    train_data: MultiModalArrays,
    out_path: Optional[str] = "feawei.pkl",
    batch_size: int = 8,
    device=None,
) -> np.ndarray:
    """The normalized fused features of every row of a split
    (past_acc_feawei.py:131-148), in batches of ``batch_size``: the eval-mode
    trunk, no draws. ``params`` may hold numpy arrays (a loaded checkpoint)."""
    dev = resolve_device(device)
    params = tree_map(lambda a: torch.as_tensor(a, device=dev), params)
    data = train_data.to_device(dev)
    feats = [fusion.apply(params, gather_batch(data, rows), fusion_cfg, 0.0, True, None, False,
                          return_features=True)
             for rows in torch.arange(len(train_data), device=dev).split(batch_size)]
    out = torch.cat(feats).cpu().numpy()
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    return out


class AlphaSweep:
    """ref train_val.py:524-543: the PriGumbel pretrainer over the
    privacy-regularized loss's alpha, exp(linspace(log 0.01, 2, 50)), one
    run per alpha under <out_root>/<alpha>/."""

    def __init__(self, fusion_cfg=None, out_root: str = "model_dict/PriGumbel/alpha",
                 bert_params=None, device=None):
        self.fusion_cfg = fusion_cfg or fusion.config_for("ti", "NDP")
        self.out_root = out_root
        self.base_cfg = PriGumbelConfig()
        self.bert_params = bert_params
        self.device = resolve_device(device)

    def alphas(self, n: int = 50):
        return alpha_sweep_values(n)

    def run(self, train_data, test_data, n: int = 50, echo: bool = False, alphas=None):
        """``alphas`` overrides the grid (e.g. a few of the reference's 50
        values); by default the reference's whole grid."""
        results = {}
        for alpha in (self.alphas(n) if alphas is None else alphas):
            cfg = dataclasses.replace(self.base_cfg, alpha=float(alpha))
            trainer = PriGumbelPretrainer(self.fusion_cfg, cfg, bert_params=self.bert_params,
                                          device=self.device)
            results[float(alpha)] = trainer.pretrain(
                train_data, test_data, path=os.path.join(self.out_root, f"{alpha:.4f}"),
                echo=echo)
        return results


def rewrite_val_to_test(root: str) -> int:
    """Rewrite 'Val' -> 'Test' in every *record*.txt under root (ref
    1224.py:12-31); returns the number of files rewritten."""
    count = 0
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".txt") and "record" in name:
                p = os.path.join(dirpath, name)
                with open(p) as f:
                    text = f.read()
                new = text.replace("Val Loss", "Test Loss").replace(
                    "Val Accuracy", "Test Accuracy")
                if new != text:
                    with open(p, "w") as f:
                        f.write(new)
                    count += 1
    return count
