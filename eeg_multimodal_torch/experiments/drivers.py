"""The six experiment drivers (ref: python/src/custom_models/{demo,compare_*}.py).

Port of the JAX package's ``experiments/drivers.py``: thin config generators
over the port's ``TrainAndTest``, with the exact grids of the reference,

  Demo                   : ti/double/bert-uncased/ViT-B-32, lapacian_dropout,
                           eps=0.1 (demo.py:30-55)
  CompareModal           : ti/tt/it/ii (compare_modal.py:41-108)
  ComparePrivacyBudget   : 20-pt logspace eps 0.01..5.0 + representative
                           [0.01, 0.1, 1.0] (compare_privacy_budget.py:50-62)
  ComparePrivateScheme   : lapacian_dropout / DPSGD / equal-weight / NDP
                           (compare_private_scheme.py:53-78)
  CompareModelInitWeight : bert-{un,}cased x {ViT-B/32, ViT-B/16, resnet34}
                           (compare_model_ini_weight.py:58-69)
  CompareCrossModalType  : double_stream vs single_stream
                           (compare_cross_modal_type.py:50-63)

Each driver's ``configs()`` is its grid as a list of ``TrainAndTest.train``
keyword sets; ``run`` trains them one after the other, on the card unless
the job was built with ``device="cpu"``.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..train.api import TrainAndTest


class _Driver:
    def __init__(self, python_job: TrainAndTest = None, **kw):
        self.python_job = python_job or TrainAndTest(**kw)

    def configs(self) -> List[Dict]:
        raise NotImplementedError

    def _completed(self, cfg) -> bool:
        """A config is complete when its best_record.txt exists, the presence
        check the reference's plot tooling relies on
        (visualization/plot.py:147-149)."""
        return os.path.exists(os.path.join(
            self.python_job.artifacts_root, "logs", cfg["train_type"],
            cfg["path_suffix"], "best_record.txt",
        ))

    def run(self, skip_completed: bool = False):
        results = {}
        for cfg in self.configs():
            if skip_completed and self._completed(cfg):
                results[cfg["path_suffix"]] = "skipped (completed)"
                continue
            results[cfg["path_suffix"]] = self.python_job.train(**cfg)
        return results


_BASE = dict(
    multimodal_type="ti",
    dp_mode="lapacian_dropout",
    eeg_model="bert",
    eeg_model_coef="bert-base-uncased",
    act_model="clip",
    act_model_coef="ViT-B/32",
    cross_atn_type="double_stream",
    epsilon=0.1,
)


class Demo(_Driver):
    """ref demo.py: one DP-MLD run at eps=0.1."""

    def configs(self):
        return [dict(_BASE, train_type="demo", path_suffix="DPMLD/")]

    def demo(self):
        return self.run()


class CompareModal(_Driver):
    """ref compare_modal.py: the four modality pairings."""

    def configs(self):
        out = []
        for mt in ("ti", "tt", "it", "ii"):
            eeg_model, eeg_coef = ("bert", "bert-base-uncased") if mt[0] == "t" else (
                "clip", "ViT-B/32")
            act_model, act_coef = ("bert", "bert-base-uncased") if mt[1] == "t" else (
                "clip", "ViT-B/32")
            out.append(dict(_BASE, train_type="compare_modal", path_suffix=f"{mt}/",
                            multimodal_type=mt, eeg_model=eeg_model, eeg_model_coef=eeg_coef,
                            act_model=act_model, act_model_coef=act_coef))
        return out


def eps_list_20() -> np.ndarray:
    """np.around(logspace(log10(0.01), log10(5.0), 20), 3)
    (compare_privacy_budget.py:52-53)."""
    return np.around(np.logspace(np.log10(0.01), np.log10(5.0), 20), decimals=3)


EPS_REPRESENTATIVE = [0.01, 0.1, 1.0]  # compare_privacy_budget.py:60


class ComparePrivacyBudget(_Driver):
    def configs(self, representative: bool = False):
        eps = EPS_REPRESENTATIVE if representative else eps_list_20()
        sub = "eps_representative" if representative else "eps_list"
        return [dict(_BASE, train_type="compare_privacy_budget", path_suffix=f"{sub}/{e}/",
                     epsilon=float(e))
                for e in eps]

    def run_eps_list(self):
        return self._run(self.configs(representative=False))

    def run_representative_list(self):
        return self._run(self.configs(representative=True))

    def _run(self, cfgs):
        return {c["path_suffix"]: self.python_job.train(**c) for c in cfgs}


class ComparePrivateScheme(_Driver):
    """ref compare_private_scheme.py: the four DP schemes."""

    SCHEMES = ("lapacian_dropout", "DPSGD", "lapacian_dropout_equal_weight", "NDP")

    def configs(self):
        return [dict(_BASE, train_type="compare_private_scheme", path_suffix=f"{scheme}/",
                     dp_mode=scheme)
                for scheme in self.SCHEMES]


class CompareModelInitWeight(_Driver):
    """ref compare_model_ini_weight.py: encoder-init grid (note the
    reference's output dir is spelled 'compare_model_ini_wight')."""

    TXT = ("bert-base-uncased", "bert-base-cased")
    IMG = (("clip", "ViT-B/32"), ("clip", "ViT-B/16"), ("resnet", "resnet34"))

    def configs(self):
        return [dict(_BASE, train_type="compare_model_ini_wight",
                     path_suffix=f"{txt_coef}_{img_coef.replace('/', '_')}/",
                     eeg_model_coef=txt_coef, act_model=img_model, act_model_coef=img_coef)
                for txt_coef in self.TXT for img_model, img_coef in self.IMG]


class CompareCrossModalType(_Driver):
    """ref compare_cross_modal_type.py. The committed logs carry three
    train_type labels from successive runs of the same driver:
    'compare_corss_model_type' (both streams),
    'compare_corss_model_type_3layers' (single stream only) and the source's
    current default 'compare_corss_model_type_3layers_v2'
    (compare_cross_modal_type.py:32); the model is the same (TISC has always
    had 3 encoder layers, models.py:257), only the output dir differs.
    ``train_type`` selects the label; ``streams`` mirrors the reference's
    run(), which at HEAD runs single_stream only (:60-63)."""

    def __init__(self, train_type: str = "compare_corss_model_type",
                 streams=("double_stream", "single_stream"), **kw):
        super().__init__(**kw)
        self.train_type = train_type
        self.streams = tuple(streams)

    def configs(self):
        return [dict(_BASE, train_type=self.train_type, path_suffix=f"{stream}/",
                     cross_atn_type=stream)
                for stream in self.streams]
