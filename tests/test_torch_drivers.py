"""The port's six experiment drivers (experiments/drivers.py) against the JAX
package's: every grid equal, dict for dict; ``skip_completed``; and one
``Demo().run()`` on the CPU at a tiny BERT, from the reference's file
layout, through ``TrainAndTest.train``."""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.experiments import drivers as JDRV
from eeg_multimodal_torch.data import datasets as TD
from eeg_multimodal_torch.experiments import drivers as TDRV
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.train.api import TrainAndTest

DRIVERS = ("Demo", "CompareModal", "ComparePrivacyBudget", "ComparePrivateScheme",
           "CompareModelInitWeight", "CompareCrossModalType")
TINY = TB.BertConfig(vocab_size=50, num_layers=1, intermediate_size=64,
                     max_position_embeddings=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_grid_equals_jax(name):
    port, jax_ = getattr(TDRV, name)(device="cpu"), getattr(JDRV, name)()
    assert port.configs() == jax_.configs()
    assert len(port.configs()) == {"Demo": 1, "CompareModal": 4, "ComparePrivacyBudget": 20,
                                   "ComparePrivateScheme": 4, "CompareModelInitWeight": 6,
                                   "CompareCrossModalType": 2}[name]
    if name == "ComparePrivacyBudget":
        assert port.configs(representative=True) == jax_.configs(representative=True)
    if name == "CompareCrossModalType":
        kw = dict(train_type="compare_corss_model_type_3layers_v2", streams=("single_stream",))
        assert (TDRV.CompareCrossModalType(device="cpu", **kw).configs()
                == JDRV.CompareCrossModalType(**kw).configs())


def test_eps_lists_equal_jax():
    assert np.array_equal(TDRV.eps_list_20(), JDRV.eps_list_20())
    assert TDRV.eps_list_20().dtype == JDRV.eps_list_20().dtype
    assert TDRV.EPS_REPRESENTATIVE == JDRV.EPS_REPRESENTATIVE == [0.01, 0.1, 1.0]


class Recording(TrainAndTest):
    """A job that records the configs it is asked to train."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.trained = []

    def train(self, **cfg):
        self.trained.append(cfg["path_suffix"])
        return "trained"


def test_skip_completed(tmp_path):
    """A config is complete when its best_record.txt exists; ``run`` skips it
    only with ``skip_completed``."""
    drv = TDRV.ComparePrivateScheme(python_job=Recording(artifacts_root=str(tmp_path)))
    done = drv.configs()[1]
    assert not any(drv._completed(c) for c in drv.configs())
    logs = tmp_path / "logs" / done["train_type"] / done["path_suffix"]
    logs.mkdir(parents=True)
    (logs / "whole_record.txt").write_text("")
    assert not drv._completed(done)  # the whole record alone does not complete it
    (logs / "best_record.txt").write_text("")
    assert [drv._completed(c) for c in drv.configs()] == [False, True, False, False]
    out = drv.run(skip_completed=True)
    assert out["DPSGD/"] == "skipped (completed)"
    assert drv.python_job.trained == ["lapacian_dropout/", "lapacian_dropout_equal_weight/",
                                      "NDP/"]
    assert set(drv.run().values()) == {"trained"}


def write_split(root, split, n, seed):
    """``n`` ti rows as the reference's files (base_train.py:77-125): the
    label CSV, the EEG text's BERT token pickle, the act CLIP embeddings."""
    rng = np.random.RandomState(seed)
    processed = root / "data" / "processed"
    processed.mkdir(parents=True, exist_ok=True)
    (processed / f"{split}_label.csv").write_text(
        "label\n" + "".join(f"{x}\n" for x in rng.randint(0, 2, n)))
    mask = np.ones((n, 8), np.int32)
    mask[0, 5:] = 0
    ids = rng.randint(1, 50, (n, 8)).astype(np.int32) * mask
    for sub, obj in (("EEG/txt/bert_bert_base_uncased",
                      [{"input_ids": i[None], "attention_mask": m[None]}
                       for i, m in zip(ids, mask)]),
                     ("act/img/clip_ViT_B_32", rng.randn(n, 512).astype(np.float32))):
        path = root / "data" / "embedding" / sub
        path.mkdir(parents=True, exist_ok=True)
        with open(path / f"{split}.pickle", "wb") as f:
            pickle.dump(obj, f)


class TinyJob(TrainAndTest):
    """``TrainAndTest`` with the tiny BERT and the F1 threshold below any F1."""

    def run_configs(self, fusion_cfg, train_cfg):
        return (dataclasses.replace(fusion_cfg, bert_config=TINY),
                dataclasses.replace(train_cfg, f1_best_init=-1.0))


def test_demo_runs_on_cpu(tmp_path):
    """``Demo(python_job=...).run()``: one lapacian_dropout epoch at the bf16
    default from the files, its records and best checkpoint in the
    reference's layout; then ``run(skip_completed=True)`` skips it."""
    write_split(tmp_path, "train", 8, seed=0)
    write_split(tmp_path, "test", 4, seed=1)
    demo = TDRV.Demo(python_job=TinyJob(batch_size=4, epochs=1, echo=False,
                                        data_root=str(tmp_path), device="cpu"))
    out = demo.demo()
    assert list(out) == ["DPMLD/"] and len(out["DPMLD/"]["history"]) == 1
    assert np.isfinite(out["DPMLD/"]["history"][0]["train_loss"])
    assert demo.python_job.trainer.steps.compute_dtype == torch.bfloat16
    logs = tmp_path / "logs" / "demo" / "DPMLD"
    assert (logs / "whole_record.txt").exists() and (logs / "best_record.txt").exists()
    assert os.path.exists(tmp_path / "models" / "custom" / "demo" / "DPMLD" / "best_f1.pickle")
    assert demo.run(skip_completed=True) == {"DPMLD/": "skipped (completed)"}
