"""The port's 512-token path around the trainer against the JAX package, on
the CPU: the file loaders, the legacy records, checkpoints in both
directions (all compared exactly), and
``TrainAndTest.train_on(auto_truncate=False)`` -> ``Trainer.fit`` end to end.
The step itself at S = 512 is held against JAX in test_torch_trainer512.py.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.data import datasets as JD
from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.train import checkpoint as JC
from eeg_multimodal_tpu.train import records as JR
from eeg_multimodal_torch.data import datasets as TD
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models.convert import params_to_numpy
from eeg_multimodal_torch.ops import attention as TA
from eeg_multimodal_torch.ops import dp_fused
from eeg_multimodal_torch.train import checkpoint as TCK
from eeg_multimodal_torch.train import records as TR
from eeg_multimodal_torch.train.api import TrainAndTest, standardize_coef
from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
from eeg_multimodal_torch.utils.trees import tree_items, tree_map

S, EPS = 512, 0.5
TINY = dict(vocab_size=50, hidden_size=768, num_layers=1, num_heads=12,
            intermediate_size=64, max_position_embeddings=S)
JCFG = dataclasses.replace(JF.config_for("ti", "lapacian_dropout"),
                           bert_config=JB.BertConfig(**TINY), fused_dp_kernel=True)
PCFG = dataclasses.replace(TF.config_for("ti", "lapacian_dropout"),
                           bert_config=TB.BertConfig(**TINY), fused_dp_kernel=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows(n, seed, valid=65):
    """``n`` ti rows of ``valid`` tokens padded to S = 512, made with numpy."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((n, S), np.int32)
    mask[:, :valid] = 1
    mask[0, valid // 2:] = 0
    return TD.MultiModalArrays(
        rng.randint(0, 50, (n, S)).astype(np.int32), mask,
        rng.randn(n, 1, 512).astype(np.float32), np.ones((n, 1), np.int32),
        rng.randint(0, 2, n).astype(np.int32), "ti")


@pytest.fixture(scope="module")
def weights():
    """One weight set, drawn by the port's init, as numpy."""
    return params_to_numpy(TF.init(PCFG, seed=0, device="cpu"))


def port_params(weights):
    return tree_map(lambda a: torch.from_numpy(a.copy()), weights)


def test_loaders_match_jax(tmp_path):
    labels = tmp_path / "train_label.csv"
    labels.write_text("label\n1\n\nnan\n0\n1.0\n")
    rng = np.random.RandomState(0)
    items = [{"input_ids": rng.randint(0, 99, (1, 12)), "attention_mask": np.ones((1, 12))}
             for _ in range(3)]
    with open(tmp_path / "bert.pickle", "wb") as f:
        pickle.dump(items, f)
    with open(tmp_path / "emb.pickle", "wb") as f:
        pickle.dump(rng.randn(3, 512), f)
    for ours, theirs, name in ((TD.load_label_csv, JD.load_label_csv, "train_label.csv"),
                               (TD.load_embedding_pickle, JD.load_embedding_pickle,
                                "emb.pickle")):
        a, b = ours(str(tmp_path / name)), theirs(str(tmp_path / name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ours, theirs = (f(str(tmp_path / "bert.pickle"))
                    for f in (TD.load_bert_pickle, JD.load_bert_pickle))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert standardize_coef("ViT-B/32") == "ViT_B_32"


def test_legacy_records_match_jax():
    for nums in ((0, 0.6931, 0.5, 0.7012, 0.4375, 0.5, 12.34),
                 (41, -1.0, 1.0, 1e-4, 0.0, 0.98765, 0.05)):
        ours = TR.legacy_record(*nums, record_time="2026-10-16 12:00:00")
        assert ours == JR.legacy_record(*nums, record_time="2026-10-16 12:00:00")
        assert TR.parse_legacy_records(ours * 2) == JR.parse_legacy_records(ours * 2)


def test_checkpoints_load_in_both_packages(tmp_path, weights):
    # the port writes, JAX reads
    params = port_params(weights)
    TCK.save_torch_checkpoint(str(tmp_path / "port.pickle"), params, PCFG)
    loaded = JC.load_torch_checkpoint(str(tmp_path / "port.pickle"), JCFG)
    got = dict(tree_items(jax.tree_util.tree_map(np.asarray, loaded)))
    assert sorted(got) == sorted(p for p, _ in tree_items(params))
    for path, leaf in tree_items(params):
        np.testing.assert_array_equal(got[path], leaf.numpy(), err_msg=path)
    assert set(TCK.fusion_to_torch_state_dict(params, PCFG)) == \
        set(JC.fusion_to_torch_state_dict(loaded, JCFG))
    # JAX writes (its own init), the port reads, also under Opacus's prefix
    jparams = JF.init(jax.random.PRNGKey(3), JCFG)
    JC.save_torch_checkpoint(str(tmp_path / "jax.pickle"), jparams, JCFG)
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jparams)))
    ours = TCK.load_torch_checkpoint(str(tmp_path / "jax.pickle"), PCFG, device="cpu")
    assert sorted(p for p, _ in tree_items(ours)) == sorted(want)
    for path, leaf in tree_items(ours):
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    sd = {"_module." + k: v for k, v in JC.fusion_to_torch_state_dict(jparams, JCFG).items()}
    wrapped = TCK.fusion_from_torch_state_dict(sd, PCFG, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(wrapped),
                                                            tree_items(ours)))


def test_train_and_test_runs_the_512_token_path_on_cpu(tmp_path):
    train, test = rows(8, seed=2), rows(4, seed=3)
    launches = [k.launches for k in TA.KERNELS + dp_fused.KERNELS]
    api = TrainAndTest(batch_size=4, learning_rate=1e-3, epochs=2, compute_dtype="float32",
                       echo=False, artifacts_root=str(tmp_path), device="cpu")
    out = api.train_on(train, test, "DPMLD", "run/", "ti", "lapacian_dropout",
                       bert_config=TB.BertConfig(**TINY), auto_truncate=False)
    assert [k.launches for k in TA.KERNELS + dp_fused.KERNELS] == launches
    assert set(out) == {"history", "best", "f1_best"} and len(out["history"]) == 2
    for row in out["history"]:
        assert all(np.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1"))
    assert float(api.trainer.params["DP"].abs().max()) > 0  # DP trained from zeros
    logs = tmp_path / "logs" / "DPMLD" / "run"
    recs = TR.parse_legacy_records((logs / "whole_record.txt").read_text())
    assert [r["epoch"] for r in recs] == [1, 2]
    assert recs == JR.parse_legacy_records((logs / "whole_record.txt").read_text())
    assert len((logs / "metrics.jsonl").read_text().splitlines()) == 2
    ckpt = tmp_path / "models" / "custom" / "DPMLD" / "run" / "best_f1.pickle"
    improved = out["f1_best"] > 0.5
    assert ckpt.exists() == improved and (logs / "best_record.txt").exists() == improved


def test_fit_writes_a_forced_checkpoint_and_flushes_it_when_a_hook_raises(tmp_path):
    train, test = rows(4, seed=4), rows(4, seed=5)
    cfg = TrainConfig(batch_size=4, learning_rate=1e-3, epochs=1, f1_best_init=-1.0)
    trainer = Trainer(PCFG, cfg, device="cpu")
    path = str(tmp_path / "a" / "best_f1.pickle")
    out = trainer.fit(train, test, EPS, log_path=str(tmp_path / "logs"), model_path=path,
                      echo=False)
    assert out["best"]["epoch"] == 1
    loaded = TCK.load_torch_checkpoint(path, PCFG, device="cpu")
    for (p, a), (_, b) in zip(tree_items(loaded), tree_items(trainer.params)):
        assert torch.equal(a, b), p
    assert (tmp_path / "logs" / "best_record.txt").exists()

    def boom(epoch):
        raise RuntimeError("stop")

    cfg = dataclasses.replace(cfg, epochs=3, defer_flush_epochs=0)
    path = str(tmp_path / "b" / "best_f1.pickle")
    with pytest.raises(RuntimeError, match="stop"):
        Trainer(PCFG, cfg, device="cpu").fit(train, test, EPS, model_path=path,
                                              echo=False, epoch_end_hook=boom)
    assert os.path.exists(path)  # the pending best, written in finally


@pytest.mark.parametrize("defer", [False, True])
def test_fit_writes_the_best_at_the_improving_epoch_unless_deferred(tmp_path, defer):
    train, test = rows(4, seed=4), rows(4, seed=5)
    cfg = TrainConfig(batch_size=4, learning_rate=1e-3, epochs=2, f1_best_init=-1.0,
                      defer_best_checkpoint=defer)
    trainer = Trainer(PCFG, cfg, device="cpu")
    path = str(tmp_path / "best_f1.pickle")
    seen = {}

    def hook(epoch):
        if epoch == 0:  # epoch 0 improves on -1; its params are still the live ones
            seen["written"] = os.path.exists(path)
            if seen["written"]:
                loaded = TCK.load_torch_checkpoint(path, PCFG, device="cpu")
                seen["equal"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
                    tree_items(loaded), tree_items(trainer.params)))

    trainer.fit(train, test, EPS, model_path=path, echo=False, epoch_end_hook=hook)
    assert seen == ({"written": False} if defer else {"written": True, "equal": True})
    assert os.path.exists(path)


def test_what_waits_is_refused():
    """``precast_params`` with a fast mode is refused as the JAX package
    refuses it. Every other ``TrainConfig`` field of the JAX package is
    accepted. (Nothing of ``train_on`` waits any more: DP-SGD trains, in
    test_torch_dpsgd.py.)"""
    for fast in (dict(share_phase_dropout=True), dict(paired_phase_encode=True)):
        with pytest.raises(ValueError, match="precast_params"):
            TrainConfig(compute_dtype="bfloat16", precast_params=True, **fast)
    for field in (dict(n_eval=5), dict(shuffle_eval=True), dict(share_phase_dropout=True),
                  dict(share_phase_dropout=True, reuse_phase_features=True),
                  dict(paired_phase_encode=True)):
        TrainConfig(**field)


def test_train_and_test_runs_its_bf16_default_with_a_compact_vocab_on_cpu(tmp_path):
    """``TrainAndTest()`` at its default ``compute_dtype="bfloat16"`` through
    ``train_on(compact_vocab=True)`` end to end: truncated rows, the bf16
    forward on a copy of the f32 masters, records, and a trainer whose
    checkpoint scatters the compact word table back to full-vocab rows."""
    train, test = rows(8, seed=8), rows(4, seed=9)
    launches = [k.launches for k in TA.KERNELS + dp_fused.KERNELS]
    api = TrainAndTest(batch_size=4, learning_rate=1e-3, epochs=2, echo=False,
                       artifacts_root=str(tmp_path), device="cpu")
    assert api.compute_dtype == "bfloat16"
    out = api.train_on(train, test, "DPMLD", "bf16/", "ti", "lapacian_dropout",
                       bert_config=TB.BertConfig(**TINY), compact_vocab=True)
    assert [k.launches for k in TA.KERNELS + dp_fused.KERNELS] == launches
    tr = api.trainer
    assert tr.steps.compute_dtype == torch.bfloat16 and not tr.steps.precast
    for row in out["history"]:
        assert all(np.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1"))
    assert all(leaf.dtype == torch.float32 for _, leaf in tree_items(tr.params))  # masters
    assert float(tr.params["DP"].abs().max()) > 0
    words = tr.params["bert"]["embeddings"]["word"].shape[0]
    assert tr.vocab is not None and words == tr.vocab.size
    assert tr.export_params()["bert"]["embeddings"]["word"].shape == (50, 768)
    logs = tmp_path / "logs" / "DPMLD" / "bf16"
    assert [r["epoch"] for r in TR.parse_legacy_records(
        (logs / "whole_record.txt").read_text())] == [1, 2]
