"""The port's pytree files, resumable training and pretrain -> finetune
pipeline, and its profiling helpers, on the CPU.

The port's ``Trainer`` is held against the JAX trainer step by step in
``test_torch_trainer.py``; here the pieces built on it are held to the
semantics of the JAX package's ``train/pipeline.py`` and
``utils/profiling.py``: ``save_pytree`` / ``load_pytree`` give back every
leaf bit for bit (bf16 as its bits, packed Adam moments as views of their
buffer again); ``Trainer.fit(start_epoch=1)`` after one epoch equals the
unbroken two-epoch fit bit for bit (the params, both optimizer states, the
second epoch's row); ``ResumableTrainer`` resumes from its state file and
reports a finished run; ``pretrain_finetune`` equals its two
``Trainer.fit`` calls, and with ``load_stat`` the finetune from that state
dict; ``save_pytree_dcp`` / ``load_pytree_dcp`` (the orbax backend's
counterpart) give back every leaf bit for bit, into a ``like`` tree and from
the checkpoint's metadata alone. The model: the flagship class with a 1-layer BERT of width 768 (the
fusion head's width), S = 8.
"""
import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.train import pipeline as JPL
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.ops.optim import AdamState
from eeg_multimodal_torch.train import checkpoint as TC
from eeg_multimodal_torch.train import pipeline as TPL
from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
from eeg_multimodal_torch.utils import profiling as TPR
from eeg_multimodal_torch.utils.trees import tree_items, tree_map
from test_torch_trainer import TINY, arrays

CFG = dataclasses.replace(TF.config_for("ti", "lapacian_dropout"),
                          bert_config=TB.BertConfig(**TINY))
EPS = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tc(epochs, **kw):
    return TrainConfig(batch_size=4, learning_rate=1e-3, epochs=epochs, **kw)


def data():
    return arrays(8, 0), arrays(4, 1)


def equal_trees(a, b):
    ia, ib = tree_items(a), tree_items(b)
    return [p for p, _ in ia] == [p for p, _ in ib] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(ia, ib))


def equal_states(a: AdamState, b: AdamState):
    return a.count == b.count and all(torch.equal(x, y) for x, y in zip(a.mu + a.nu,
                                                                        b.mu + b.nu))


def test_pytree_round_trip_keeps_every_leaf(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"f32": torch.randn(3, 4, generator=g),
            "bf16": [torch.randn(5, generator=g).bfloat16(), torch.tensor(1e-30).bfloat16()],
            "i64": torch.arange(6).reshape(2, 3), "np": np.arange(4, dtype=np.int32),
            "scalars": (3, 2.5, None, "name"), "empty": {}, "nested": {"a": [{"b": torch.ones(1)}]}}
    path = str(tmp_path / "sub" / "t.pickle")
    TC.save_pytree(path, tree)
    back = TC.load_pytree(path, "cpu")
    assert back["bf16"][0].dtype == torch.bfloat16 and torch.equal(back["bf16"][0],
                                                                    tree["bf16"][0])
    assert torch.equal(back["bf16"][1], tree["bf16"][1])  # a bf16 subnormal, bit for bit
    assert back["i64"].dtype == torch.int64 and torch.equal(back["i64"], tree["i64"])
    assert back["np"].dtype == torch.int32 and back["np"].tolist() == [0, 1, 2, 3]
    assert back["scalars"] == (3, 2.5, None, "name") and back["empty"] == {}
    assert torch.equal(back["f32"], tree["f32"]) and torch.equal(back["nested"]["a"][0]["b"],
                                                                 torch.ones(1))
    with open(path, "rb") as f:  # numpy leaves only: no torch object in the file
        raw = pickle.load(f)
    assert raw["tree"]["bf16"][0]["data"].dtype == np.uint16
    with pytest.raises(ValueError, match="save_pytree"):
        bad = str(tmp_path / "bad.pickle")
        with open(bad, "wb") as f:
            pickle.dump({"leaves": [], "treedef": None}, f)  # the JAX package's layout
        TC.load_pytree(bad, "cpu")


def test_save_pytree_dcp_round_trip(tmp_path):
    """The counterpart of tests/test_pipeline.py:104 (orbax): a tree of
    dicts, lists and tuples, f32, bf16 and int64 tensors and a scalar
    count, read back bit for bit into a ``like`` tree and from the
    metadata alone, with no process group."""
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(2, 3, generator=gen),
            "b": {"c": torch.ones(4), "layers": [{"k": torch.randn(3, generator=gen)},
                                                  {"k": torch.arange(3)}]},
            "moment": torch.randn(5, generator=gen).to(torch.bfloat16), "count": 7,
            "pair": (torch.zeros(1), torch.ones(2))}
    path = str(tmp_path / "dcp_ckpt")
    TC.save_pytree_dcp(path, tree)
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4), "layers": [
        {"k": torch.zeros(3)}, {"k": torch.zeros(3, dtype=torch.int64)}]},
        "moment": torch.zeros(5, dtype=torch.bfloat16), "count": 0,
        "pair": (torch.ones(1), torch.zeros(2))}
    for out in (TC.load_pytree_dcp(path, like=like), TC.load_pytree_dcp(path, device="cpu")):
        assert out["count"] == 7 and isinstance(out["pair"], tuple)
        got = dict(tree_items(out))
        assert sorted(got) == sorted(p for p, _ in tree_items(tree))
        for path, x in tree_items(tree):
            if torch.is_tensor(x):
                assert x.dtype == got[path].dtype, path
                np.testing.assert_array_equal(x.float().numpy(), got[path].float().numpy())
    assert torch.equal(like["a"], tree["a"])  # read in place



@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_dcp_restores_a_trainer_state_bit_for_bit(tmp_path, moments):
    """A trained flagship's params and both Adam states (a packed bf16
    moment as its flat buffer) through ``save_pytree_dcp``, read into a
    fresh trainer's trees (``like``): every leaf and count bit for bit, the
    packed moments' views reading the loaded buffers."""
    cfg = TrainConfig(batch_size=4, learning_rate=1e-3, epochs=1, adam_mu_dtype=moments,
                      adam_nu_dtype=moments)
    a = Trainer(CFG, cfg, device="cpu")
    a.fit(arrays(8, 1), arrays(4, 2), EPS, echo=False)
    state = {"params": a.params, "dp_os": a.dp_os.to_tree(), "model_os": a.model_os.to_tree()}
    path = str(tmp_path / "state")
    TC.save_pytree_dcp(path, state)
    b = Trainer(CFG, cfg, device="cpu")
    like = {"params": b.params, "dp_os": b.dp_os.to_tree(), "model_os": b.model_os.to_tree()}
    back = TC.load_pytree_dcp(path, like=like)
    for (p, x), (q, y) in zip(tree_items(state), tree_items(back)):
        assert p == q
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            assert x == y, p
    model_os = AdamState.from_tree(back["model_os"], [t for path, t in tree_items(b.params)
                                                      if path != "DP"])
    for m, n in zip(model_os.nu, a.model_os.nu):
        assert torch.equal(m, n)
    assert model_os.count == a.model_os.count == 2
    shutil.rmtree(path)  # a few hundred MB: the suite keeps its tmp dirs


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_resumed_fit_equals_the_unbroken_fit(tmp_path, moments):
    """One epoch, the train state through its file, then epoch 2 from
    ``start_epoch=1``: bit for bit the unbroken two-epoch run, packed bf16
    moments included (their views rebuilt over the loaded buffer)."""
    train, test = data()
    kw = dict(adam_mu_dtype=moments, adam_nu_dtype=moments, f1_best_init=0.0)
    whole = Trainer(CFG, tc(2, **kw), device="cpu")
    full = whole.fit(train, test, EPS, echo=False)

    first = Trainer(CFG, tc(1, **kw), device="cpu")
    first.fit(train, test, EPS, echo=False)
    path = str(tmp_path / "state.pickle")
    TPL.save_train_state(path, first, 0)
    second = Trainer(CFG, tc(2, **kw), device="cpu")
    assert TPL.load_train_state(path, second) == 0
    assert equal_trees(second.params, first.params)
    if moments == "bfloat16":
        buf = second.model_os.packed["mu"]
        assert all(m.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
                   for m in second.model_os.mu)
    hooked = []
    rest = second.fit(train, test, EPS, echo=False, start_epoch=1,
                      epoch_end_hook=hooked.append)
    assert hooked == [1] and [r["epoch"] for r in rest["history"]] == [2]
    assert equal_trees(second.params, whole.params)
    assert equal_states(second.model_os, whole.model_os)
    assert equal_states(second.dp_os, whole.dp_os)
    strip = ("time_cost",)
    assert {k: v for k, v in rest["history"][0].items() if k not in strip} == \
        {k: v for k, v in full["history"][1].items() if k not in strip}
    # the best restarts at f1_best_init on resume, as the JAX trainer's does
    assert rest["f1_best"] == max(0.0, rest["history"][0]["f1"])


def test_resumable_trainer_resumes_and_reports_a_finished_run(tmp_path):
    train, test = data()
    log = str(tmp_path / "run")
    out1 = TPL.ResumableTrainer(CFG, tc(1), device="cpu").fit(train, test, EPS, log_path=log,
                                                              echo=False)
    assert len(out1["history"]) == 1
    assert os.path.exists(os.path.join(log, TPL.ResumableTrainer.STATE_FILE))
    assert TPL.ResumableTrainer.STATE_FILE == JPL.ResumableTrainer.STATE_FILE
    done = TPL.ResumableTrainer(CFG, tc(1), device="cpu").fit(train, test, EPS, log_path=log,
                                                              echo=False)
    assert done == {"history": [], "best": None, "f1_best": None, "resumed_complete": True}
    more = TPL.ResumableTrainer(CFG, tc(2), device="cpu")
    out2 = more.fit(train, test, EPS, log_path=log, echo=False)
    assert [r["epoch"] for r in out2["history"]] == [2]
    whole = Trainer(CFG, tc(2), device="cpu")
    whole.fit(train, test, EPS, echo=False)
    assert equal_trees(more.params, whole.params)
    with open(os.path.join(log, "whole_record.txt")) as f:
        assert f.read().count("Epochs:") == 2  # the record goes on where it stopped


CONFIG_FOR = TF.config_for


def small_config_for(*a, **kw):
    return dataclasses.replace(CONFIG_FOR(*a, **kw), bert_config=TB.BertConfig(**TINY))


def test_pretrain_finetune_equals_its_two_fits(tmp_path, monkeypatch):
    monkeypatch.setattr(TPL.fusion, "config_for", small_config_for)
    train, test = data()
    cfg = TPL.PipelineConfig(epsilon=EPS, pretrain_epochs=1, finetune_epochs=1, batch_size=4,
                             learning_rate=1e-3)
    assert dataclasses.asdict(TPL.PipelineConfig()) == dataclasses.asdict(JPL.PipelineConfig())
    out = TPL.pretrain_finetune(train, test, str(tmp_path / "a"), cfg, echo=False,
                                device="cpu")
    pre = Trainer(small_config_for("ti", "NDP"), tc(1), device="cpu")
    want_pre = pre.fit(train, test, 0.0, echo=False)
    fin = Trainer(small_config_for("ti", "feature_all_lap"), tc(1),
                  params=tree_map(torch.clone, pre.params), device="cpu")
    want_fin = fin.fit(train, test, EPS, echo=False)

    def rows(result):
        return [{k: v for k, v in r.items() if k != "time_cost"} for r in result["history"]]

    assert rows(out["pretrain"]) == rows(want_pre) and rows(out["finetune"]) == rows(want_fin)
    for sub in ("pretrain", "fineturn"):  # the reference's directory names
        assert os.path.exists(tmp_path / "a" / sub / "whole_record.txt")

    stat = str(tmp_path / "pre.pickle")  # the reference's state-dict format
    TC.save_torch_checkpoint(stat, pre.params, small_config_for("ti", "NDP"))
    out2 = TPL.pretrain_finetune(train, test, str(tmp_path / "b"), cfg, echo=False,
                                 load_stat=stat, device="cpu")
    assert out2["pretrain"] is None and rows(out2["finetune"]) == rows(want_fin)


def test_step_timer_trace_and_finite_guards():
    """The finite guards (the port's tracing is ``span``, tests/test_torch_spans.py)."""
    TPR.assert_finite({"a": torch.ones(2), "i": torch.arange(3)}, "ok")
    with pytest.raises(FloatingPointError, match="params at b/1"):
        TPR.assert_finite({"b": [torch.ones(1), torch.tensor([1.0, float("nan")])]}, "params")
    with pytest.raises(FloatingPointError):
        TPR.assert_finite({"c": torch.tensor([float("inf")]).bfloat16()})
    try:
        TPR.debug_nan_check(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()  # a NaN made by a backward
    finally:
        TPR.debug_nan_check(False)
    assert not torch.is_anomaly_enabled()
