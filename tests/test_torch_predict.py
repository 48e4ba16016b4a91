"""``TrainAndTest.predict`` (train/api.py) on the CPU: a checkpoint that the
JAX package wrote, over a tiny data tree in the reference's layout, at the
tiny width of test_torch_trainer.py. Held: its numbers equal the port's
``eval_epoch`` on the loaded params (exactly: the same computation), its CSV
is the JAX package's format byte for byte, and a word table too small for
the data's ids raises ``ValueError`` before any forward.
"""
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.train import checkpoint as JCK
from eeg_multimodal_tpu.train.api import TrainAndTest as JTrainAndTest
from eeg_multimodal_torch.data import datasets as TD
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.train import api as TAPI
from eeg_multimodal_torch.train.checkpoint import load_torch_checkpoint
from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig
from eeg_multimodal_torch.utils.seeding import DEFAULT_SEED, generator
from test_torch_trainer import TINY

N, S, VOCAB = 10, 16, 50
JCFG = dataclasses.replace(JF.config_for("ti", "lapacian_dropout"),
                           bert_config=JB.BertConfig(**TINY))
PCFG = dataclasses.replace(TF.config_for("ti", "lapacian_dropout"),
                           bert_config=TB.BertConfig(**TINY))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A test split in the reference's on-disk layout (base_train.py:77-125)
    and a checkpoint of the JAX package's init, written by the JAX package."""
    root = tmp_path_factory.mktemp("predict")
    rng = np.random.RandomState(0)
    processed = root / "data" / "processed"
    processed.mkdir(parents=True)
    labels = rng.randint(0, 2, N)
    (processed / "test_label.csv").write_text("label\n" + "".join(f"{x}\n" for x in labels))
    items = []
    for n in range(N):
        valid = rng.randint(4, 12)
        mask = (np.arange(S) < valid).astype(np.int64)[None]
        items.append({"input_ids": rng.randint(0, VOCAB, (1, S)) * mask, "attention_mask": mask})
    for sub, obj in (("EEG/txt/bert_bert_base_uncased", items),
                     ("act/img/clip_ViT_B_32", rng.randn(N, 512).astype(np.float32))):
        path = root / "data" / "embedding" / sub
        path.mkdir(parents=True)
        with open(path / "test.pickle", "wb") as f:
            pickle.dump(obj, f)
    jparams = JF.init(jax.random.PRNGKey(3), JCFG)
    JCK.save_torch_checkpoint(str(root / "best_f1.pickle"), jparams, JCFG)
    return root


def port_api(root):
    return TAPI.TrainAndTest(batch_size=4, data_root=str(root), compute_dtype="float32",
                             echo=False, device="cpu")


@pytest.mark.parametrize("n_eval", [1, 3])
def test_predict_equals_eval_epoch_on_the_loaded_checkpoint(tree, n_eval):
    out = port_api(tree).predict(str(tree / "best_f1.pickle"), n_eval=n_eval,
                                 bert_config=TB.BertConfig(**TINY))
    assert set(out) == {"loss", "accuracy", "f1", "predictions", "labels", "scores"}

    # the same epoch by hand: the split, the params, the unshuffled batches
    api = port_api(tree)
    data = TD.truncate_tokens(api._load_split("test", "ti", "bert", "bert-base-uncased", "clip",
                                              "ViT-B/32"))
    params = load_torch_checkpoint(str(tree / "best_f1.pickle"), PCFG, "cpu")
    steps = StepFunctions(PCFG, TrainConfig(batch_size=4, n_eval=n_eval), "cpu")
    idx, w = TD.epoch_indices(N, 4, False)
    loss, _, preds, labels, scores, ws = steps.eval_epoch(
        params, data.to_device("cpu"), idx, w, 0.1, generator(DEFAULT_SEED))
    valid = ws > 0
    assert len(out["predictions"]) == N and int(valid.sum()) == N
    assert out["loss"] == float(loss)
    np.testing.assert_array_equal(out["predictions"], preds[valid].numpy())
    np.testing.assert_array_equal(out["labels"], labels[valid].numpy())
    np.testing.assert_array_equal(out["labels"], data.labels)
    np.testing.assert_array_equal(out["scores"], scores[valid].numpy())
    assert out["accuracy"] == float((out["predictions"] == out["labels"]).mean())
    tp = int(((out["predictions"] == 1) & (out["labels"] == 1)).sum())
    wrong = int((out["predictions"] != out["labels"]).sum())
    assert out["f1"] == pytest.approx(2 * tp / (2 * tp + wrong) if tp + wrong else 0.0)


def test_predict_writes_the_jax_packages_csv(tree, tmp_path):
    """The port's file is JAX's writer applied to the port's numbers; the
    JAX package's own predict on the same tree writes the same header, the
    same index and label columns and the same line format (its DP noise is
    threefry's, so its predictions and scores are other draws)."""
    path = tmp_path / "out" / "pred.csv"
    out = port_api(tree).predict(str(tree / "best_f1.pickle"), n_eval=2, out_csv=str(path),
                                 bert_config=TB.BertConfig(**TINY))
    want = "index,prediction,label,score\n" + "".join(
        f"{i},{int(p)},{int(l)},{float(s):.6f}\n"
        for i, (p, l, s) in enumerate(zip(out["predictions"], out["labels"], out["scores"])))
    assert path.read_bytes() == want.encode()
    jpath = tmp_path / "jax.csv"
    JTrainAndTest(batch_size=4, data_root=str(tree), compute_dtype="float32", echo=False).predict(
        str(tree / "best_f1.pickle"), n_eval=2, out_csv=str(jpath),
        bert_config=JB.BertConfig(**TINY))
    ours, theirs = (p.read_text().splitlines() for p in (path, jpath))
    assert ours[0] == theirs[0] and len(ours) == len(theirs) == N + 1
    for a, b in zip(ours[1:], theirs[1:]):
        (ia, pa, la, sa), (ib, pb, lb, sb) = a.split(","), b.split(",")
        assert (ia, la) == (ib, lb) and pa in "01" and pb in "01"
        assert len(sa.split(".")[1]) == len(sb.split(".")[1]) == 6


def test_a_word_table_too_small_raises_before_any_forward(tree, tmp_path, monkeypatch):
    with open(tree / "best_f1.pickle", "rb") as f:
        sd = pickle.load(f)
    key = "bert.embeddings.word_embeddings.weight"
    sd[key] = sd[key][:20]  # ids run to VOCAB - 1 = 49
    path = tmp_path / "small.pickle"
    with open(path, "wb") as f:
        pickle.dump(sd, f)

    def no_forward(*args, **kwargs):
        raise AssertionError("a forward ran")

    monkeypatch.setattr(TAPI.StepFunctions, "eval_epoch", no_forward)
    monkeypatch.setattr(TF, "apply", no_forward)
    with pytest.raises(ValueError, match="out of range for the checkpoint's 20-row"):
        port_api(tree).predict(str(path), bert_config=TB.BertConfig(**TINY))
    assert not os.path.exists(tmp_path / "out")
