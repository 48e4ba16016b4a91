"""The port's compact vocabulary (data/compact_vocab.py) against the JAX
package's, on the CPU: the same arrays, a step on the compact table that is
the full-vocab step on the rows it uses, and checkpoints that scatter the
table back to full-vocab rows for the JAX loader."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.data import compact_vocab as JV
from eeg_multimodal_tpu.data import datasets as JD
from eeg_multimodal_tpu.train import checkpoint as JC
from eeg_multimodal_torch.data import compact_vocab as V
from eeg_multimodal_torch.train import checkpoint as TCK
from eeg_multimodal_torch.train.api import TrainAndTest
from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig, Trainer
from eeg_multimodal_torch.utils.trees import tree_items, tree_map
from test_torch_api import JCFG, PCFG, port_params, rows, weights  # noqa: F401

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


def test_build_and_remap_give_the_jax_arrays():
    rng = np.random.RandomState(0)
    streams = [rng.randint(0, 30522, (6, 20)).astype(np.int32), np.int32([[101, 7, 102, 0]])]
    ours, theirs = V.build_compact_vocab(streams), JV.build_compact_vocab(streams)
    for name in ("new_to_old", "old_to_new"):
        assert getattr(ours, name).dtype == getattr(theirs, name).dtype
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    assert (ours.size, ours.full_vocab, ours.pad_id, ours.cls_id) == \
        (theirs.size, theirs.full_vocab, theirs.pad_id, theirs.cls_id)
    ids = np.int32([[5, 101, 29999]])  # 5 and 29999 unused: both go to [UNK]
    np.testing.assert_array_equal(ours.remap(ids), theirs.remap(ids))
    table = rng.randn(30522, 4).astype(np.float32)
    np.testing.assert_array_equal(ours.compact_embeddings(table), theirs.compact_embeddings(table))
    np.testing.assert_array_equal(ours.compact_embeddings(torch.from_numpy(table)).numpy(),
                                  theirs.compact_embeddings(table))
    small = table[: ours.size]
    np.testing.assert_array_equal(ours.expand_embeddings(small), theirs.expand_embeddings(small))
    data = rows(4, seed=1)
    jdata = JD.MultiModalArrays(*(getattr(data, f.name) for f in dataclasses.fields(data)))
    vocab = V.build_compact_vocab([data.eeg_input])
    ours_d = V.remap_pairing(data, vocab)
    theirs_d = JV.remap_pairing(jdata, JV.build_compact_vocab([jdata.eeg_input]))
    for f in dataclasses.fields(ours_d):
        np.testing.assert_array_equal(getattr(ours_d, f.name), getattr(theirs_d, f.name))


def compact_setup(weights):
    """Rows that use token ids 0-29 of the 50, their compact vocab, and the
    full and compact f32 configs and params."""
    data = rows(4, seed=2)
    data.eeg_input = data.eeg_input % 30
    vocab = V.build_compact_vocab([data.eeg_input], full_vocab=50)
    assert vocab.size == 30
    cfg = dataclasses.replace(PCFG, bert_config=dataclasses.replace(
        PCFG.bert_config, vocab_size=vocab.size))
    full = port_params(weights)
    compact = tree_map(torch.clone, full)
    compact["bert"]["embeddings"]["word"] = vocab.compact_embeddings(
        full["bert"]["embeddings"]["word"]).clone()
    return data, vocab, cfg, full, compact


def test_a_compact_step_is_the_full_step_on_the_rows_it_uses(weights):
    """One f32 alternating step (dropout off, the DP noise handed across) on
    the compact table and on the full one: every leaf equal within the f32
    step tests' rtol 1e-4 / atol 1e-5 (the word table row for row), and the
    rows no id gathers unchanged, exactly."""
    data, vocab, cfg, full, compact = compact_setup(weights)
    noise = tuple(torch.from_numpy(np.random.RandomState(i).laplace(size=(4, 2304))).float()
                  for i in range(2))
    out = {}
    for name, config, params, d in (("full", PCFG, full, data),
                                    ("compact", cfg, compact, V.remap_pairing(data, vocab))):
        steps = StepFunctions(config, TrainConfig(batch_size=4, learning_rate=1e-3),
                              device="cpu")
        states = steps.init_opt_states(params)
        steps.train_step(params, *states, d.to_device("cpu"), torch.ones(4), EPS,
                         torch.Generator().manual_seed(0), dp_noise=noise, dropout=False)
        out[name] = dict(tree_items(params))
    word_full = out["full"].pop("bert/embeddings/word")
    word = out["compact"].pop("bert/embeddings/word")
    used = torch.from_numpy(vocab.new_to_old).long()
    torch.testing.assert_close(word, word_full[used], rtol=1e-4, atol=1e-5)
    unused = torch.ones(50, dtype=torch.bool)
    unused[used] = False
    word0 = torch.from_numpy(weights["bert"]["embeddings"]["word"])
    assert torch.equal(word_full[unused], word0[unused])
    assert not torch.equal(word_full[used], word0[used])
    for path, leaf in out["full"].items():
        torch.testing.assert_close(out["compact"][path], leaf, rtol=1e-4, atol=1e-5, msg=path)


def test_a_checkpoint_under_a_compact_vocab_loads_in_jax_with_full_rows(tmp_path, weights):
    """``Trainer.export_params`` scatters the compact table to full-vocab rows
    (the unused ones 0); the JAX loader reads the file with the full config."""
    _, vocab, cfg, _, compact = compact_setup(weights)
    trainer = Trainer(cfg, TrainConfig(batch_size=4), params=compact, device="cpu", vocab=vocab)
    path = str(tmp_path / "best_f1.pickle")
    TCK.save_torch_checkpoint(path, trainer.export_params(), cfg)
    loaded = dict(tree_items(jax.tree_util.tree_map(np.asarray,
                                                    JC.load_torch_checkpoint(path, JCFG))))
    word = loaded.pop("bert/embeddings/word")
    assert word.shape == (50, 768)
    np.testing.assert_array_equal(word[vocab.new_to_old],
                                  compact["bert"]["embeddings"]["word"].numpy())
    assert not word[30:].any()  # ids 30-49 unused
    for p, leaf in tree_items(compact):
        if p != "bert/embeddings/word":
            np.testing.assert_array_equal(loaded[p], leaf.numpy(), err_msg=p)
    assert trainer.export_params()["bert"]["embeddings"]["word"].shape == (50, 768)
    assert trainer.params["bert"]["embeddings"]["word"].shape == (30, 768)  # the live tree


@pytest.mark.parametrize("prebuilt", [False, True])
def test_train_on_runs_with_a_compact_or_a_prebuilt_vocab(tmp_path, prebuilt):
    """``train_on(compact_vocab=True)`` remaps the rows and shrinks the word
    table (JAX api.py:165-184); ``vocab=`` takes a caller's remapped rows.
    Either way the trainer keeps the vocab for the checkpoint's scatter."""
    train, test = rows(4, seed=3), rows(4, seed=4)
    for d in (train, test):
        d.eeg_input = d.eeg_input % 20
    api = TrainAndTest(batch_size=4, epochs=1, echo=False, artifacts_root=str(tmp_path),
                       device="cpu", compute_dtype="float32")
    kw = dict(bert_config=PCFG.bert_config)
    if prebuilt:
        vocab = V.build_compact_vocab([train.eeg_input, test.eeg_input], full_vocab=50)
        train, test = V.remap_pairing(train, vocab), V.remap_pairing(test, vocab)
        kw.update(vocab=vocab, bert_config=dataclasses.replace(PCFG.bert_config,
                                                               vocab_size=vocab.size))
    else:
        kw.update(compact_vocab=True)
    out = api.train_on(train, test, "DPMLD", "cv/", "ti", "lapacian_dropout", **kw)
    assert np.isfinite(out["history"][0]["train_loss"])
    assert api.trainer.vocab is not None and api.trainer.vocab.size == 20
    assert api.trainer.params["bert"]["embeddings"]["word"].shape == (20, 768)
    assert api.trainer.export_params()["bert"]["embeddings"]["word"].shape == (50, 768)
    with pytest.raises(ValueError, match="either"):
        api.train_on(train, test, "DPMLD", "cv/", "ti", "lapacian_dropout", compact_vocab=True,
                     vocab=api.trainer.vocab)


def test_injected_bert_params_are_compacted(tmp_path, weights):
    """``bert_params`` (a full-vocab table) is sliced to the compact rows
    (seen before any step: zero epochs), and the caller's tree is left as it
    was."""
    bert = port_params(weights)["bert"]
    before = bert["embeddings"]["word"].clone()
    train, test = rows(4, seed=5), rows(4, seed=6)
    for d in (train, test):
        d.eeg_input = d.eeg_input % 10
    api = TrainAndTest(batch_size=4, epochs=0, echo=False, artifacts_root=str(tmp_path),
                       device="cpu", compute_dtype="float32", bert_params=bert)
    api.train_on(train, test, "DPMLD", "b/", "ti", "lapacian_dropout",
                 bert_config=PCFG.bert_config, compact_vocab=True)
    used = torch.from_numpy(api.trainer.vocab.new_to_old).long()
    assert torch.equal(api.trainer.params["bert"]["embeddings"]["word"], before[used])
    assert torch.equal(bert["embeddings"]["word"], before)
