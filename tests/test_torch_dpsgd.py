"""The port's DP-SGD (dp/accountant.py, dp/dpsgd.py, train/dpsgd_trainer.py and
``TrainAndTest.train_on(dp_mode="DPSGD")``) against the JAX package, on the
CPU.

The accountant is pure Python on both sides: its values must be equal. The
per-example gradients and the step run a 2-layer tiny BERT (hidden 768, so
layer 0 is frozen and layer 1 trainable), dropout off, 5 rows weighted
[1, 1, 1, 0, 0], one weight set for both sides drawn by the port's init;
tolerance rtol 1e-4 / atol 1e-5 (f32, sums in another order), as
test_torch_zoo.py. The Gaussian noise is JAX's draw, handed to the port.
The trainer runs at q = 1/8, 16 steps (the accountant's bisection at a
larger q takes minutes, on both sides).
"""
import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.dp import accountant as JA
from eeg_multimodal_tpu.dp import dpsgd as JDP
from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_tpu.utils.trees import path_str, tree_merge, tree_partition
from eeg_multimodal_torch.data import datasets as TD
from eeg_multimodal_torch.dp import accountant as TA
from eeg_multimodal_torch.dp import dpsgd as TDP
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models.convert import params_to_numpy
from eeg_multimodal_torch.ops import attention as TATT
from eeg_multimodal_torch.ops import dp_fused
from eeg_multimodal_torch.ops.optim import Adam
from eeg_multimodal_torch.train import metrics as TM
from eeg_multimodal_torch.train.api import TrainAndTest
from eeg_multimodal_torch.train.dpsgd_trainer import DPSGDTrainer
from eeg_multimodal_torch.utils.trees import tree_items, tree_map

TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(vocab_size=50, hidden_size=768, num_layers=2, num_heads=12,
            intermediate_size=64, max_position_embeddings=16, hidden_dropout=0.0,
            attention_dropout=0.0)
N_ROWS, S = 5, 8
WEIGHT = np.array([1, 1, 1, 0, 0], np.float32)
JCFG = dataclasses.replace(JF.config_for("ti", "DPSGD"), bert_config=JB.BertConfig(**TINY))
PCFG = dataclasses.replace(TF.config_for("ti", "DPSGD"), bert_config=TB.BertConfig(**TINY))
# the smoke's privacy setup: q = 1/8, 16 steps, delta = 1/8, eps = 0.1
SMOKE_SIGMA = 1.9441650390624998


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows(n, seed):
    """``n`` ti rows of S = 8 tokens (two of them padded), made with numpy."""
    rng = np.random.RandomState(seed)
    mask = np.ones((n, S), np.int32)
    mask[1, 5:] = 0
    mask[-1, 3:] = 0
    return TD.build_pairing(
        "ti", rng.randint(0, 2, n).astype(np.int32),
        eeg_txt={"input_ids": rng.randint(0, 50, (n, S)).astype(np.int32) * mask,
                 "attention_mask": mask},
        act_img=rng.randn(n, 512).astype(np.float32))


@functools.lru_cache(maxsize=None)
def weights():
    return params_to_numpy(TF.init(PCFG, seed=0, device="cpu"))


def port_params():
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), weights())


def jax_params():
    return jax.tree_util.tree_map(jnp.asarray, weights())


def trainable(path):
    return TDP.trainable_predicate(path, 2)


def leaves_by_path(tree):
    """{path: leaf as numpy} of a JAX tree (shapes as they are), the
    partition's None leaves left out."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {path_str(p): leaf if isinstance(leaf, jax.ShapeDtypeStruct) else np.asarray(leaf)
            for p, leaf in flat}


@functools.lru_cache(maxsize=None)
def jax_smoke_privacy():
    return JDP.make_private(16, JDP.DPSGDConfig(target_epsilon=0.1, epochs=2, batch_size=2))


# -- the accountant -------------------------------------------------------------

ORDERS = (1.5, 2.0, 3.0, 4.5, 8.0, 12.0, 32.0)


@pytest.mark.parametrize("q,sigma,steps", [(8 / 2402, 0.6, 15050), (0.01, 1.0, 100),
                                           (0.05, 2.5, 7), (1.0, 3.0, 4), (0.0, 1.0, 5)])
def test_accountant_equals_jax(q, sigma, steps):
    """compute_rdp (integer and fractional orders, q = 1 and q = 0),
    rdp_to_epsilon and epsilon: equal, not close."""
    for orders in (ORDERS, TA.DEFAULT_ORDERS[:40:7]):
        rdp = TA.compute_rdp(q, sigma, steps, orders)
        assert rdp == JA.compute_rdp(q, sigma, steps, orders)
        for delta in (1e-5, 1 / 301):
            assert TA.rdp_to_epsilon(rdp, delta, orders) == JA.rdp_to_epsilon(rdp, delta, orders)
    if 0 < q < 0.1:
        assert TA.epsilon(q, sigma, steps, 1 / 301) == JA.epsilon(q, sigma, steps, 1 / 301)
    assert TA.DEFAULT_ORDERS == JA.DEFAULT_ORDERS


def test_noise_multiplier_equals_jax_at_the_reference_and_smoke_configurations():
    """The reference's setup (batch 8 of 2402 rows, 50 epochs of 301 steps,
    delta 1/301) at eps 0.1 and 7.5, and the smoke's, equal to JAX's."""
    q, delta, steps = 8 / 2402, 1 / 301, 50 * 301
    for eps, want in ((0.1, 6.719078124999999), (7.5, 0.5771142578124999)):
        got = TA.get_noise_multiplier(eps, delta, q, steps=steps)
        assert got == want == JA.get_noise_multiplier(eps, delta, q, steps=steps)
    # the port's make_private at this setup: in test_dpsgd_trainer_fit
    assert jax_smoke_privacy()[0] == SMOKE_SIGMA
    with pytest.raises(ValueError, match="epochs or steps"):
        TA.get_noise_multiplier(0.1, delta, q)


# -- the mechanism ----------------------------------------------------------------

def test_trainable_predicate_selects_jax_paths():
    """The same trainable path set on both packages' TICA_DPSGD trees (the
    tiny 2-layer BERT), and on their paths renumbered as BERT-base's last
    two of 12 layers."""
    port_paths = {p for p, _ in tree_items(TF.init(PCFG, seed=0, device="cpu"))}
    jax_paths = set(leaves_by_path(jax.eval_shape(
        lambda: JF.init(jax.random.PRNGKey(0), JCFG))))
    assert port_paths == jax_paths
    base = {p.replace("bert/layers/1/", "bert/layers/11/").replace("bert/layers/0/",
                                                                   "bert/layers/10/")
            for p in jax_paths}
    for paths, layers in ((jax_paths, 2), (base, 12)):
        want = {p for p in paths if JDP.trainable_predicate(p, layers)}
        assert {p for p in paths if TDP.trainable_predicate(p, layers)} == want
        assert f"bert/layers/{layers - 1}/attn/query/kernel" in want
        assert f"bert/layers/{layers - 2}/attn/query/kernel" not in want
        assert "bert/embeddings/word" not in want and "visual_encoder/kernel" in want
        assert "bert/pooler/kernel" in want and "classifier/bias" in want


@pytest.mark.parametrize("n,q", [(12, 1 / 3), (2402, 8 / 2402)])
def test_poisson_window(n, q):
    """The window: min(b_max, n) rows (n = 12 at batch 4: b_max 14, window
    12), the drawn rows first and distinct, the weight 1 on them alone; the
    mean count over 200 draws within 0.75 of nq (tests/test_dpsgd.py:136)."""
    mean = n * q
    b_max = int(mean + 6 * math.sqrt(max(mean * (1 - q), 1.0))) + 1
    assert TDP.window_size(n, q) == min(b_max, n)
    counts = []
    for s in range(200):
        gen = torch.Generator().manual_seed(s)
        idx, w = TDP.poisson_batch_indices(gen, n, q)
        assert idx.shape == w.shape == (min(b_max, n),)
        assert idx.dtype == torch.int64 and w.dtype == torch.float32
        k = int(w.sum())
        assert torch.equal(w[:k], torch.ones(k)) and not w[k:].any()  # drawn rows first
        assert len(set(idx.tolist())) == len(idx)
        assert torch.equal(idx[:k], idx[:k].sort().values)  # stable: in order
        counts.append(k)
    assert abs(np.mean(counts) - mean) < 0.75
    # the window with a given width is the same draw, cut
    full = TDP.poisson_batch_indices(torch.Generator().manual_seed(0), n, q, n)
    cut = TDP.poisson_batch_indices(torch.Generator().manual_seed(0), n, q, 5)
    assert torch.equal(full[0][:5], cut[0]) and torch.equal(full[1][:5], cut[1])


def test_clip_and_aggregate_equal_jax():
    """clip_per_example and noisy_aggregate on gradients large enough to be
    clipped and small enough not to be, with JAX's normal draws handed in."""
    rng = np.random.RandomState(0)
    grads = {"a": rng.randn(4, 10).astype(np.float32) * 5,
             "b": rng.randn(4, 3, 3).astype(np.float32) * 5}
    grads["a"][2] *= 1e-3
    grads["b"][2] *= 1e-3
    weight = np.array([1, 0, 1, 1], np.float32)
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    jclipped = JDP.clip_per_example(jg, 0.1)
    tclipped = TDP.clip_per_example([torch.from_numpy(grads[k]) for k in "ab"], 0.1)
    for k, t in zip("ab", tclipped):
        np.testing.assert_allclose(t.numpy(), np.asarray(jclipped[k]), rtol=1e-6, atol=1e-9)
    norms = torch.sqrt(sum(t.reshape(4, -1).square().sum(1) for t in tclipped))
    assert float(norms.max()) <= 0.1 + 1e-6 and float(norms[2]) < 0.1
    assert torch.equal(tclipped[0][2], torch.from_numpy(grads["a"][2]))  # not clipped
    key = jax.random.PRNGKey(3)
    jagg = JDP.noisy_aggregate(jclipped, jnp.asarray(weight), key, 1.7, 0.1, 3)
    noise = [np.asarray(jax.random.normal(k, jg[name].shape[1:]))
             for k, name in zip(jax.random.split(key, 2), "ab")]
    tagg = TDP.noisy_aggregate(tclipped, torch.from_numpy(weight), 1.7, 0.1, 3,
                               noise=[torch.tensor(z) for z in noise])
    for k, t in zip("ab", tagg):
        np.testing.assert_allclose(t.numpy(), np.asarray(jagg[k]), rtol=1e-5, atol=1e-7)
    # drawn from a generator: one N(0, 1) call over every coordinate
    drawn = TDP.noisy_aggregate(tclipped, torch.from_numpy(weight), 1.7, 0.1, 3,
                                gen=torch.Generator().manual_seed(0))
    assert [t.shape for t in drawn] == [t.shape for t in tagg]


# -- the per-example gradients and the step ------------------------------------------

def batch_pair():
    data = rows(N_ROWS, seed=1)
    port = data.to_device("cpu")
    return port, {k: jnp.asarray(v.numpy()) for k, v in port.items()}


@functools.lru_cache(maxsize=None)
def jax_per_example():
    """``jax.vmap(jax.grad(example_loss))`` over the 5 rows, as
    dpsgd.py:131-142 there: {path: (5, ...) gradient}."""
    _, jb = batch_pair()
    pred = lambda p: JDP.trainable_predicate(p, 2)
    tr, frozen = tree_partition(jax_params(), pred)

    def example_loss(t, example):
        batch = {k: v[None] for k, v in example.items()}
        logits = JF.apply(tree_merge(t, frozen), batch, JCFG, 0.0, hard=True,
                          rng=jax.random.PRNGKey(0), train=True)
        return JM.cross_entropy(logits, batch["labels"])[0]

    return leaves_by_path(jax.jit(jax.vmap(jax.grad(example_loss), in_axes=(None, 0)))(tr, jb))


def port_losses(batch):
    def losses(tree):
        logits = TF.apply(tree, batch, PCFG, 0.0, True, None, True)
        return TM.cross_entropy(logits, batch["labels"])
    return losses


def test_per_example_grads_equal_jax_vmap_grad(monkeypatch):
    """Every trainable leaf's 5 per-example gradients, from one batched
    forward and backward, against JAX's vmap(grad); the frozen leaves get
    none, and the attention backward runs once (the last layer's)."""
    bwd_calls = []
    plain_bwd = TATT.attention_bwd_plain
    monkeypatch.setattr(TATT, "attention_bwd_plain",
                        lambda *a: bwd_calls.append(1) or plain_bwd(*a))
    batch, _ = batch_pair()
    params = port_params()
    grads = TDP.per_example_grads(port_losses(batch), params, trainable, N_ROWS)
    assert len(bwd_calls) == 1
    paths = [p for p, _ in tree_items(params) if trainable(p)]
    want = jax_per_example()
    assert sorted(paths) == sorted(want) and len(grads) == len(paths)
    for path, g in zip(paths, grads):
        assert g.shape == (N_ROWS, *dict(tree_items(params))[path].shape)
        np.testing.assert_allclose(g.numpy(), want[path], err_msg=path, **TOL)
    assert all(not t.requires_grad and t.grad is None for _, t in tree_items(params))
    assert min(float(np.abs(want[p][i]).max()) for p in ("fc1/kernel",)
               for i in range(N_ROWS)) > 1e-4  # every row's gradient, not vacuous


def test_dpsgd_step_equals_jax():
    """One make_dpsgd_step with Adam against JAX's (optax.adam), JAX's noise
    handed in: the trainable leaves and the first moments (1 - b1) times the
    noisy aggregate at TOL, the frozen leaves untouched."""
    batch, jb = batch_pair()
    sigma, lr = 0.02, 1e-3
    pred = lambda p: JDP.trainable_predicate(p, 2)
    jopt = optax.adam(lr)
    jtr, _ = tree_partition(jax_params(), pred)
    jstate = jopt.init(jtr)

    def jloss(p, example, k):
        b = {kk: v[None] for kk, v in example.items()}
        return JM.cross_entropy(JF.apply(p, b, JCFG, 0.0, hard=True, rng=k, train=True),
                                b["labels"])[0]

    jstep = JDP.make_dpsgd_step(jloss, pred, jopt, sigma, 0.1, 3)
    rng = jax.random.PRNGKey(11)
    new_jp, new_jstate = jax.jit(jstep)(jax_params(), jstate, jb, jnp.asarray(WEIGHT), rng)
    # the noise JAX's step drew: split(rng) -> k_noise, one key a leaf in
    # its flatten order
    k_noise = jax.random.split(rng)[1]
    shapes = leaves_by_path(jtr)
    noise = {p: np.asarray(jax.random.normal(k, shapes[p].shape))
             for p, k in zip(shapes, jax.random.split(k_noise, len(shapes)))}

    params = port_params()
    opt = Adam(lr)
    state = opt.init(TDP.trainable_leaves(params, trainable))
    step = TDP.make_dpsgd_step(
        lambda tree, b, gen: port_losses(b)(tree), trainable, opt, sigma, 0.1, 3)
    paths = [p for p, _ in tree_items(params) if trainable(p)]
    state = step(params, state, batch, torch.from_numpy(WEIGHT), None,
                 noise=[torch.tensor(noise[p]) for p in paths])
    got, want = dict(tree_items(params)), leaves_by_path(new_jp)
    before = dict(tree_items(port_params()))
    for path, leaf in got.items():
        if trainable(path):
            np.testing.assert_allclose(leaf.numpy(), want[path], err_msg=path, **TOL)
            assert not torch.equal(leaf, before[path])
        else:
            assert torch.equal(leaf, before[path]), path
    mu = leaves_by_path(new_jstate[0].mu)
    for path, m in zip(paths, state.mu):
        np.testing.assert_allclose(m.numpy(), mu[path], err_msg=path, rtol=1e-4, atol=1e-7)


# -- the trainer and the API ---------------------------------------------------------

def test_dpsgd_trainer_fit(tmp_path):
    """Two epochs of 16 rows at batch 2 (q = 1/8, a window of 10 rows):
    sigma and delta equal JAX's make_private; the frozen leaves bit-equal,
    every trainable leaf moved; records with sigma and delta. The classifier
    bias leans far to class 1 and every test label is 1, so each epoch's F1
    is 1: the first epoch beats the 0.5 threshold and writes the best
    checkpoint and record, the second (not better) does not."""
    params = port_params()
    params["classifier"]["bias"] = torch.tensor([-50.0, 50.0])
    tr = DPSGDTrainer(PCFG, TDP.DPSGDConfig(target_epsilon=0.1, epochs=2, batch_size=2,
                                            learning_rate=1e-3),
                      params=params, device="cpu")
    before = {p: t.clone() for p, t in tree_items(tr.params)}
    logs, ckpt = tmp_path / "logs", tmp_path / "best_f1.pickle"
    test = dataclasses.replace(rows(6, seed=3), labels=np.ones(6, np.int32))
    out = tr.fit(rows(16, seed=2), test, log_path=str(logs), model_path=str(ckpt), echo=False)
    sigma, q, delta, steps = jax_smoke_privacy()
    assert (out["sigma"], out["delta"]) == (sigma, delta) == (SMOKE_SIGMA, 1 / 8)
    assert TDP.window_size(16, q) == 10 and steps == 8
    assert len(out["history"]) == 2
    for row in out["history"]:
        assert all(math.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1"))
        assert (row["sigma"], row["delta"]) == (sigma, delta)
    for path, t in tree_items(tr.params):
        if tr.trainable(path):
            assert not torch.equal(t, before[path]), path
        else:
            assert torch.equal(t, before[path]), path
    assert (logs / "whole_record.txt").read_text().count("Epochs:") == 2
    jsonl = (logs / "metrics.jsonl").read_text()
    assert f'"sigma": {sigma}' in jsonl and f'"delta": {delta}' in jsonl
    assert [row["f1"] for row in out["history"]] == [1.0, 1.0] and out["f1_best"] == 1.0
    assert out["best"] == out["history"][0] and os.path.exists(ckpt)
    assert (logs / "best_record.txt").read_text().count("Epochs:") == 1
    with pytest.raises(ValueError, match="DPSGD"):
        DPSGDTrainer(TF.config_for("ti", "NDP"), TDP.DPSGDConfig(0.1, 1), device="cpu")


def test_train_on_dpsgd_runs_f32_over_the_full_vocab(tmp_path):
    """``TrainAndTest(device="cpu")`` at its bf16 default through
    ``train_on(..., "DPSGD", compact_vocab=True)``: the DP-SGD trainer, f32
    end to end, the full word table, 8 rows at batch 1 (b_max 8: a window
    of every row), records written, no kernel launched."""
    launches = [k.launches for k in TATT.KERNELS + dp_fused.KERNELS]
    api = TrainAndTest(batch_size=1, learning_rate=1e-3, epochs=2, echo=False,
                       artifacts_root=str(tmp_path), device="cpu")
    assert api.compute_dtype == "bfloat16"
    out = api.train_on(rows(8, seed=4), rows(4, seed=5), "compare_private_scheme", "DPSGD/",
                       "ti", "DPSGD", bert_config=TB.BertConfig(**TINY), compact_vocab=True)
    assert [k.launches for k in TATT.KERNELS + dp_fused.KERNELS] == launches
    tr = api.trainer
    assert isinstance(tr, DPSGDTrainer) and TDP.window_size(8, 1 / 8) == 8
    assert tr.eval_steps.compute_dtype == torch.float32
    assert all(t.dtype == torch.float32 for _, t in tree_items(tr.params))
    assert tr.params["bert"]["embeddings"]["word"].shape[0] == 50  # not compacted
    assert out["sigma"] == SMOKE_SIGMA and len(out["history"]) == 2
    assert all(math.isfinite(r["train_loss"]) for r in out["history"])
    assert (tmp_path / "logs" / "compare_private_scheme" / "DPSGD" / "whole_record.txt").exists()
