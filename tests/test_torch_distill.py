"""The port's CLIP distiller against the JAX package's, on the CPU.

From the same numpy rows and targets: ``_mlp_apply`` (the tanh GELU of
``jax.nn.gelu``'s default) within rtol 1e-5 / atol 1e-6; ``_fit_arrays``
for five full-batch Adam steps from JAX's init and JAX's jitter draws (made
from its key as distill.py:99-121 there makes them), the params and the
last loss within rtol 1e-5 / atol 1e-6; ``fit``'s split equal to JAX's and
its metrics on a learnable map as good as JAX's test asks; and
``build_distilled_act_tree`` writing the files JAX's writes (the copies and
the real test array byte for byte). Hidden width 32.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.train import distill as JD
from eeg_multimodal_torch.train import distill as TD
from eeg_multimodal_torch.utils.trees import tree_map

F32 = dict(rtol=1e-5, atol=1e-6)
CFG = dict(hidden=32, depth=2, steps=5, learning_rate=3e-3, warmup=2, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_pairs(n=60, d_in=6, d_out=8, seed=0):
    """A smooth deterministic row -> embedding map (as CLIP(render(row)) is
    of the act row)."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 50, (n, d_in)).astype(np.float32)
    w1, w2 = rng.randn(d_in, 32).astype(np.float32), rng.randn(32, d_out).astype(np.float32)
    return rows, (np.tanh(np.tanh(rows / 25.0 - 1.0) @ w1) @ w2).astype(np.float32)


def test_mlp_apply_equals_jax():
    layers = JD._init_mlp(jax.random.PRNGKey(0), 6, 8, JD.DistillConfig(**CFG))
    x = np.random.RandomState(1).randn(10, 6).astype(np.float32)
    want = JD._mlp_apply(layers, jnp.asarray(x))
    got = TD._mlp_apply(tree_map(lambda a: torch.tensor(np.asarray(a)),
                                 jax.tree_util.tree_map(np.asarray, layers)), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    ours = TD._init_mlp(torch.Generator().manual_seed(0), 6, 8, TD.DistillConfig(**CFG))
    assert [(tuple(l["w"].shape), tuple(l["b"].shape)) for l in ours] == \
        [(l["w"].shape, l["b"].shape) for l in layers]


def test_fit_arrays_five_steps_follow_jax_with_its_draws():
    rows, targets = synth_pairs()
    cfg_j, cfg_t = JD.DistillConfig(**CFG), TD.DistillConfig(**CFG)
    x_mean, x_std = rows.mean(0), rows.std(0) + 1e-6
    key = jax.random.PRNGKey(7)
    want, want_loss = JD.CLIPDistiller(cfg_j)._fit_arrays(rows, targets, x_mean, x_std, key,
                                                          cfg_j.steps)
    init = jax.tree_util.tree_map(np.asarray, JD._init_mlp(key, rows.shape[1],
                                                           targets.shape[1], cfg_j))
    noise = [np.asarray(jax.random.normal(k, rows.shape, jnp.float32))
             for k in jax.random.split(key, cfg_j.steps)]
    got, got_loss = TD.CLIPDistiller(cfg_t, "cpu")._fit_arrays(
        rows, targets, x_mean, x_std, None, cfg_t.steps, init=init, noise=noise)
    np.testing.assert_allclose(got_loss, want_loss, **F32)
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **F32)
    for gl, wl in zip(got["mlp"], want["mlp"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(gl[k].numpy(), np.asarray(wl[k]), **F32)
    d = TD.CLIPDistiller(cfg_t, "cpu")
    np.testing.assert_allclose(d.predict(got, rows[:5]).numpy(),
                               np.asarray(JD.CLIPDistiller(cfg_j).predict(want, rows[:5])),
                               rtol=1e-5, atol=1e-5)


def test_fit_split_and_metrics():
    rows, targets = synth_pairs(n=200, seed=2)
    cfg = dict(CFG, hidden=64, steps=400, warmup=20)
    params, metrics = TD.CLIPDistiller(TD.DistillConfig(**cfg), "cpu").fit(rows, targets)
    _, want = JD.CLIPDistiller(JD.DistillConfig(**cfg)).fit(rows, targets)
    assert sorted(metrics) == sorted(want) and metrics["n_val"] == want["n_val"] == 20
    assert metrics["val_cosine_mean"] > 0.9 and metrics["val_rel_mse"] < 0.3, metrics
    assert np.isfinite(metrics["final_train_loss"])
    # deterministic per seed; extra rows move the input normalizer only
    again = TD.CLIPDistiller(TD.DistillConfig(**cfg), "cpu").fit(rows, targets)
    assert again[1] == metrics
    wide, _ = TD.CLIPDistiller(TD.DistillConfig(**dict(cfg, steps=30)), "cpu").fit(
        rows, targets, extra_rows=rows[:50] * 3.0)
    assert not torch.allclose(wide["x_mean"], params["x_mean"])
    np.testing.assert_allclose(wide["y_mean"].numpy(), params["y_mean"].numpy())


def write_root(root, d_in=6, d_out=8, n_te=40, n_tr=50):
    rows_te, clip_te = synth_pairs(n_te, d_in, d_out, seed=1)
    rows_tr, _ = synth_pairs(n_tr, d_in, d_out, seed=2)
    proc = os.path.join(root, "data", "processed")
    os.makedirs(proc)
    header = ",".join(f"c{i}" for i in range(d_in))
    for split, r in (("test", rows_te), ("train", rows_tr)):
        np.savetxt(os.path.join(proc, f"{split}_act.csv"), r, delimiter=",", header=header,
                   comments="")
    txt = os.path.join(root, "data", "embedding", "EEG", "txt", "bert_bert_base_uncased")
    os.makedirs(txt)
    with open(os.path.join(txt, "train.pickle"), "wb") as f:
        pickle.dump({"input_ids": [1]}, f)
    real = os.path.join(root, "real.pickle")
    with open(real, "wb") as f:
        pickle.dump(clip_te, f)
    return real, clip_te


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                  for f in fs)


@pytest.mark.parametrize("fit_fraction", [1.0, 0.5])
def test_build_distilled_act_tree_writes_what_jax_writes(tmp_path, fit_fraction):
    src = str(tmp_path / "root")
    real, clip_te = write_root(src)
    cfg = dict(CFG, steps=20, fit_fraction=fit_fraction)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    mj = JD.build_distilled_act_tree(src, out_j, real, cfg=JD.DistillConfig(**cfg), echo=False)
    mt = TD.build_distilled_act_tree(src, out_t, real, cfg=TD.DistillConfig(**cfg), echo=False,
                                     device="cpu")
    assert tree(out_t) == tree(out_j)
    assert sorted(mt) == sorted(mj) and mt["n_val"] == mj["n_val"]
    assert mt["fit_fraction"] == fit_fraction
    save = os.path.join("data", "embedding", "act", "img", "clip_ViT_B_32")
    for rel in tree(out_j):
        a, b = (open(os.path.join(o, rel), "rb").read() for o in (out_t, out_j))
        if rel != os.path.join(save, "train.pickle"):
            assert a == b, rel  # the copies and the real test array
    with open(os.path.join(out_t, save, "train.pickle"), "rb") as f:
        train = pickle.load(f)
    assert type(train) is np.ndarray and train.dtype == np.float32 and train.shape == (50, 8)
    assert np.isfinite(train).all()
    with open(os.path.join(out_t, save, "test.pickle"), "rb") as f:
        assert np.array_equal(pickle.load(f), clip_te)


def test_build_refuses_an_array_of_another_split(tmp_path):
    src = str(tmp_path / "root")
    real, clip_te = write_root(src)
    with open(real, "wb") as f:
        pickle.dump(clip_te[:-1], f)
    with pytest.raises(ValueError, match="expected \\(40, D\\)"):
        TD.build_distilled_act_tree(src, str(tmp_path / "o"), real,
                                    cfg=TD.DistillConfig(**CFG), echo=False, device="cpu")
    assert dataclasses.asdict(TD.DistillConfig()) == dataclasses.asdict(JD.DistillConfig())
