"""The port's rendering-inversion ViT pretrainer against the JAX package's,
on the CPU.

From the same numpy rows and weights: ``clip_loss`` within rtol 1e-5 /
atol 1e-6; ``_loss_fn`` (images rendered from the rows, the tower, both
inversion heads, InfoNCE) and every gradient in f32 within rtol 1e-4 /
atol 1e-6 (the tower's matmuls sum in another order; the JAX embedding
tests' tolerance), and in bf16 the gradient within the yardstick of
``test_torch_bf16.py`` (JAX's own bf16 distance from its f32, which covers
JAX's bf16 scores against the kernel path's f32 ones) and the loss within
one bf16 rounding of JAX's f32 loss; three AdamW steps
from JAX's batch indices (the decay mask on the matrices only) within rtol
1e-4 / atol 1e-6 after the third, the key third of each attention
in-projection bias within Adam's step bound (its gradient is 0 in exact
arithmetic); the pickled tower read by the port's
``GetEmbedding``. The tower: 2 layers of width 64 with one head (D = 64,
the kernels' head width, so attention takes ``fused_attention``'s path as
on the card), 224x224 images (the transforms fix the size), S = 50.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.models import vit as JV
from eeg_multimodal_tpu.train import contrastive as JC
from eeg_multimodal_tpu.utils.trees import path_str
from eeg_multimodal_torch.data import embedding as TE
from eeg_multimodal_torch.models import vit as TV
from eeg_multimodal_torch.ops import attention as A
from eeg_multimodal_torch.train import contrastive as TC
from eeg_multimodal_torch.utils.trees import tree_items, tree_map
from test_torch_bf16 import within_yardstick

TOL = dict(rtol=1e-4, atol=1e-6)
SMALL = dict(patch_size=32, width=64, layers=2, heads=1, output_dim=32)
B, N = 4, 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return (rng.randint(-300, 300, (n, 30)).astype(np.float32),
            rng.randint(-2048, 2048, (n, 25)).astype(np.float32))


def pretrainers(dtype="float32", **cfg):
    """The JAX pretrainer and the port's with JAX's initial params."""
    kw = dict(batch_size=B, total_steps=3, warmup_steps=1, log_every=3, learning_rate=1e-3,
              compute_dtype=dtype, **cfg)
    jp = JC.ContrastivePretrainer(JV.ViTConfig(**SMALL), JC.ContrastiveConfig(**kw))
    tp = TC.ContrastivePretrainer(TV.ViTConfig(**SMALL), TC.ContrastiveConfig(**kw),
                                  device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jp.params)
    tp.params = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)), tree)
    tp.opt_state = tp.opt.init(tp._leaves())
    assert sorted(p for p, _ in tree_items(tp.params)) == sorted(
        path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp.params)[0])
    return jp, tp


def by_path(tree):
    return {path_str(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_clip_loss_equals_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(6, 32).astype(np.float32), rng.randn(6, 32).astype(np.float32)
    for scale in (0.0, 2.659, 4.6):
        want = JC.clip_loss(jnp.asarray(a), jnp.asarray(b), jnp.float32(scale))
        got = TC.clip_loss(torch.tensor(a), torch.tensor(b), torch.tensor(scale))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    same = TC.clip_loss(torch.tensor(a), torch.tensor(a), torch.tensor(4.6))
    assert float(same) < float(TC.clip_loss(torch.tensor(a), torch.tensor(b),
                                            torch.tensor(4.6)))


def jax_loss_and_grads(jp, eeg, act):
    def standardize(x):
        return (x - x.mean(axis=0, keepdims=True)) / jnp.maximum(x.std(axis=0, keepdims=True),
                                                                 1e-6)

    e, a = jnp.asarray(eeg), jnp.asarray(act)
    fn = jax.jit(jax.value_and_grad(lambda p: jp._loss_fn(p, e, a, standardize(e),
                                                          standardize(a))))
    return fn(jp.params)


def port_loss_and_grads(tp, eeg, act):
    e, a = torch.tensor(eeg), torch.tensor(act)
    leaves = [t.detach().requires_grad_() for _, t in tree_items(tp.params)]
    it = iter(leaves)
    params = tree_map(lambda _: next(it), tp.params)
    loss = tp._loss_fn(params, e, a, TC.standardize(e), TC.standardize(a))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {p: g.numpy() for (p, _), g in zip(tree_items(tp.params), grads)}


def test_loss_and_every_gradient_equal_jax_in_f32(monkeypatch):
    jp, tp = pretrainers()
    eeg, act = rows(1, B)
    calls = []
    real = A.fused_attention
    monkeypatch.setattr(A, "fused_attention", lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    loss, grads = port_loss_and_grads(tp, eeg, act)
    # two towers' passes, each layer through the kernels' path (fwd and bwd)
    assert calls == [(B, 1, 50, 64)] * (2 * SMALL["layers"])
    want, jgrads = jax_loss_and_grads(jp, eeg, act)
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    jg = by_path(jgrads)
    assert sorted(grads) == sorted(jg)
    for path, g in grads.items():
        np.testing.assert_allclose(g, jg[path], **TOL, err_msg=path)
    assert np.abs(grads["logit_scale"]).max() > 0 and np.abs(grads["vit/conv"]).max() > 0


def test_loss_and_every_gradient_bf16_within_jax_yardstick():
    eeg, act = rows(2, B)
    jp32, _ = pretrainers()
    jp16, tp16 = pretrainers("bfloat16")
    w32, g32 = jax_loss_and_grads(jp32, eeg, act)
    w16, g16 = jax_loss_and_grads(jp16, eeg, act)
    loss, grads = port_loss_and_grads(tp16, eeg, act)
    # one number: a ratio of two single distances says little, so the loss
    # is held within one bf16 rounding (2^-8 relative) of JAX's f32 loss
    assert abs(float(loss) - float(w32)) <= 2 ** -8 * abs(float(w32))
    j16, j32 = by_path(g16), by_path(g32)
    for path, g in grads.items():
        assert g.dtype == np.float32  # through the cast to the f32 masters
    # the whole gradient vector: a small leaf's RMS is too noisy alone
    paths = sorted(grads)
    within_yardstick("gradient", *(np.concatenate([d[p].ravel() for p in paths])
                                   for d in (grads, j16, j32)))


def test_three_steps_follow_jax_and_decay_only_matrices():
    jp, tp = pretrainers()
    eeg, act = rows(3)
    k = jax.random.split(jax.random.PRNGKey(jp.cfg.seed + 1))[0]  # fit's one chunk key
    idx = [np.asarray(jax.random.randint(key, (B,), 0, N)) for key in jax.random.split(k, 3)]
    jvit, jhist = jp.fit(eeg, act, echo=False)
    tvit, thist = tp.fit(eeg, act, echo=False, idx=[torch.tensor(i) for i in idx])
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [3]
    np.testing.assert_allclose(thist[0]["loss"], jhist[0]["loss"], **TOL)
    want = by_path(jp.params)
    moved = sum(tp.opt.schedule(i) for i in range(3))
    W = SMALL["width"]
    for path, leaf in tree_items(tp.params):
        got = leaf.numpy()
        if path.endswith("in_proj_bias"):
            # the key third's gradient is 0 in exact arithmetic (softmax is
            # shift-invariant along a row): Adam steps it by each side's
            # rounding noise, within its step bound of the other
            assert np.abs(got[W:2 * W] - want[path][W:2 * W]).max() <= 2 * moved
            got, w = np.delete(got, np.s_[W:2 * W]), np.delete(want[path], np.s_[W:2 * W])
        else:
            w = want[path]
        np.testing.assert_allclose(got, w, **TOL, err_msg=path)
    assert tvit is tp.params["vit"]
    assert tp.opt.decay_mask(tp.params["vit"]["conv"]) and not tp.opt.decay_mask(
        tp.params["logit_scale"]) and not tp.opt.decay_mask(tp.params["head_eeg"]["bias"])


def test_the_pickled_tower_is_read_by_get_embedding(tmp_path, monkeypatch):
    """The tower pickled as a tree of numpy arrays (as the JAX package's
    examples/pretrain_clip.py pickles its own) goes through
    ``GetEmbedding(clip_weights=...)``: the written features are the
    tower's own embeddings of the rendered rows."""
    _, tp = pretrainers()
    eeg, act = rows(4, 5)
    root = str(tmp_path)
    out = os.path.join(root, "data", "processed")
    os.makedirs(out)
    for modal, r in (("EEG", eeg), ("act", act)):
        with open(os.path.join(out, f"test_{modal}.csv"), "w") as f:
            f.write(",".join(f"c{i}" for i in range(r.shape[1])) + "\n")
            f.writelines(",".join(str(int(v)) for v in row) + "\n" for row in r)
    weights = os.path.join(root, "tower.pickle")
    with open(weights, "wb") as f:
        pickle.dump(tree_map(lambda t: t.numpy(), tp.params["vit"]), f)
    monkeypatch.setattr(TV.ViTConfig, "for_coef", staticmethod(lambda c: TV.ViTConfig(**SMALL)))
    TE.GetEmbedding(["act", "EEG"], ["test"], data_root=root, clip_weights=weights,
                    device="cpu").get_img_encode([["clip", "ViT-B/32"]])
    from eeg_multimodal_torch.data import image_transform as IT

    cfg = TV.ViTConfig(**SMALL)
    for modal, r, to_img in (("act", act, IT.act_to_images), ("EEG", eeg, IT.eeg_to_images)):
        with open(os.path.join(root, "data", "embedding", modal, "img", "clip_ViT_B_32",
                               "test.pickle"), "rb") as f:
            got = pickle.load(f)
        with torch.no_grad():
            want = TV.encode_image(tp.params["vit"], to_img(torch.tensor(r)), cfg).numpy()
        assert got.shape == (5, SMALL["output_dim"]) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
