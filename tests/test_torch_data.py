"""The port's data pipeline, metrics and Adam (data/datasets.py,
train/metrics.py, ops/optim.py) against the JAX package on numpy inputs.
Tolerance for the float parts: rtol 1e-5 / atol 1e-5 for one loss, rtol 1e-4 /
atol 1e-5 for Adam steps (f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.data import datasets as JD
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_torch.data import datasets as TD
from eeg_multimodal_torch.ops.optim import Adam
from eeg_multimodal_torch.train import metrics as TM


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def streams(n, s=48, longest=33, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 100, (n, s)).astype(np.int32)
    mask = np.zeros((n, s), np.int32)
    for i, k in enumerate(rng.randint(1, longest + 1, n)):
        mask[i, :k] = 1
    mask[0, :longest] = 1
    return {"input_ids": ids, "attention_mask": mask}, rng.randn(n, 512).astype(np.float32)


def fields(a):
    return (a.eeg_input, a.eeg_mask, a.act_input, a.act_mask, a.labels, a.multimodal_type)


@pytest.mark.parametrize("mt", ["ti", "tt", "it", "ii"])
def test_build_pairing_and_truncation_match_jax(mt):
    tok, emb = streams(6)
    tok2, emb2 = streams(4, longest=20, seed=1)
    labels = np.array([0, 1, np.nan, 1, 0, np.nan])
    kw = dict(eeg_txt=tok, eeg_img=emb, act_txt=tok, act_img=emb)
    kw2 = dict(eeg_txt=tok2, eeg_img=emb2, act_txt=tok2, act_img=emb2)
    got = TD.build_pairing(mt, labels, **kw), TD.build_pairing(mt, labels[:4], **kw2)
    want = JD.build_pairing(mt, labels, **kw), JD.build_pairing(mt, labels[:4], **kw2)
    for g, w in zip(got, want):
        for a, b in zip(fields(g), fields(w)):
            np.testing.assert_array_equal(a, b)
    assert list(got[0].labels) == [0, 1, 0, 1, 0, 0]  # NaN -> 0
    for g, w in zip(TD.truncate_pair(*got), JD.truncate_pair(*want)):
        for a, b in zip(fields(g), fields(w)):
            np.testing.assert_array_equal(a, b)
    if mt[0] == "t":
        assert TD.truncate_pair(*got)[0].eeg_input.shape[1] == 48  # 33 -> 48


def test_truncate_pair_gives_80_tokens_for_65_valid():
    tok, emb = streams(3, s=512, longest=65)
    a = TD.build_pairing("ti", np.zeros(3), eeg_txt=tok, act_img=emb)
    train, test = TD.truncate_pair(a, a)
    assert train.eeg_input.shape == (3, 80) and test.eeg_mask.shape == (3, 80)


@pytest.mark.parametrize("n,bs,shuffle", [(10, 4, True), (8, 4, False), (3, 8, True)])
def test_epoch_indices_pad_and_weight_out_like_jax(n, bs, shuffle):
    idx, w = TD.epoch_indices(n, bs, shuffle, torch.Generator().manual_seed(0))
    j_idx, j_w = JD.epoch_indices(jax.random.PRNGKey(0), n, bs, shuffle)
    assert idx.shape == tuple(j_idx.shape) and idx.dtype == torch.int64
    np.testing.assert_array_equal(w.numpy(), np.asarray(j_w))
    flat = idx.reshape(-1)[: n].numpy()
    assert sorted(flat) == list(range(n))  # a permutation, then index-0 padding
    assert (idx.reshape(-1)[n:] == 0).all()
    if not shuffle:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


def test_to_device_and_gather_batch():
    tok, emb = streams(5)
    data = TD.build_pairing("ti", np.arange(5) % 2, eeg_txt=tok, act_img=emb).to_device("cpu")
    assert data["eeg_input"].dtype == torch.int64 and data["act_input"].dtype == torch.float32
    idx = torch.tensor([4, 0, 0])
    got = TD.gather_batch(data, idx)
    want = JD.gather_batch({k: jnp.asarray(v.numpy()) for k, v in data.items()},
                           jnp.asarray(idx.numpy()))
    for k in data:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_losses_and_f1_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(8, 2).astype(np.float32)
    logits[5] = [0.3, 0.3]  # argmax tie -> first index in both
    labels = rng.randint(0, 2, 8)
    weight = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    got = TM.cal_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(weight))
    want = JM.cal_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weight))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(
        TM.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(JM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-5)
    for y, p, w in [(labels, got[2].numpy(), weight), (labels, 1 - labels, None),
                    (np.zeros(4, int), np.zeros(4, int), None)]:
        assert TM.f1_binary(y, p) == JM.f1_binary(y, p)
        dev = TM.f1(torch.from_numpy(y), torch.from_numpy(p),
                    None if w is None else torch.from_numpy(w))
        ref = JM.f1_binary_jnp(jnp.asarray(y), jnp.asarray(p),
                               None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(float(dev), float(ref), rtol=1e-6)


def test_adam_matches_optax():
    rng = np.random.RandomState(4)
    shapes = [(3, 5), (7,), (1, 4)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    opt = optax.adam(1e-2)
    j_params = [jnp.asarray(p) for p in params]
    j_state = opt.init(j_params)
    t_params = [torch.from_numpy(p.copy()) for p in params]
    adam = Adam(1e-2)
    t_state = adam.init(t_params)
    for step in range(3):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        upd, j_state = opt.update([jnp.asarray(g) for g in grads], j_state)
        j_params = optax.apply_updates(j_params, upd)
        t_state = adam.update(t_params, [torch.from_numpy(g) for g in grads], t_state)
        assert t_state.count == step + 1
        for a, b in zip(t_params, j_params):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
        for a, b in zip(t_state.nu, j_state[0].nu):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-7)
