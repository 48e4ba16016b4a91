"""The port's trainer (train/trainer.py) against the JAX package: one faithful
alternating step and one eval epoch, on one weight set, with the DP noise
of each forward handed across (JAX's threefry draws cannot be reproduced)
and dropout off. Tolerance: rtol 1e-4 / atol 1e-5 for losses, gradients
and the Adam step (f32, sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_tpu.train.trainer import StepFunctions as JSteps
from eeg_multimodal_tpu.train.trainer import TrainConfig as JTrainConfig
from eeg_multimodal_torch.data.datasets import MultiModalArrays
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models.convert import params_to_numpy
from eeg_multimodal_torch.ops import dp_fused
from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig, Trainer
from eeg_multimodal_torch.utils.trees import tree_items, tree_map

TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(vocab_size=50, hidden_size=768, num_layers=1, num_heads=12,
            intermediate_size=64, max_position_embeddings=16)
B, S, EPS = 4, 8, 0.5
JC = dataclasses.replace(JF.config_for("ti", "lapacian_dropout"),
                         bert_config=JB.BertConfig(**TINY), fused_dp_kernel=True)
TC = dataclasses.replace(TF.config_for("ti", "lapacian_dropout"),
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


def arrays(n, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, S), np.int32)
    mask[1, 5:] = 0
    return MultiModalArrays(
        rng.randint(0, 50, (n, S)).astype(np.int32), mask,
        rng.randn(n, 1, 512).astype(np.float32), np.ones((n, 1), np.int32),
        rng.randint(0, 2, n).astype(np.int32), "ti")


def jax_batch(a: MultiModalArrays):
    return {"eeg_input": jnp.asarray(a.eeg_input), "eeg_mask": jnp.asarray(a.eeg_mask),
            "act_input": jnp.asarray(a.act_input), "act_mask": jnp.asarray(a.act_mask),
            "labels": jnp.asarray(a.labels)}


def jax_noise(rng):
    """The fused DP block's noise for a forward keyed by ``rng`` (JAX CPU
    path: dp_pallas._reference_impl)."""
    _, k_dp = JF.split_rng(rng)
    seed = jax.random.randint(k_dp, (1,), 0, 2**31 - 1, jnp.int32)
    key = jax.random.PRNGKey(seed.reshape(()).astype(jnp.uint32))
    return np.array(jax.random.laplace(key, (B, TC.concat_width)))


@pytest.fixture(scope="module")
def weights():
    """One weight set, drawn by the port's init, as numpy."""
    return params_to_numpy(TF.init(TC, seed=0, device="cpu"))


def port_params(weights):
    return tree_map(lambda a: torch.from_numpy(a.copy()), weights)


def test_faithful_alternating_step_matches_jax(weights):
    data = arrays(B, seed=1)
    weight = np.array([1, 1, 1, 0], np.float32)  # a padded last row
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))

    # JAX: the two phases of train/trainer.py:292-321 with dropout off
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    jb, jw = jax_batch(data), jnp.asarray(weight)

    def loss(params, rng, hard):
        logits = JF.apply(params, jb, JC, EPS, hard, rng, train=False)
        return JM.cal_loss(logits, jb["labels"], jw)[:2]

    rest = {k: v for k, v in jp.items() if k != "DP"}
    opt = optax.adam(1e-6)
    g_dp = jax.jit(jax.grad(lambda dp, r: loss({**r, "DP": dp}, k1, False)[0]))(
        jp["DP"], rest)
    upd, dp_os = opt.update(g_dp, opt.init(jp["DP"]))
    dp1 = optax.apply_updates(jp["DP"], upd)
    (j_loss, j_acc), g = jax.jit(jax.value_and_grad(
        lambda r, dp: loss({**r, "DP": dp}, k2, True), has_aux=True))(rest, dp1)
    upd, model_os = opt.update(g, opt.init(rest))
    rest1 = optax.apply_updates(rest, upd)

    # the port, handed the same noise for each phase
    steps = StepFunctions(TC, TrainConfig(batch_size=B), device="cpu")
    params = port_params(weights)
    p_dp_os, p_model_os = steps.init_opt_states(params)
    batch = {k: v for k, v in data.to_device("cpu").items()}
    noise = (torch.from_numpy(jax_noise(k1)), torch.from_numpy(jax_noise(k2)))
    launches = (dp_fused.dp_fwd.launches, dp_fused.dp_bwd.launches)
    p_dp_os, p_model_os, p_loss, p_acc = steps.train_step(
        params, p_dp_os, p_model_os, batch, torch.from_numpy(weight), EPS,
        torch.Generator().manual_seed(0), dp_noise=noise, dropout=False)
    assert (dp_fused.dp_fwd.launches, dp_fused.dp_bwd.launches) == launches  # CPU: no kernel

    np.testing.assert_allclose(float(p_loss), float(j_loss), **TOL)
    np.testing.assert_allclose(float(p_acc), float(j_acc), **TOL)
    # gradients, read back from the first Adam moment: mu = (1 - b1) g
    np.testing.assert_allclose(p_dp_os.mu[0].numpy() / 0.1, np.asarray(g_dp), **TOL)
    grads = dict(tree_items(jax.tree_util.tree_map(np.asarray, g)))
    model_paths = [p for p, _ in tree_items(params) if p != "DP"]
    assert sorted(model_paths) == sorted(grads)
    for path, mu in zip(model_paths, p_model_os.mu):
        np.testing.assert_allclose(mu.numpy() / 0.1, grads[path], err_msg=path, **TOL)
    assert max(abs(grads[p]).max() for p in grads) > 1e-3  # not vacuous
    # the Adam step
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, {**rest1, "DP": dp1})))
    for path, leaf in tree_items(params):
        np.testing.assert_allclose(leaf.numpy(), want[path], err_msg=path, **TOL)


def test_eval_epoch_matches_jax(weights):
    test = arrays(6, seed=2)  # 2 batches of 4, the last padded
    jsteps = JSteps(JC, JTrainConfig(batch_size=B))
    idx = np.array([[0, 1, 2, 3], [4, 5, 0, 0]], np.int32)
    w = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)
    key = jax.random.PRNGKey(9)
    want = jsteps.eval_epoch(jax.tree_util.tree_map(jnp.asarray, weights), jax_batch(test),
                             jnp.asarray(idx), jnp.asarray(w), EPS, key)
    keys = jax.random.split(key, 2).reshape(2, 1, -1)  # (n_batches, n_eval) as there
    noise = [torch.from_numpy(jax_noise(keys[i, 0])) for i in range(2)]

    steps = StepFunctions(TC, TrainConfig(batch_size=B), device="cpu")
    got = steps.eval_epoch(port_params(weights), test.to_device("cpu"),
                           torch.from_numpy(idx).long(), torch.from_numpy(w), EPS,
                           torch.Generator().manual_seed(0), dp_noise=noise)
    loss, acc, preds, labels, scores, ws = got
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(want[5]))
    np.testing.assert_allclose(float(loss), float(want[0]), **TOL)
    np.testing.assert_allclose(float(acc), float(want[1]), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[4]), **TOL)


def test_trainer_epochs_train_dp_and_are_deterministic_per_seed():
    train, test = arrays(10, seed=3), arrays(6, seed=4)

    def run():
        tr = Trainer(TC, TrainConfig(batch_size=B, learning_rate=1e-3), device="cpu")
        dp0 = tr.params["DP"].clone()
        rows = [tr.run_epoch(e, train.to_device("cpu"), test.to_device("cpu"), 10, 6, EPS)
                for e in range(2)]
        return rows, tr.params, dp0

    rows, params, dp0 = run()
    for row in rows:
        assert all(np.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1"))
        assert 0.0 <= row["f1"] <= 1.0
    assert not torch.equal(params["DP"], dp0)
    rows2, params2, _ = run()
    assert [{k: v for k, v in r.items() if k != "time_cost"} for r in rows] == \
        [{k: v for k, v in r.items() if k != "time_cost"} for r in rows2]
    for (path, a), (_, b) in zip(tree_items(params), tree_items(params2)):
        assert torch.equal(a, b), path
