"""The port's eval epoch with repeats, the eval order and the K-epoch cycle
(train/trainer.py) on the CPU, at the tiny width of test_torch_trainer.py:

- ``n_eval = 3`` against the JAX package's ``_eval_epoch``, the DP noise of
  each (batch, repeat) handed across: predictions, labels and weights
  exact, loss, accuracy and scores at rtol 1e-4 / atol 1e-5 (f32, sums in
  another order);
- the majority vote, a tie voting 0; the batched forward against the loop;
- ``shuffle_eval``: the same rows in another order, and no other draw moved;
- ``StepFunctions.cycle`` at K = 2 equal to two ``Trainer.run_epoch`` rows,
  exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.train.trainer import StepFunctions as JSteps
from eeg_multimodal_tpu.train.trainer import TrainConfig as JTrainConfig
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models.convert import params_to_numpy
from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig, Trainer
from eeg_multimodal_torch.utils.trees import tree_items
from test_torch_trainer import B, EPS, JC, TC, TOL, arrays, jax_batch, jax_noise, port_params

IDX = np.array([[0, 1, 2, 3], [4, 5, 0, 0]], np.int32)  # 2 batches of 4, the last padded
W = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)
ROW = ("train_loss", "train_acc", "test_loss", "test_acc", "f1")


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
def weights():
    """One weight set, drawn by the port's init, as numpy."""
    return params_to_numpy(TF.init(TC, seed=0, device="cpu"))


def port_eval(weights, n_eval, noise, batched=True):
    steps = StepFunctions(TC, TrainConfig(batch_size=B, n_eval=n_eval,
                                          eval_vmap_batches=batched), device="cpu")
    return steps.eval_epoch(port_params(weights), arrays(6, seed=2).to_device("cpu"),
                            torch.from_numpy(IDX).long(), torch.from_numpy(W), EPS,
                            torch.Generator().manual_seed(0), dp_noise=noise)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "loop"])
def test_repeated_eval_matches_jax(weights, batched):
    n_eval = 3
    jsteps = JSteps(JC, JTrainConfig(batch_size=B, n_eval=n_eval))
    key = jax.random.PRNGKey(9)
    want = jsteps.eval_epoch(jax.tree_util.tree_map(jnp.asarray, weights),
                             jax_batch(arrays(6, seed=2)), jnp.asarray(IDX), jnp.asarray(W),
                             EPS, key)
    keys = jax.random.split(key, 2 * n_eval).reshape(2, n_eval, -1)  # as trainer.py:475 there
    noise = [[torch.from_numpy(jax_noise(keys[i, r])) for r in range(n_eval)] for i in range(2)]
    loss, acc, preds, labels, scores, ws = port_eval(weights, n_eval, noise, batched)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(want[5]))
    np.testing.assert_allclose(float(loss), float(want[0]), **TOL)
    np.testing.assert_allclose(float(acc), float(want[1]), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[4]), **TOL)


def test_the_vote_is_the_majority_and_a_tie_votes_0(weights):
    """Two repeats under large, opposite-signed noise: where their single
    predictions disagree the vote is 0; where they agree it is theirs. Three
    repeats vote with the majority. Scores are the repeats' mean."""
    rng = np.random.RandomState(1)
    draws = [torch.from_numpy((rng.laplace(size=(2, 4, TC.concat_width)) * 30.0)
                              .astype(np.float32)) for _ in range(3)]
    singles = [port_eval(weights, 1, list(d)) for d in draws]
    pred = [s[2] for s in singles]
    two = port_eval(weights, 2, [[draws[0][i], draws[1][i]] for i in range(2)])
    tie = pred[0] != pred[1]
    assert bool(tie.any()) and bool((~tie).any())  # both cases occur
    assert torch.equal(two[2], pred[0] & pred[1])
    torch.testing.assert_close(two[4], (singles[0][4] + singles[1][4]) / 2, **TOL)
    torch.testing.assert_close(two[0], (singles[0][0] + singles[1][0]) / 2, **TOL)
    three = port_eval(weights, 3, [[d[i] for d in draws] for i in range(2)])
    assert torch.equal(three[2], (pred[0] + pred[1] + pred[2] >= 2).long())


def test_batched_repeats_equal_the_loop(weights):
    rng = np.random.RandomState(2)
    noise = [torch.from_numpy(rng.laplace(size=(3, 4, TC.concat_width)).astype(np.float32))
             for _ in range(2)]
    batched, loop = port_eval(weights, 3, noise, True), port_eval(weights, 3, noise, False)
    for i in (2, 3, 5):
        assert torch.equal(batched[i], loop[i])
    for i in (0, 1, 4):
        torch.testing.assert_close(batched[i], loop[i], **TOL)


def test_shuffle_eval_reorders_the_eval_rows_and_moves_no_other_draw():
    cfgs = [TrainConfig(batch_size=B, shuffle_eval=s) for s in (False, True)]
    trainers = [Trainer(TC, c, params={}, device="cpu") for c in cfgs]
    for epoch in (0, 1):
        plain, shuffled = (t.epoch_inputs(epoch, 10, 14) for t in trainers)
        idx, w, tgen, eidx, ew, egen = plain
        sidx, sw, stgen, seidx, sew, segen = shuffled
        assert torch.equal(idx, sidx) and torch.equal(w, sw)
        for a, b in ((tgen, stgen), (egen, segen)):
            assert torch.equal(a.get_state(), b.get_state())
        assert torch.equal(eidx.reshape(-1)[:14], torch.arange(14))  # in order by default
        assert torch.equal(ew, sew) and int(sew.sum()) == 14
        rows = seidx.reshape(-1)[sew.reshape(-1) > 0]
        assert torch.equal(rows.sort().values, torch.arange(14))
        assert not torch.equal(rows, torch.arange(14))
    assert not torch.equal(trainers[1].epoch_inputs(0, 10, 14)[3],
                           trainers[1].epoch_inputs(1, 10, 14)[3])


@pytest.mark.parametrize("shuffle_eval", [False, True])
def test_cycle_equals_run_epoch_rows(shuffle_eval):
    train, test = arrays(10, seed=3), arrays(6, seed=4)
    cfg = TrainConfig(batch_size=B, learning_rate=1e-3, shuffle_eval=shuffle_eval)
    train_dev, test_dev = train.to_device("cpu"), test.to_device("cpu")
    by_epoch = Trainer(TC, cfg, device="cpu")
    rows = [by_epoch.run_epoch(e, train_dev, test_dev, 10, 6, EPS) for e in range(2)]
    cycled = Trainer(TC, cfg, device="cpu")
    inputs = cycled.cycle_inputs(range(2), 10, 6)
    assert inputs[0].shape == (2, 3, B) and inputs[3].shape == (2, 2, B)
    cycled.dp_os, cycled.model_os, out = cycled.steps.cycle(
        cycled.params, cycled.dp_os, cycled.model_os, train_dev, test_dev, *inputs, EPS)
    assert out.shape == (2, 5)
    assert out.tolist() == [[row[k] for k in ROW] for row in rows]
    for (path, a), (_, b) in zip(tree_items(cycled.params), tree_items(by_epoch.params)):
        assert torch.equal(a, b), path
    assert cycled.model_os.count == by_epoch.model_os.count == 6
