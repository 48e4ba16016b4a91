"""The port's fast modes (train/trainer.py) against the JAX package and against
their sequential forms, on the CPU at the tiny width of test_torch_trainer.py
(1 layer, S = 8, B = 4):

- the reuse step (``share_phase_dropout``, features encoded once) against
  the JAX package's ``_shared_feature_step`` math, dropout off and the DP
  noise handed across: rtol 1e-4 / atol 1e-5 (f32, sums in another order);
- reuse against sharing without reuse, and the paired 2B encode against the
  sequential step that draws phase 1 from one generator and phase 2 from
  another, in the port with dropout on: rtol 1e-5, as the JAX package's
  exact-rewrite tests (tests/test_trainer.py);
- the grouped draws (attention masks, dropout, seeds) of G = 2 over 2B rows
  equal to two G = 1 draws, bit for bit;
- every new TrainConfig mode through ``Trainer.fit``, and the JAX
  package's refusals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_torch.data.datasets import epoch_indices, gather_batch
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models import layers as TL
from eeg_multimodal_torch.models.convert import params_to_numpy
from eeg_multimodal_torch.ops import attention as TA
from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig, Trainer
from eeg_multimodal_torch.utils.seeding import generator
from eeg_multimodal_torch.utils.trees import tree_items, tree_map
from test_torch_trainer import B, EPS, JC, TC, TOL, arrays, jax_batch, jax_noise, port_params

EXACT = dict(rtol=1e-5, atol=1e-7)  # a rewrite of the same step
# the weights after Adam steps at lr 1e-3: a step moves a weight by up to lr
# whatever the size of its gradient, so a tiny gradient's last bits move it
# visibly; atol 1e-6 is 1e-3 of one step
EXACT_PARAMS = dict(rtol=1e-5, atol=1e-6)


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


def assert_trees_close(a, b, **tol):
    for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=path, **tol)


def test_reuse_step_matches_jax_shared_feature_step(weights):
    data = arrays(B, seed=1)
    weight = np.array([1, 1, 1, 0], np.float32)  # a padded last row
    key = jax.random.PRNGKey(5)

    # JAX: trainer.py:414-465 there, dropout off
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    jb, jw = jax_batch(data), jnp.asarray(weight)
    rest = {k: v for k, v in jp.items() if k != "DP"}
    enc_keys, k_dp = JF.split_rng(key)
    feature, enc_vjp = jax.vjp(
        lambda r: JF.encode_features(r, jb, JC, enc_keys, train=False), rest)

    def head_loss(r, dp, feat, hard):
        logits = JF.apply_head({**r, "DP": dp}, feat, JC, EPS, hard, k_dp, train=False)
        return JM.cal_loss(logits, jb["labels"], jw)[:2]

    opt = optax.adam(1e-6)
    g_dp = jax.grad(lambda dp: head_loss(rest, dp, feature, False)[0])(jp["DP"])
    upd, _ = opt.update(g_dp, opt.init(jp["DP"]))
    dp1 = optax.apply_updates(jp["DP"], upd)
    (j_loss, j_acc), (g_head, g_feat) = jax.value_and_grad(
        lambda r, f: head_loss(r, dp1, f, True), argnums=(0, 1), has_aux=True)(rest, feature)
    g = jax.tree_util.tree_map(jnp.add, g_head, enc_vjp(g_feat)[0])
    upd, _ = opt.update(g, opt.init(rest))
    rest1 = optax.apply_updates(rest, upd)

    # the port: both phases' heads draw the one k_dp noise
    steps = StepFunctions(TC, TrainConfig(batch_size=B, share_phase_dropout=True), device="cpu")
    assert steps.reuse and not steps.paired
    params = port_params(weights)
    dp_os, model_os = steps.init_opt_states(params)
    noise = torch.from_numpy(jax_noise(key))
    dp_os, model_os, loss, acc = steps.train_step(
        params, dp_os, model_os, data.to_device("cpu"), torch.from_numpy(weight), EPS,
        torch.Generator().manual_seed(0), dp_noise=(noise, noise), dropout=False)

    np.testing.assert_allclose(float(loss), float(j_loss), **TOL)
    np.testing.assert_allclose(float(acc), float(j_acc), **TOL)
    # gradients, read back from the first Adam moment: mu = (1 - b1) g
    np.testing.assert_allclose(dp_os.mu[0].numpy() / 0.1, np.asarray(g_dp), **TOL)
    grads = dict(tree_items(jax.tree_util.tree_map(np.asarray, g)))
    model_paths = [p for p, _ in tree_items(params) if p != "DP"]
    assert sorted(model_paths) == sorted(grads)
    for path, mu in zip(model_paths, model_os.mu):
        np.testing.assert_allclose(mu.numpy() / 0.1, grads[path], err_msg=path, **TOL)
    assert max(abs(grads[p]).max() for p in grads) > 1e-3  # not vacuous
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, {**rest1, "DP": dp1})))
    for path, leaf in tree_items(params):
        np.testing.assert_allclose(leaf.numpy(), want[path], err_msg=path, **TOL)


def test_reuse_equals_sharing_without_reuse_through_fit():
    train, test = arrays(8, seed=3), arrays(6, seed=4)

    def run(reuse):
        cfg = TrainConfig(batch_size=B, learning_rate=1e-3, epochs=2,
                          share_phase_dropout=True, reuse_phase_features=reuse)
        tr = Trainer(TC, cfg, device="cpu")
        assert tr.steps.reuse == reuse
        return tr.fit(train, test, EPS, echo=False), tr.params

    (two_fwd, p2), (one_fwd, p1) = run(False), run(True)
    for a, b in zip(two_fwd["history"], one_fwd["history"]):
        for k in ("train_loss", "train_acc", "test_loss", "test_acc", "f1"):
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **EXACT)
    assert_trees_close(p1, p2, **EXACT_PARAMS)


def test_sharing_replays_phase_1s_draws_in_phase_2():
    """Shared dropout leaves the generator where one phase's draws leave it,
    and phase 2 sees phase 1's draws: dropout off and equal noise handed to
    both phases give the faithful step's numbers."""
    batch = arrays(B, seed=5).to_device("cpu")
    w = torch.ones(B)
    shared = StepFunctions(TC, TrainConfig(batch_size=B, share_phase_dropout=True,
                                           reuse_phase_features=False), "cpu")
    faithful = StepFunctions(TC, TrainConfig(batch_size=B), "cpu")
    noise = torch.from_numpy(np.random.RandomState(0).laplace(size=(B, TC.concat_width))
                             .astype(np.float32))
    outs, states = [], []
    for steps in (shared, faithful):
        params = TF.init(TC, seed=1, device="cpu")
        gen = generator(9)
        outs.append(steps.train_step(params, *steps.init_opt_states(params), batch, w, EPS,
                                     gen, dp_noise=(noise, noise), dropout=False)[2:])
        states.append(gen.get_state())
    assert [float(t) for t in outs[0]] == [float(t) for t in outs[1]]
    assert not torch.equal(states[0], states[1])  # the faithful step drew twice
    gen = generator(9)
    params = TF.init(TC, seed=1, device="cpu")
    shared.train_step(params, *shared.init_opt_states(params), batch, w, EPS, gen)
    once = generator(9)
    TF.apply(params, batch, TC, EPS, True, once, True)  # one forward's draws
    assert torch.equal(gen.get_state(), once.get_state())


def test_paired_steps_equal_the_sequential_two_generator_steps():
    """The paired mode's steps, each 2B forward drawing its halves from (the
    step's generator, a child of its state), against the faithful step run
    on each step's same pair of generators: phase 1 from one, phase 2 from
    the other. Compared: every step's loss and accuracy, the first step's
    gradients, and the final weights by what they compute (logits, dropout
    off): the weights themselves cannot be compared, since Adam moves a
    weight whose gradient is rounding noise (a key bias, to which softmax is
    blind) by up to the learning rate."""
    data = arrays(12, seed=6).to_device("cpu")
    idx, w = epoch_indices(12, B, True, generator(1))
    cfg = TrainConfig(batch_size=B, learning_rate=1e-3)
    paired = StepFunctions(TC, dataclasses.replace(cfg, paired_phase_encode=True), "cpu")
    sequential = StepFunctions(TC, cfg, "cpu")
    assert paired.paired and not sequential.paired

    def run(steps, pair_up):
        params = TF.init(TC, seed=2, device="cpu")
        states, gen, rows, first = steps.init_opt_states(params), generator(7), [], None
        for b_idx, wb in zip(idx, w):
            g = paired.phase_generators(gen) if pair_up else gen
            *states, loss, acc = steps.train_step(params, *states, gather_batch(data, b_idx),
                                                  wb, EPS, g)
            rows.append((float(loss), float(acc)))
            first = first or [m.clone() for m in states[1].mu]
        return params, rows, first

    pa, rows_a, first_a = run(paired, False)  # the paired step splits its generator itself
    pb, rows_b, first_b = run(sequential, True)
    np.testing.assert_allclose(rows_a, rows_b, **EXACT)
    scale = max(float(m.abs().max()) for m in first_b)
    for a, b in zip(first_a, first_b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6 * scale)
    noise = torch.zeros(4, TC.concat_width)
    logits = [TF.apply(p, gather_batch(data, idx[0]), TC, EPS, True, None, False, noise)
              for p in (pa, pb)]
    torch.testing.assert_close(logits[0], logits[1], **EXACT)
    assert not torch.equal(pa["DP"], TF.init(TC, seed=2, device="cpu")["DP"])


def test_grouped_masks_equal_one_call_per_group():
    """G = 2 seeds over 2B rows: the kernels' mask (keep_mask_plain) and the
    CPU path's (seeded_keep) are the two G = 1 masks stacked, bit for bit."""
    B2, H, S, rate = 4, 3, 21, 0.1
    seeds = [2 ** 33 + 5, 77]
    for fn in (lambda s, b: TA.keep_mask_plain(s, b, H, S, rate),
               lambda s, b: TA.seeded_keep(s, (b, H, S, S), rate)):
        both = fn(seeds, B2)
        assert torch.equal(both, torch.cat([fn(s, B2 // 2) for s in seeds]))
        assert not torch.equal(both[:B2 // 2], both[B2 // 2:])
    # a seed tensor of one element is the plain single-seed call
    assert torch.equal(TA.keep_mask_plain(torch.tensor([77]), 2, H, S, rate),
                       TA.keep_mask_plain(77, 2, H, S, rate))


def test_grouped_attention_and_dropout_equal_one_call_per_group():
    """fused_attention (CPU path) over 2B rows with two seeds, forward and
    backward, equals two B-row calls; a group of generators draws dropout
    masks and seeds as two separate draws do."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(4, 2, 16, 64).astype(np.float32)) for _ in range(3))
    bias = torch.zeros(4, 16)
    bias[1, 9:] = float(np.finfo(np.float32).min)
    dout = torch.from_numpy(rng.randn(4, 2, 16, 64).astype(np.float32))
    seeds = torch.tensor([11, 12])

    def run(q, k, v, bias, seed, dout):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = TA.fused_attention(*leaves, bias, seed, 0.1)
        return (out, *torch.autograd.grad(out, leaves, dout))

    both = run(q, k, v, bias, seeds, dout)
    halves = [run(q[s], k[s], v[s], bias[s], seeds[i:i + 1], dout[s])
              for i, s in enumerate((slice(0, 2), slice(2, 4)))]
    for got, *want in zip(both, *halves):
        assert torch.equal(got, torch.cat(want))

    x = torch.ones(6, 5, 3)
    group = (generator(1), generator(2))
    twins = (generator(1), generator(2))
    assert torch.equal(TL.dropout(x, 0.5, group),
                       torch.cat([TL.dropout(x[:3], 0.5, g) for g in twins]))
    assert torch.equal(TL.draw_seeds(group, "cpu"),
                       torch.cat([TL.draw_seeds(g, "cpu") for g in twins]))
    assert TL.draw_seeds(generator(1), "cpu").shape == (1,)


@pytest.mark.parametrize("mode", [
    dict(share_phase_dropout=True),
    dict(share_phase_dropout=True, reuse_phase_features=False),
    dict(paired_phase_encode=True),
    dict(n_eval=4),
    dict(shuffle_eval=True),
    dict(paired_phase_encode=True, compute_dtype="bfloat16"),
], ids=["share", "share-no-reuse", "paired", "n_eval", "shuffle_eval", "paired-bf16"])
def test_each_mode_trains_through_fit(mode):
    train, test = arrays(8, seed=7), arrays(6, seed=8)
    tr = Trainer(TC, TrainConfig(batch_size=B, learning_rate=1e-3, epochs=2, **mode),
                 device="cpu")
    dp0 = tr.params["DP"].clone()
    out = tr.fit(train, test, EPS, echo=False)
    assert len(out["history"]) == 2
    for row in out["history"]:
        assert all(np.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1"))
        assert 0.0 <= row["f1"] <= 1.0
    assert not torch.equal(tr.params["DP"], dp0)
    assert all(leaf.dtype == torch.float32 for _, leaf in tree_items(tr.params))


def test_the_jax_refusals():
    with pytest.raises(ValueError, match="share_phase_dropout"):
        TrainConfig(reuse_phase_features=True)  # trainer.py:240-244 there
    for fast in (dict(paired_phase_encode=True), dict(share_phase_dropout=True),
                 dict(share_phase_dropout=True, reuse_phase_features=True)):
        with pytest.raises(ValueError, match="precast_params"):  # :166-175 there
            TrainConfig(compute_dtype="bfloat16", precast_params=True, **fast)
        TrainConfig(precast_params=True, **fast)  # a no-op at float32
    with pytest.raises(ValueError, match="n_eval"):
        TrainConfig(n_eval=0)
    assert TrainConfig(share_phase_dropout=True).reuses_features
    assert not TrainConfig(share_phase_dropout=True, reuse_phase_features=False).reuses_features
    assert not TrainConfig().reuses_features
    # reuse takes precedence over pairing, as in the JAX step
    steps = StepFunctions(TC, TrainConfig(share_phase_dropout=True, paired_phase_encode=True),
                          "cpu")
    assert steps.reuse and not steps.paired
