"""The port's legacy generation (train/legacy.py, experiments/legacy_drivers.py,
ops/dp_inits.py, the rest of train/metrics.py) against the JAX package, on
the CPU, at a tiny BERT (hidden 768, two layers), 4 rows a batch.

One weight set for both sides; each forward's DP draws rebuilt from the JAX
key layout and handed to the port; dropout off. Tolerance: rtol 1e-4 / atol
1e-5 for losses, features and the Adam step (f32, matmul sums in another
order), as test_torch_trainer.py; the metrics, the DP inits and the grids
exactly.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.data.datasets import MultiModalArrays as JArrays
from eeg_multimodal_tpu.experiments import legacy_drivers as JLD
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.ops import dp as JDP
from eeg_multimodal_tpu.ops import dp_inits as JINIT
from eeg_multimodal_tpu.train import checkpoint as JCK
from eeg_multimodal_tpu.train import legacy as JL
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_torch.experiments import legacy_drivers as TLD
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models.convert import params_to_numpy
from eeg_multimodal_torch.ops import dp_inits as TINIT
from eeg_multimodal_torch.train import checkpoint as TCK
from eeg_multimodal_torch.train import legacy as TL
from eeg_multimodal_torch.train import metrics as TM
from eeg_multimodal_torch.train.trainer import TrainConfig
from eeg_multimodal_torch.utils.trees import tree_items, tree_map
from test_torch_sweep import (B, arrays, configs, jax_batch, jax_noise,  # noqa: F401
                              one_torch_thread, quick_jit)

TOL = dict(rtol=1e-4, atol=1e-5)
EPS = 0.5


def port_params(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def assert_step_close(trainer, grads, new):
    """The port's gradients, read back from the first Adam moment (mu = (1 -
    b1) g), and its updated leaves against JAX's."""
    grads, new = dict(tree_items(grads)), dict(tree_items(new))
    paths = [p for p, _ in tree_items(trainer.params)]
    assert sorted(paths) == sorted(grads)
    for path, mu in zip(paths, trainer.opt_state.mu):
        np.testing.assert_allclose(mu.numpy() / 0.1, np.asarray(grads[path]), err_msg=path, **TOL)
    assert max(abs(np.asarray(g)).max() for g in grads.values()) > 1e-3  # not vacuous
    for path, leaf in tree_items(trainer.params):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(new[path]), err_msg=path, **TOL)


def test_metrics_match_jax():
    """accuracy, auroc (tied scores at their mean rank; 0.0 with a class
    absent) and the registry, equal to the JAX package's."""
    labels = np.array([0, 1, 0, 1, 1, 0, 1, 0])
    preds = np.array([0, 1, 1, 1, 0, 0, 1, 1])
    scores = np.array([0.1, 0.4, 0.4, 0.8, 0.4, 0.2, 0.8, 0.1])  # ties across classes
    assert TM.accuracy(labels, preds) == JM.accuracy(labels, preds)
    assert TM.accuracy([], []) == JM.accuracy([], []) == 0.0
    for y, s in ((labels, scores), (labels, preds), (np.ones(4, int), scores[:4]),
                 (np.zeros(3, int), scores[:3])):
        assert TM.auroc(y, s) == JM.auroc(y, s)
    assert TM.auroc(np.ones(4, int), scores[:4]) == 0.0
    assert 0.0 < TM.auroc(labels, scores) < 1.0
    assert sorted(TM.METRICS) == sorted(JM.METRICS) == ["AUROC", "Accuracy", "F1Score"]
    for name in TM.METRICS:
        assert TM.METRICS[name](labels, preds) == JM.METRICS[name](labels, preds)
        assert TM.METRICS[name](labels, preds, scores) == JM.METRICS[name](labels, preds, scores)


def test_dp_inits_match_jax():
    feats = np.random.RandomState(0).rand(10, 3 * 768).astype(np.float32)
    for got, want in ((TINIT.zeros(), JINIT.zeros()),
                      (TINIT.modality_constants(), JINIT.modality_constants()),
                      (TINIT.modality_constants((0.1, 0.2, 0.3), seg=4),
                       JINIT.modality_constants((0.1, 0.2, 0.3), seg=4)),
                      (TINIT.feawei(feats), JINIT.feawei(feats)),
                      (TINIT.feawei(feats, k=2.0, base_values=(0.3, 0.3, 0.3)),
                       JINIT.feawei(feats, k=2.0, base_values=(0.3, 0.3, 0.3)))):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grids_match_jax():
    np.testing.assert_array_equal(TLD.eps_experiment_epsilons(), JLD.eps_experiment_epsilons())
    np.testing.assert_array_equal(TL.alpha_sweep_values(), JL.alpha_sweep_values())
    np.testing.assert_array_equal(TL.alpha_sweep_values(7), JL.alpha_sweep_values(7))
    for cls in ("MetricTrainConfig", "PriGumbelConfig"):
        assert dataclasses.asdict(getattr(TL, cls)()) == dataclasses.asdict(getattr(JL, cls)())


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
def test_eval_repeats_in_one_forward_equal_a_forward_each(fused):
    """MetricTrainer's n_eval repeats as one forward, repeat r's rows drawing
    from generator r (the fused kernels take the one ``DP`` row for each
    group), equal one forward per repeat with its generator."""
    _, tc = configs(fused_dp_kernel=fused)
    params = TF.init(tc, 0, "cpu")
    data = arrays(B, seed=11).to_device("cpu")

    def gens():
        return tuple(torch.Generator().manual_seed(90 + r) for r in range(3))

    with torch.no_grad():
        got = TF.apply(params, TF.repeat_batch(data, 3), tc, EPS, True, gens(), False)
        want = torch.cat([TF.apply(params, data, tc, EPS, True, g, False) for g in gens()])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(want[:B], want[B:2 * B])  # each repeat its own noise


def test_metric_trainer_step_matches_jax():
    """One MetricTrainer step at n_para = 2: the two repeats' summed
    cross-entropies' gradients added (train.py:108-113), then plain Adam
    over every leaf, ``DP`` included, each repeat with its own DP noise."""
    jc, tc = configs()
    tree = params_to_numpy(TF.init(tc, seed=0, device="cpu"))
    tree["DP"] = np.random.RandomState(1).randn(1, tc.concat_width).astype(np.float32) * 0.5
    data = arrays(B, seed=2)
    weight = np.array([1, 1, 1, 0], np.float32)
    jb, jw = jax_batch(data), jnp.asarray(weight)
    keys = [jax.random.fold_in(jax.random.PRNGKey(4), r) for r in range(2)]

    def loss(p, rng):  # MetricTrainer._loss there, dropout off
        logits = JF.apply(p, jb, jc, EPS, True, rng, train=False)
        return (JM.cross_entropy(logits, jb["labels"]) * jw).sum()

    opt = optax.adam(1e-6)

    def step(p, keys):  # one compiled program: eager JAX compiles every op alone
        losses, per_key = jax.vmap(jax.value_and_grad(loss), in_axes=(None, 0))(p, keys)
        g = jax.tree_util.tree_map(lambda a: a.sum(0), per_key)
        upd, _ = opt.update(g, opt.init(p), p)
        return losses, g, optax.apply_updates(p, upd)

    losses, g, new = quick_jit(step, jax.tree_util.tree_map(jnp.asarray, tree), jnp.stack(keys))

    cfg = TL.MetricTrainConfig(eps=EPS, n_para=2, learning_rate=1e-6, batch_size=B)
    tr = TL.MetricTrainer(tc, cfg, params=port_params(tree), device="cpu")
    gens = [torch.Generator().manual_seed(r) for r in range(2)]
    got = tr.train_step(data.to_device("cpu"), torch.from_numpy(weight), gens,
                        dp_noise=[torch.from_numpy(jax_noise(k, tc.concat_width)) for k in keys],
                        dropout=False)
    np.testing.assert_allclose(float(got), float(losses.sum()) / 2, **TOL)
    assert_step_close(tr, g, new)


def test_pri_gumbel_step_matches_jax():
    """One PriGumbelPretrainer step: alpha CE + max((1 - w) e^eps + w)
    through the legacy head out of training (dropout off, the hard gate),
    its (768, 2) Gumbel and (B, 1) Laplace draws handed in, then Adam."""
    jc, tc = configs("ti", "NDP")
    cfg = TL.PriGumbelConfig(epsilon=EPS, alpha=0.7, batch_size=B)
    tree = params_to_numpy(TF.legacy_pri_gumbel_init(tc, seed=0, device="cpu"))
    data = arrays(B, seed=3)
    weight = np.array([1, 1, 1, 0], np.float32)
    jb, jw = jax_batch(data), jnp.asarray(weight)
    rng = jax.random.PRNGKey(6)
    k_gum, k_lap = jax.random.split(rng, 5)[3:]

    def loss(p):  # PriGumbelPretrainer._loss there, out of training
        logits = JF.legacy_pri_gumbel_apply(p, jb, jc, cfg.epsilon, cfg.tau, rng, False)
        ce, acc, _, _ = JM.cal_loss(logits, jb["labels"], jw)
        return JDP.privacy_regularized_loss(ce, p["w"], cfg.alpha, cfg.epsilon), acc

    opt = optax.adam(cfg.learning_rate)

    def step(p):
        (j_loss, j_acc), g = jax.value_and_grad(loss, has_aux=True)(p)
        upd, _ = opt.update(g, opt.init(p), p)
        return j_loss, j_acc, g, optax.apply_updates(p, upd)

    j_loss, j_acc, g, new = quick_jit(step, jax.tree_util.tree_map(jnp.asarray, tree))

    tr = TL.PriGumbelPretrainer(tc, cfg, params=port_params(tree), device="cpu")
    loss_, acc = tr.train_step(
        data.to_device("cpu"), torch.from_numpy(weight), None, train=False,
        gumbel=torch.from_numpy(np.array(jax.random.gumbel(k_gum, (768, 2)))),
        lap_noise=torch.from_numpy(np.array(jax.random.laplace(k_lap, (B, 1)))))
    np.testing.assert_allclose(float(loss_), float(j_loss), **TOL)
    np.testing.assert_allclose(float(acc), float(j_acc), **TOL)
    assert_step_close(tr, g, new)


def test_extract_feawei_matches_jax(tmp_path):
    """The normalized fused features of every row (eval trunk, no draws),
    equal to the JAX package's on the same weights, and their pickle."""
    jc, tc = configs()
    tree = params_to_numpy(TF.init(tc, seed=0, device="cpu"))
    data = arrays(6, seed=4)  # a last batch of 2 at batch_size 4
    jdata = JArrays(data.eeg_input, data.eeg_mask, data.act_input, data.act_mask, data.labels,
                    "ti")
    want = JLD.extract_feawei(tree, jc, jdata, out_path=None, batch_size=B)
    path = str(tmp_path / "feawei.pkl")
    got = TLD.extract_feawei(tree, tc, data, out_path=path, batch_size=B, device="cpu")
    assert got.shape == want.shape == (6, tc.concat_width)
    np.testing.assert_allclose(got, want, **TOL)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), got)
    assert TINIT.feawei(got).shape == (1, tc.concat_width)


@pytest.mark.parametrize("metrics", ["Accuracy,F1Score,AUROC", "F1Score"])
def test_metric_trainer_fit_writes_results(tmp_path, metrics):
    """fit with n_para = 2, n_eval = 3: results.pkl with the JAX keys and
    shapes (predictions sample-major), the logs, and the best-Accuracy
    model.pth in the reference's state-dict layout; without "Accuracy" in
    ``metrics`` no best (the JAX package raises there, ROADMAP §3)."""
    _, tc = configs()
    names = metrics.split(",")
    cfg = TL.MetricTrainConfig(n_para=2, n_eval=3, n_epochs=1, batch_size=B, metrics=metrics,
                               learning_rate=1e-3)
    tr = TL.MetricTrainer(tc, cfg, device="cpu")
    train, val = arrays(8, 5), arrays(6, 6)
    out = tr.fit(train, val, base_path=str(tmp_path), echo=True)
    with open(tmp_path / "results.pkl", "rb") as f:
        res = pickle.load(f)
    assert sorted(res) == sorted(["train_loss", "logits", "pred", "val_loss", "DP_params",
                                  *names])
    assert res["train_loss"][0].shape == (2,)  # one mean loss per step
    assert res["pred"][0].shape == (6, 3) and set(np.unique(res["pred"][0])) <= {0, 1}
    assert res["val_loss"][0].shape == (2, 3, B)  # (batches, repeats, rows)
    assert res["DP_params"][0].shape == (1, tc.concat_width)
    for name in names:
        assert res[name][0].shape == (3,)
        np.testing.assert_array_equal(res[name][0], [TM.METRICS[name](
            val.labels, res["pred"][0][:, r]) for r in range(3)])
    assert out["best_acc"] == pytest.approx(res["Accuracy"][0].mean() if "Accuracy" in names
                                            else 0.0)
    assert os.path.exists(tmp_path / "debug.log") and os.path.exists(tmp_path / "info.log")
    assert os.path.exists(tmp_path / "model.pth") == (out["best_acc"] > 0)
    if out["best_acc"] > 0:
        back = TCK.load_torch_checkpoint(str(tmp_path / "model.pth"), tc, device="cpu")
        for (p, a), (_, b) in zip(tree_items(back), tree_items(tr.params)):
            assert torch.equal(a, b), p


def test_pri_gumbel_pretrain_writes_curves_and_checkpoint(tmp_path, monkeypatch):
    """pretrain: the seven curves in result.pkl, the privacy budget of w,
    the records with its extras, and best_f1.pickle (the F1 here made to
    pass the 0.5 threshold) in the JAX package's state-dict layout."""
    jc, tc = configs("ti", "NDP")
    cfg = TL.PriGumbelConfig(epochs=1, batch_size=B, learning_rate=1e-3)
    tr = TL.PriGumbelPretrainer(tc, cfg, device="cpu")
    monkeypatch.setattr(TM, "f1", lambda *args: torch.tensor(0.75))
    out = tr.pretrain(arrays(8, 7), arrays(4, 8), path=str(tmp_path), echo=False)
    with open(tmp_path / "result.pkl", "rb") as f:
        curves = pickle.load(f)
    assert list(curves) == ["train_loss", "train_acc", "val_loss", "val_acc", "f1",
                            "privacy_budget_max", "privacy_budget_avg"]
    assert all(len(v) == 1 for v in curves.values()) and out["f1_best"] == 0.75
    w = tr.params["w"].numpy().astype(np.float64)
    budget = (1 - w) * np.exp(cfg.epsilon) + w
    assert curves["privacy_budget_max"][0] == pytest.approx(budget.max())
    assert curves["privacy_budget_avg"][0] == pytest.approx(budget.mean())
    assert sorted(os.listdir(tmp_path)) == ["best_f1.pickle", "best_record.txt", "metrics.jsonl",
                                            "result.pkl", "whole_record.txt"]
    with open(tmp_path / "best_f1.pickle", "rb") as f:
        sd = pickle.load(f)
    want = JCK.fusion_to_torch_state_dict(params_to_numpy(tr.params), jc)
    assert sorted(sd) == sorted(want) and "w" in sd
    for k in want:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)


def test_eps_experiment_and_alpha_sweep_drivers(tmp_path, monkeypatch):
    """run_index trains epsilon i into <out_root>/<eps>/ from a given DP
    init (learning rate 0 keeps it, so the best checkpoint holds it);
    run_all_vmapped hands the sweep the 20 epsilons labelled as the
    reference's directories; AlphaSweep runs each given alpha into its
    directory."""
    _, tc = configs()
    train, test = arrays(4, 9), arrays(4, 10)
    exp = TLD.EpsExperiment(tc, TrainConfig(batch_size=B, epochs=1, learning_rate=0.0,
                                            f1_best_init=-1.0),
                            out_root=str(tmp_path / "eps"), device="cpu")
    init = TINIT.feawei(np.random.RandomState(0).rand(5, tc.concat_width).astype(np.float32))
    res = exp.run_index(3, train, test, dp_init=init)
    eps3 = str(float(TLD.eps_experiment_epsilons()[3]))
    assert len(res["history"]) == 1 and eps3 == str(float(JLD.eps_experiment_epsilons()[3]))
    run_dir = tmp_path / "eps" / eps3
    assert {"whole_record.txt", "best_f1.pickle"} <= set(os.listdir(run_dir))
    with open(run_dir / "best_f1.pickle", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["DP"], init.numpy())

    seen = {}

    class Runner:
        def __init__(self, fusion_cfg, train_cfg, members, **kw):
            seen.update(members=members, kw=kw)

        def run(self, train_data, test_data, log_root=None):
            seen["log_root"] = log_root
            return "ran"

    monkeypatch.setattr(TLD, "SweepRunner", Runner)
    assert exp.run_all_vmapped(train, test, max_members_in_flight=10) == "ran"
    assert [m.name for m in seen["members"]] == [str(e) for e in JLD.eps_experiment_epsilons()]
    assert seen["log_root"] == str(tmp_path / "eps") and seen["kw"]["max_members_in_flight"] == 10

    sweep = TLD.AlphaSweep(configs("ti", "NDP")[1], out_root=str(tmp_path / "alpha"),
                           device="cpu")
    sweep.base_cfg = dataclasses.replace(sweep.base_cfg, epochs=1, batch_size=B)
    out = sweep.run(train, test, alphas=[0.5, 1.25])
    assert sorted(out) == [0.5, 1.25]
    assert sorted(os.listdir(tmp_path / "alpha")) == ["0.5000", "1.2500"]
    assert os.path.exists(tmp_path / "alpha" / "1.2500" / "result.pkl")
    if not torch.cuda.is_available():  # the card by default, never a quiet CPU run
        for make in (lambda: TL.MetricTrainer(tc, TL.MetricTrainConfig()),
                     lambda: TL.PriGumbelPretrainer(tc, TL.PriGumbelConfig()),
                     lambda: TLD.EpsExperiment(tc), lambda: TLD.AlphaSweep(tc)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_rewrite_val_to_test_matches_jax(tmp_path):
    text = "Epochs: 1\n                | Val Loss:  0.500\n                | Val Accuracy:  0.750\n"
    for root in ("port", "jax"):
        for sub, name, body in (("a", "whole_record.txt", text), ("a/b", "best_record.txt", text),
                                ("c", "notes.txt", text), ("c", "best_record.txt", "no val\n")):
            os.makedirs(tmp_path / root / sub, exist_ok=True)
            (tmp_path / root / sub / name).write_text(body)
    assert TLD.rewrite_val_to_test(str(tmp_path / "port")) == \
        JLD.rewrite_val_to_test(str(tmp_path / "jax")) == 2
    for sub, name in (("a", "whole_record.txt"), ("a/b", "best_record.txt"), ("c", "notes.txt")):
        assert (tmp_path / "port" / sub / name).read_text() == \
            (tmp_path / "jax" / sub / name).read_text()
    assert "Test Loss" in (tmp_path / "port" / "a" / "whole_record.txt").read_text()
