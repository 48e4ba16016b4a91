"""The port's figures (visualization/) against the JAX package's.

Each figure function of both modules is called from the same inputs, made
with numpy, in one process: the port's PNG must have the JAX function's
bytes (the same matplotlib draws both; PNG metadata holds no date). The
record readers (``load_run`` over metrics.jsonl and over the legacy
whole_record.txt, ``best_row``, ``dp_param_stats``) must return what JAX's
return; ``dp_param_stats`` bit for bit.
"""
import os
import shutil

import numpy as np
import pytest

from eeg_multimodal_torch.train.records import RunRecorder
from eeg_multimodal_torch.visualization import plot as TP
from eeg_multimodal_torch.visualization import plot_new as TPN
from eeg_multimodal_tpu.visualization import plot as JP
from eeg_multimodal_tpu.visualization import plot_new as JPN

D3 = 3 * 768


def write_run(path, n_epochs=12, seed=0):
    rec = RunRecorder(str(path) + "/", echo=False)
    rng = np.random.RandomState(seed)
    for e in range(n_epochs):
        acc = min(0.6 + 0.02 * e + rng.rand() * 0.01, 0.99)
        rec.epoch(e, 0.7 - 0.01 * e, acc - 0.05, 0.65 - 0.01 * e, acc, acc, 1.0 + rng.rand())
    return str(path)


def rows(seed, n=12):
    """Epoch rows as load_run gives them, plus plot_new's keys."""
    rng = np.random.RandomState(seed)
    out = []
    for e in range(n):
        acc = float(min(0.6 + 0.02 * e + rng.rand() * 0.01, 0.99))
        out.append({"epoch": e + 1, "train_loss": 0.7 - 0.01 * e, "train_accuracy": acc - 0.05,
                    "test_loss": 0.65 - 0.01 * e, "test_accuracy": acc, "f1": acc,
                    "time_cost_s": 1.0 + float(rng.rand()), "train_acc": acc - 0.05,
                    "test_acc": acc})
    return out


DP = np.random.RandomState(0).randn(1, D3).astype(np.float32)
FEAWEI = np.random.RandomState(1).rand(40, D3).astype(np.float32)
RUNS = {name: rows(i) for i, name in enumerate(("a", "b", "c"))}
EPS_RUNS = {e: rows(i + 3) for i, e in enumerate((0.1, 1.0, 5.0))}
GRID = ([0.1, 1.0, 5.0], [0.8, 0.9, 0.95], [0.01, 0.02, 0.01])

# name: (module attribute, the arguments before the output path, keyword arguments)
PLOT = {
    "plot_dp_param_histograms": ((DP, 0.5), {}),
    "plot_noise_scale_scatter": ((DP, 1.0), {}),
    "plot_training_curves": ((RUNS,), {}),
    "plot_training_curves-loss": ((RUNS,), {"metric": "test_loss"}),
    "plot_privacy_utility": ((EPS_RUNS,), {}),
    "plot_privacy_utility_seeds": (GRID, {"reference": {0.1: 0.7, 1.0: 0.9}}),
    "plot_scheme_comparison": ((RUNS,), {}),
    "plot_modality_comparison": ((RUNS,), {}),
    "plot_modality_comparison-costs": ((RUNS,), {"time_costs": {"a": 1, "b": 2, "c": 3}}),
    "plot_alpha_sweep": (GRID, {}),
    "plot_init_weight_comparison": ((RUNS,), {}),
    "plot_feature_magnitudes": ((FEAWEI,), {"k": 2.0}),
}
PLOT_NEW = {
    "fig1_epoch_grid": ((EPS_RUNS,), {}),
    "fig2_feature_histograms": ((DP, FEAWEI), {}),
    "fig3_acc_best": ((TPN.PAPER_EPS, TPN.PAPER_ACC), {}),
    "fig5_eps_epoch_curves": ((EPS_RUNS,), {}),
    "fig6_eps_best_vs_epoch10": ((EPS_RUNS,), {}),
    "fig7_feature_vectors": ((DP, FEAWEI), {"epsilon": 0.5}),
}


def same_png(tmp_path, fn_t, fn_j, args, kw):
    a, b = str(tmp_path / "torch.png"), str(tmp_path / "jax.png")
    assert fn_t(*args, a, **kw) == a
    assert fn_j(*args, b, **kw) == b
    with open(a, "rb") as f, open(b, "rb") as g:
        got, want = f.read(), g.read()
    assert len(got) > 1000
    assert got == want


@pytest.mark.parametrize("name", sorted(PLOT))
def test_plot_figures_are_jax_bytes(tmp_path, name):
    args, kw = PLOT[name]
    fn = name.split("-")[0]
    same_png(tmp_path, getattr(TP, fn), getattr(JP, fn), args, kw)


@pytest.mark.parametrize("name", sorted(PLOT_NEW))
def test_plot_new_figures_are_jax_bytes(tmp_path, name):
    args, kw = PLOT_NEW[name]
    same_png(tmp_path, getattr(TPN, name), getattr(JPN, name), args, kw)


def test_readers_equal_jax(tmp_path):
    """``load_run`` over metrics.jsonl and over whole_record.txt alone,
    ``best_row`` by each key, and ``dp_param_stats`` bit for bit."""
    run = write_run(tmp_path / "run", seed=3)
    legacy = tmp_path / "legacy"
    os.makedirs(legacy)
    shutil.copy(os.path.join(run, "whole_record.txt"), legacy / "whole_record.txt")
    for path in (run, str(legacy)):
        got, want = TP.load_run(path), JP.load_run(path)
        assert got == want and len(got) == 12
        for key in ("f1", "test_accuracy", "train_loss"):
            assert TP.best_row(got, key) == JP.best_row(want, key)
    for eps in (0.1, 1.0, 10.0):
        got, want = TP.dp_param_stats(DP, eps), JP.dp_param_stats(DP, eps)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_regenerate_all_and_plot_new_write_the_jax_figures(tmp_path):
    """The two orchestrators over one logs tree: the same files, byte for
    byte."""
    logs = tmp_path / "logs"
    for i, e in enumerate(("0.1", "1.0")):
        write_run(logs / "compare_privacy_budget" / "eps_list" / e, seed=i)
    for i, s in enumerate(("DPMLD", "NDP")):
        write_run(logs / "compare_private_scheme" / s, seed=5 + i)
    write_run(logs / "demo" / "DPMLD", seed=9)
    eps_root = tmp_path / "eps_experiment"
    for i, e in enumerate((0.01, 0.1, 1.0)):
        write_run(eps_root / str(e), seed=20 + i)
    outs = {}
    for side, (P, PN) in {"torch": (TP, TPN), "jax": (JP, JPN)}.items():
        out = tmp_path / side
        written = P.regenerate_all(str(logs), str(out / "all"))
        written += PN.regenerate_plot_new(str(eps_root), str(out / "new"), dp_param=DP,
                                          feawei=FEAWEI, grid_eps=[0.01, 0.1, 1.0])
        outs[side] = {os.path.relpath(w, out): open(w, "rb").read() for w in written}
    assert sorted(outs["torch"]) == sorted(outs["jax"])
    assert len(outs["torch"]) == 9
    for name in outs["jax"]:
        assert outs["torch"][name] == outs["jax"][name], name
