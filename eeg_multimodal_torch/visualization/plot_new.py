"""The legacy one-off figure suite (ref: plot_new.py of the reference).

Port of the JAX package's ``visualization/plot_new.py``, with the same names
and figures; matplotlib (and scipy, for the KDEs) are imported inside the
figure functions. Re-derivation of the 7 `cp4_fig*` paper figures over this framework's logs
and checkpoints (both the byte-exact legacy whole_record.txt format and the
jsonl records parse through visualization.plot.load_run). Colors, layouts
and the per-modality 768-feature splits (EEG / OM [other-modality image] /
CM [cross-modality]) follow the reference verbatim so regenerated figures
are visually comparable with the committed PDFs.

Figure map (reference line cites):
  fig1  epoch grid, rows = eps, cols = (acc, loss)       plot_new.py:13-74
  fig2  dropout-rate & feature-magnitude hist+KDE grid   plot_new.py:77-112
  fig3  best accuracy vs privacy budget                  plot_new.py:114-129
  fig5  test-acc curves for the 20-pt eps sweep          plot_new.py:132-187
  fig6  best acc + epoch-10 acc vs eps (log x)           plot_new.py:190-255
  fig7  sorted per-feature scatter grid (w / scale / mag) plot_new.py:259-328
(The reference's fig4 savefig is commented out — :185 — so there are six
live figures; numbering keeps the reference's gaps.)
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .plot import _plt as _mpl
from .plot import load_run

TRAIN_COLOR, TEST_COLOR = "#FF928B", "#B3D9FB"  # plot_new.py:47-48
MODAL_COLORS = ("#5F9C61", "#B092B6", "#E38D26")  # EEG / OM / CM, :102-104
MAG_COLORS = ("#A4C97C", "#CAC1D4", "#F1CC74")  # :106-108
MODAL_NAMES = ("EEG", "OM", "CM")
D = 768


def _acc_loss(rows: List[Dict]):
    tr_a = [r.get("train_acc") for r in rows]
    te_a = [r.get("test_acc") for r in rows]
    tr_l = [r.get("train_loss") for r in rows]
    te_l = [r.get("test_loss") for r in rows]
    return tr_a, te_a, tr_l, te_l


def fig1_epoch_grid(runs_by_eps: Dict[float, List[Dict]], out_path: str):
    """Rows = epsilon, cols = (accuracy, loss) with train/test lines
    (ref plot_new.py:13-74, cp4_fig1)."""
    plt = _mpl()
    eps_list = sorted(runs_by_eps)
    fig, axs = plt.subplots(len(eps_list), 2, figsize=(15, 10), squeeze=False)
    for i, e in enumerate(eps_list):
        tr_a, te_a, tr_l, te_l = _acc_loss(runs_by_eps[e])
        epoch = range(len(tr_a))
        axs[i, 0].plot(epoch, tr_a, label="Train Accuracy", color=TRAIN_COLOR, linewidth=4)
        axs[i, 0].plot(epoch, te_a, label="Test Accuracy", color=TEST_COLOR, linewidth=4)
        axs[i, 0].set_title(f"Accuracy with $\\epsilon$ = {e}", fontsize=14)
        axs[i, 0].legend(loc="lower right")
        axs[i, 1].plot(epoch, tr_l, label="Train Loss", color=TRAIN_COLOR, linewidth=4)
        axs[i, 1].plot(epoch, te_l, label="Test Loss", color=TEST_COLOR, linewidth=4)
        axs[i, 1].set_title(f"Loss with $\\epsilon$ = {e}", fontsize=14)
        axs[i, 1].legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def _hist_kde(ax, values, color, title, xlabel, kde_color, mean=True,
              mean_color="black"):
    values = np.asarray(values, np.float64)
    ax.hist(values, bins=30, alpha=0.75, density=True, edgecolor="black", color=color)
    if values.std() > 0:
        from scipy import stats

        kde = stats.gaussian_kde(values)
        x = np.linspace(values.min(), values.max(), 1000)
        ax.plot(x, kde(x), color=kde_color, linestyle="-", linewidth=2)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Frequency")
    if mean:
        ax.axvline(x=float(values.mean()), color=mean_color, linestyle="--",
                   label=f"Mean: {values.mean():.2f}")


def fig2_feature_histograms(dp_param, feawei, out_path: str):
    """3x2 hist+KDE grid: per-modality dropout rates w = sigmoid(DP) and
    feature magnitudes from the feawei features (ref plot_new.py:77-112)."""
    plt = _mpl()
    w = 1.0 / (1.0 + np.exp(-np.asarray(dp_param, np.float64).reshape(-1)))
    w = w.reshape(3, D)
    mags = np.mean(np.asarray(feawei), axis=0).reshape(3, D)
    fig, axs = plt.subplots(3, 2, figsize=(15, 10))
    for i, name in enumerate(MODAL_NAMES):
        _hist_kde(
            axs[i, 0], w[i], MODAL_COLORS[i],
            f"Dropout rate with {name} (Avg. = {w[i].mean():.3f})",
            "Dropout rate", MODAL_COLORS[i],
        )
        _hist_kde(
            axs[i, 1], mags[i], MAG_COLORS[i],
            f"Feature magnitude of {name}", "Feature magnitude",
            MAG_COLORS[i], mean=False,
        )
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig3_acc_best(eps_labels: Sequence, accs: Sequence[float], out_path: str):
    """Best accuracy vs privacy budget (ref plot_new.py:114-129); defaults to
    the hard-coded paper table when called through regenerate_plot_new."""
    plt = _mpl()
    fig = plt.figure(figsize=(10, 6))
    plt.plot([str(e) for e in eps_labels], accs, marker="o", linestyle="-",
             color=TEST_COLOR)
    plt.title("Best validation accuracy vs privacy budget")
    plt.xlabel("Privacy budget")
    plt.ylabel("Accuracy")
    plt.grid(True, linestyle="--", linewidth=0.5, color="#C0C0C0", alpha=0.5)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig5_eps_epoch_curves(eps_to_rows: Dict[float, List[Dict]], out_path: str):
    """Test-accuracy-over-epochs for every eps, viridis gradient
    (ref plot_new.py:132-187, cp4_fig5)."""
    plt = _mpl()
    eps_list = sorted(eps_to_rows)
    colors = plt.cm.viridis(np.linspace(0, 1, len(eps_list)))
    fig = plt.figure(figsize=(10, 6))
    for i, e in enumerate(eps_list):
        acc = [r.get("test_acc") for r in eps_to_rows[e]]
        plt.plot(range(1, len(acc) + 1), acc, label=f"eps={e}", color=colors[i])
    plt.xlabel("Epoch", fontsize=12)
    plt.ylabel("Test accuracy", fontsize=12)
    plt.title("Test accuracy over epochs for different privacy budget", fontsize=14)
    plt.grid(True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig6_eps_best_vs_epoch10(eps_to_rows: Dict[float, List[Dict]], out_path: str):
    """Best acc within 50 epochs + acc at epoch 10, vs eps on a log axis
    (ref plot_new.py:190-255, cp4_fig6)."""
    plt = _mpl()
    eps_list = sorted(eps_to_rows)
    best = [max(r.get("test_acc", 0.0) for r in eps_to_rows[e]) for e in eps_list]
    ep10 = [
        (eps_to_rows[e][9].get("test_acc") if len(eps_to_rows[e]) > 9 else None)
        for e in eps_list
    ]
    fig = plt.figure(figsize=(10, 6))
    plt.plot(eps_list, best, marker="o", linestyle="-", color="#87CEEB",
             label="Best Test Accuracy within 50 Epoches", linewidth=4, markersize=10)
    plt.plot(eps_list, ep10, marker="x", linestyle="--", color="#2774AE",
             label="Test Accuracy at Epoch 10", linewidth=4, markersize=10,
             markeredgewidth=4)
    plt.xscale("log")
    plt.xlabel("Privacy budget", fontsize=12)
    plt.ylabel("Test accuracy", fontsize=12)
    plt.title("Test accuracy for different privacy budget", fontsize=14)
    plt.legend(loc="best", fontsize=12)
    plt.grid(True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fig7_feature_vectors(dp_param, feawei, out_path: str, epsilon: float = 1.0):
    """3x3 sorted per-feature scatter grid: dropout rate w, Laplacian noise
    scale 1/log((e^eps - w)/(1 - w)), feature magnitude — per modality with
    the reference's co-sort of (w, magnitude) (ref plot_new.py:259-328)."""
    plt = _mpl()
    w = 1.0 / (1.0 + np.exp(-np.asarray(dp_param, np.float64).reshape(-1)))
    mags = np.mean(np.asarray(feawei), axis=0)
    sorted_w, sorted_m = [], []
    for w_part, m_part in zip(np.split(w, 3), np.split(mags, 3)):
        order = np.argsort(w_part, kind="stable")
        sorted_w.append(w_part[order])
        sorted_m.append(m_part[order])
    w = np.concatenate(sorted_w)
    mags = np.concatenate(sorted_m)
    scale = 1.0 / np.log((np.exp(epsilon) - w) / (1.0 - w))

    fig, axs = plt.subplots(3, 3, figsize=(15, 10))

    def cell(i, j, vec, color, title, ylabel, mean_color):
        axs[i, j].scatter(range(len(vec)), vec, color=color, s=5)
        axs[i, j].axhline(y=float(np.mean(vec)), color=mean_color, linestyle="--")
        axs[i, j].set_xlabel("Index", fontsize=12)
        axs[i, j].set_ylabel(ylabel, fontsize=12)
        axs[i, j].set_title(title)
        axs[i, j].set_ylim(0, 1)
        axs[i, j].grid(True)

    cols = [
        (w, "Dropout rate", "Dropout rate with sorted {} features", MODAL_COLORS),
        (scale, "Laplacian noise scale",
         "Laplacian noise scale with sorted {} features", MODAL_COLORS),
        (mags, "Feature magnitude", "Magnitude of sorted {} features", MAG_COLORS),
    ]
    for j, (vec, ylabel, title_fmt, colors) in enumerate(cols):
        for i, name in enumerate(MODAL_NAMES):
            seg = vec[i * D : (i + 1) * D]
            cell(
                i, j, seg, colors[i],
                title_fmt.format(name) + f" (Avg. = {np.mean(seg):.3f})",
                ylabel, "black",
            )
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


# ---------------------------------------------------------------------------
# Orchestration over the legacy model_dict layout
# ---------------------------------------------------------------------------

PAPER_EPS = ["0.01", "0.05", "0.1", "0.5", "1.0", "5.0"]  # plot_new.py:115
PAPER_ACC = [0.806, 0.892, 0.956, 0.968, 0.987, 0.988]  # plot_new.py:116


def regenerate_plot_new(
    eps_experiment_root: str,
    out_dir: str,
    dp_param: Optional[np.ndarray] = None,
    feawei: Optional[np.ndarray] = None,
    grid_eps: Optional[Sequence[float]] = None,
) -> List[str]:
    """Regenerate every live plot_new figure that has data available.

    ``eps_experiment_root`` is a model_dict/eps_experiment-style tree
    (<eps>/whole_record.txt per value, ref plot_new.py:199). Checkpoint-based
    figures (fig2/fig7) need ``dp_param`` (the trained (1, 2304) DP logits)
    and ``feawei`` ((N, 2304) extracted features, legacy_drivers.extract_feawei).
    """
    os.makedirs(out_dir, exist_ok=True)
    written = []
    if grid_eps is None:
        grid_eps = np.around(np.logspace(np.log10(0.01), np.log10(5.0), 20), 3)

    eps_to_rows = {}
    for e in grid_eps:
        p = os.path.join(eps_experiment_root, str(e))
        if os.path.isdir(p):
            rows = load_run(p)
            if rows:
                eps_to_rows[float(e)] = rows
    if eps_to_rows:
        written.append(
            fig5_eps_epoch_curves(eps_to_rows, os.path.join(out_dir, "cp4_fig5_new.png"))
        )
        written.append(
            fig6_eps_best_vs_epoch10(eps_to_rows, os.path.join(out_dir, "cp4_fig6_new.png"))
        )
        rep = {e: eps_to_rows[e] for e in sorted(eps_to_rows)[:3]}
        written.append(
            fig1_epoch_grid(rep, os.path.join(out_dir, "cp4_fig1_new.png"))
        )
    written.append(
        fig3_acc_best(PAPER_EPS, PAPER_ACC, os.path.join(out_dir, "cp4_fig3.png"))
    )
    if dp_param is not None and feawei is not None:
        written.append(
            fig2_feature_histograms(dp_param, feawei, os.path.join(out_dir, "cp4_fig2.png"))
        )
        written.append(
            fig7_feature_vectors(dp_param, feawei, os.path.join(out_dir, "cp4_fig7.png"))
        )
    return written
