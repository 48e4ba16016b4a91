"""Analysis and figure regeneration (ref: python/src/visualization/plot.py).

Port of the JAX package's ``visualization/plot.py``, over the port's own
``train/records.parse_legacy_records``, with the same names and figures. The
reference re-parses whole_record.txt logs back into curves (plot.py:17-32,
347-366) and draws the paper figures; this module reads legacy text logs or
metrics.jsonl:

  - accuracy/loss-vs-epoch curves per epsilon      (ref plot.py:339-401)
  - dropout-rate and noise-scale distributions from a checkpoint's DP param
    (ref plot.py:80-115, 265-300; weight.py:8-43)
  - DP-scheme comparison bars                      (ref plot.py:339-401)
  - modality comparison incl. per-epoch time costs (ref plot.py:503,600)
  - encoder-init grid comparison                   (ref plot.py:648-709)

Every figure function takes parsed data and an output path. matplotlib is
imported inside the figure functions, with the Agg backend (headless), so
that importing this module, ``load_run``, ``best_row`` and
``dp_param_stats`` need no matplotlib (the card machine has none).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..train.records import parse_legacy_records


def _plt():
    """``matplotlib.pyplot`` on the Agg backend, imported on first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# Log ingestion
# ---------------------------------------------------------------------------

def load_run(log_path: str) -> List[Dict]:
    """Load epoch rows from a run dir: prefers metrics.jsonl, falls back to
    whole_record.txt (the reference's only format)."""
    jsonl = os.path.join(log_path, "metrics.jsonl")
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            return [json.loads(line) for line in f if line.strip()]
    txt = os.path.join(log_path, "whole_record.txt")
    rows = parse_legacy_records(open(txt).read())
    return [
        {
            "epoch": r["epoch"],
            "train_loss": r.get("Train Loss"),
            "train_accuracy": r.get("Train Accuracy"),
            "test_loss": r.get("Test Loss"),
            "test_accuracy": r.get("Test Accuracy"),
            "f1": r.get("f_1 Score"),
            "time_cost_s": r.get("Time Cost"),
        }
        for r in rows
    ]


def best_row(rows: List[Dict], key: str = "f1") -> Dict:
    return max(rows, key=lambda r: r.get(key) or 0.0)


# ---------------------------------------------------------------------------
# DP-parameter analysis (ref plot.py:80-115, weight.py)
# ---------------------------------------------------------------------------

def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def dp_param_stats(dp_param: np.ndarray, epsilon: float) -> Dict[str, np.ndarray]:
    """w = sigmoid(DP); dropout prob per feature = w; noise scale per feature
    eps_hat = 1/log((e^eps - w)/(1 - w)) (ref plot.py:290)."""
    w = _sigmoid(np.asarray(dp_param).reshape(-1))
    eps_hat = 1.0 / np.log((np.exp(epsilon) - w) / (1.0 - w))
    return {"w": w, "dropout_rate": w, "noise_scale": eps_hat}


def plot_dp_param_histograms(dp_param, epsilon: float, out_path: str):
    plt = _plt()
    stats = dp_param_stats(dp_param, epsilon)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(stats["dropout_rate"], bins=50)
    axes[0].set_xlabel("per-feature dropout rate w")
    axes[0].set_ylabel("count")
    axes[1].hist(stats["noise_scale"], bins=50)
    axes[1].set_xlabel(r"per-feature noise scale $\hat\epsilon$")
    fig.suptitle(f"DP parameter distributions (eps={epsilon})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_noise_scale_scatter(dp_param, epsilon: float, out_path: str):
    plt = _plt()
    stats = dp_param_stats(dp_param, epsilon)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.scatter(np.arange(len(stats["noise_scale"])), stats["noise_scale"], s=2)
    ax.set_xlabel("feature index")
    ax.set_ylabel(r"$\hat\epsilon$")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


# ---------------------------------------------------------------------------
# Curves & comparisons
# ---------------------------------------------------------------------------

def plot_training_curves(runs: Dict[str, List[Dict]], out_path: str,
                         metric: str = "test_accuracy"):
    """Accuracy/loss-vs-epoch for a dict of named runs (e.g. per epsilon)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, rows in runs.items():
        xs = [r["epoch"] for r in rows]
        ys = [r[metric] for r in rows]
        ax.plot(xs, ys, label=str(name))
    ax.set_xlabel("epoch")
    ax.set_ylabel(metric)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_privacy_utility(eps_to_rows: Dict[float, List[Dict]], out_path: str):
    """Best accuracy vs epsilon — the paper's headline figure
    (ref plot.py:118-119 table)."""
    plt = _plt()
    eps = sorted(eps_to_rows)
    best = [best_row(eps_to_rows[e], "test_accuracy")["test_accuracy"] for e in eps]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogx(eps, best, marker="o")
    ax.set_xlabel(r"privacy budget $\epsilon$")
    ax.set_ylabel("best test accuracy")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_privacy_utility_seeds(eps, mean_acc, std_acc, out_path: str,
                               reference: Dict[float, float] = None):
    """Privacy-utility frontier with mean±std error bands across seeds —
    the reference's mean±std figure style (ref plot.py:22-81) applied to
    the BASELINE.json eps x seeds grid."""
    plt = _plt()
    eps = np.asarray(eps)
    mean_acc = np.asarray(mean_acc)
    std_acc = np.asarray(std_acc)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogx(eps, mean_acc, marker="o", label="DP-MLD (mean over seeds)")
    ax.fill_between(eps, mean_acc - std_acc, mean_acc + std_acc, alpha=0.25,
                    label=r"$\pm$1 std")
    if reference:
        re = sorted(reference)
        ax.semilogx(re, [reference[e] for e in re], marker="s", linestyle="--",
                    color="gray", label="reference (single seed)")
    ax.set_xlabel(r"privacy budget $\epsilon$")
    ax.set_ylabel("best test accuracy")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_scheme_comparison(scheme_to_rows: Dict[str, List[Dict]], out_path: str):
    """DP-scheme comparison bars (ref plot.py:339-401)."""
    plt = _plt()
    names = list(scheme_to_rows)
    vals = [
        best_row(scheme_to_rows[n], "test_accuracy")["test_accuracy"]
        for n in names
    ]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(names, vals)
    ax.set_ylabel("best test accuracy")
    ax.set_ylim(0, 1)
    plt.xticks(rotation=20, ha="right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_modality_comparison(modal_to_rows: Dict[str, List[Dict]], out_path: str,
                             time_costs: Optional[Dict[str, float]] = None):
    """Accuracy + per-epoch time cost per modality pairing
    (ref plot.py:503,600 uses hard-coded costs; we read them from the logs)."""
    plt = _plt()
    names = list(modal_to_rows)
    accs = [
        best_row(modal_to_rows[n], "test_accuracy")["test_accuracy"]
        for n in names
    ]
    if time_costs is None:
        time_costs = {
            n: float(np.median([r["time_cost_s"] for r in modal_to_rows[n]]))
            for n in names
        }
    fig, ax1 = plt.subplots(figsize=(7, 4))
    x = np.arange(len(names))
    ax1.bar(x - 0.2, accs, width=0.4, label="best acc")
    ax1.set_ylabel("best test accuracy")
    ax1.set_ylim(0, 1)
    ax2 = ax1.twinx()
    ax2.bar(x + 0.2, [time_costs[n] for n in names], width=0.4,
            color="tab:orange", label="s/epoch")
    ax2.set_ylabel("time cost (s/epoch)")
    ax1.set_xticks(x)
    ax1.set_xticklabels(names)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_alpha_sweep(alphas, mean_acc, std_acc, out_path: str,
                     public_baseline: float = 0.94):
    """Alpha-sweep mean±std accuracy with the 'Baseline (Public)' line at
    0.94 (ref plot.py:22-81, the PriGumbel alpha figure)."""
    plt = _plt()
    alphas = np.asarray(alphas)
    mean_acc = np.asarray(mean_acc)
    std_acc = np.asarray(std_acc)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogx(alphas, mean_acc, marker="o", label="DP-MLD")
    ax.fill_between(alphas, mean_acc - std_acc, mean_acc + std_acc, alpha=0.25)
    ax.axhline(public_baseline, color="gray", linestyle="--",
               label=f"Baseline (Public) {public_baseline}")
    ax.set_xlabel(r"loss weight $\alpha$")
    ax.set_ylabel("val accuracy")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_init_weight_comparison(grid_to_rows: Dict[str, List[Dict]], out_path: str):
    """Encoder-init grid comparison (ref plot.py:648-709)."""
    plt = _plt()
    names = list(grid_to_rows)
    vals = [
        best_row(grid_to_rows[n], "test_accuracy")["test_accuracy"]
        for n in names
    ]
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar(names, vals)
    ax.set_ylabel("best test accuracy")
    ax.set_ylim(0, 1)
    plt.xticks(rotation=25, ha="right", fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_feature_magnitudes(features: np.ndarray, out_path: str, k: float = 1.0):
    """Per-feature mean magnitude of extracted fused features and the
    derived sigmoid DP init (ref past_acc_feawei.py:151-189)."""
    plt = _plt()
    mean_values = np.mean(np.asarray(features), axis=0)
    std = (mean_values - mean_values.mean()) / mean_values.std()
    w_init = 1.0 - _sigmoid(k * std)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].plot(mean_values, lw=0.5)
    axes[0].set_xlabel("feature index")
    axes[0].set_ylabel("mean magnitude")
    axes[1].hist(w_init, bins=50)
    axes[1].set_xlabel("derived init dropout weight w")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def regenerate_all(log_root: str, out_dir: str, epsilon: float = 0.1):
    """Walk a logs/ tree in the reference layout and regenerate every figure
    that has data available. Returns the list of written figure paths."""
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def run_dirs(base):
        if not os.path.isdir(base):
            return {}
        out = {}
        for name in sorted(os.listdir(base)):
            p = os.path.join(base, name)
            if os.path.isdir(p) and (
                os.path.exists(os.path.join(p, "whole_record.txt"))
                or os.path.exists(os.path.join(p, "metrics.jsonl"))
            ):
                out[name] = load_run(p)
        return out

    eps_runs = run_dirs(os.path.join(log_root, "compare_privacy_budget", "eps_list"))
    if eps_runs:
        written.append(
            plot_privacy_utility(
                {float(k): v for k, v in eps_runs.items()},
                os.path.join(out_dir, "privacy_utility.png"),
            )
        )
    schemes = run_dirs(os.path.join(log_root, "compare_private_scheme"))
    if schemes:
        written.append(
            plot_scheme_comparison(
                schemes, os.path.join(out_dir, "scheme_comparison.png")
            )
        )
    modal = run_dirs(os.path.join(log_root, "compare_modal"))
    if modal:
        written.append(
            plot_modality_comparison(
                modal, os.path.join(out_dir, "modality_comparison.png")
            )
        )
    demo = run_dirs(os.path.join(log_root, "demo"))
    if demo:
        written.append(
            plot_training_curves(
                demo, os.path.join(out_dir, "demo_curves.png")
            )
        )
    rep = run_dirs(
        os.path.join(log_root, "compare_privacy_budget", "eps_representative")
    )
    if rep:
        written.append(
            plot_training_curves(
                {f"eps={k}": v for k, v in rep.items()},
                os.path.join(out_dir, "eps_representative_curves.png"),
            )
        )
    grid = run_dirs(os.path.join(log_root, "compare_model_ini_wight"))
    if grid:
        written.append(
            plot_init_weight_comparison(
                grid, os.path.join(out_dir, "init_weight_comparison.png")
            )
        )
    # all three committed run labels of the cross-modal-type driver
    # (the reference renamed its output dir between runs — drivers.py)
    for fam in (
        "compare_corss_model_type",
        "compare_corss_model_type_3layers",
        "compare_corss_model_type_3layers_v2",
    ):
        streams = run_dirs(os.path.join(log_root, fam))
        if streams:
            written.append(
                plot_training_curves(
                    streams, os.path.join(out_dir, f"{fam}_curves.png")
                )
            )
    return written
