"""CLIP-embedding distillation from the real CLIP outputs of the test split.

Port of the JAX package's ``train/distill.py``. The reference's tree holds
the (601, 512) f32 real OpenAI CLIP ViT-B/32 embeddings of the test split's
act rows (``feature/action/test_clip_v2.pickle``, from get_embedding.py:62-71
over ``TransferToImage`` renders) but lost the train split's. The act
render is a deterministic function of the row (get_embedding.py:26-31), so
CLIP's embedding of it is one too: a small MLP learns it from the 601
pairs and predicts the 2402 train rows' embeddings. No labels are involved.

Training is full-batch Adam on standardized inputs and targets with
Gaussian input jitter, on the device with no host sync until the end;
quality is the held-out cosine on a validation split of the pairs, before
the deployed distiller is refit on all of them. The MLP's GELU is the tanh
approximation (``jax.nn.gelu``'s default). Every random draw can be handed
in (the init, the jitter), so that the CPU tests give the port JAX's.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.datasets import load_feature_csv
from ..ops.optim import AdamW, warmup_cosine_decay_schedule
from ..utils.device import resolve_device
from ..utils.seeding import derive_seed, generator
from ..utils.trees import tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """The JAX package's ``DistillConfig`` (distill.py:33-50 there), every
    field with its name and default."""

    hidden: int = 1024
    depth: int = 3  # hidden layers
    steps: int = 4000
    learning_rate: float = 1e-3
    warmup: int = 100
    jitter: float = 0.05  # stddev of the input noise, in standardized units
    cosine_weight: float = 1.0  # weight of (1 - cos) beside the MSE
    val_frac: float = 0.1
    seed: int = 0
    # fit the deployed distiller on this random fraction of the pairs only
    # (a leakage control); 1.0 fits on all of them, as the reference's use
    fit_fraction: float = 1.0


def _init_mlp(gen: torch.Generator, d_in: int, d_out: int, cfg: DistillConfig):
    """He-normal kernels (in, out) and zero biases, drawn from ``gen`` on
    its device."""
    dims = [d_in] + [cfg.hidden] * cfg.depth + [d_out]
    return [{"w": torch.randn(a, b, generator=gen, device=gen.device) * (2.0 / a) ** 0.5,
             "b": torch.zeros(b, device=gen.device)} for a, b in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers, x):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = F.gelu(x, approximate="tanh")
    return x


class CLIPDistiller:
    """row (d_in,) -> CLIP embedding (512,) regressor, on the card unless
    ``device="cpu"``. Its params are a self-contained tree: the MLP and the
    input and target standardization moments."""

    def __init__(self, cfg: DistillConfig = DistillConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _fit_arrays(self, rows, targets, x_mean, x_std, gen, steps, init=None, noise=None):
        """``steps`` full-batch Adam steps on (rows, targets) (numpy f32),
        standardized by (x_mean, x_std) and the targets' own moments.
        Returns (params, the last step's loss). ``init`` (an MLP tree) and
        ``noise`` (``steps`` standard-normal (N, d_in) arrays), tests only,
        replace the draws from ``gen``."""
        cfg, dev = self.cfg, self.device
        y_mean = targets.mean(0)
        y_std = targets.std(0) + 1e-6

        def put(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

        x, y, y_raw = put((rows - x_mean) / x_std), put((targets - y_mean) / y_std), put(targets)
        y_mean_t, y_std_t = put(y_mean), put(y_std)
        params = (tree_map(put, init) if init is not None
                  else _init_mlp(gen, x.shape[1], y.shape[1], cfg))
        leaves = [t for _, t in tree_items(params)]
        opt = AdamW(warmup_cosine_decay_schedule(0.0, cfg.learning_rate, cfg.warmup, steps))
        state = opt.init(leaves)
        y_norm = torch.linalg.norm(y_raw, dim=-1)
        for s in range(steps):
            eps = put(noise[s]) if noise is not None else torch.randn(
                x.shape, generator=gen, device=dev)
            aliases = [t.detach().requires_grad_() for t in leaves]
            it = iter(aliases)
            pred = _mlp_apply(tree_map(lambda _: next(it), params), x + cfg.jitter * eps)
            mse = ((pred - y) ** 2).mean()
            pred_raw = pred * y_std_t + y_mean_t
            cos = (pred_raw * y_raw).sum(-1) / (torch.linalg.norm(pred_raw, dim=-1) * y_norm
                                                + 1e-8)
            loss = mse + cfg.cosine_weight * (1.0 - cos).mean()
            state = opt.update(leaves, list(torch.autograd.grad(loss, aliases)), state)
        return {"mlp": params, "x_mean": put(x_mean), "x_std": put(x_std), "y_mean": y_mean_t,
                "y_std": y_std_t}, float(loss.detach())

    @torch.no_grad()
    def predict(self, params, rows):
        """The embeddings of ``rows`` as a device tensor."""
        x = (torch.as_tensor(np.asarray(rows, np.float32), device=self.device)
             - params["x_mean"]) / params["x_std"]
        return _mlp_apply(params["mlp"], x) * params["y_std"] + params["y_mean"]

    @staticmethod
    def cosine(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
                                  + 1e-12)

    def fit(self, rows, targets, extra_rows: Optional[np.ndarray] = None):
        """Fit on (rows, targets); returns (params, metrics). A ``val_frac``
        split is held out first to measure the held-out cosine and relative
        MSE, then the deployed params are refit on all pairs with the same
        number of steps. ``extra_rows`` (the train split's rows) enter only
        the input standardization, so the normalizer covers the rows the
        distiller will predict."""
        cfg = self.cfg
        rows = np.asarray(rows, np.float32)
        targets = np.asarray(targets, np.float32)
        all_rows = (np.concatenate([rows, np.asarray(extra_rows, np.float32)])
                    if extra_rows is not None else rows)
        x_mean = all_rows.mean(0)
        x_std = all_rows.std(0) + 1e-6
        perm = np.random.RandomState(cfg.seed).permutation(len(rows))
        n_val = max(1, int(len(rows) * cfg.val_frac))
        val_idx, tr_idx = perm[:n_val], perm[n_val:]

        def gen(name):
            return generator(derive_seed(cfg.seed, "distill", name), self.device)

        p_holdout, _ = self._fit_arrays(rows[tr_idx], targets[tr_idx], x_mean, x_std,
                                        gen("holdout"), cfg.steps)
        val_pred = self.predict(p_holdout, rows[val_idx]).cpu().numpy()
        val_cos = self.cosine(val_pred, targets[val_idx])
        val_t = targets[val_idx]
        val_rel_mse = float(np.mean(np.square(val_pred - val_t))
                            / np.mean(np.square(val_t - val_t.mean(0))))
        params, final_loss = self._fit_arrays(rows, targets, x_mean, x_std, gen("final"),
                                              cfg.steps)
        return params, {"val_cosine_mean": float(val_cos.mean()),
                        "val_cosine_min": float(val_cos.min()), "val_rel_mse": val_rel_mse,
                        "n_val": int(n_val), "final_train_loss": final_loss}


def build_distilled_act_tree(data_root: str, out_tree: str, real_test_pickle: str,
                             cfg: DistillConfig = DistillConfig(), echo: bool = True,
                             device=None):
    """Synthesize the train split's act CLIP embeddings into a new tree.

    Writes ``data/embedding/act/img/clip_ViT_B_32/{train,test}.pickle``
    under ``out_tree``: test the real array as it is, train the distiller's
    predictions for the train split's act rows; copies the processed CSVs
    and the text and EEG-image embeddings from ``data_root``, so the result
    is a whole data root. Returns the distiller's metrics. On the card
    unless ``device="cpu"``."""
    test_rows = load_feature_csv(os.path.join(data_root, "data", "processed", "test_act.csv"))
    train_rows = load_feature_csv(os.path.join(data_root, "data", "processed", "train_act.csv"))
    with open(real_test_pickle, "rb") as f:
        test_clip = np.asarray(pickle.load(f), np.float32)
    if test_clip.ndim != 2 or test_clip.shape[0] != len(test_rows):
        raise ValueError(f"{real_test_pickle}: shape {test_clip.shape}, expected "
                         f"({len(test_rows)}, D) for the test split's act rows")

    distiller = CLIPDistiller(cfg, device)
    fit_rows, fit_clip = test_rows, test_clip
    if cfg.fit_fraction < 1.0:
        n_fit = max(2, int(len(test_rows) * cfg.fit_fraction))
        sel = np.random.RandomState(cfg.seed + 1).permutation(len(test_rows))[:n_fit]
        fit_rows, fit_clip = test_rows[sel], test_clip[sel]
        if echo:
            print(f"[distill] fit_fraction={cfg.fit_fraction}: fitting on {n_fit}/"
                  f"{len(test_rows)} test pairs (control run)", flush=True)
    params, metrics = distiller.fit(fit_rows, fit_clip, extra_rows=train_rows)
    metrics["fit_fraction"] = float(cfg.fit_fraction)
    train_clip = distiller.predict(params, train_rows).cpu().numpy().astype(np.float32)
    if echo:
        print(f"[distill] held-out cosine {metrics['val_cosine_mean']:.4f} (min "
              f"{metrics['val_cosine_min']:.4f}) rel-MSE {metrics['val_rel_mse']:.4f} over "
              f"{metrics['n_val']} rows", flush=True)

    for sub in ("data/processed", "data/embedding/EEG/txt", "data/embedding/act/txt",
                "data/embedding/EEG/img"):
        src = os.path.join(data_root, sub)
        if os.path.isdir(src):
            # dirs_exist_ok: a rerun into a stale tree refreshes the copies too
            shutil.copytree(src, os.path.join(out_tree, sub), dirs_exist_ok=True)
    save_dir = os.path.join(out_tree, "data", "embedding", "act", "img", "clip_ViT_B_32")
    os.makedirs(save_dir, exist_ok=True)
    for split, arr in (("train", train_clip), ("test", test_clip)):
        with open(os.path.join(save_dir, f"{split}.pickle"), "wb") as f:
            pickle.dump(arr, f)
    return metrics
