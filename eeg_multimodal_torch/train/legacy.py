"""The legacy generation's trainers (the reference's root scripts).

Port of the JAX package's ``train/legacy.py``:

1. :class:`MetricTrainer` (ref train.py): the argparse-config trainer. Plain
   f32 Adam over every leaf, ``DP`` included; a loss of sum(ce * weight)
   (train.py:110-112); ``n_para`` gradient-accumulation repeats before one
   Adam step, each repeat drawing from its own generator (train.py:108-113);
   an eval every ``interval`` epochs under ``n_eval`` stochastic repeats
   (train.py:126-138), all repeats of all batches one forward, repeat r's
   rows drawing from generator r (a group, ``models/layers.py``); the metric
   registry (train.py:79-80), the ``DP`` history, the best-Accuracy
   ``model.pth`` (train.py:141-143) and ``results.pkl`` every epoch
   (train.py:144-145).
2. :class:`PriGumbelPretrainer` (ref train_val.py pretrain()): the legacy
   PriGumbel head (``fusion.legacy_pri_gumbel_apply``) trained with the
   privacy-regularized loss alpha CE + max((1 - w) e^eps + w)
   (train_val.py:80-93), the privacy budget's max and mean per epoch
   (train_val.py:222-226), ``result.pkl`` with the seven curves
   (train_val.py:275-277) and the best-F1 ``best_f1.pickle``.
3. :func:`alpha_sweep_values`: train_val.py:532's alpha grid.

Both run on the card unless ``device="cpu"``. Every draw comes from
generators seeded from (cfg.seed, "epoch", epoch, name), as ``Trainer``'s.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import MultiModalArrays, epoch_indices, gather_batch
from ..models import fusion
from ..ops import dp as dp_ops
from ..ops.optim import Adam
from ..utils.device import resolve_device
from ..utils.seeding import DEFAULT_SEED, derive_seed
from ..utils.trees import tree_items, tree_map
from . import checkpoint as ckpt
from . import metrics as M
from .records import RunRecorder
from .trainer import epoch_generator


@dataclasses.dataclass(frozen=True)
class MetricTrainConfig:
    """ref train.py:29-47 argparse surface."""

    exp: str = "test"
    name: str = "test"
    batch_size: int = 8
    eps: float = 2.0
    n_class: int = 2
    n_dp: int = 1
    n_para: int = 1
    n_eval: int = 5
    n_epochs: int = 50
    interval: int = 1
    metrics: str = "Accuracy"  # CSV of registry names (train.py:45)
    learning_rate: float = 1e-6
    seed: int = DEFAULT_SEED


class _LegacyTrainer:
    """The legacy trainers' shared parts: params on the device, plain f32
    Adam over every leaf, and the epoch's generators."""

    def __init__(self, params, learning_rate: float, seed: int):
        self.params = params
        self.seed = seed
        self.optimizer = Adam(learning_rate)
        self.opt_state = self.optimizer.init(self.leaves())

    def leaves(self) -> List[torch.Tensor]:
        return [t for _, t in tree_items(self.params)]

    def gen(self, epoch: int, name: str, device=None) -> torch.Generator:
        return epoch_generator(self.seed, epoch, name, self.device if device is None else device)

    def step(self, loss_of):
        """Adam on the gradient of ``loss_of(tree)`` over every leaf, in
        place; returns what ``loss_of`` returns, detached."""
        tracked = [t.detach().requires_grad_() for t in self.leaves()]
        it = iter(tracked)
        loss, *aux = loss_of(tree_map(lambda _: next(it), self.params))
        grads = torch.autograd.grad(loss, tracked)
        self.opt_state = self.optimizer.update(self.leaves(), list(grads), self.opt_state)
        return (loss.detach(), *(a.detach() for a in aux))


class MetricTrainer(_LegacyTrainer):
    def __init__(self, fusion_cfg: fusion.FusionConfig, cfg: MetricTrainConfig,
                 params=None, bert_params=None, device=None):
        self.device = resolve_device(device)
        self.fusion_cfg = fusion_cfg
        self.cfg = cfg
        if params is None:
            params = fusion.init(fusion_cfg, derive_seed(cfg.seed, "init"), self.device,
                                 bert_params)
        super().__init__(params, cfg.learning_rate, cfg.seed)
        self.metric_fns = {name: M.METRICS[name] for name in cfg.metrics.split(",")}

    def _loss(self, params, batch, weight, gen, dp_noise=None, dropout=True):
        logits = fusion.apply(params, batch, self.fusion_cfg, self.cfg.eps, True, gen, dropout,
                              dp_noise)
        # train.py:110-112: reduction='none', then .sum()
        return (M.cross_entropy(logits, batch["labels"]) * weight).sum()

    def train_step(self, batch, weight, gens, dp_noise=None, dropout=True):
        """One Adam step on the gradients of ``n_para`` repeats, repeat r
        drawing from ``gens[r]`` (train.py:108-113); returns the mean of
        the repeats' losses. Test-only: ``dp_noise`` hands repeat r its DP
        noise ``dp_noise[r]``, ``dropout=False`` turns dropout off."""
        noises = dp_noise if dp_noise is not None else [None] * len(gens)

        def loss_of(tree):
            return (sum(self._loss(tree, batch, weight, g, n, dropout)
                        for g, n in zip(gens, noises)),)
        return self.step(loss_of)[0] / len(gens)

    @torch.no_grad()
    def eval_epoch(self, data, idx, gens):
        """The ``n_eval`` repeats of every (n_batches, B) batch as one
        forward, repeat r's rows drawing from ``gens[r]``; returns (logits,
        preds, ce) as (n_batches, n_eval, B, ...) and the labels (n_batches,
        B), the JAX scan's layout."""
        n_eval, (n, B) = len(gens), idx.shape
        batch = gather_batch(data, idx.reshape(-1).repeat(n_eval))
        logits = fusion.apply(self.params, batch, self.fusion_cfg, self.cfg.eps, True,
                              tuple(gens), False)
        ce = M.cross_entropy(logits, batch["labels"])
        logits = logits.reshape(n_eval, n, B, -1).transpose(0, 1)
        return (logits, logits.argmax(-1), ce.reshape(n_eval, n, B).transpose(0, 1),
                batch["labels"][:n * B].reshape(n, B))

    def fit(self, train_data: MultiModalArrays, val_data: MultiModalArrays,
            base_path: Optional[str] = None, echo: bool = True) -> Dict[str, Any]:
        cfg = self.cfg
        if base_path is None:
            base_path = f"experiment/{cfg.exp}/{cfg.name}/"
        os.makedirs(base_path, exist_ok=True)
        from ..utils.logging import setup_run_logging

        logger = setup_run_logging(base_path) if echo else None
        train_dev = train_data.to_device(self.device)
        val_dev = val_data.to_device(self.device)
        results: Dict[str, Any] = {k: [] for k in (
            "train_loss", "logits", "pred", "val_loss", "DP_params")}
        for name in self.metric_fns:
            results[name] = []
        results["labels"] = np.asarray(val_data.labels)
        best_acc = 0.0

        for epoch in range(cfg.n_epochs):
            idx, w = epoch_indices(len(train_data), cfg.batch_size, True,
                                   self.gen(epoch, "shuffle", device="cpu"), self.device)
            gens = [self.gen(epoch, f"train{r}") for r in range(cfg.n_para)]
            losses = torch.stack([
                self.train_step(gather_batch(train_dev, b_idx), wb, gens)
                for b_idx, wb in zip(idx, w)]).cpu().numpy()
            results["train_loss"].append(losses)
            if logger:
                logger.debug(f"Train Epoch: {epoch:3d} loss {float(losses.mean()):.4f}")

            if (epoch + 1) % cfg.interval == 0:
                eidx, ew = epoch_indices(len(val_data), cfg.batch_size, False, None, self.device)
                _, preds, ces, labels = self.eval_epoch(
                    val_dev, eidx, [self.gen(epoch, f"eval{r}") for r in range(cfg.n_eval)])
                # (n_batches, n_eval, B) -> (N, n_eval) sample-major
                preds_np = preds.transpose(1, 2).reshape(-1, cfg.n_eval).cpu().numpy()
                sel = ew.reshape(-1).cpu().numpy() > 0
                preds_np = preds_np[sel]
                labels_np = labels.reshape(-1).cpu().numpy()[sel]
                results["pred"].append(preds_np)
                results["val_loss"].append(ces.cpu().numpy())
                info = f"Eval  Epoch: {epoch:3d}"
                for name, fn in self.metric_fns.items():
                    vals = np.asarray([fn(labels_np, preds_np[:, r]) for r in range(cfg.n_eval)])
                    results[name].append(vals)
                    info += f" | {name}: {vals.mean():5.2f}"
                if "DP" in self.params:
                    results["DP_params"].append(self.params["DP"].detach().cpu().numpy())
                if logger:
                    logger.info(info)
                if "Accuracy" not in results:
                    # the JAX trainer's ``results.get("Accuracy", [[0.0]])[-1].mean()``
                    # raises here, on a list (legacy.py:204 there): mirrored, with the cause
                    raise AttributeError(
                        f"MetricTrainer.fit keeps the best model by 'Accuracy', which metrics="
                        f"{cfg.metrics!r} does not name ('list' object has no attribute "
                        "'mean', as in the JAX package)")
                acc = float(np.mean(results["Accuracy"][-1]))
                if acc > best_acc:
                    best_acc = acc
                    ckpt.save_torch_checkpoint(os.path.join(base_path, "model.pth"),
                                               self.params, self.fusion_cfg)
            # the results.pth equivalent, every epoch (train.py:144-145)
            with open(os.path.join(base_path, "results.pkl"), "wb") as f:
                pickle.dump({k: v for k, v in results.items() if k != "labels"}, f)
        return {"results": results, "best_acc": best_acc}


# ---------------------------------------------------------------------------
# PriGumbel pretraining (train_val.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PriGumbelConfig:
    tau: float = 0.1  # train_val.py pretrain(tau=...)
    epsilon: float = 0.1
    alpha: float = 1.0
    learning_rate: float = 1e-6
    batch_size: int = 8
    epochs: int = 30  # train_val.py:172
    seed: int = DEFAULT_SEED


class PriGumbelPretrainer(_LegacyTrainer):
    def __init__(self, fusion_cfg: fusion.FusionConfig, cfg: PriGumbelConfig,
                 params=None, bert_params=None, device=None):
        self.device = resolve_device(device)
        self.fusion_cfg = fusion_cfg
        self.cfg = cfg
        if params is None:
            params = fusion.legacy_pri_gumbel_init(fusion_cfg, derive_seed(cfg.seed, "init"),
                                                   self.device, bert_params)
        super().__init__(params, cfg.learning_rate, cfg.seed)

    def loss(self, params, batch, weight, gen, train, gumbel=None, lap_noise=None):
        """(alpha CE + max((1 - w) e^eps + w), accuracy, predictions);
        ``gumbel`` and ``lap_noise`` hand the head's draws in (tests)."""
        cfg = self.cfg
        logits = fusion.legacy_pri_gumbel_apply(params, batch, self.fusion_cfg, cfg.epsilon,
                                                cfg.tau, gen, train, gumbel, lap_noise)
        ce, acc, pred, _ = M.cal_loss(logits, batch["labels"], weight)
        return dp_ops.privacy_regularized_loss(ce, params["w"], cfg.alpha, cfg.epsilon), acc, pred

    def train_step(self, batch, weight, gen, train=True, **draws):
        """One Adam step; returns (loss, accuracy). Test-only: ``train=False``
        takes the eval forward (no dropout, the hard gate), and ``draws``
        hands the head's draws in."""
        return self.step(lambda tree: self.loss(tree, batch, weight, gen, train, **draws)[:2])

    @torch.no_grad()
    def eval_epoch(self, data, idx, weight, gen):
        """Per batch (loss, accuracy, predictions, labels), stacked."""
        out = [self.loss(self.params, gather_batch(data, b), wb, gen, False) + (data["labels"][b],)
               for b, wb in zip(idx, weight)]
        return tuple(torch.stack(t) for t in zip(*out))

    def pretrain(self, train_data, val_data, path: str, echo: bool = True):
        """ref train_val.py pretrain(): the epochs with the seven curves and
        the privacy statistics, result.pkl and the best-F1 checkpoint."""
        cfg = self.cfg
        os.makedirs(path, exist_ok=True)
        recorder = RunRecorder(path, echo=echo)
        train_dev = train_data.to_device(self.device)
        val_dev = val_data.to_device(self.device)
        curves = {k: [] for k in (
            "train_loss", "train_acc", "val_loss", "val_acc", "f1",
            "privacy_budget_max", "privacy_budget_avg")}
        f1_best = 0.5
        for epoch in range(cfg.epochs):
            t0 = time.time()
            idx, w = epoch_indices(len(train_data), cfg.batch_size, True,
                                   self.gen(epoch, "shuffle", device="cpu"), self.device)
            train_gen = self.gen(epoch, "train")
            tr = torch.stack([torch.stack(self.train_step(gather_batch(train_dev, b), wb,
                                                          train_gen))
                              for b, wb in zip(idx, w)]).mean(0)
            eidx, ew = epoch_indices(len(val_data), cfg.batch_size, False, None, self.device)
            losses, accs, preds, labels = self.eval_epoch(val_dev, eidx, ew, self.gen(epoch, "eval"))
            f1 = float(M.f1(labels.reshape(-1), preds.reshape(-1), ew.reshape(-1)))
            # the privacy budget per feature: (1 - w) e^eps + w (train_val.py:222-226)
            wv = self.params["w"].detach().cpu().numpy()
            budget = (1 - wv) * np.exp(cfg.epsilon) + wv
            tr_loss, tr_acc = tr.tolist()
            dt = time.time() - t0
            for k, v in (
                ("train_loss", tr_loss), ("train_acc", tr_acc),
                ("val_loss", float(losses.mean())), ("val_acc", float(accs.mean())),
                ("f1", f1),
                ("privacy_budget_max", float(budget.max())),
                ("privacy_budget_avg", float(budget.mean())),
            ):
                curves[k].append(v)
            rec = recorder.epoch(
                epoch, tr_loss, tr_acc, curves["val_loss"][-1], curves["val_acc"][-1], f1, dt,
                extra={"privacy_budget_max": curves["privacy_budget_max"][-1],
                       "privacy_budget_avg": curves["privacy_budget_avg"][-1],
                       "alpha": cfg.alpha})
            if f1 > f1_best:
                f1_best = f1
                ckpt.save_torch_checkpoint(os.path.join(path, "best_f1.pickle"), self.params,
                                           self.fusion_cfg)
                recorder.best_record(rec)
            with open(os.path.join(path, "result.pkl"), "wb") as f:
                pickle.dump(curves, f)
        return {"curves": curves, "f1_best": f1_best}


def alpha_sweep_values(n: int = 50) -> np.ndarray:
    """ref train_val.py:532: exp(linspace(log(0.01), 2, 50))."""
    return np.exp(np.linspace(np.log(0.01), 2.0, n))
