"""The DP-SGD training regime (ref: base_train.py:258-434, dp_mode='DPSGD').

Port of the JAX package's ``train/dpsgd_trainer.py``. The reference trains
the TICA_DPSGD model (the two-stream concat, no cross block, no feature DP)
with every parameter frozen but the last BERT layer, the pooler, the fc
layers, the visual encoder and the classifier; Opacus's
``make_private_with_epsilon`` (delta = 1 / len(loader), max_grad_norm 0.1);
Adam at 1e-6; a stochastic eval, F1 and the best-F1 checkpoint each epoch,
in the same record format.

Here sigma comes from the port's RDP accountant, the per-example gradients
from one batched forward and backward over the Poisson window with the
trainable leaves replicated per row (``dp/dpsgd.py``), and Adam (f32
moments, ``ops/optim.py``) updates the trainable leaves in place; the
frozen ones are never written. Each step draws its window, the forward's
dropout (BERT's and the attention kernels') and the Gaussian noise from the
epoch's generator, then runs the cheap weighted forward (eval mode, eps 0)
on the window for the train metrics (dpsgd_trainer.py:102-108 there). An
epoch's losses and accuracies stay on the device: the one host sync of an
epoch reads its whole metric row after the eval. The eval is
``StepFunctions``'s, f32, one batched forward.

Under a mesh (``parallel/train.py::shard_dpsgd_trainer``) each rank takes
its rows of the window and its shards (``dp/dpsgd.py``), the train metrics'
and the eval's logits are gathered over the data group, and rank (0, 0)
writes the records and the best checkpoint, from the gathered tree.

Seeds: as the JAX trainer calls ``set_seed()`` with the reference's seed
(dpsgd_trainer.py:45 there), this one draws its init and every epoch's
generator from ``DEFAULT_SEED``, whatever seed ``TrainAndTest`` was given.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ..data.datasets import MultiModalArrays, epoch_indices, gather_batch
from ..dp import dpsgd
from ..models import fusion
from ..ops.optim import Adam
from ..parallel import sharding
from ..utils.device import resolve_device
from ..utils.seeding import DEFAULT_SEED, derive_seed, generator
from . import checkpoint as ckpt
from . import metrics as M
from .records import RunRecorder
from .trainer import StepFunctions, TrainConfig


class DPSGDTrainer:
    """Runs on the card unless ``device="cpu"``."""

    def __init__(self, fusion_cfg: fusion.FusionConfig, dp_cfg: dpsgd.DPSGDConfig,
                 params=None, bert_params=None, device=None):
        if fusion_cfg.dp_mode != "DPSGD":
            raise ValueError(f"the DP-SGD trainer takes dp_mode 'DPSGD', not "
                             f"{fusion_cfg.dp_mode!r}")
        self.device = resolve_device(device)
        self.fusion_cfg = fusion_cfg
        self.dp_cfg = dp_cfg
        if params is None:
            params = fusion.init(fusion_cfg, derive_seed(DEFAULT_SEED, "init"), self.device,
                                 bert_params=bert_params)
        self.params = params
        n_layers = fusion_cfg.bert_cfg().num_layers
        self.trainable = lambda path: dpsgd.trainable_predicate(path, n_layers)
        self.optimizer = Adam(dp_cfg.learning_rate)
        # the eval is the standard one: f32, hard=True, one batched forward
        self.eval_steps = StepFunctions(fusion_cfg, TrainConfig(batch_size=dp_cfg.batch_size),
                                        self.device)
        self.mesh = None  # set by parallel/train.py::shard_dpsgd_trainer

    def example_losses(self, params, batch, gen):
        """The per-example losses of a training forward (dropout on, from
        ``gen``; the DP-SGD head adds no noise); under a mesh the rank's
        rows'."""
        if self.mesh is None:
            logits = fusion.apply(params, batch, self.fusion_cfg, 0.0, True, gen, True)
            return M.cross_entropy(logits, batch["labels"])
        layout = sharding.Layout.of(self.mesh, batch["labels"].shape[0])
        local = layout.local_rows(batch)
        logits = fusion.apply(params, local, self.fusion_cfg, 0.0, True, gen, True,
                              layout=layout)
        return M.cross_entropy(logits, local["labels"])

    def train_epoch(self, params, opt_state, data, n: int, q: float, window: int, steps: int,
                    step, gen):
        """``steps`` DP-SGD steps, each over a Poisson window of ``window``
        rows drawn from ``gen``. Returns (opt_state, mean loss, mean
        accuracy), the means of the steps' weighted window means, as device
        tensors."""
        losses, accs = [], []
        for _ in range(steps):
            idx, w = dpsgd.poisson_batch_indices(gen, n, q, window)
            batch = gather_batch(data, idx)
            opt_state = step(params, opt_state, batch, w, gen)
            with torch.no_grad():
                logits = self.eval_steps.forward(params, batch, 0.0, True, None, False)
            loss, acc, _, _ = M.cal_loss(logits, batch["labels"], w)
            losses.append(loss)
            accs.append(acc)
        return opt_state, torch.stack(losses).mean(), torch.stack(accs).mean()

    def fit(self, train_data: MultiModalArrays, test_data: MultiModalArrays,
            log_path: Optional[str] = None, model_path: Optional[str] = None,
            echo: bool = True) -> Dict[str, Any]:
        """Train ``dp_cfg.epochs`` epochs; each epoch's legacy record (with
        sigma and delta in ``metrics.jsonl``) to ``log_path``, the best-F1
        params to ``model_path``. Returns {"history", "best", "f1_best",
        "sigma", "delta"}."""
        cfg = self.dp_cfg
        n = len(train_data)
        sigma, q, delta, steps_per_epoch = dpsgd.make_private(n, cfg)
        if echo:
            print(f"DP-SGD: sigma={sigma:.3f} q={q:.5f} delta={delta:.5f} "
                  f"steps/epoch={steps_per_epoch} (target eps={cfg.target_epsilon})")
        window = dpsgd.window_size(n, q)
        step = dpsgd.make_dpsgd_step(self.example_losses, self.trainable, self.optimizer, sigma,
                                     cfg.max_grad_norm, cfg.batch_size, self.mesh)
        opt_state = self.optimizer.init(dpsgd.trainable_leaves(self.params, self.trainable))
        lead = self.mesh is None or self.mesh.is_lead  # under a mesh rank (0, 0) writes
        recorder = RunRecorder(log_path, echo=echo) if log_path and lead else None
        train_dev = train_data.to_device(self.device)
        test_dev = test_data.to_device(self.device)
        eidx, ew = epoch_indices(len(test_data), cfg.batch_size, False, device=self.device)
        f1_best = 0.5  # the F1 an epoch must beat to be the best (dpsgd_trainer.py:121 there)
        history, best = [], None
        for epoch in range(cfg.epochs):
            t0 = time.time()
            gen = generator(derive_seed(DEFAULT_SEED, "dpsgd_epoch", epoch), self.device)
            opt_state, tr_loss, tr_acc = self.train_epoch(
                self.params, opt_state, train_dev, n, q, window, steps_per_epoch, step, gen)
            te_loss, te_acc, preds, labels, _, ws = self.eval_steps.eval_epoch(
                self.params, test_dev, eidx, ew, 0.0, None)
            # one host sync for the whole row
            tr_loss, tr_acc, te_loss, te_acc, f1 = torch.stack(
                [tr_loss, tr_acc, te_loss, te_acc, M.f1(labels, preds, ws)]).tolist()
            dt = time.time() - t0
            row = dict(epoch=epoch + 1, train_loss=tr_loss, train_acc=tr_acc,
                       test_loss=te_loss, test_acc=te_acc, f1=f1, time_cost=dt,
                       sigma=sigma, delta=delta)
            history.append(row)
            rec = None
            if recorder:
                rec = recorder.epoch(epoch, tr_loss, tr_acc, te_loss, te_acc, f1, dt,
                                     extra={"sigma": sigma, "delta": delta})
            if f1 > f1_best:
                f1_best = f1
                best = row
                if model_path:
                    whole = (self.params if self.mesh is None
                             else sharding.gather_params(self.mesh, self.params))
                    if lead:
                        ckpt.save_torch_checkpoint(model_path, whole, self.fusion_cfg)
                if rec:
                    recorder.best_record(rec)
        return {"history": history, "best": best, "f1_best": f1_best,
                "sigma": sigma, "delta": delta}
