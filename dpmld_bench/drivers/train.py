"""The training driver: the alternating step, batch by batch, as
``StepFunctions.train_epoch`` calls it, with the eval epoch and F1 at each
epoch's end, as ``StepFunctions.epoch`` runs them.

One model goes through ``Trainer`` (its ``StepFunctions`` and
``epoch_inputs``); several members (the traffic's ``epsilons``, every
member at the run's seed, ``privacy_utility_frontier``) through
``MemberSteps`` and ``SweepRunner.epoch_inputs``. Set-up builds the one
step object with its weights and optimizer states, drives it through the
epoch's first ``warmup_steps`` steps (the first ``checked_steps`` of them
recorded for the check) and one eval epoch, and the window goes on with
the same object from the next batch. No host sync inside the window; a
CUDA event after every step.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch
from torch.profiler import record_function

from eeg_multimodal_torch.data.datasets import gather_batch
from eeg_multimodal_torch.models import fusion
from eeg_multimodal_torch.train import metrics as M
from eeg_multimodal_torch.train.sweep import MemberSteps, SweepRunner, privacy_utility_frontier
from eeg_multimodal_torch.train.trainer import Trainer, epoch_generator
from eeg_multimodal_torch.utils.trees import tree_items

from ..reference import check, follow

KEYS = {"warmup_steps", "checked_steps", "span_steps"}
B1 = 0.9
WARM_EPOCH = 10**6  # the throwaway eval generator of the set-up's eval epoch


class Driver:
    def __init__(self, prog, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.prog = prog
        eps = traffic["epsilons"]
        self.members = len(eps)
        self.n_train, self.n_test = len(prog.train), len(prog.test)
        self.batch = prog.train_cfg.batch_size
        self.n_batches = -(-self.n_train // self.batch)
        self.last_rows = self.n_train - (self.n_batches - 1) * self.batch
        params = prog.weights(cfg, seed, device)
        if self.members == 1:
            trainer = Trainer(prog.fusion_cfg, prog.train_cfg, params=params, device=device,
                              vocab=prog.vocab)
            self.steps, self.params = trainer.steps, trainer.params
            self.dp_os, self.model_os = trainer.dp_os, trainer.model_os
            self.epsilon = float(eps[0])
            self._inputs = lambda e: trainer.epoch_inputs(e, self.n_train, self.n_test)
        else:
            runner = SweepRunner(prog.fusion_cfg, prog.train_cfg,
                                 privacy_utility_frontier(eps, (seed,)), device=device)
            self.steps = MemberSteps(prog.fusion_cfg, prog.train_cfg, self.members, device)
            self.params = {k: _stack(v, self.members) for k, v in params.items()}
            del params
            self.dp_os, self.model_os = self.steps.init_opt_states(self.params)
            self.epsilon = torch.tensor(eps, dtype=torch.float64, device=device)
            self._inputs = lambda e: runner.epoch_inputs(runner.members, e, self.n_train,
                                                         self.n_test)
        self.train_dev = prog.train.to_device(device)
        self.test_dev = prog.test.to_device(device)
        self.epoch, self.b = -1, 0
        self.losses, self.rows_out = [], []

    # -- the step as train_epoch calls it ------------------------------------
    def _start_epoch(self):
        self.epoch += 1
        self.b = 0
        (self.idx, self.w, self.gen, self.eidx, self.ew,
         self.egen) = self._inputs(self.epoch)
        with record_function("bench.precast_copy"):
            self.params_c = self.steps.precast_copy(self.params) if self.steps.precast else None
        self.losses, self.accs = [], []

    def step(self):
        """One train step (and, after an epoch's last, its eval epoch and F1);
        returns the step's real rows."""
        if self.epoch < 0 or self.b == self.n_batches:
            self._start_epoch()
        b = self.b
        with record_function("bench.gather_batch"):
            batch = gather_batch(self.train_dev, self.idx[b])
        with record_function("bench.train_step"):
            self.dp_os, self.model_os, loss, acc = self.steps.train_step(
                self.params, self.dp_os, self.model_os, batch, self.w[b], self.epsilon,
                self.gen, params_c=self.params_c)
        self.losses.append(loss)
        self.accs.append(acc)
        self.last_loss = loss
        self.b += 1
        if self.b == self.n_batches:
            self._epoch_end()
        return (self.last_rows if b == self.n_batches - 1 else self.batch) * self.members

    def _epoch_end(self, gen=None):
        with record_function("bench.eval_epoch"):
            te_loss, te_acc, preds, labels, _, ws = self.steps.eval_epoch(
                self.params, self.test_dev, self.eidx, self.ew, self.epsilon,
                self.egen if gen is None else gen)
            row = torch.stack([torch.stack(self.losses).mean(0), torch.stack(self.accs).mean(0),
                               te_loss, te_acc, M.f1(labels, preds, ws)], dim=-1)
        if gen is None:
            self.rows_out.append(row)

    def steps_left_in_epoch(self):
        return self.n_batches - self.b if self.epoch >= 0 else self.n_batches

    # -- set-up ----------------------------------------------------------------
    def setup(self):
        """The first steps (recorded for the check) and one eval epoch."""
        t = self.traffic
        rec = {"loss": [[] for _ in range(self.members)]}
        for i in range(t["warmup_steps"]):
            self.step()
            if i < t["checked_steps"]:
                for m, v in enumerate(self.losses[-1].float().reshape(-1).tolist()):
                    rec["loss"][m].append(v)
            if i == 0:
                rec["grad1"] = self._first_gradients()
            if i == t["checked_steps"] - 1:
                rec["change"] = self._changes()
        egen = [epoch_generator(self.seed, WARM_EPOCH, "eval", self.device)] * self.members
        self._epoch_end(egen[0] if self.members == 1 else tuple(egen))
        self.program_records = rec
        if self.device.type == "cuda":
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(4096)]
            torch.cuda.synchronize(self.device)

    def _model_paths(self):
        return [p for p, _ in tree_items(self.params) if not fusion.dp_param_predicate(p)]

    def _first_gradients(self):
        """Each leaf's gradient as the optimizers got it at step 1, from
        their first moments: mu / (1 - b1)."""
        grads = {"DP": self.dp_os.mu[0] / (1 - B1)}
        grads.update({p: m.float() / (1 - B1)
                      for p, m in zip(self._model_paths(), self.model_os.mu)})
        return check.program_norms(grads, self.members)

    def _changes(self):
        """Each leaf's change since the weights were made."""
        start = dict(tree_items(self.prog.weights(self.cfg, self.seed, self.device)))
        diffs = {p: t - start[p] for p, t in tree_items(self.params)}
        out = check.program_norms(diffs, self.members)
        del start, diffs
        return out

    # -- the window -----------------------------------------------------------------
    def window(self, seconds: float):
        dev = self.device
        cuda = dev.type == "cuda"
        events = self.events if cuda else []
        rows = steps = 0
        host = 0.0
        if cuda:
            events[0].record()
        t0 = time.perf_counter()
        losses = []
        epoch0 = self.epoch
        while True:
            th = time.perf_counter()
            rows += self.step()
            host += time.perf_counter() - th
            losses.append(self.last_loss)
            steps += 1
            if cuda:
                if steps >= len(events):
                    events.append(torch.cuda.Event(enable_timing=True))
                events[steps].record()
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        self.window_steps = steps
        evals = self.epoch - epoch0 + (self.b == self.n_batches)
        gaps = [events[i].elapsed_time(events[i + 1]) for i in range(steps)] if cuda else [0.0]
        finite = torch.isfinite(torch.stack(losses).reshape(steps, -1)).all(1)
        self.failed = int((~finite).sum())
        return {"seconds": t1 - t0, "steps": steps, "rows": rows, "step_host_s": host,
                "step_ms": gaps, "evals": evals}

    def attempts(self):
        """(steps attempted in the window, steps whose loss is not finite)."""
        return self.window_steps, self.failed

    def span(self, steps: int):
        """``steps`` train steps inside one epoch (the rest of this epoch, and
        its eval, run first when fewer are left); returns what the readers
        count over them."""
        if self.steps_left_in_epoch() <= steps:
            while self.steps_left_in_epoch() > 0:
                self.step()
        return {"run": lambda: sum(self.step() for _ in range(steps)), "steps": steps}

    # -- the check ---------------------------------------------------------------------
    def release(self):
        for name in ("steps", "params", "dp_os", "model_os", "params_c", "train_dev", "test_dev",
                     "gen", "egen", "losses", "accs", "rows_out"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        ref = follow.train_records(self.cfg, self.traffic, self.seed, self.device, "float32",
                                   self.traffic["checked_steps"])
        return check.train_numbers(self.program_records, ref)


def _stack(tree, members):
    """Every leaf of ``tree`` repeated on a leading member axis."""
    if isinstance(tree, dict):
        return {k: _stack(v, members) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stack(v, members) for v in tree]
    return tree.unsqueeze(0).repeat(members, *(1,) * tree.dim()).contiguous()


def p95(values):
    return statistics.quantiles(values, n=20)[18]
