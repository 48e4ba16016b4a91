"""The eval driver: ``StepFunctions.eval_epoch`` back to back over the eval
rows, each epoch with its own eval generator (epoch e's, as
``Trainer.epoch_inputs`` draws it), then F1, as ``StepFunctions.epoch``
runs them. Forward only: no backward, no Adam, no dropout; the DP noise on.
Every epoch's loss, F1, votes and scores stay on the device until the
window has closed; the check follows a sample of them drawn from the seed.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from eeg_multimodal_torch.data.datasets import epoch_indices
from eeg_multimodal_torch.train import metrics as M
from eeg_multimodal_torch.train.trainer import StepFunctions, epoch_generator

from ..reference import check, follow

KEYS = {"warmup_epochs", "checked_epochs", "span_epochs"}
WARM_EPOCH = 10**6  # the throwaway generators of the set-up's epochs


class Driver:
    def __init__(self, prog, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.steps = StepFunctions(prog.fusion_cfg, prog.train_cfg, device)
        self.params = prog.weights(cfg, seed, device)
        self.test_dev = prog.test.to_device(device)
        self.n_test = len(prog.test)
        self.eidx, self.ew = epoch_indices(self.n_test, prog.train_cfg.batch_size, False, None,
                                           device)
        self.epsilon = float(traffic["epsilons"][0])
        self.epoch = 0
        self.outputs = []

    def _eval(self, gen):
        with record_function("bench.eval_epoch"):
            loss, _, preds, labels, scores, ws = self.steps.eval_epoch(
                self.params, self.test_dev, self.eidx, self.ew, self.epsilon, gen)
            return loss, M.f1(labels, preds, ws), preds, scores

    def step(self):
        """One eval epoch; returns its real rows."""
        gen = epoch_generator(self.seed, self.epoch, "eval", self.device)
        self.outputs.append(self._eval(gen))
        self.epoch += 1
        return self.n_test

    def setup(self):
        for k in range(self.traffic["warmup_epochs"]):
            self._eval(epoch_generator(self.seed, WARM_EPOCH + k, "eval", self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float):
        rows = steps = 0
        host = 0.0
        t0 = time.perf_counter()
        while True:
            th = time.perf_counter()
            rows += self.step()
            host += time.perf_counter() - th
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_epochs = steps
        return {"seconds": time.perf_counter() - t0, "steps": steps, "rows": rows,
                "step_host_s": host}

    def attempts(self):
        """(eval epochs attempted in the window, epochs whose loss is not
        finite)."""
        n = self.window_epochs
        finite = torch.isfinite(torch.stack([o[0] for o in self.outputs[:n]]).reshape(n, -1))
        return n, int((~finite.all(1)).sum())

    def span(self, steps: int):
        return {"run": lambda: sum(self.step() for _ in range(steps)), "steps": steps}

    def sample(self):
        """The window's epochs the check follows: the first, the last and
        ``checked_epochs - 2`` more drawn from the seed."""
        n = self.window_epochs
        rng = np.random.default_rng([self.seed & (2**64 - 1), 19])
        inner = rng.choice(np.arange(1, max(n - 1, 1)), min(max(n - 2, 0),
                                                             self.traffic["checked_epochs"] - 2),
                           replace=False)
        return sorted({0, n - 1, *inner.tolist()})

    def release(self):
        picked = self.sample()
        self.program_records = {
            "epochs": picked,
            "f1": [float(self.outputs[e][1]) for e in picked],
            "votes": [self.outputs[e][2].cpu() for e in picked],
            "scores": [self.outputs[e][3].cpu() for e in picked]}
        for name in ("steps", "params", "test_dev", "outputs"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        prog = self.program_records
        ref = follow.eval_records(self.cfg, self.traffic, self.seed, self.device,
                                  prog["epochs"])
        return check.eval_numbers(prog, ref)
