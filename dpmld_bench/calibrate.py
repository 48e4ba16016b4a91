"""The readings the limits of ``correct`` are set from, many seeds in one
process.

    python3 -m dpmld_bench.calibrate --workload <cell> --seeds 1,2,3 \
        --modes program,control,half_batch [--seconds 2] [--out file.jsonl]

For each mode and seed, one JSON line with the numbers the check compares:

- ``program``: the program as a run drives it (set-up's first steps, or a
  short eval window), against the reference: the lower readings;
- ``control``: the reference itself in the program's place, its products one
  precision step below the configuration's (TF32 for float32, float8 e4m3
  for bfloat16), against the reference: the upper readings;
- ``half_batch``: the program with the second half of every batch weighted
  out, the means taken over the rest;
- ``altered``: the program with its answer altered where it is produced
  (the step's loss plus one; the first eval batch's votes flipped).

A training reading also carries ``grad1_gap_own`` and ``change3_gap_own``,
each leaf's gap over its own reference norm with no median floor, the
leaves of a small reference gradient left out (not compared), and the
leaves that read worst.

A step that returns its state unchanged reads 1 on ``grad1_gap`` and
``change3_gap`` by their definition and needs no run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from . import drivers, program
from .reference import check, follow
from .reference.model import f1_binary
from .run import cell_spec

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


@contextlib.contextmanager
def fault(mode: str):
    """The program's timed path broken as ``mode`` says, for the block."""
    from eeg_multimodal_torch.train.trainer import StepFunctions

    saved = StepFunctions.train_step, StepFunctions.eval_epoch
    train_step, eval_epoch = saved

    if mode == "half_batch":
        def halve(w):
            w = w.clone()
            w.reshape(-1, w.shape[-1])[:, w.shape[-1] // 2:] = 0
            return w

        def broken_train(self, params, dp_os, model_os, batch, weight, *a, **k):
            return train_step(self, params, dp_os, model_os, batch, halve(weight), *a, **k)

        def broken_eval(self, params, data, idx, weight, *a, **k):
            return eval_epoch(self, params, data, idx, halve(weight), *a, **k)
    elif mode == "altered":
        def broken_train(self, *a, **k):
            dp_os, model_os, loss, acc = train_step(self, *a, **k)
            return dp_os, model_os, loss + 1.0, acc

        def broken_eval(self, *a, **k):
            loss, acc, preds, labels, scores, ws = eval_epoch(self, *a, **k)
            preds = preds.clone()
            preds[..., :8] = 1 - preds[..., :8]
            return loss, acc, preds, labels, scores, ws
    elif mode == "unchanged":
        def broken_train(self, params, dp_os, model_os, batch, weight, *a, **k):
            zero = torch.zeros((*self.lead,), device=weight.device)
            return dp_os, model_os, zero, zero

        broken_eval = eval_epoch
    else:
        raise ValueError(f"unknown fault {mode!r}")
    StepFunctions.train_step, StepFunctions.eval_epoch = broken_train, broken_eval
    try:
        yield
    finally:
        StepFunctions.train_step, StepFunctions.eval_epoch = saved


def program_numbers(cfg, traffic, seed, device, seconds):
    """The program's numbers (for training with the own-norm readings), and
    for training the leaves that read worst."""
    prog = program.build(cfg, traffic, seed)
    driver = drivers.driver(traffic).Driver(prog, cfg, traffic, seed, device)
    driver.setup()
    if traffic["driver"] == "eval":
        driver.window(seconds)
    driver.release()
    if traffic["driver"] != "train":
        return driver.check(), {}
    ref = follow.train_records(cfg, traffic, seed, device, "float32", traffic["checked_steps"])
    rec = driver.program_records
    return ({**check.train_numbers(rec, ref), **check.own_norm_gaps(rec, ref)},
            check.worst_leaves(rec, ref))


def control_numbers(cfg, traffic, seed, device):
    """The reference one precision step below the configuration's, in the
    program's place."""
    low = CONTROL[cfg["program"]["compute_dtype"]]
    if traffic["driver"] == "train":
        steps = traffic["checked_steps"]
        ctrl = follow.train_records(cfg, traffic, seed, device, low, steps)
        ref = follow.train_records(cfg, traffic, seed, device, "float32", steps)
        return {**check.train_numbers(ctrl, ref), **check.own_norm_gaps(ctrl, ref)}
    epochs = list(range(traffic["checked_epochs"]))
    ref = follow.eval_records(cfg, traffic, seed, device, epochs)
    low_rec = follow.eval_records(cfg, traffic, seed, device, epochs, low)
    votes = [lg.argmax(-1) for lg in low_rec["logits"]]
    ctrl = {"epochs": epochs, "votes": votes,
            "scores": [lg[:, 1] for lg in low_rec["logits"]],
            "f1": [float(f1_binary(ref["labels"], v, ref["weight"])) for v in votes]}
    return check.eval_numbers(ctrl, ref)


def readings(workload, seeds, modes, seconds, device, edit=None):
    """One dict of numbers for each mode and seed, as the module docstring
    says; ``edit(cfg, traffic)`` may change the specs first (small sizes)."""
    _, _, cfg, traffic, limits = cell_spec(workload)
    if edit is not None:
        edit(cfg, traffic)
    for mode in modes:
        for seed in seeds:
            worst = {}
            if mode == "program":
                numbers, worst = program_numbers(cfg, traffic, seed, device, seconds)
            elif mode == "control":
                numbers = control_numbers(cfg, traffic, seed, device)
            else:
                with fault(mode):
                    numbers, worst = program_numbers(cfg, traffic, seed, device, seconds)
            if device.type == "cuda":
                torch.cuda.empty_cache()
            compared = {k: v for k, v in numbers.items() if k in limits}
            yield {"workload": workload, "mode": mode, "seed": seed,
                   "correct": check.judge(compared, limits)[0], **numbers, "worst": worst}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: the readings are the card's; no CUDA card is present", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # as a run has it
    seeds = [int(s) for s in args.seeds.split(",")]
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None
        for reading in readings(args.workload, seeds, args.modes.split(","), args.seconds,
                                torch.device("cuda", 0)):
            line = json.dumps(reading)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
