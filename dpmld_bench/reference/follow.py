"""The reference's side of a check: it makes the run's inputs again from the
seed (rows, weights, the epoch's order, every draw) and follows the timed
path's first train steps, or the eval epochs a run sampled, in plain
PyTorch at the given precision."""
from __future__ import annotations

import torch

from .. import rows as R
from . import encoders
from .draws import Draws, epoch_generator, epoch_order
from .model import Precision, Stepper, eval_logits
from .weights import leaves, make_weights


def _tensors(split, S, device):
    return {"input_ids": torch.as_tensor(split["input_ids"][:, :S], device=device),
            "attention_mask": torch.as_tensor(split["attention_mask"][:, :S], device=device),
            "act": torch.as_tensor(split["act"], device=device),
            "labels": torch.as_tensor(split["labels"], device=device)}


def inputs(cfg, traffic, seed, device):
    """(train rows, eval rows) on ``device``, at the run's sequence length."""
    train, test = R.make_rows(seed, traffic, encoders.of(cfg).TOKENS)
    S = R.seq_len(train, test, traffic["truncate"])
    return _tensors(train, S, device), _tensors(test, S, device)


def norms(tensors: dict):
    """Each leaf's 2-norm, as a float."""
    return {p: float(t.double().norm()) for p, t in tensors.items()}


def train_records(cfg, traffic, seed, device, precision="float32", steps=3):
    """Per member (the traffic's ``epsilons``, every member at ``seed``): the
    first ``steps`` steps' phase-2 losses, each leaf's norm of the first
    step's gradient, and of the parameters' change over the ``steps``."""
    prec = Precision(precision)
    train, _ = inputs(cfg, traffic, seed, device)
    idx, weight = epoch_order(traffic["n_train"], cfg["train"]["batch_size"], seed, 0)
    fused = cfg["program"]["fused_dp_kernel"]
    out = {"loss": [], "grad1": [], "change": []}
    for eps in traffic["epsilons"]:
        params = make_weights(cfg, seed, device)
        start = {p: t.clone() for p, t in leaves(params)}
        stepper = Stepper(params, cfg, prec)
        gen = epoch_generator(seed, 0, "train", device)
        losses = []
        for t in range(steps):
            batch = {k: v[idx[t].to(v.device)] for k, v in train.items()}
            loss, grads = stepper.step(batch, weight[t].to(device), float(eps),
                                       Draws(gen, gen, device, fused))
            losses.append(float(loss))
            if t == 0:
                out["grad1"].append(norms(grads))
        out["loss"].append(losses)
        out["change"].append(norms({p: t - start[p] for p, t in leaves(params)}))
        del params, start, stepper
    return out


def eval_records(cfg, traffic, seed, device, epochs, precision="float32"):
    """For each eval epoch of ``epochs`` each row's logits, and the rows'
    weights and labels, the rows in the eval order (the last batch padded
    with row 0)."""
    prec = Precision(precision)
    _, test = inputs(cfg, traffic, seed, device)
    batch_size = cfg["train"]["batch_size"]
    idx, weight = epoch_order(traffic["n_eval"], batch_size, seed, 0, shuffle=False)
    rows = {k: v[idx.reshape(-1).to(v.device)] for k, v in test.items()}
    weight = weight.to(device)
    params = make_weights(cfg, seed, device)
    fused = cfg["program"]["fused_dp_kernel"]
    eps = float(traffic["epsilons"][0])
    out = {"logits": [], "weight": weight.reshape(-1), "labels": rows["labels"]}
    for e in epochs:
        gen = epoch_generator(seed, e, "eval", device)
        out["logits"].append(eval_logits(params, rows, cfg, eps,
                                         Draws(None, gen, device, fused), prec))
    return out
