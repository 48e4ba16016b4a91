"""The numbers that decide ``correct``, from the two sides' records.

Training (the first steps, per member):
- ``loss_gap``: the largest |program - reference| / |reference| over each
  step's phase-2 loss;
- ``grad1_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first step's gradient (the program's read from
  its optimizer's first moment after one step, mu / (1 - b1)), over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``change3_gap``: the same of the parameters' change over the steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move under Adam by round-off alone).

Eval (each sampled epoch):
- ``score_gap``: the largest |program - reference| of a row's score
  (logit 1) over the root mean square of the reference's scores;
- ``vote_flip_margin``: the largest reference margin |logit 1 - logit 0|,
  over the margins' root mean square, of a row whose vote differs from the
  reference's (0 if none does);
- ``f1_gap``: |the program's F1 - the F1 of the program's votes| (exact).

The eval epoch's loss is not compared: a mean over 601 rows, its rounding
averages out, and float8 products read it within twice bf16's (PERF.md).
"""
from __future__ import annotations

import statistics

import torch

from .model import f1_binary

SMALL_GRADIENT = 1e-3


def _leaf_gaps(prog: dict, ref: dict, paths, own: bool):
    """Each leaf's gap, over the larger of its reference norm and the
    median leaf's (``own``: over its reference norm alone)."""
    floor = 0.0 if own else statistics.median(ref.values())
    return {p: abs(prog[p] - ref[p]) / max(ref[p], floor) for p in paths}


def train_gaps(prog, ref, own=False):
    """Per member, each leaf's grad1 gap and change3 gap (the leaves it
    counts; ``own`` leaves the small gradients out of both)."""
    out = []
    for gp, gr, cp, cr in zip(prog["grad1"], ref["grad1"], prog["change"], ref["change"]):
        floor = statistics.median(gr.values())
        moved = [p for p in cr if gr[p] >= SMALL_GRADIENT * floor]
        out.append((_leaf_gaps(gp, gr, moved if own else gr, own),
                    _leaf_gaps(cp, {p: cr[p] for p in moved}, moved, own)))
    return out


def train_numbers(prog, ref):
    loss = max(abs(a - b) / abs(b) for lp, lr in zip(prog["loss"], ref["loss"])
               for a, b in zip(lp, lr))
    gaps = train_gaps(prog, ref)
    return {"loss_gap": loss,
            "grad1_gap": max(max(g.values(), default=0.0) for g, _ in gaps),
            "change3_gap": max(max(c.values(), default=0.0) for _, c in gaps)}


def own_norm_gaps(prog, ref):
    """``grad1_gap`` and ``change3_gap`` with each leaf's gap over its own
    reference norm, with no median floor, the leaves of a small reference
    gradient left out of both: read beside the compared numbers, never
    compared."""
    gaps = train_gaps(prog, ref, own=True)
    return {"grad1_gap_own": max(max(g.values(), default=0.0) for g, _ in gaps),
            "change3_gap_own": max(max(c.values(), default=0.0) for _, c in gaps)}


def worst_leaves(prog, ref, n=3):
    """The ``n`` leaves of each train number with the largest gaps, as
    (member, path, gap, the reference's norm), for a look at a reading."""
    out = {}
    for i, name in enumerate(("grad1", "change3")):
        rows = [(m, p, g, ref["grad1" if i == 0 else "change"][m][p])
                for m, gaps in enumerate(train_gaps(prog, ref)) for p, g in gaps[i].items()]
        out[name] = sorted(rows, key=lambda r: -r[2])[:n]
    return out


def eval_numbers(prog, ref):
    """``prog``: per sampled epoch its F1, votes and scores (tensors over
    the eval rows); ``ref``: :func:`follow.eval_records`."""
    valid = ref["weight"] > 0
    out = {"score_gap": 0.0, "vote_flip_margin": 0.0, "f1_gap": 0.0}
    for i, logits in enumerate(ref["logits"]):
        s_ref = logits[valid, 1]
        s_prog = prog["scores"][i].to(logits.device).float()[valid]
        rms = s_ref.square().mean().sqrt()
        out["score_gap"] = max(out["score_gap"], float((s_prog - s_ref).abs().max() / rms))
        margin = (logits[valid, 1] - logits[valid, 0])
        votes = prog["votes"][i].to(logits.device)[valid]
        flipped = votes != (margin > 0).to(votes.dtype)
        if bool(flipped.any()):
            worst = margin.abs()[flipped].max() / margin.square().mean().sqrt()
            out["vote_flip_margin"] = max(out["vote_flip_margin"], float(worst))
        labels = ref["labels"].to(logits.device)
        f1 = f1_binary(labels, prog["votes"][i].to(logits.device), ref["weight"])
        out["f1_gap"] = max(out["f1_gap"], abs(float(prog["f1"][i]) - float(f1)))
    return out


def judge(numbers: dict, limits: dict):
    """(correct, lines): every number at or under its limit; a line each,
    its name, number and limit."""
    lines = [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in numbers]
    return all(numbers[k] <= limits[k] for k in numbers), lines


def program_norms(tensors, members: int):
    """Each leaf's norm per member, a leaf of ``tensors`` (path -> tensor)
    carrying a leading member axis when ``members`` > 1."""
    out = [dict() for _ in range(members)]
    for p, t in tensors.items():
        flat = t.detach().double().reshape(members, -1)
        for m, n in enumerate(torch.linalg.vector_norm(flat, dim=1).tolist()):
            out[m][p] = n
    return out
