"""Run records: the legacy text format (verbatim) + structured jsonl.

The port's own copy of the JAX package's ``train/records.py`` (which needs
no JAX, but the port imports nothing of that package).

The reference's record string (base_train.py:238-245) is a de-facto schema —
every figure script re-parses it (visualization/plot.py:17-32,353-360) — so
:func:`legacy_record` reproduces it byte-for-byte, including the f-string's
16-space indentation and ``'% .3f'``-style leading-space formats. Structured
metrics additionally go to ``metrics.jsonl`` for modern tooling.
"""
from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Optional


def legacy_record(
    epoch: int,
    train_loss: float,
    train_acc: float,
    test_loss: float,
    test_acc: float,
    f1: float,
    time_cost: float,
    record_time: Optional[str] = None,
) -> str:
    """Byte-exact reproduction of base_train.py:238-245's record f-string."""
    if record_time is None:
        record_time = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    return (
        f"Epochs: {epoch + 1}\n"
        f"                | Train Loss: {train_loss: .3f}\n"
        f"                | Train Accuracy: {train_acc: .3f}\n"
        f"                | Test Loss: {test_loss: .3f}\n"
        f"                | Test Accuracy: {test_acc: .3f}\n"
        f"                | f_1 Score: {f1: .3f}\n"
        f"                | Time Cost: {time_cost: .1f}\n"
        f"                | Record Time: {record_time} \n"
    )


def parse_legacy_records(text: str):
    """Inverse of :func:`legacy_record`: parse a whole_record.txt back into a
    list of dicts (mirrors the parsing in visualization/plot.py:353-360)."""
    out = []
    cur = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Epochs:"):
            if cur:
                out.append(cur)
            cur = {"epoch": int(line.split(":")[1])}
        elif line.startswith("|"):
            k, _, v = line[1:].partition(":")
            k = k.strip()
            v = v.strip()
            if k == "Record Time":
                cur[k] = v
            else:
                try:
                    cur[k] = float(v)
                except ValueError:
                    cur[k] = v
    if cur:
        out.append(cur)
    return out


class RunRecorder:
    """Writes whole_record.txt (append) / best_record.txt (overwrite) exactly
    like base_train.py:247-255, plus metrics.jsonl, under log_path."""

    def __init__(self, log_path: str, echo: bool = True):
        self.log_path = log_path
        self.echo = echo
        os.makedirs(log_path, exist_ok=True)
        self.whole = os.path.join(log_path, "whole_record.txt")
        self.best = os.path.join(log_path, "best_record.txt")
        self.jsonl = os.path.join(log_path, "metrics.jsonl")

    def epoch(self, epoch: int, train_loss, train_acc, test_loss, test_acc,
              f1, time_cost, extra: Optional[dict] = None) -> str:
        rec = legacy_record(
            epoch, float(train_loss), float(train_acc), float(test_loss),
            float(test_acc), float(f1), float(time_cost),
        )
        if self.echo:
            print(rec)
        with open(self.whole, "a") as f:
            f.write(rec)
        payload = {
            "epoch": epoch + 1,
            "train_loss": float(train_loss),
            "train_accuracy": float(train_acc),
            "test_loss": float(test_loss),
            "test_accuracy": float(test_acc),
            "f1": float(f1),
            "time_cost_s": float(time_cost),
        }
        if extra:
            payload.update(extra)
        with open(self.jsonl, "a") as f:
            f.write(json.dumps(payload) + "\n")
        return rec

    def best_record(self, rec: str):
        with open(self.best, "w") as f:
            f.write(rec)
