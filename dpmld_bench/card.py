"""The card's name and power limit, the line printed beside every number.

A frozen copy of ``eeg_multimodal_torch/utils/device.py::card_line``.
"""
from __future__ import annotations

import subprocess


def card_line(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    ``device``'s card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]
