"""Device resolution: the card by default, the CPU only when asked for."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means the CUDA card; it raises when there is none, so a run
    never carries on quietly on the CPU. ``"cpu"`` is honoured as asked (the
    tests use it). Also pins true-f32 matmuls and convolutions: the JAX
    reference forces ``Precision.HIGHEST`` (models/layers.py there), which
    TF32 would break; and f32 accumulation inside bf16 GEMMs, since the
    JAX package's ``linear`` accumulates a bf16 product in f32 and rounds
    once (``preferred_element_type=float32``), which cuBLAS's reduced-
    precision split-K reductions would not.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
