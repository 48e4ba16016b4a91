"""The fused DP block's long-run NaN repro, on the card.

    REPRO_STEPS=1200 python -m eeg_multimodal_torch.tools.repro_fused_dp_scan_nan \\
        [variant ...]

The port of the JAX package's ``tools/repro_fused_dp_scan_nan.py``. There,
the in-kernel Laplace inverse CDF once mapped a 24-bit draw of exactly 0
to u = -1/2 and log1p(-1) = -inf, with p ~ 1.1e-3 per (8, 2304) kernel
instance a step: reliably within a few hundred train steps, almost never in
short tests. The fix draws 23 bits plus a half step, so every draw is
finite (``ops/dp.py::laplace_from_bits``, the port's kernels alike). This
runs the block in the trainer's alternating shape for ``REPRO_STEPS``
steps (default 120) at ``REPRO_LR`` (default 1e-2) and prints a PASS/FAIL
row per variant: FAIL means non-finite params, with the first non-finite
step of the DP-mean trace.

The block's input is ``base * scale`` with ``base`` = numpy
``RandomState(0).randn(8, 2304)``, ``DP`` zeros (1, 2304), ``scale`` 1.0,
epsilon 0.1, under ``ops/optim.py``'s Adam (``optax.adam``). Each step's
phase 1 takes the gradient of mean(out^2) w.r.t. ``DP`` only, phase 2 the
gradient w.r.t. ``scale`` through a second instance of the block.

Variants (their names are the JAX tool's):
  dual-scan          two instances a step through ``ops/dp_fused.py``'s
                     ``fused_lap_dropout``: ``dp_fwd_kernel`` and
                     ``dp_bwd_kernel`` on the card, 2 + 2 launches a step,
                     each phase's seed a one-element int64 tensor drawn on
                     the card from a CUDA generator (no host sync)
  single-scan        one instance a step (1 + 1 launches)
  dual-python        = dual-scan here
  dual-scan-barrier  = dual-scan here
  dual-scan-jaxnoise the composed path: ``ops/dp.py::laplace_noise`` from a
                     torch generator into ``lap_dropout_fast``, outside any
                     kernel (0 launches); it isolates the kernels' bits
In JAX ``scan`` and ``python`` differ in how the steps are compiled (one
scanned program, or a jitted step per call) and ``barrier`` puts an
``optimization_barrier`` between the phases. In eager PyTorch each step is
the same sequence of launches, so dual-scan, dual-python and
dual-scan-barrier compute the same thing, draw for draw; the names are
kept for the command line. The trace is a device tensor, fetched once at
the end. The tool exits 0 whatever the table says: the table is the result.
Runs on the card unless ``device="cpu"``, where ``fused_lap_dropout`` takes
its plain version with ``laplace_plain``'s noise of the same seeds.
"""
import os
import sys

import numpy as np
import torch

from ..models.layers import draw_seeds
from ..ops import dp as dp_ops
from ..ops.dp_fused import fused_lap_dropout
from ..ops.optim import Adam
from ..utils.device import resolve_device
from ..utils.seeding import generator

B, F = 8, 2304
EPS = 0.1
VARIANTS = ("dual-scan", "single-scan", "dual-python", "dual-scan-barrier",
            "dual-scan-jaxnoise")


def settings():
    """(steps, learning rate) from ``REPRO_STEPS`` and ``REPRO_LR``."""
    return int(os.environ.get("REPRO_STEPS", "120")), float(os.environ.get("REPRO_LR", "1e-2"))


def make_step(n_instances: int, jax_noise: bool, lr: float, device):
    """(the optimizer, ``step``). ``step(params, state, base, gen,
    noise=(None, None))`` runs one alternating step on ``params`` = [DP
    (1, F), scale ()] in place and returns (the new Adam state, mean(DP)
    as a device scalar). ``gen`` draws each phase's seed (fused) or noise
    (``jax_noise``), phase 1 first; ``noise`` hands in a phase's (B, F)
    Laplace(0, 1) draw instead (a test hook; on the CPU only for the fused
    block)."""
    opt = Adam(lr)

    def phase_loss(scale, dp, base, gen, noise):
        f = base * scale  # (B, F) raw features
        if jax_noise:
            feature = dp_ops.minmax_normalize(f)
            if noise is None:
                noise = dp_ops.laplace_noise(f.shape, 1.0, gen, f.device)
            out = dp_ops.lap_dropout_fast(feature, dp, EPS, noise)
        else:
            out = fused_lap_dropout(f, dp, EPS, draw_seeds(gen, f.device), noise=noise)
        return out.square().mean()

    def step(params, state, base, gen, noise=(None, None)):
        dp, scale = params
        dp_leaf = dp.detach().requires_grad_()
        (g1,) = torch.autograd.grad(phase_loss(scale.detach(), dp_leaf, base, gen, noise[0]),
                                    dp_leaf)
        if n_instances == 2:
            scale_leaf = scale.detach().requires_grad_()
            (g2,) = torch.autograd.grad(
                phase_loss(scale_leaf, dp.detach(), base, gen, noise[1]), scale_leaf)
        else:
            g2 = torch.zeros_like(scale)
        state = opt.update(params, [g1, g2], state)
        return state, dp.mean()

    return opt, step


def init(device):
    """[DP zeros (1, F), scale 1.0] and ``base``, on ``device``."""
    params = [torch.zeros(1, F, device=device), torch.tensor(1.0, device=device)]
    base = torch.tensor(np.random.RandomState(0).randn(B, F), dtype=torch.float32,
                        device=device)
    return params, base


def run(variant: str, steps: int, lr: float, device) -> bool:
    """Run ``variant`` for ``steps`` steps and print its row; returns
    whether every param is finite."""
    n_inst = 1 if variant == "single-scan" else 2
    jax_noise = "jaxnoise" in variant
    opt, step = make_step(n_inst, jax_noise, lr, device)
    params, base = init(device)
    state = opt.init(params)
    gen = generator(0, device)
    trace = torch.empty(steps, device=device)
    for i in range(steps):
        state, trace[i] = step(params, state, base, gen)
    finite = all(bool(torch.isfinite(p).all()) for p in params)
    trace = trace.cpu()
    bad = ~torch.isfinite(trace)
    first_bad = int(bad.to(torch.int8).argmax()) if bool(bad.any()) else -1
    print(
        f"{variant:22s} {'PASS' if finite else 'FAIL':4s} "
        f"dp_mean_trace[-1]={float(trace[-1]):+.5f}"
        + (f" first_nonfinite_step={first_bad}" if first_bad >= 0 else "")
    )
    return finite


def main(argv=None, device=None):
    """Run the variants named in ``argv`` (default: all five); returns
    {variant: PASS}."""
    variants = (sys.argv[1:] if argv is None else list(argv)) or list(VARIANTS)
    dev = resolve_device(device)
    steps, lr = settings()
    backend = "gpu" if dev.type == "cuda" else dev.type
    print(f"backend={backend} steps={steps} shape=({B},{F})")
    return {v: run(v, steps, lr, dev) for v in variants}


if __name__ == "__main__":
    main()
    # informational, never a hard exit: the point is the printed table
    sys.exit(0)
