#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's Triton kernels (the fused DP block, forward and backward)
from this checkout, holds each against its plain PyTorch version, drives the
flagship TICA_LapDropout fused-DP trainer at full width (BERT-base, 3-layer
cross-attention decoder, F = 2304, batch 8, S = 80) for two train+eval
epochs, checks that the path went through both kernels, and times each
kernel beside its bound. Exits non-zero on any failure; without a CUDA
device it fails before printing any result. The last line is
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Approximate operations per element (Philox: 10 rounds of integer
# multiplies and xors dominate; the float work is ~20)
OPS_PER_ELEM = {"dp_fwd": 80, "dp_bwd": 100}
SOURCE = "eeg_multimodal_torch/ops/dp_fused.py"
REPLACES = {"dp_fwd": "eeg_multimodal_tpu/ops/dp_pallas.py:63",
            "dp_bwd": "eeg_multimodal_tpu/ops/dp_pallas.py:76"}

EPS = 0.1
N_TRAIN, N_EVAL, VALID_TOKENS = 64, 32, 65
LAPLACE_MAX = math.log(2 ** 23) + 1e-3


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def phase(name):
    print(f"== {name}", flush=True)


def time_ms(torch, fn, iters=200, reps=7):
    """Median ms per call over ``reps`` runs of ``iters`` calls (CUDA events)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def device_us(torch, fn, n=50):
    """Device time per call of ``fn`` in us, by CUDA kernel name
    (torch.profiler); empty when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / n
    return by_name


def forward_matmul_flops(B, S, H=768, layers=12, ffn=3072, dec_layers=3, dec_ffn=2048,
                         F=2304, visual=512):
    """Matmul FLOPs of one flagship forward (2 per multiply-add)."""
    T = B * S
    bert = layers * (2 * T * H * 3 * H + 2 * T * H * H + 4 * T * H * ffn
                     + 4 * B * S * S * H) + 2 * B * H * H
    dec = dec_layers * (2 * B * H * 3 * H + 2 * B * H * H  # self-attn (tgt len 1)
                        + 2 * B * H * H + 2 * T * H * 2 * H + 2 * B * H * H  # cross
                        + 4 * B * S * H + 4 * B * H * dec_ffn)
    head = 2 * B * visual * H + 2 * B * F * F + 2 * B * F * H + 2 * B * H * 2
    return bert + dec + head


def bound_ms(name, B, F):
    """Least time on the card: the larger of bytes over HBM rate (each input
    read once, each output written once) and operations over f32 rate."""
    if name == "dp_fwd":  # read f, dp, seed; write out
        nbytes = (2 * B * F + F) * 4 + 8
    else:  # read f, g, dp, seed; write df, dDP
        nbytes = (3 * B * F + 2 * F) * 4 + 8
    ops = OPS_PER_ELEM[name] * B * F
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def main():
    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.ops import dp as dp_ops
    from eeg_multimodal_torch.ops import dp_fused as K
    from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
    from eeg_multimodal_torch.utils.device import resolve_device
    from eeg_multimodal_torch.utils.trees import tree_map, tree_size

    dev = resolve_device()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"dp_fwd": 0.0, "dp_bwd": 0.0}

    def inputs(B, F):
        f = torch.randn(B, F, generator=gen, device=dev)
        dp = torch.randn(1, F, generator=gen, device=dev)
        return f, dp

    def recover(out, f, dp, eps):
        return (out - dp_ops.minmax_normalize(f)) / dp_ops.eps_hat(torch.sigmoid(dp), eps)

    def seed(s):
        return torch.tensor([s], dtype=torch.int64, device=dev)

    phase("DP forward kernel against dp_block_plain")
    t0 = time.time()
    for B, F in ((8, 2304), (5, 1000)):
        f, dp = inputs(B, F)
        out = K.dp_fwd(f, dp, EPS, seed(1234))
        noise = recover(out, f, dp, EPS)
        check(bool(torch.isfinite(noise).all()), f"non-finite noise at {(B, F)}")
        check(float(noise.abs().max()) <= LAPLACE_MAX, f"|noise| > ln(2^23) at {(B, F)}")
        check(torch.equal(out, K.dp_fwd(f, dp, EPS, seed(1234))), "not deterministic per seed")
        check(not torch.equal(out, K.dp_fwd(f, dp, EPS, seed(1235))), "seeds give equal noise")
        plain = K.dp_block_plain(f, dp, EPS, noise)
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)
        err["dp_fwd"] = max(err["dp_fwd"], float((out - plain).abs().max()))
        print(f"  {(B, F)}: max|out - plain| {err['dp_fwd']:.3g}, max|noise| "
              f"{float(noise.abs().max()):.3f}")
    f, dp = inputs(64, 2304)  # 147456 draws
    noise = recover(K.dp_fwd(f, dp, 1.0, seed(7)), f, dp, 1.0).double().cpu().numpy().ravel()
    qs = np.linspace(0.05, 0.95, 19)
    exact = -np.sign(qs - 0.5) * np.log1p(-2 * np.abs(qs - 0.5))
    q_err = float(np.abs(np.quantile(noise, qs) - exact).max())
    print(f"  Laplace quantiles over {noise.size} draws: max error {q_err:.4f}; var {noise.var():.4f}")
    check(q_err <= 0.05, "noise quantiles off the Laplace(0, 1) closed form")
    print(f"  (build + checks {time.time() - t0:.1f} s)")

    phase("DP backward kernel against dp_block_bwd_plain")
    for B, F in ((8, 2304), (5, 1000)):
        f, dp = inputs(B, F)
        # tied minima and maxima in row 0
        f[0, [3, 10]] = f[0].min() - 1.0
        f[0, [7, 20]] = f[0].max() + 1.0
        g = torch.randn(B, F, generator=gen, device=dev)
        s = seed(99)
        noise = recover(K.dp_fwd(f, dp, EPS, s), f, dp, EPS)
        df, ddp = K.dp_bwd(f, dp, EPS, s, g)
        df_p, ddp_p = K.dp_block_bwd_plain(f, dp, EPS, noise, g)
        torch.testing.assert_close(df, df_p, rtol=2e-3, atol=1e-4)
        torch.testing.assert_close(ddp, ddp_p, rtol=2e-3, atol=1e-4)
        err["dp_bwd"] = max(err["dp_bwd"], float((df - df_p).abs().max()),
                            float((ddp - ddp_p).abs().max()))
        df_only, none1 = K.dp_bwd(f, dp, EPS, s, g, need_df=True, need_ddp=False)
        none2, ddp_only = K.dp_bwd(f, dp, EPS, s, g, need_df=False, need_ddp=True)
        check(none1 is None and none2 is None, "skipped halves returned")
        check(torch.equal(df_only, df) and torch.equal(ddp_only, ddp), "halves differ")
        fr = f.clone().requires_grad_()
        dpr = dp.clone().requires_grad_()
        gf, gdp = torch.autograd.grad(K.fused_lap_dropout(fr, dpr, EPS, s), (fr, dpr), g)
        check(torch.equal(gf, df) and torch.equal(gdp, ddp), "autograd.Function differs")
        print(f"  {(B, F)}: max err {err['dp_bwd']:.3g} (ties in row 0)")

    phase("main path: TICA_LapDropout fused-DP trainer, full width")
    rng = np.random.RandomState(0)

    def synth(n):
        ids = rng.randint(0, 30000, (n, 512)).astype(np.int32)
        mask = np.zeros((n, 512), np.int32)
        mask[:, :VALID_TOKENS] = 1
        return D.build_pairing(
            "ti", rng.randint(0, 2, n).astype(np.int32),
            eeg_txt={"input_ids": ids, "attention_mask": mask},
            act_img=rng.randn(n, 512).astype(np.float32),
        )

    train, test = D.truncate_pair(synth(N_TRAIN), synth(N_EVAL))
    check(train.eeg_input.shape == (N_TRAIN, 80), f"S = {train.eeg_input.shape[1]}, not 80")
    fc = dataclasses.replace(fusion.config_for("ti", "lapacian_dropout"), fused_dp_kernel=True)
    tc = TrainConfig()
    trainer = Trainer(fc, tc)
    train_dev, test_dev = train.to_device(dev), test.to_device(dev)
    n_params = tree_size(trainer.params)
    print(f"  params {n_params}, S = {train.eeg_input.shape[1]}, batch {tc.batch_size}")
    dp0 = trainer.params["DP"].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in K.KERNELS:
        k.launches = 0
    rows = []
    for epoch in range(2):
        rows.append(trainer.run_epoch(epoch, train_dev, test_dev, N_TRAIN, N_EVAL, EPS))
        if epoch == 0:
            dp_changed = not torch.equal(trainer.params["DP"], dp0)
    launches = {k.name: k.launches for k in K.KERNELS}
    steps = N_TRAIN // tc.batch_size
    eval_batches = N_EVAL // tc.batch_size
    for row in rows:
        print(f"  epoch {row['epoch']}: train loss {row['train_loss']:.4f} acc "
              f"{row['train_acc']:.3f} | test loss {row['test_loss']:.4f} acc "
              f"{row['test_acc']:.3f} f1 {row['f1']:.3f} | {row['time_cost']:.3f} s, "
              f"{steps / row['time_cost']:.2f} steps/s (train+eval epoch)")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}")
    for row in rows:
        check(all(math.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1")),
              "non-finite loss")
        check(0.0 <= row["f1"] <= 1.0, "F1 outside [0, 1]")
    check(dp_changed, "DP did not change in the first epoch")
    want = {"dp_fwd": 2 * (2 * steps + eval_batches), "dp_bwd": 2 * 2 * steps}
    check(launches == want, f"launches {launches}, expected {want}")

    phase("reference check: card against CPU on 2 rows")
    fc_plain = dataclasses.replace(fc, fused_dp_kernel=False)
    batch = D.gather_batch(test_dev, torch.arange(2, device=dev))
    noise = torch.randn(2, fc.concat_width, generator=gen, device=dev)
    with torch.no_grad():
        on_card = fusion.apply(trainer.params, batch, fc_plain, EPS, True, None, False, noise)
        on_cpu = fusion.apply(tree_map(torch.Tensor.cpu, trainer.params),
                              tree_map(torch.Tensor.cpu, batch), fc_plain, EPS, True,
                              None, False, noise.cpu())
    ref_err = float((on_card.cpu() - on_cpu).abs().max())
    print(f"  logits max|card - cpu| {ref_err:.3g}")
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-3, atol=1e-4)

    phase("profile: steady-state train step (device time by kernel)")
    step_batch = D.gather_batch(train_dev, torch.arange(tc.batch_size, device=dev))
    step_w = torch.ones(tc.batch_size, device=dev)
    states = [trainer.dp_os, trainer.model_os]

    def train_step():
        states[:] = trainer.steps.train_step(trainer.params, *states, step_batch, step_w,
                                             EPS, gen)[:2]

    train_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        train_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    flops = 4 * forward_matmul_flops(tc.batch_size, train.eeg_input.shape[1])
    print(f"  train step {step_ms:.2f} ms ({1e3 / step_ms:.1f} steps/s); matmul work "
          f"~{flops / 1e9:.0f} GFLOP/step (2 forwards + 1 backward ~ 4 forwards) = "
          f"{flops / F32_OPS_PER_S * 1e3:.2f} ms at the f32 peak")
    by_kernel = device_us(torch, train_step, n=3)
    busy_ms = sum(by_kernel.values()) / 1e3
    if by_kernel:
        print(f"  device busy {busy_ms:.2f} ms/step, idle share "
              f"{max(0.0, 1 - busy_ms / step_ms):.3f}; top kernels (us/step):")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {us:9.1f}  {name[:90]}")
        dp_us = {k: v for k, v in by_kernel.items() if "dp_" in k and "kernel" in k}
        print(f"  DP kernels in the step (us/step): {dp_us}")
    else:
        print("  the profiler saw no device activity: device time not measured")

    phase("timing at (8, 2304)")
    B, F = 8, fc.concat_width
    f, dp = inputs(B, F)
    g = torch.randn(B, F, generator=gen, device=dev)
    s = seed(5)

    def plain_noise():
        return K.laplace_from_bits(K.random_bits((B, F), gen, dev))

    timed = {
        "dp_fwd": (lambda: K.dp_fwd(f, dp, EPS, s),
                   lambda: K.dp_block_plain(f, dp, EPS, plain_noise())),
        "dp_bwd": (lambda: K.dp_bwd(f, dp, EPS, s, g),
                   lambda: K.dp_block_bwd_plain(f, dp, EPS, plain_noise(), g)),
    }
    kernels = []
    for name, (kern, plain) in timed.items():
        ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
        bms, by = bound_ms(name, B, F)
        dev_k = sum(device_us(torch, kern).values())
        dev_p = sum(device_us(torch, plain).values())
        print(f"  {name}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us (CUDA "
              f"events over back-to-back calls); device time kernel {dev_k:.2f} us, plain "
              f"{dev_p:.2f} us; bound {bms * 1e3:.4f} us ({by})")
        kernels.append({
            "name": name, "route": "triton", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
