#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA C++ kernels from this checkout with one nvcc call
(the DP block, forward and backward; attention, forward, backward on the
tensor cores and the dropout-mask test hook) and holds each against its
plain PyTorch version: the DP forward bit for bit where the card's math
library allows (within 1e-5 in any case) with ``laplace_plain``'s noise, the
attention mask bit for bit against ``keep_mask_plain``; and a 2-layer BERT
at S = 512 on the card against the CPU. Then drives the two main paths at
full width (BERT-base, 3-layer cross-attention decoder, F = 2304, batch 8,
f32):

1. the flagship TICA_LapDropout fused-DP trainer at the truncated S = 80,
   two train+eval epochs through ``Trainer.run_epoch``, where both DP
   kernels and (the H100's gate) both attention kernels run;
2. the untruncated 512-token trainer through
   ``TrainAndTest.train_on(auto_truncate=False)`` and ``Trainer.fit``, two
   epochs, where every BERT self-attention runs the attention kernels;

checks that each path went through its kernels and the fused path's logits
on the card against the CPU with one DP seed, profiles one train step of
each (at S = 80 with the attention gate open and closed), and times every
kernel beside its bound, its plain version, an empty kernel's launch and,
where one exists, the one PyTorch call that computes the same function.
Exits non-zero on any failure; without a CUDA device it fails before
printing any result. The last line is ``{"ok": true, "device": {...}}``.
"""
import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s,
# dense bf16 tensor-core FLOP/s, and the f32 rate of the attention kernels'
# error-compensated 3xTF32 products (three TF32 passes at 495 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32X3_OPS_PER_S = 495e12 / 3
# Approximate operations per element of the DP kernels (Philox: 10 rounds
# of integer multiplies and xors dominate; the float work is ~20)
OPS_PER_ELEM = {"dp_fwd": 80, "dp_bwd": 100}
SOURCES = {"dp_fwd": "eeg_multimodal_torch/csrc/dp_block.cu",
           "dp_bwd": "eeg_multimodal_torch/csrc/dp_block.cu",
           "attn_fwd": "eeg_multimodal_torch/csrc/attention.cu",
           "attn_bwd": "eeg_multimodal_torch/csrc/attention.cu"}
ROUTES = {"dp_fwd": "cuda", "dp_bwd": "cuda", "attn_fwd": "cuda", "attn_bwd": "cuda"}
REPLACES = {"dp_fwd": "eeg_multimodal_tpu/ops/dp_pallas.py:63",
            "dp_bwd": "eeg_multimodal_tpu/ops/dp_pallas.py:76",
            "attn_fwd": "eeg_multimodal_tpu/ops/attention.py:42",
            "attn_bwd": "eeg_multimodal_tpu/ops/attention.py:71"}

EPS = 0.1
N_TRAIN, N_EVAL, VALID_TOKENS = 64, 32, 65
LAPLACE_MAX = math.log(2 ** 23) + 1e-3
ATTN_DROP = 0.1  # BERT's attention-prob dropout
NEG = float(np.finfo(np.float32).min)
# f32: the JAX attention tests' own tolerances (tests/test_attention_kernel.py)
ATTN_TOL = {"f32_fwd": dict(rtol=1e-4, atol=1e-5), "f32_bwd": dict(rtol=2e-3, atol=1e-4),
            "bf16": dict(rtol=2e-2, atol=2e-2)}


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
    (torch.profiler); empty when three sessions saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(3):  # a session now and then reports no device events: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / n
        if by_name:
            break
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


def _bound(nbytes, ops, ops_per_s):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def dp_bound_ms(name, B, F):
    """Least time on the card: the larger of bytes over HBM rate (each input
    read once, each output written once) and operations over f32 rate."""
    if name == "dp_fwd":  # read f, dp, seed; write out
        nbytes = (2 * B * F + F) * 4 + 8
    else:  # read f, g, dp, seed; write df, dDP
        nbytes = (3 * B * F + 2 * F) * 4 + 8
    return _bound(nbytes, OPS_PER_ELEM[name] * B * F, F32_OPS_PER_S)


def attn_bound_ms(name, B, H, S, D, itemsize, f32_ops_per_s=TF32X3_OPS_PER_S):
    """Least time on the card for attention at (B, H, S, D): bytes (q, k, v
    read and out written, plus dO and out read and dq, dk, dv written for
    the backward; the bias, the seed and the (2, B, H, S) row statistics)
    against the matrix products' operations (4 B H S^2 D forward; 10 B H S^2
    D backward, the scores recomputed) at the tensor-core rate the kernels
    use: 3xTF32 (495 / 3 TFLOP/s) for f32, bf16 for bf16.
    ``f32_ops_per_s=F32_OPS_PER_S`` gives the bound of the first,
    CUDA-core design. The exponentials and the mask's integer work are not counted."""
    bhsd, small = B * H * S * D * itemsize, B * S * 4 + 8 + 2 * B * H * S * 4
    if name == "attn_fwd":
        nbytes, ops = 4 * bhsd + small, 4 * B * H * S * S * D
    else:
        nbytes, ops = 8 * bhsd + small, 10 * B * H * S * S * D
    return _bound(nbytes, ops, f32_ops_per_s if itemsize == 4 else BF16_OPS_PER_S)


def print_rows(rows, steps):
    for row in rows:
        print(f"  epoch {row['epoch']}: train loss {row['train_loss']:.4f} acc "
              f"{row['train_acc']:.3f} | test loss {row['test_loss']:.4f} acc "
              f"{row['test_acc']:.3f} f1 {row['f1']:.3f} | {row['time_cost']:.3f} s, "
              f"{steps / row['time_cost']:.2f} steps/s (train+eval epoch)")


def synth_rows(D, rng, n, seq=512):
    """``n`` synthetic ti rows: VALID_TOKENS valid token ids padded to
    ``seq``, a 512-d act embedding and a label, made with numpy."""
    ids = rng.randint(0, 30000, (n, seq)).astype(np.int32)
    mask = np.zeros((n, seq), np.int32)
    mask[:, :VALID_TOKENS] = 1
    return D.build_pairing(
        "ti", rng.randint(0, 2, n).astype(np.int32),
        eeg_txt={"input_ids": ids, "attention_mask": mask},
        act_img=rng.randn(n, 512).astype(np.float32),
    )


def profile_step(torch, step, label, flops):
    """Host step time, device busy time, idle share and the top kernels of
    one steady-state train step; returns the device us by kernel name."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"  {label}: train step {step_ms:.2f} ms ({1e3 / step_ms:.2f} steps/s); matmul "
          f"work ~{flops / 1e9:.0f} GFLOP/step (2 forwards + 1 backward ~ 4 forwards) = "
          f"{flops / F32_OPS_PER_S * 1e3:.2f} ms at the f32 peak")
    by_kernel = device_us(torch, step, n=3)
    if not by_kernel:
        print("  the profiler saw no device activity: device time not measured")
        return by_kernel
    busy_ms = sum(by_kernel.values()) / 1e3
    print(f"  device busy {busy_ms:.2f} ms/step, idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f}; matmul work at "
          f"{flops / (busy_ms * 1e-3) / 1e12:.2f} TFLOP/s of device time "
          f"({flops / (busy_ms * 1e-3) / F32_OPS_PER_S:.3f} of the f32 peak); "
          "top kernels (us/step):")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us:9.1f}  {name[:90]}")
    return by_kernel


def check_attention_kernels(torch, A, gen, dev):
    """Attention kernels against their plain versions; returns the max
    errors of the forward and the backward (f32, and bf16 under
    "<name> bf16")."""
    err = {"attn_fwd": 0.0, "attn_bwd": 0.0, "attn_fwd bf16": 0.0, "attn_bwd bf16": 0.0}
    for S in (80, 512):  # the kernels' mask is keep_mask_plain's, bit for bit
        seed = torch.tensor([2 ** 40 + S], dtype=torch.int64, device=dev)
        card = A.attn_dropout_mask(seed, 2, 3, S, ATTN_DROP).bool()
        check(torch.equal(card, A.keep_mask_plain(2 ** 40 + S, 2, 3, S, ATTN_DROP, dev)),
              f"attn_dropout_mask differs from keep_mask_plain at S = {S}")
    print("  attn_dropout_mask equals keep_mask_plain at S = 80 and 512")
    cases = [(2, 3, 80, 64, torch.float32), (8, 12, 128, 64, torch.float32),
             (8, 12, 512, 64, torch.float32), (1, 2, 512, 128, torch.float32),
             (2, 3, 80, 64, torch.bfloat16), (8, 12, 512, 64, torch.bfloat16)]
    for B, H, S, D, dtype in cases:
        f32 = dtype == torch.float32
        fwd_tol = ATTN_TOL["f32_fwd" if f32 else "bf16"]
        bwd_tol = ATTN_TOL["f32_bwd" if f32 else "bf16"]
        # packed (B, S, 3, H, D) projections: q, k, v are strided views, as
        # the BERT path passes them
        qkv = torch.randn(B, S, 3, H, D, generator=gen, device=dev).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias = torch.zeros(B, S, device=dev)
        bias[0, S // 2 + 3:] = NEG  # a partly masked row
        if B > 1:
            bias[1] = NEG  # every key masked: the uniform softmax
        dout = torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
        for rate in (0.0, ATTN_DROP):
            seed = torch.tensor([1000 + S + D], dtype=torch.int64, device=dev)
            out, stats = A.attn_fwd(q, k, v, bias, seed, rate)
            keep = A.attn_dropout_mask(seed, B, H, S, rate).bool() if rate else None
            plain = A.attention_plain(q, k, v, bias, keep, rate)
            torch.testing.assert_close(out.float(), plain.float(), **fwd_tol)
            e_fwd = float((out.float() - plain.float()).abs().max())
            grads = A.attn_bwd(q, k, v, bias, seed, rate, out, stats, dout)
            plain_g = A.attention_bwd_plain(q, k, v, bias, keep, rate, dout)
            e_bwd = 0.0
            for name, g, pg in zip("qkv", grads, plain_g):
                torch.testing.assert_close(g.float(), pg.float(), **bwd_tol,
                                           msg=lambda m: f"d{name}: {m}")
                e_bwd = max(e_bwd, float((g.float() - pg.float()).abs().max()))
            tag = "" if f32 else " bf16"
            err["attn_fwd" + tag] = max(err["attn_fwd" + tag], e_fwd)
            err["attn_bwd" + tag] = max(err["attn_bwd" + tag], e_bwd)
            check(torch.equal(out, A.attn_fwd(q, k, v, bias, seed, rate)[0]),
                  "the same seed gives another output")
            if rate:
                other = A.attn_fwd(q, k, v, bias, seed + 1, rate)[0]
                check(not torch.equal(out, other), "two seeds give equal outputs")
            if B > 1:
                uniform = v[1].float().mean(dim=1, keepdim=True).expand(H, S, D)
                torch.testing.assert_close(A.attn_fwd(q, k, v, bias, seed, 0.0)[0][1].float(),
                                           uniform, **fwd_tol)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(A.fused_attention(*leaves, bias, seed, rate),
                                       leaves, dout)
            check(all(torch.equal(a, g) for a, g in zip(auto, grads)),
                  "fused_attention's autograd gradients differ from attn_bwd's")
            print(f"  {(B, H, S, D)} {str(dtype)[6:]} p={rate}: max|out - plain| {e_fwd:.3g}, "
                  f"max|grad - plain| {e_bwd:.3g}")
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    frac = float(A.attn_dropout_mask(seed, 8, 12, 512, ATTN_DROP).float().mean())
    print(f"  keep fraction over 8*12*512*512 = {8 * 12 * 512 * 512} draws: {frac:.6f}")
    check(abs(frac - (1 - ATTN_DROP)) <= 1e-3, f"keep fraction {frac} off {1 - ATTN_DROP}")
    print("  max errors: f32 fwd {attn_fwd:.3g}, grads {attn_bwd:.3g}; bf16 fwd "
          "{attn_fwd bf16:.3g}, grads {attn_bwd bf16:.3g} (CUDA-core design: f32 2.98e-7 / "
          "4.77e-7, bf16 1.95e-3 / 7.81e-3)".format_map(err))
    return err


def check_bert_card_against_cpu(torch, bert_mod, A, tree_map, dev):
    """A 2-layer BERT at S = 512 on 2 rows, dropout off: the card (through
    the attention kernels) against the CPU (their plain versions), at the
    JAX fused-branch test's tolerance."""
    cfg = bert_mod.BertConfig(num_layers=2)
    gen = torch.Generator(device="cpu").manual_seed(1)
    params = bert_mod.init(gen, cfg, "cpu")
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 512))).long()
    mask = torch.ones(2, 512, dtype=torch.int64)
    mask[0, VALID_TOKENS:] = 0
    before = A.attn_fwd.launches
    with torch.no_grad():
        on_card = bert_mod.apply(tree_map(lambda t: t.to(dev), params), ids.to(dev),
                                 mask.to(dev), cfg)
        on_cpu = bert_mod.apply(params, ids, mask, cfg)
    check(A.attn_fwd.launches - before == cfg.num_layers,
          "the card's BERT did not go through the attention kernel")
    for name, a, b in zip(("sequence", "pooled"), on_card, on_cpu):
        print(f"  {name} output max|card - cpu| {float((a.cpu() - b).abs().max()):.3g}")
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)


def main():
    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.models import bert as bert_mod
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.ops import _build
    from eeg_multimodal_torch.ops import attention as A
    from eeg_multimodal_torch.ops import dp as dp_ops
    from eeg_multimodal_torch.ops import dp_fused as K
    from eeg_multimodal_torch.train.api import TrainAndTest
    from eeg_multimodal_torch.train.checkpoint import load_torch_checkpoint, save_torch_checkpoint
    from eeg_multimodal_torch.train.records import parse_legacy_records
    from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
    from eeg_multimodal_torch.utils.device import resolve_device
    from eeg_multimodal_torch.utils.trees import tree_items, tree_map, tree_size

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
    all_kernels = K.KERNELS + A.KERNELS

    phase("build the CUDA library (nvcc, sm_90a)")
    t0 = time.time()
    _, build_log, nvcc_s = _build.library()
    print(f"  nvcc {nvcc_s:.1f} s, build + load {time.time() - t0:.1f} s")
    entry = ""
    for line in build_log.splitlines():  # ptxas -v: registers, shared memory, spills
        if "Compiling entry function" in line:
            # the mangled name's length prefix, then the kernel's name
            name = re.search(r"\d((?:attn|dp)_[a-z]+_kernel|empty_kernel)", line)
            targs = re.search(r"kernelI(f|13__nv_bfloat16)Li(\d+)E", line)
            entry = (name.group(1) if name else "?") + (
                f"<{'f32' if targs.group(1) == 'f' else 'bf16'}, {targs.group(2)}>"
                if targs else "")
        elif "Used" in line or re.search(r"[1-9]\d* bytes spill", line):
            print(f"  ptxas {entry}: {line.split(':', 1)[-1].strip()[:100]}")

    def inputs(B, F):
        f = torch.randn(B, F, generator=gen, device=dev)
        dp = torch.randn(1, F, generator=gen, device=dev)
        return f, dp

    def recover(out, f, dp, eps):
        return (out - dp_ops.minmax_normalize(f)) / dp_ops.eps_hat(torch.sigmoid(dp), eps)

    def seed(s):
        return torch.tensor([s], dtype=torch.int64, device=dev)

    phase("DP forward kernel against dp_block_plain with laplace_plain's noise")
    t0 = time.time()
    for B, F in ((8, 2304), (5, 1000), (5, 1001)):  # 1001: groups of four cross rows
        f, dp = inputs(B, F)
        out = K.dp_fwd(f, dp, EPS, seed(1234))
        plain = K.dp_block_plain(f, dp, EPS, K.laplace_plain(1234, (B, F), dev))
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)
        e = float((out - plain).abs().max())
        err["dp_fwd"] = max(err["dp_fwd"], e)
        check(torch.equal(out, K.dp_fwd(f, dp, EPS, seed(1234))), "not deterministic per seed")
        check(not torch.equal(out, K.dp_fwd(f, dp, EPS, seed(1235))), "seeds give equal noise")
        noise = recover(out, f, dp, EPS)  # the kernel's own noise
        check(bool(torch.isfinite(noise).all()), f"non-finite noise at {(B, F)}")
        check(float(noise.abs().max()) <= LAPLACE_MAX, f"|noise| > ln(2^23) at {(B, F)}")
        print(f"  {(B, F)}: max|out - plain| {e:.3g} (bit for bit: {torch.equal(out, plain)}), "
              f"max|noise| {float(noise.abs().max()):.3f}")
    f, dp = inputs(64, 2304)  # 147456 draws
    noise = recover(K.dp_fwd(f, dp, 1.0, seed(7)), f, dp, 1.0).double().cpu().numpy().ravel()
    qs = np.linspace(0.05, 0.95, 19)
    exact = -np.sign(qs - 0.5) * np.log1p(-2 * np.abs(qs - 0.5))
    q_err = float(np.abs(np.quantile(noise, qs) - exact).max())
    print(f"  Laplace quantiles over {noise.size} draws: max error {q_err:.4f}; var {noise.var():.4f}")
    check(q_err <= 0.05, "noise quantiles off the Laplace(0, 1) closed form")
    print(f"  (checks {time.time() - t0:.1f} s)")

    phase("DP backward kernel against dp_block_bwd_plain with laplace_plain's noise")
    for B, F in ((8, 2304), (5, 1000), (5, 1001)):
        f, dp = inputs(B, F)
        # tied minima and maxima in row 0
        f[0, [3, 10]] = f[0].min() - 1.0
        f[0, [7, 20]] = f[0].max() + 1.0
        g = torch.randn(B, F, generator=gen, device=dev)
        s = seed(99)
        df, ddp = K.dp_bwd(f, dp, EPS, s, g)
        df_p, ddp_p = K.dp_block_bwd_plain(f, dp, EPS, K.laplace_plain(99, (B, F), dev), g)
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

    phase("attention kernels against attention_plain / attention_bwd_plain")
    t0 = time.time()
    err.update(check_attention_kernels(torch, A, gen, dev))
    print(f"  (checks {time.time() - t0:.1f} s)")

    phase("reference check: 2-layer BERT at S = 512, card (attention kernels) against CPU")
    check_bert_card_against_cpu(torch, bert_mod, A, tree_map, dev)

    phase("main path 1: TICA_LapDropout fused-DP trainer, full width, S = 80")
    rng = np.random.RandomState(0)
    train, test = D.truncate_pair(synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL))
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
    for k in all_kernels:
        k.launches = 0
    rows = []
    for epoch in range(2):
        rows.append(trainer.run_epoch(epoch, train_dev, test_dev, N_TRAIN, N_EVAL, EPS))
        if epoch == 0:
            dp_changed = not torch.equal(trainer.params["DP"], dp0)
    launches_80 = {k.name: k.launches for k in all_kernels}
    steps = N_TRAIN // tc.batch_size
    eval_batches = N_EVAL // tc.batch_size
    print_rows(rows, steps)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches_80}")
    for row in rows:
        check(all(math.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1")),
              "non-finite loss")
        check(0.0 <= row["f1"] <= 1.0, "F1 outside [0, 1]")
    check(dp_changed, "DP did not change in the first epoch")
    # the H100 attention gate takes S = 80: every BERT layer of both phases'
    # forwards and of the eval forwards, and of the phase-2 backward
    layers = fusion.config_for("ti", "lapacian_dropout").bert_cfg().num_layers
    want = {"dp_fwd": 2 * (2 * steps + eval_batches), "dp_bwd": 2 * 2 * steps,
            "attn_fwd": layers * (2 * steps + eval_batches) * 2, "attn_bwd": layers * steps * 2}
    check(launches_80 == want, f"launches {launches_80}, expected {want}")

    phase("reference check: card against CPU on 2 rows, composed and fused DP block")
    batch = D.gather_batch(test_dev, torch.arange(2, device=dev))
    cpu_params = tree_map(torch.Tensor.cpu, trainer.params)
    cpu_batch = tree_map(torch.Tensor.cpu, batch)
    noise = torch.randn(2, fc.concat_width, generator=gen, device=dev)
    # out of training the fused path draws only the DP seed from its generator:
    # a twin seeded alike gives that seed, and the CPU gets laplace_plain's noise of it
    dp_seed = int(torch.randint(0, 2**31 - 1, (1,), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(17)))
    with torch.no_grad():
        for name, cfg, card_kw, cpu_kw in (
                ("composed", dataclasses.replace(fc, fused_dp_kernel=False),
                 dict(gen=None, dp_noise=noise), dict(gen=None, dp_noise=noise.cpu())),
                ("fused", fc, dict(gen=torch.Generator(device=dev).manual_seed(17)),
                 dict(gen=None, dp_noise=K.laplace_plain(dp_seed, (2, fc.concat_width))))):
            before = K.dp_fwd.launches
            on_card = fusion.apply(trainer.params, batch, cfg, EPS, True, train=False, **card_kw)
            check(K.dp_fwd.launches - before == (name == "fused"),
                  f"the {name} DP block took the wrong path on the card")
            on_cpu = fusion.apply(cpu_params, cpu_batch, cfg, EPS, True, train=False, **cpu_kw)
            ref_err = float((on_card.cpu() - on_cpu).abs().max())
            print(f"  {name} DP block: logits max|card - cpu| {ref_err:.3g}")
            torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-3, atol=1e-4)

    def step_fn(tr, data):
        batch = D.gather_batch(data, torch.arange(tc.batch_size, device=dev))
        w = torch.ones(tc.batch_size, device=dev)
        states = [tr.dp_os, tr.model_os]

        def train_step():
            states[:] = tr.steps.train_step(tr.params, *states, batch, w, EPS, gen)[:2]
        return train_step

    phase("profile: steady-state train step at S = 80, attention gate open and closed")
    # closed: the unfused branch, as under the JAX package's gate (S >= 512);
    # in turns (closed, open, open, closed), since the host's clock spreads
    gate = A.attention_available
    step_80 = step_fn(trainer, train_dev)
    for label in ("closed", "open", "open", "closed"):
        A.attention_available = gate if label == "open" else (lambda S, D: False)
        try:
            by_kernel = profile_step(torch, step_80, f"S = 80, gate {label}",
                                     4 * forward_matmul_flops(tc.batch_size, 80))
        finally:
            A.attention_available = gate
        if by_kernel:
            dp_us = {k[:40]: round(v, 2) for k, v in by_kernel.items() if "dp_" in k}
            attn = sum(v for k, v in by_kernel.items() if "attn_" in k)
            print(f"  DP kernels in the step (us/step): {dp_us}; attention kernels "
                  f"{attn:.1f} us/step")
    del trainer, train_dev, test_dev, step_80

    phase("main path 2: TrainAndTest.train_on(auto_truncate=False) -> Trainer.fit, S = 512")
    train, test = synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL)
    check(train.eeg_input.shape == (N_TRAIN, 512), "the 512-token rows were cut")
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    snaps = {}  # host copies of the params after each epoch, for the checkpoint check
    run_epoch = Trainer.run_epoch

    def snapshot_epoch(self, *args, **kwargs):
        row = run_epoch(self, *args, **kwargs)
        snaps[row["epoch"]] = tree_map(lambda t: t.detach().cpu().clone(), self.params)
        return row

    api = TrainAndTest(compute_dtype="float32", epochs=2, artifacts_root=root, echo=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in all_kernels:
        k.launches = 0
    Trainer.run_epoch = snapshot_epoch
    try:
        result = api.train_on(train, test, "DPMLD", "smoke/", "ti", "lapacian_dropout",
                              auto_truncate=False)
    finally:
        Trainer.run_epoch = run_epoch
    launches = {k.name: k.launches for k in all_kernels}
    history = result["history"]
    print_rows(history, steps)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}; f1_best {result['f1_best']:.4f}")
    check(len(history) == 2, "fit ran another number of epochs")
    for row in history:
        check(all(math.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1")),
              "non-finite loss at S = 512")
        check(0.0 <= row["f1"] <= 1.0, "F1 outside [0, 1] at S = 512")
    want = {"attn_fwd": layers * (2 * steps + eval_batches) * 2,
            "attn_bwd": layers * steps * 2, "dp_fwd": 0, "dp_bwd": 0}
    check(launches == want, f"launches {launches}, expected {want}")
    final = api.trainer.params
    check(not torch.equal(final["DP"].cpu(), snaps[1]["DP"])
          and float(final["DP"].abs().max()) > 0, "DP did not train at S = 512")
    logs = os.path.join(root, "logs", "DPMLD", "smoke")
    recs = parse_legacy_records(open(os.path.join(logs, "whole_record.txt")).read())
    check([r["epoch"] for r in recs] == [1, 2], f"whole_record.txt epochs {recs}")
    check(len(open(os.path.join(logs, "metrics.jsonl")).read().splitlines()) == 2,
          "metrics.jsonl does not hold two epochs")
    ckpt_path = os.path.join(root, "models", "custom", "DPMLD", "smoke", "best_f1.pickle")
    if result["f1_best"] > tc.f1_best_init:
        check(os.path.exists(ckpt_path) and os.path.exists(os.path.join(logs, "best_record.txt")),
              "F1 improved but no checkpoint or best record")
        loaded = load_torch_checkpoint(ckpt_path, api.trainer.fusion_cfg, device="cpu")
        best = dict(tree_items(snaps[result["best"]["epoch"]]))
        check(all(torch.equal(leaf, best[path]) for path, leaf in tree_items(loaded)),
              "the checkpoint differs from the best params")
        print(f"  checkpoint of epoch {result['best']['epoch']} loads back equal")
    else:
        check(not os.path.exists(ckpt_path), "F1 never improved, yet a checkpoint exists")
        print("  F1 did not pass 0.5: no checkpoint written, as expected")
    # either way, the final params through the checkpoint format and back
    round_trip = os.path.join(root, "final.pickle")
    save_torch_checkpoint(round_trip, final, api.trainer.fusion_cfg)
    back = load_torch_checkpoint(round_trip, api.trainer.fusion_cfg)
    check(all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(back), tree_items(final))),
          "the final params do not survive the checkpoint round trip on the card")
    shutil.rmtree(root)

    phase("profile: steady-state train step at S = 512 (device time by kernel)")
    by_kernel = profile_step(torch, step_fn(api.trainer, train.to_device(dev)), "S = 512",
                             4 * forward_matmul_flops(tc.batch_size, 512))
    if by_kernel:
        attn = {k: v for k, v in by_kernel.items() if "attn_" in k}
        total = sum(by_kernel.values())
        print(f"  attention kernels: {sum(attn.values()):.1f} us/step, "
              f"{sum(attn.values()) / total:.3f} of device time; "
              + ", ".join(f"{name} {v:.1f}" for name, v in
                          ((re.search(r"attn_[a-z]+", k).group(0), v) for k, v in attn.items())))
    del api

    phase("timing: DP kernels at (8, 2304)")
    B, F = 8, fc.concat_width
    f, dp = inputs(B, F)
    g = torch.randn(B, F, generator=gen, device=dev)
    s = seed(5)

    lib = _build.library()[0]
    lib.eeg_launch_floor.argtypes = [ctypes.c_void_p]

    def launch_floor():  # an empty kernel, launched through ctypes as the kernels are
        _build.raise_on_error(lib.eeg_launch_floor(_build.current_stream(f.device)), "floor")

    floor_ms = time_ms(torch, launch_floor)
    floor_dev = sum(device_us(torch, launch_floor).values())
    print(f"  launch floor (an empty kernel through ctypes): {floor_ms * 1e3:.2f} us (CUDA "
          f"events over back-to-back calls); device time {floor_dev:.2f} us")
    timed = {  # the plain versions draw the kernels' own noise, laplace_plain
        "dp_fwd": (lambda: K.dp_fwd(f, dp, EPS, s),
                   lambda: K.dp_block_plain(f, dp, EPS, K.laplace_plain(5, (B, F), dev))),
        "dp_bwd": (lambda: K.dp_bwd(f, dp, EPS, s, g),
                   lambda: K.dp_block_bwd_plain(f, dp, EPS, K.laplace_plain(5, (B, F), dev), g)),
    }
    kernels = []
    for name, (kern, plain) in timed.items():
        ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain, 20, 5)
        bms, by = dp_bound_ms(name, B, F)
        dev_k = sum(device_us(torch, kern).values())
        dev_p = sum(device_us(torch, plain, 10).values())
        print(f"  {name}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us (CUDA "
              f"events over back-to-back calls); device time kernel {dev_k:.2f} us "
              f"({dev_k / floor_dev:.2f}x the launch floor), plain {dev_p:.2f} us; bound "
              f"{bms * 1e3:.4f} us ({by})")
        kernels.append({
            "name": name, "route": ROUTES[name], "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches_80[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        })

    phase("timing: attention kernels, f32, p = 0.1 (the gate question at S = 80 and 128)")
    import torch.nn.functional as TF

    for S in (80, 128, 512):
        B, H, D = 8, 12, 64
        qkv = torch.randn(B, S, 3, H, D, generator=gen, device=dev)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias = torch.zeros(B, S, device=dev)
        bias[:, VALID_TOKENS:] = NEG
        bias4 = bias[:, None, None, :]
        dout = torch.randn(B, H, S, D, generator=gen, device=dev)
        s = seed(11)
        out, stats = A.attn_fwd(q, k, v, bias, s, ATTN_DROP)

        def plain_fwd():
            keep = torch.rand(B, H, S, S, generator=gen, device=dev) < 1 - ATTN_DROP
            return A.attention_plain(q, k, v, bias, keep, ATTN_DROP)

        def plain_bwd():
            keep = torch.rand(B, H, S, S, generator=gen, device=dev) < 1 - ATTN_DROP
            return A.attention_bwd_plain(q, k, v, bias, keep, ATTN_DROP, dout)

        def sdpa():
            return TF.scaled_dot_product_attention(q, k, v, attn_mask=bias4, dropout_p=ATTN_DROP)

        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(*leaves), leaves, dout)

        n = 20 if S == 512 else 50
        t = {
            "fwd": time_ms(torch, lambda: A.attn_fwd(q, k, v, bias, s, ATTN_DROP), n, 5),
            "fwd plain": time_ms(torch, plain_fwd, n, 5),
            "fwd sdpa": time_ms(torch, sdpa, n, 5),
            "bwd": time_ms(torch, lambda: A.attn_bwd(q, k, v, bias, s, ATTN_DROP, out, stats,
                                                     dout), n, 5),
            "bwd plain": time_ms(torch, plain_bwd, n, 5),
            "fwd+bwd": time_ms(torch, fwd_bwd(
                lambda q_, k_, v_: A.fused_attention(q_, k_, v_, bias, s, ATTN_DROP)), n, 5),
            "fwd+bwd unfused": time_ms(torch, fwd_bwd(
                lambda q_, k_, v_: bert_mod.attention_unfused(q_, k_, v_, bias4, ATTN_DROP,
                                                              gen)), n, 5),
            "fwd+bwd sdpa": time_ms(torch, fwd_bwd(
                lambda q_, k_, v_: TF.scaled_dot_product_attention(
                    q_, k_, v_, attn_mask=bias4, dropout_p=ATTN_DROP)), n, 5),
        }
        t["bwd sdpa"] = t["fwd+bwd sdpa"] - t["fwd sdpa"]
        # the eval path's forward: no mask, so no Philox
        t["fwd p=0"] = time_ms(torch, lambda: A.attn_fwd(q, k, v, bias, s, 0.0), n, 5)
        dev_t = {
            "fwd": sum(device_us(torch, lambda: A.attn_fwd(q, k, v, bias, s, ATTN_DROP),
                                 10).values()),
            "bwd": sum(device_us(torch, lambda: A.attn_bwd(q, k, v, bias, s, ATTN_DROP, out,
                                                           stats, dout), 10).values()),
            "fwd plain": sum(device_us(torch, plain_fwd, 10).values()),
            "bwd plain": sum(device_us(torch, plain_bwd, 10).values()),
        }
        bounds = {name: attn_bound_ms(name, B, H, S, D, 4) for name in ("attn_fwd", "attn_bwd")}
        simt = {name: attn_bound_ms(name, B, H, S, D, 4, F32_OPS_PER_S)[0]
                for name in ("attn_fwd", "attn_bwd")}
        print(f"  S = {S}: " + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in t.items()))
        print(f"  S = {S}: device time fwd {dev_t['fwd']:.1f} us, bwd {dev_t['bwd']:.1f} us, "
              f"plain fwd {dev_t['fwd plain']:.1f} us, plain bwd {dev_t['bwd plain']:.1f} us; "
              f"bound (3xTF32) fwd {bounds['attn_fwd'][0] * 1e3:.1f} us "
              f"({bounds['attn_fwd'][1]}), bwd {bounds['attn_bwd'][0] * 1e3:.1f} us "
              f"({bounds['attn_bwd'][1]}); CUDA-core f32 bound fwd {simt['attn_fwd'] * 1e3:.1f} "
              f"us, bwd {simt['attn_bwd'] * 1e3:.1f} us")
        if S == 512:
            for name, key in (("attn_fwd", "fwd"), ("attn_bwd", "bwd")):
                kernels.append({
                    "name": name, "route": ROUTES[name], "source": SOURCES[name],
                    "replaces": REPLACES[name], "launches": launches[name],
                    "max_abs_err": err[name], "ms": t[key], "plain_ms": t[key + " plain"],
                    "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                    "library_ms": t[key + " sdpa"],
                })

    phase("timing: attention kernels, bf16, (8, 12, 512, 64), p = 0.1")
    B, H, S, D = 8, 12, 512, 64
    q, k, v, dout = (torch.randn(B, H, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
                     for _ in range(4))
    bias = torch.zeros(B, S, device=dev)
    s = seed(13)
    out, stats = A.attn_fwd(q, k, v, bias, s, ATTN_DROP)
    bf = {"fwd": time_ms(torch, lambda: A.attn_fwd(q, k, v, bias, s, ATTN_DROP), 20, 5),
          "bwd": time_ms(torch, lambda: A.attn_bwd(q, k, v, bias, s, ATTN_DROP, out, stats,
                                                   dout), 20, 5),
          "fwd sdpa": time_ms(torch, lambda: TF.scaled_dot_product_attention(
              q, k, v, attn_mask=bias[:, None, None, :], dropout_p=ATTN_DROP), 20, 5)}
    bnd = {n: attn_bound_ms(n, B, H, S, D, 2)[0] for n in ("attn_fwd", "attn_bwd")}
    print("  " + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in bf.items())
          + f"; bound fwd {bnd['attn_fwd'] * 1e3:.2f} us, bwd {bnd['attn_bwd'] * 1e3:.2f} us")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
