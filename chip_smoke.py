#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA C++ kernels from this checkout, one nvcc process
per source, started together (the DP block, forward and backward;
attention, forward, backward on the tensor cores and the dropout-mask test
hook), and holds each against its
plain PyTorch version: the DP forward bit for bit where the card's math
library allows (within 1e-5 in any case) with ``laplace_plain``'s noise, the
attention mask bit for bit against ``keep_mask_plain``, also with a seed
vector of G = 2 over 2B rows and of G = 5 over the sweep's 5 members'
rows (equal to G calls of G = 1, bit for bit, the forward and backward
too), the DP kernels with a member axis (equal to M single calls and their
plain versions, bit for bit), the attention forward at the ViT's shapes
(S = 50 at 16, 2 and 9 rows, S = 197; zero bias, p = 0); and a 2-layer
BERT at S = 512 on the card against the CPU. Checks the bf16 Adam moment's
stochastic rounding on the card. Then drives the main paths at full width
(BERT-base, 3-layer cross-attention decoder, F = 2304, batch 8):

1. the flagship TICA_LapDropout fused-DP trainer in f32 at the truncated
   S = 80, two train+eval epochs through ``Trainer.run_epoch``, where both
   DP kernels and (the H100's gate) both attention kernels run;
3. ``TrainAndTest(epochs=2)`` at its default bf16 compute through
   ``train_on(compact_vocab=True)`` at S = 80, where the bf16
   instantiations of the attention kernels run; then ``bench.py``'s
   configuration (bf16 compute, bf16 Adam moments with stochastic rounding,
   ``precast_params``, compact vocab, composed DP) through ``Trainer.fit``,
   writing and reloading a full-vocab best checkpoint;
4. ``share_phase_dropout`` (features encoded once), fused DP, f32, and
   sharing without reuse, through ``Trainer.fit``;
5. ``paired_phase_encode`` (one encoder forward at 2B rows), bf16 with the
   in-step cast, through ``Trainer.fit``; then ``n_eval=4`` and
   ``shuffle_eval`` through ``Trainer.fit``; ``StepFunctions.cycle`` at
   K = 2 over the bench configuration under
   ``torch.cuda.set_sync_debug_mode("error")``, against two
   ``Trainer.run_epoch`` calls; ``TrainAndTest.predict`` on the bench
   configuration's checkpoint at n_eval = 1 and 4 (against ``eval_epoch``,
   timed at 601 rows, the vocabulary range check raising before any launch);
6. the model zoo: TTCA, ITCA, IICA, TISC, NonPrivate, EquWeight and
   ``feature_all_lap`` each through ``TrainAndTest.train_on`` in f32 (the
   DP block fused where the class has it), one epoch (text streams cut
   together to the longest text row: S = 80, the act text taking the EEG
   rows' length), held to its predicted launches, card against CPU, its
   best checkpoint reloaded and served through ``predict``, a step
   profiled; TTCA and ITCA again at the bf16 default with the compact
   vocab; one forward and backward of TICA_DPSGD and of the PriGumbel head;
6. DP-SGD: TICA_DPSGD through ``TrainAndTest(epochs=2).train_on(...,
   dp_mode="DPSGD")`` at the API's bf16 default, which DP-SGD does not
   take (f32, Poisson windows of 24 rows, the attention kernels in every
   forward and in the last layer's backward), its sigma and launches
   exact, frozen leaves bit-equal, an epoch under sync debug mode "error",
   per-example gradients card against CPU and against batch-1 passes, a
   step profiled; then ``ComparePrivateScheme().run()`` over files it
   writes, the four schemes held to their launches, then skipped as
   completed;
7. the batched sweep: ``SweepRunner`` over ``privacy_utility_frontier()``
   (5 members, epsilon 0.1 to 10), the flagship with fused DP in f32, two
   epochs held to path 1's launches (the DP kernels with a member axis,
   attention with a seed per member), one more epoch under sync debug mode
   "error", a member step against single-member steps from the same
   weights, the step profiled in turns against five single-member steps,
   the bench configuration as a 5-member sweep; then the legacy drivers:
   ``EpsExperiment.run_all_vmapped`` (20 members in two chunks of 10),
   ``extract_feawei``, ``dp_inits.feawei`` and ``run_index``,
   ``MetricTrainer.fit``, ``PriGumbelPretrainer.pretrain`` and
   ``AlphaSweep.run``, each held to the launches predicted from the code;
8. the embedding path, raw rows to a trained model: raw task txt files of
   3003 rows through ``process`` (the reference's 2402 / 601 split),
   ``GetEmbedding.run`` with CLIP ViT-B/32 (its self-attention through the
   attention forward kernel: 12 launches per chunk of 16 rows, 4536 in
   all) and ResNet-34 at 224 x 224 and both tokenizers (the C++ WordPiece,
   every row held to the Python engine), ViT-B/16 on the test split, both
   towers card against CPU on 4 images, a ViT-B/32 chunk profiled, then
   one f32 fused-DP epoch of the flagship through ``TrainAndTest.train``
   from the tree written, which launches all four kernels;
2. the untruncated 512-token f32 trainer through
   ``TrainAndTest.train_on(auto_truncate=False)`` and ``Trainer.fit``, two
   epochs, where every BERT self-attention runs the attention kernels;

checks that each path went through its kernels (launches by dtype, the
eval as one batched forward an epoch) and its logits on the card against
the CPU (f32 with the composed and the fused DP block; bf16 at a bf16
tolerance), profiles one train step of each (device time by kernel, the
host's kernel launches and top host ops; at S = 80 with the attention gate
open and closed, bf16 with ``precast_params`` and with the in-step cast in
turns with f32, and the fast modes in turns with f32), times the eval epoch batched against the batch loop at
601 rows, and times every kernel
beside its bound, its plain version, an empty kernel's launch and, where
one exists, the one PyTorch call that computes the same function. Exits
non-zero on any failure; without a CUDA device it fails before printing any
result. The last line is ``{"ok": true, "device": {...}}``.
"""
import ctypes
import dataclasses
import json
import math
import os
import pickle
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
# valid tokens of the act text stream (tt, it). The repo holds no act rows
# to tokenize; its one measured text length is the committed EEG rows'
# longest, 65 tokens (eeg_multimodal_tpu/data/datasets.py:181), so the act
# stream takes that bound: 25 integer channels against the EEG's 30
ACT_TOKENS = VALID_TOKENS
LAPLACE_MAX = math.log(2 ** 23) + 1e-3
ATTN_DROP = 0.1  # BERT's attention-prob dropout
NEG = float(np.finfo(np.float32).min)
# f32: the JAX attention tests' own tolerances (tests/test_attention_kernel.py)
ATTN_TOL = {"f32_fwd": dict(rtol=1e-4, atol=1e-5), "f32_bwd": dict(rtol=2e-3, atol=1e-4),
            "bf16": dict(rtol=2e-2, atol=2e-2)}
# bf16 logits (max |logit| 0.26-0.76 at random init), card against CPU:
# cuBLAS and the CPU's GEMMs may round at other points, so not bit for bit.
# The limit sits between sound runs' readings (4.14e-5 and 6.81e-5 on an
# H100) and the whole effect of bf16 on the logits (max |bf16 - f32| on the
# card, 1.15e-3 to 2.01e-3): a forward off by half of bf16's own effect fails
BF16_LOGIT_TOL = dict(rtol=0.0, atol=5e-4)
# the host's kernel launches as the profiler names them (cudaLaunchKernel*,
# and cuLaunchKernel*, through which cuBLAS launches), and its copies and syncs
LAUNCH_API = re.compile(r"cu(da)?LaunchKernel")
# main path 8: two raw task files, 3003 rows in all, so that the split is the
# reference's 2402 / 601 (bench.py:26-27; ceil(0.2 * 3003) = 601)
RAW_ROWS = (1500, 1503)
# the ViT's attention: ViT-B/32 (S = 50) at the embed's batch of 16 and its
# tail batches (2402 mod 16 = 2, 601 mod 16 = 9); ViT-B/16 (S = 197)
VIT_ATTN_SHAPES = ((16, 12, 50, 64), (2, 12, 50, 64), (9, 12, 50, 64), (16, 12, 197, 64))
# the image towers, card against CPU: the 2-layer BERT check's tolerance
EMBED_TOL = dict(rtol=1e-3, atol=1e-4)
ROW = ("train_loss", "train_acc", "test_loss", "test_acc", "f1")  # run_epoch's numbers
SYNC_API = re.compile(r"cuda(Memcpy|Memset|StreamSynchronize|DeviceSynchronize|EventSynchronize"
                      r"|Malloc|Free)")


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


def device_us(torch, fn, n=50, host=None):
    """Device time per call of ``fn`` in us, by CUDA kernel name
    (torch.profiler); empty when three profiles saw no device activity.
    ``host``, a dict, receives each host event's (calls, self us) per call
    of ``fn`` (aten ops, autograd nodes, CUDA API calls) from the same
    profile."""
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
            if host is not None:
                for a in prof.key_averages():
                    if a.device_type == torch.autograd.DeviceType.CPU:
                        host[a.key] = (a.count / n, a.self_cpu_time_total / n)
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


def dp_bound_ms(name, B, F, M=1):
    """Least time on the card: the larger of bytes over HBM rate (each input
    read once, each output written once) and operations over f32 rate. B
    rows in all, M members (each with its DP row, seed and, for M > 1, its
    e^eps)."""
    per_member = 8 + (4 if M > 1 else 0)
    if name == "dp_fwd":  # read f, dp, seed; write out
        nbytes = (2 * B * F + M * F) * 4 + M * per_member
    else:  # read f, g, dp, seed; write df, dDP
        nbytes = (3 * B * F + 2 * M * F) * 4 + M * per_member
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


def zoo_rows(D, rng, mt, n, seq=512):
    """``n`` synthetic rows of the ``mt`` pairing, made with numpy: an EEG
    text stream of VALID_TOKENS valid ids padded to ``seq``, an act text
    stream of ACT_TOKENS (the faithful ``tt`` pairing feeds its attention
    mask as ids, dataset.py:63), 512-d embeddings for an image stream, and
    a label."""
    def txt(valid):
        mask = np.zeros((n, seq), np.int32)
        mask[:, :valid] = 1
        return {"input_ids": rng.randint(0, 30000, (n, seq)).astype(np.int32) * mask,
                "attention_mask": mask}

    kw = {}
    for stream, kind, valid in (("eeg", mt[0], VALID_TOKENS), ("act", mt[1], ACT_TOKENS)):
        kw[f"{stream}_{'txt' if kind == 't' else 'img'}"] = (
            txt(valid) if kind == "t" else rng.randn(n, 512).astype(np.float32))
    return D.build_pairing(mt, rng.randint(0, 2, n).astype(np.int32), **kw)


def zoo_seq_lens(D):
    """The text lengths S the zoo phase's attention runs at: each ZOO
    pairing's text streams after ``train_on``'s ``truncate_pair``."""
    rng = np.random.RandomState(0)
    seqs = set()
    for _, mt, _, _ in ZOO:
        for part in D.truncate_pair(zoo_rows(D, rng, mt, 2), zoo_rows(D, rng, mt, 2)):
            seqs |= {x.shape[1] for x, kind in zip((part.eeg_input, part.act_input), mt)
                     if kind == "t"}
    return seqs


PAPER_TRAIN_ROWS = 2402  # the reference's training split: q = 8 / 2402


def dpsgd_batches():
    """The batches B the DP-SGD path's attention runs at, as
    (windows, eval): its Poisson window at the API's default batch over the
    smoke's N_TRAIN rows and over the paper's 2402 (forward and backward),
    and its batched eval over N_EVAL rows, padded to whole batches (forward
    only)."""
    import inspect

    from eeg_multimodal_torch.dp.dpsgd import window_size
    from eeg_multimodal_torch.train.api import TrainAndTest

    b = inspect.signature(TrainAndTest).parameters["batch_size"].default
    windows = tuple(sorted({window_size(n, b / n) for n in (N_TRAIN, PAPER_TRAIN_ROWS)}))
    return windows, -(-N_EVAL // b) * b


def zoo_launches(mt, dp_mode, steps, layers):
    """The predicted kernel launches of one ``train_on`` epoch of ``steps``
    train steps and one batched eval forward, with the fused DP block: the
    alternating step (``lapacian_dropout``) runs two forwards and one
    backward through the encoders, the single-optimizer step one of each;
    each BERT stream launches ``layers`` attention kernels a forward or a
    backward, and the DP block one kernel a forward or a backward, where
    the class has it (phase 1's backward reaches only ``DP``). A DP-SGD
    step runs the per-example forward and the metric forward over its
    window, and a backward that stops at the last BERT layer: one
    attention backward a step."""
    alternating = dp_mode == "lapacian_dropout"
    forwards = (2 if alternating or dp_mode == "DPSGD" else 1) * steps + 1
    txt = mt.count("t")
    return {"dp_fwd": forwards if alternating else 0,
            "dp_bwd": 2 * steps if alternating else 0,
            "attn_fwd": txt * layers * forwards,
            "attn_bwd": txt * (1 if dp_mode == "DPSGD" else layers) * steps}


def profile_step(torch, step, label, flops=None, work="2 forwards + 1 backward ~ 4 forwards"):
    """Host step time, device busy time, idle share, the top kernels, the
    host's kernel launches and the top host ops of one steady-state train
    step; returns the device us by kernel name. ``work`` says what ``flops``
    counts (None: no matmul count is printed)."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"  {label}: train step {step_ms:.2f} ms ({1e3 / step_ms:.2f} steps/s)" + (
        f"; matmul work ~{flops / 1e9:.0f} GFLOP/step ({work}) = "
        f"{flops / F32_OPS_PER_S * 1e3:.2f} ms at the f32 peak" if flops else ""))
    host = {}
    by_kernel = device_us(torch, step, n=3, host=host)
    if not by_kernel:
        print("  the profiler saw no device activity: device time not measured")
        return by_kernel
    busy_ms = sum(by_kernel.values()) / 1e3
    print(f"  device busy {busy_ms:.2f} ms/step, idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f}" + (
              f"; matmul work at {flops / (busy_ms * 1e-3) / 1e12:.2f} TFLOP/s of device time "
              f"({flops / (busy_ms * 1e-3) / F32_OPS_PER_S:.3f} of the f32 peak)" if flops
              else "") + "; top kernels (us/step):")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us:9.1f}  {name[:90]}")
    calls = {k: c for k, (c, _) in host.items()}
    launches = sum(c for k, c in calls.items() if LAUNCH_API.match(k))
    syncs = {k: c for k, c in calls.items() if SYNC_API.match(k)}
    aten = sum(c for k, c in calls.items() if k.startswith("aten::"))
    print(f"  host, per step under the profiler: {launches:.0f} kernel launches "
          f"(cudaLaunchKernel and cuLaunchKernel calls), {aten:.0f} aten ops, "
          f"{sum(c for k, c in calls.items() if k.startswith('autograd::engine')):.0f} "
          f"autograd nodes, copies and syncs {syncs}; top host ops by self time "
          "(us/step, calls/step):")
    for name, (c, us) in sorted(host.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"    {us:9.1f} {c:6.0f}  {name[:80]}")
    return by_kernel


def check_attention_kernels(torch, A, gen, dev, zoo_seqs, dpsgd_bs):
    """Attention kernels against their plain versions, at the main paths'
    shapes (8, 12, 80, 64) and (8, 12, 512, 64), the DP-SGD path's
    (B, 12, 80, 64) f32 for each B of ``dpsgd_bs`` (``dpsgd_batches``: the
    windows at the smoke's and the paper's rows, and the batched eval),
    and (8, 12, S, 64) for each S of ``zoo_seqs`` (the zoo phase's text
    lengths), in f32 and bf16, and at smaller ones; at each DP-SGD window
    also through autograd with an output gradient the kernels' 16-byte
    loads cannot read, which ``vector_loadable`` copies.
    Returns the max errors, both dropout rates together, as
    ``{(kernel, dtype, (B, H, S, D)): max |kernel - plain|}``."""
    err = {}
    mask_seqs = sorted({80, 512} | set(zoo_seqs))
    for S in mask_seqs:  # the kernels' mask is keep_mask_plain's, bit for bit
        seed = torch.tensor([2 ** 40 + S], dtype=torch.int64, device=dev)
        card = A.attn_dropout_mask(seed, 2, 3, S, ATTN_DROP).bool()
        check(torch.equal(card, A.keep_mask_plain(2 ** 40 + S, 2, 3, S, ATTN_DROP, dev)),
              f"attn_dropout_mask differs from keep_mask_plain at S = {S}")
    print(f"  attn_dropout_mask equals keep_mask_plain at S = {mask_seqs}")
    cases = [(2, 3, 80, 64, torch.float32), (8, 12, 80, 64, torch.float32),
             (8, 12, 128, 64, torch.float32), (8, 12, 512, 64, torch.float32),
             (1, 2, 512, 128, torch.float32), (2, 3, 80, 64, torch.bfloat16),
             (8, 12, 80, 64, torch.bfloat16), (8, 12, 512, 64, torch.bfloat16)]
    windows, eval_b = dpsgd_bs
    cases += [(B, 12, 80, 64, torch.float32) for B in windows + (eval_b,)
              if (B, 12, 80, 64, torch.float32) not in cases]
    cases += [(8, 12, S, 64, dtype) for S in sorted(zoo_seqs)
              for dtype in (torch.float32, torch.bfloat16)
              if (8, 12, S, 64, dtype) not in cases]
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
            for name, e in (("attn_fwd", e_fwd), ("attn_bwd", e_bwd)):
                key = (name, str(dtype)[6:], (B, H, S, D))
                err[key] = max(err.get(key, 0.0), e)
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
            if B in windows:  # an output gradient 4 bytes off the 16-byte grid
                odd = torch.empty(dout.numel() + 1, dtype=dtype, device=dev)[1:].view_as(dout)
                odd.copy_(dout)
                check(not A._aligned(odd) and A.vector_loadable(odd) is not odd,
                      "the misaligned output gradient was not copied")
                auto = torch.autograd.grad(A.fused_attention(*leaves, bias, seed, rate),
                                           leaves, odd)
                check(all(torch.equal(a, g) for a, g in zip(auto, grads)),
                      "a misaligned output gradient gives other gradients")
            print(f"  {(B, H, S, D)} {str(dtype)[6:]} p={rate}: max|out - plain| {e_fwd:.3g}, "
                  f"max|grad - plain| {e_bwd:.3g}")
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    frac = float(A.attn_dropout_mask(seed, 8, 12, 512, ATTN_DROP).float().mean())
    print(f"  keep fraction over 8*12*512*512 = {8 * 12 * 512 * 512} draws: {frac:.6f}")
    check(abs(frac - (1 - ATTN_DROP)) <= 1e-3, f"keep fraction {frac} off {1 - ATTN_DROP}")
    worst = {(name, dt): max(e for (n, d, _), e in err.items() if (n, d) == (name, dt))
             for name, dt, _ in err}
    print("  max errors over the shapes: " + ", ".join(
        f"{name} {dt} {e:.3g}" for (name, dt), e in sorted(worst.items()))
        + " (CUDA-core design: f32 2.98e-7 / 4.77e-7, bf16 1.95e-3 / 7.81e-3)")
    return err


def check_grouped_attention(torch, A, gen, dev, G=2):
    """The attention kernels with a seed vector of G seeds over G groups of
    8 rows: G = 2 as the paired phase encode's forward calls them, G = 5 as
    the 5-member sweep's. The mask kernel at S = 80 and 512 (G = 2) or 80
    equals G calls of G = 1 and ``keep_mask_plain``, bit for bit; forward
    and backward at (8 G, 12, 80, 64), f32 and bf16, p = 0.1, against their
    plain versions with that mask, and equal to G calls of G = 1 over the
    groups, bit for bit. Returns the max errors as ``{(kernel, dtype): max
    |kernel - plain|}``."""
    seeds = torch.tensor([2 ** 40 + 3, 17, 5, 2 ** 33 + 1, 99][:G], dtype=torch.int64,
                         device=dev)
    B, H, S, D = 8 * G, 12, 80, 64
    groups = [slice(i * 8, (i + 1) * 8) for i in range(G)]
    for S_ in ((80, 512) if G == 2 else (80,)):
        both = A.attn_dropout_mask(seeds, B, H, S_, ATTN_DROP)
        parts = torch.cat([A.attn_dropout_mask(seeds[i:i + 1], 8, H, S_, ATTN_DROP)
                           for i in range(G)])
        check(torch.equal(both, parts),
              f"the G = {G} mask differs from {G} G = 1 masks at S = {S_}")
        check(torch.equal(both.bool(), A.keep_mask_plain(seeds.tolist(), B, H, S_, ATTN_DROP,
                                                         dev)),
              f"the G = {G} mask differs from keep_mask_plain at S = {S_}")
    print(f"  G = {G} masks at ({G} x 8, 12, S) equal {G} G = 1 calls and keep_mask_plain, "
          "bit for bit")
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        qkv = torch.randn(B, S, 3, H, D, generator=gen, device=dev).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias = torch.zeros(B, S, device=dev)
        bias[:, VALID_TOKENS:] = NEG
        bias[9, 20:] = NEG  # a shorter row in the second group
        dout = torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
        out, stats = A.attn_fwd(q, k, v, bias, seeds, ATTN_DROP)
        keep = A.attn_dropout_mask(seeds, B, H, S, ATTN_DROP).bool()
        plain = A.attention_plain(q, k, v, bias, keep, ATTN_DROP)
        torch.testing.assert_close(out.float(), plain.float(),
                                   **ATTN_TOL["f32_fwd" if f32 else "bf16"])
        grads = A.attn_bwd(q, k, v, bias, seeds, ATTN_DROP, out, stats, dout)
        plain_g = A.attention_bwd_plain(q, k, v, bias, keep, ATTN_DROP, dout)
        for g, pg in zip(grads, plain_g):
            torch.testing.assert_close(g.float(), pg.float(), **ATTN_TOL["f32_bwd" if f32 else "bf16"])
        name = str(dtype)[6:]
        err[("attn_fwd", name)] = float((out.float() - plain.float()).abs().max())
        err[("attn_bwd", name)] = max(float((g.float() - pg.float()).abs().max())
                                      for g, pg in zip(grads, plain_g))
        parts = []
        for i, rows in enumerate(groups):
            o, st = A.attn_fwd(q[rows], k[rows], v[rows], bias[rows], seeds[i:i + 1], ATTN_DROP)
            parts.append((o, *A.attn_bwd(q[rows], k[rows], v[rows], bias[rows], seeds[i:i + 1],
                                         ATTN_DROP, o, st, dout[rows])))
        check(all(torch.equal(t, torch.cat(ps)) for t, *ps in zip((out, *grads), *parts)),
              f"{name}: the G = {G} call differs from {G} G = 1 calls")
        print(f"  {(B, H, S, D)} {name} G = {G}, p = {ATTN_DROP}: max|out - plain| "
              f"{err[('attn_fwd', name)]:.3g}, max|grad - plain| {err[('attn_bwd', name)]:.3g}; "
              f"forward and gradients equal {G} G = 1 calls, bit for bit")
    return err


def vit_qkv(torch, gen, dev, B, H, S, D):
    """q, k, v as the ViT passes them: (B, H, S, D) views of one packed
    (B, S, 3 H D) f32 projection, no copy."""
    W = H * D
    qkv = torch.randn(B, S, 3 * W, generator=gen, device=dev)
    return [qkv[..., i * W:(i + 1) * W].reshape(B, S, H, D).transpose(1, 2) for i in range(3)]


def check_vit_attention(torch, A, gen, dev):
    """``attn_fwd`` against ``attention_plain`` at the ViT's shapes
    (``VIT_ATTN_SHAPES``), f32, a zero key bias, p = 0, within the JAX
    attention tests' rtol 1e-4 / atol 1e-5; the tower's ``vit.attention``
    equal to the kernel bit for bit. Returns ``{(B, H, S, D): max |kernel -
    plain|}``."""
    from eeg_multimodal_torch.models import vit

    err = {}
    for B, H, S, D in VIT_ATTN_SHAPES:
        q, k, v = vit_qkv(torch, gen, dev, B, H, S, D)
        bias = torch.zeros(B, S, device=dev)
        seed = torch.zeros(1, dtype=torch.int64, device=dev)
        out, _ = A.attn_fwd(q, k, v, bias, seed, 0.0)
        plain = A.attention_plain(q, k, v, bias)
        torch.testing.assert_close(out, plain, **ATTN_TOL["f32_fwd"])
        err[(B, H, S, D)] = float((out - plain).abs().max())
        with torch.inference_mode():
            check(torch.equal(vit.attention(q, k, v), out), "the tower's attention is not the "
                                                            "kernel's")
        print(f"  {(B, H, S, D)} f32 p=0, zero bias, packed-QKV views: max|out - plain| "
              f"{err[(B, H, S, D)]:.3g}")
    return err


# the sweep's epsilons (privacy_utility_frontier's default grid)
MEMBER_EPS = (0.1, 1.0, 3.0, 5.0, 10.0)


def check_member_dp(torch, K, gen, dev):
    """The DP kernels with a member axis, at (M, B, F) = (5, 8, 2304), the
    5-member sweep's, and (3, 5, 1001), groups of four crossing rows: M
    members' rows (M B, F) with an (M, F) DP, an (M,) epsilon vector and M
    seeds. The forward equals ``dp_block_plain`` with ``laplace_plain``'s
    per-member noise and M single calls, bit for bit; the backward (df and
    dDP (M, F)) equals M single calls bit for bit, and the plain backward
    within the single model's tolerance (rtol 2e-3, atol 1e-4: the plain
    sums go in another order); the autograd Function gives the kernels'
    gradients. Returns the max errors against the plain versions."""
    err = {"dp_fwd": 0.0, "dp_bwd": 0.0}
    for M, B, F in ((5, 8, 2304), (3, 5, 1001)):
        f = torch.randn(M * B, F, generator=gen, device=dev)
        dp = torch.randn(M, F, generator=gen, device=dev)
        g = torch.randn(M * B, F, generator=gen, device=dev)
        f[B, [3, 10]] = f[B].min() - 1.0  # ties in the second member's first row
        f[B, [7, 20]] = f[B].max() + 1.0
        eps = MEMBER_EPS[:M]
        eps_t = torch.tensor(eps, dtype=torch.float64, device=dev)
        seeds = torch.tensor([1234 + 7 * m for m in range(M)], dtype=torch.int64, device=dev)
        rows = [slice(m * B, (m + 1) * B) for m in range(M)]
        out = K.dp_fwd(f, dp, eps_t, seeds)
        plain = K.dp_block_plain(f, dp, eps_t, K.laplace_plain(seeds.tolist(), (M * B, F), dev))
        singles = torch.cat([K.dp_fwd(f[r], dp[m:m + 1], eps[m], seeds[m:m + 1])
                             for m, r in enumerate(rows)])
        err["dp_fwd"] = max(err["dp_fwd"], float((out - plain).abs().max()))
        check(torch.equal(out, plain), f"member dp_fwd at {(M, B, F)} differs from dp_block_plain")
        check(torch.equal(out, singles), f"member dp_fwd at {(M, B, F)} differs from {M} calls")
        df, ddp = K.dp_bwd(f, dp, eps_t, seeds, g)
        one = [K.dp_bwd(f[r], dp[m:m + 1], eps[m], seeds[m:m + 1], g[r])
               for m, r in enumerate(rows)]
        check(torch.equal(df, torch.cat([d for d, _ in one]))
              and torch.equal(ddp, torch.cat([p for _, p in one])),
              f"member dp_bwd at {(M, B, F)} differs from {M} calls")
        df_p, ddp_p = K.dp_block_bwd_plain(f, dp, eps_t,
                                           K.laplace_plain(seeds.tolist(), (M * B, F), dev), g)
        torch.testing.assert_close(df, df_p, rtol=2e-3, atol=1e-4)
        torch.testing.assert_close(ddp, ddp_p, rtol=2e-3, atol=1e-4)
        err["dp_bwd"] = max(err["dp_bwd"], float((df - df_p).abs().max()),
                            float((ddp - ddp_p).abs().max()))
        fr, dpr = f.clone().requires_grad_(), dp.clone().requires_grad_()
        gf, gdp = torch.autograd.grad(K.fused_lap_dropout(fr, dpr, eps_t, seeds), (fr, dpr), g)
        check(torch.equal(gf, df) and torch.equal(gdp, ddp), "member autograd.Function differs")
        print(f"  (M, B, F) = {(M, B, F)}: forward equal to dp_block_plain and to {M} single "
              f"calls, bit for bit; backward equal to {M} single calls, bit for bit, max "
              f"|bwd - plain| {err['dp_bwd']:.3g}")
    return err


# a stream's model and coefficient as TrainAndTest's file layout names them
STREAM_MODEL = {"t": ("bert", "bert-base-uncased"), "i": ("clip", "ViT-B/32")}


def write_split(root, split, arrays):
    """A split as the reference's files under ``root`` (the layout
    ``TrainAndTest`` reads, base_train.py:77-125): the label CSV, and for
    each stream a BERT token pickle (a ``t`` stream) or a CLIP embedding
    pickle (an ``i`` stream), under STREAM_MODEL's names."""
    processed = os.path.join(root, "data", "processed")
    os.makedirs(processed, exist_ok=True)
    with open(os.path.join(processed, f"{split}_label.csv"), "w") as f:
        f.write("label\n" + "".join(f"{int(x)}\n" for x in arrays.labels))
    for modal, kind, x, m in (("EEG", arrays.multimodal_type[0], arrays.eeg_input,
                               arrays.eeg_mask),
                              ("act", arrays.multimodal_type[1], arrays.act_input,
                               arrays.act_mask)):
        obj = ([{"input_ids": ids[None], "attention_mask": mk[None]} for ids, mk in zip(x, m)]
               if kind == "t" else x[:, 0, :])
        model, coef = STREAM_MODEL[kind]
        sub = f"{'txt' if kind == 't' else 'img'}/{model}_{coef.replace('/', '_').replace('-', '_')}"
        path = os.path.join(root, "data", "embedding", modal, sub)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, f"{split}.pickle"), "wb") as f:
            pickle.dump(obj, f)


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


def check_stochastic_rounding(torch, O, dev):
    """The bf16 Adam moment's stochastic rounding on the card: values bf16
    holds come back exactly; the mean of many roundings of one value is that
    value; the card's int32 bit arithmetic equals the CPU's for the same
    draws (negative, largest finite); a (seed, step) gives the same bits,
    another seed or step other bits."""
    fmax = float(np.finfo(np.float32).max)
    gen = torch.Generator(device=dev).manual_seed(3)
    held = torch.cat([torch.randn(1 << 16, generator=gen, device=dev) * 1e3,
                      torch.tensor([0.0, -0.0, 1.0, -2.5, 3.0e38, -3.0e38], device=dev)])
    held = held.to(torch.bfloat16).float()
    out = O.stochastic_round_to_bf16(held, gen)
    check(torch.equal(out.view(torch.int16), held.to(torch.bfloat16).view(torch.int16)),
          "stochastic rounding changed values that bf16 holds")
    x0 = 1.0 + 0.3 * 2.0 ** -7  # 30 % of the way from 1 to the next bf16 value
    n = 1 << 22
    r = O.stochastic_round_to_bf16(torch.full((n,), x0, device=dev), gen).float()
    up = float((r > 1.0).float().mean())
    mean_err = abs(float(r.double().mean()) - x0)
    check(set(torch.unique(r).tolist()) <= {1.0, 1.0 + 2.0 ** -7}, "rounded off the neighbours")
    # 5 sigma of the binomial share over n draws: 5 sqrt(0.21 / n) = 1.1e-3
    check(abs(up - 0.3) <= 1.2e-3, f"rounded up {up:.5f} of the time, not 0.3")
    check(mean_err <= 1.2e-3 * 2.0 ** -7, f"mean off by {mean_err:.3g}")
    x = torch.cat([torch.randn(1 << 16, generator=gen, device=dev),
                   torch.tensor([fmax, -fmax, -1.5, 2.0 ** -126], device=dev)])
    rnd = torch.randint(0, 1 << 16, x.shape, generator=gen, device=dev, dtype=torch.int32)
    on_card = O.stochastic_round_bits(x, rnd).view(torch.int16).cpu()
    check(torch.equal(on_card, O.stochastic_round_bits(x.cpu(), rnd.cpu()).view(torch.int16)),
          "the card's rounding bits differ from the CPU's")
    # JAX's unsigned form, in int64: ((bits mod 2^32 + r) >> 16) mod 2^16
    bits = x.cpu().view(torch.int32).long() & 0xFFFFFFFF
    want = ((bits + rnd.cpu().long()) >> 16) & 0xFFFF
    check(torch.equal(on_card.long() & 0xFFFF, want), "the rounding bits differ from uint32's")
    adam = O.Adam(1e-3, nu_dtype=torch.bfloat16, sr_seed=7)
    y = torch.rand(1 << 16, generator=gen, device=dev)

    def draw(opt, count):
        return O.stochastic_round_to_bf16(y, opt._sr_generator(count, dev)).view(torch.int16)

    same = torch.equal(draw(adam, 5), draw(adam, 5))
    other_step = not torch.equal(draw(adam, 5), draw(adam, 6))
    other_seed = not torch.equal(draw(adam, 5),
                                 draw(O.Adam(1e-3, nu_dtype=torch.bfloat16, sr_seed=8), 5))
    check(same and other_step and other_seed, "the rounding stream is not a function of "
          f"(seed, step): same {same}, other step {other_step}, other seed {other_seed}")
    print(f"  held values exact ({held.numel()}); {n} draws of {x0}: up {up:.5f} (0.3), "
          f"|mean - x| {mean_err:.3g}; bits equal the CPU's and uint32's; per (seed, step)")


# The model zoo's trainable classes beside the flagship: (name, multimodal
# type, dp_mode, cross-attention type), as config_for names them
ZOO = (("TTCA_LapDropout", "tt", "lapacian_dropout", "double_stream"),
       ("ITCA_LapDropout", "it", "lapacian_dropout", "double_stream"),
       ("IICA_LapDropout", "ii", "lapacian_dropout", "double_stream"),
       ("TISC_LapDropout", "ti", "lapacian_dropout", "single_stream"),
       ("TICA_NonPrivate", "ti", "NDP", "double_stream"),
       ("TISC_LapDropoutEquWeight", "ti", "lapacian_dropout_equal_weight", "double_stream"),
       ("feature_all_lap", "ti", "feature_all_lap", "double_stream"))


def run_zoo(torch, dev, rng, gen, all_kernels, layers, steps, step_fn):
    """The zoo phase: each class of ZOO through ``TrainAndTest.train_on`` at
    full width, f32, one epoch of N_TRAIN / N_EVAL rows, the DP block fused
    where the class has it; its launches against ``zoo_launches``, finite
    losses, DP trained, 2-row logits card against CPU (the noise handed
    in), the best checkpoint reloaded and served through ``predict``, one
    steady-state step profiled. Then TTCA and ITCA at ``TrainAndTest()``'s
    bf16 default with the compact vocab, and one forward and backward of
    TICA_DPSGD and of the PriGumbel head. Each trainer is freed before the
    next."""
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.data.compact_vocab import remap_pairing
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.ops import dp as dp_ops
    from eeg_multimodal_torch.train import api as api_mod
    from eeg_multimodal_torch.train import metrics as M
    from eeg_multimodal_torch.train.checkpoint import load_torch_checkpoint
    from eeg_multimodal_torch.utils.trees import tree_cast, tree_items, tree_map

    root = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    checked_seqs = zoo_seq_lens(D)  # the S the attention kernels were held at

    class ZooRun(api_mod.TrainAndTest):
        """``TrainAndTest`` with the DP block fused where the class has one
        (``examples/train_demo.py --fused_dp``) and the F1 threshold below
        any F1, so that one epoch of random weights writes its best
        checkpoint (the reference starts it at 0.5, base_train.py:164)."""

        def __init__(self, fused, **kw):
            super().__init__(data_root=root, epochs=1, echo=False, **kw)
            self.fused = fused

        def run_configs(self, fusion_cfg, train_cfg):
            return (dataclasses.replace(fusion_cfg, fused_dp_kernel=self.fused and
                                        fusion_cfg.dp_mode == "lapacian_dropout"),
                    dataclasses.replace(train_cfg, f1_best_init=-1.0))

    def noise_for(cfg, rows):
        """The head's Laplace(0, 1) draw as ``dp_noise``, on the card."""
        width = {"lapacian_dropout": cfg.concat_width, "lapacian_dropout_equal_weight": 1,
                 "feature_all_lap": 1}.get(cfg.dp_mode)
        return None if width is None else torch.randn(rows, width, generator=gen, device=dev)

    def card_against_cpu(forward, params, batch, noises, where, bf16=False):
        """``forward(params, batch, *noises)`` on the card and on the CPU
        with the same params and noise (2 rows): f32 at path 1's tolerance;
        bf16 within half of bf16's own effect on the card's logits."""
        def cpu(t):
            return None if t is None else t.cpu()

        with torch.no_grad():
            p = tree_cast(params, torch.bfloat16) if bf16 else params
            on_card = forward(p, batch, *noises)
            on_cpu = forward(tree_map(cpu, p), tree_map(cpu, batch), *map(cpu, noises))
            f32_card = forward(params, batch, *noises) if bf16 else None
        check(on_card.dtype == torch.float32 and tuple(on_card.shape) == (2, 2)
              and bool(torch.isfinite(on_card).all()), f"{where}: logits not finite f32 (2, 2)")
        e = float((on_card.cpu() - on_cpu).abs().max())
        if bf16:
            effect = float((on_card - f32_card).abs().max())
            print(f"  {where}: bf16 logits max|card - cpu| {e:.3g}, bf16's own effect on the "
                  f"card {effect:.3g}")
            check(e <= 0.5 * effect, f"{where}: bf16 card and CPU differ by {e:.3g}")
        else:
            print(f"  {where}: logits max|card - cpu| {e:.3g}")
            torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-3, atol=1e-4)

    def zoo_logits(params, data, cfg, where, bf16=False):
        """``card_against_cpu`` of ``fusion.apply`` (hard, eval) on the first
        two rows of ``data``, the head's noise handed in."""
        def forward(p, batch, noise):
            return fusion.apply(p, batch, cfg, EPS, True, None, False, dp_noise=noise)

        card_against_cpu(forward, params, D.gather_batch(data, torch.arange(2, device=dev)),
                         [noise_for(cfg, 2)], where, bf16)

    def fit(name, mt, dp_mode, cross, api, **kw):
        """One train_on epoch of ``name``, the f1 threshold below any F1 so
        that fit writes its best checkpoint; returns (result, launches by
        dtype, the truncated splits)."""
        train_z, test_z = zoo_rows(D, rng, mt, N_TRAIN), zoo_rows(D, rng, mt, N_EVAL)
        write_split(root, "test", test_z)
        for k in all_kernels:
            k.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = api.train_on(train_z, test_z, "DPMLD", f"{name}/", mt, dp_mode,
                           cross_atn_type=cross, **kw)
        wall = time.perf_counter() - t0
        got = {k.name: dict(k.by_dtype) for k in all_kernels}
        row = res["history"][0]
        print(f"  train loss {row['train_loss']:.4f}, test loss {row['test_loss']:.4f}, f1 "
              f"{row['f1']:.3f}; train_on {wall:.2f} s (init, epoch, checkpoint); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches by dtype {got}")
        check(len(res["history"]) == 1 and all(math.isfinite(row[k]) for k in
                                               ("train_loss", "test_loss", "f1")),
              f"{name}: non-finite loss")
        return res, got, D.truncate_pair(train_z, test_z)

    api = ZooRun(fused=True, compute_dtype="float32")
    for name, mt, dp_mode, cross in ZOO:
        phase(f"zoo: {name} ({mt}, {dp_mode}, {cross}) through TrainAndTest.train_on, f32, "
              "one epoch" + (", fused DP" if dp_mode == "lapacian_dropout" else ""))
        fused = dp_mode == "lapacian_dropout"
        res, got, (train_z, test_z) = fit(name, mt, dp_mode, cross, api)
        seqs = [x.shape[1] for x, kind in zip((train_z.eeg_input, train_z.act_input), mt)
                if kind == "t"]
        seq = "S = " + " and ".join(map(str, seqs)) if seqs else "no text"
        print(f"  text streams after train_on's truncation: {seq}")
        check(set(seqs) <= checked_seqs,
              f"{name}: S {seqs} outside the attention checks' {sorted(checked_seqs)}")
        check(api.trainer.fusion_cfg.fused_dp_kernel == fused,
              f"{name}: the DP block is not fused as it should be")
        want = zoo_launches(mt, dp_mode, steps, layers)
        want = {k: ({"float32": n} if n else {}) for k, n in want.items()}
        check(got == want, f"{name}: launches {got}, expected {want}")
        tr = api.trainer
        check(("DP" in tr.params) == fused and (not fused or float(tr.params["DP"].abs().max()) > 0),
              f"{name}: DP missing or not trained")
        check(tr.steps.has_dp_param == fused, f"{name}: the wrong step")
        cfg = dataclasses.replace(tr.fusion_cfg, fused_dp_kernel=False)
        test_dev = test_z.to_device(dev)
        zoo_logits(tr.params, test_dev, cfg, name)
        ckpt = os.path.join(root, "models", "custom", "DPMLD", name, "best_f1.pickle")
        check(res["best"] is not None and os.path.exists(ckpt), f"{name}: no best checkpoint")
        loaded = dict(tree_items(load_torch_checkpoint(ckpt, cfg, device=dev)))
        live = dict(tree_items(tr.params))
        check(loaded.keys() == live.keys() and all(torch.equal(loaded[k], live[k]) for k in live),
              f"{name}: the checkpoint differs from the best params")
        del loaded, live
        eeg_model, eeg_coef = STREAM_MODEL[mt[0]]
        act_model, act_coef = STREAM_MODEL[mt[1]]
        for k in all_kernels:
            k.reset()
        t0 = time.perf_counter()
        res_p = api.predict(ckpt, mt, dp_mode, eeg_model, eeg_coef, act_model, act_coef, cross,
                            epsilon=EPS)
        predict_s = time.perf_counter() - t0
        got_p = {k.name: k.launches for k in all_kernels}
        want_p = {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": mt.count("t") * layers, "attn_bwd": 0}
        check(got_p == want_p, f"{name}: predict launches {got_p}, expected {want_p}")
        check(len(res_p["predictions"]) == N_EVAL and math.isfinite(res_p["loss"])
              and np.isfinite(res_p["scores"]).all(), f"{name}: predict's output")
        print(f"  best checkpoint (epoch {res['best']['epoch']}) reloads equal; predict {N_EVAL} "
              f"rows in {predict_s:.2f} s (load included): loss {res_p['loss']:.4f}, accuracy "
              f"{res_p['accuracy']:.3f}, launches {got_p}")
        os.remove(ckpt)
        step = step_fn(tr, train_z.to_device(dev))
        profile_step(torch, step, f"{name}, {seq}, f32")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the step raises
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print("  one more step under torch.cuda.set_sync_debug_mode('error'): no host sync")
        api.trainer = None
        del tr, test_dev, step
        torch.cuda.empty_cache()

    # bf16: both decoder orientations of the new streams on the card
    api16 = ZooRun(fused=False)
    check(api16.compute_dtype == "bfloat16", f"TrainAndTest defaults to {api16.compute_dtype}")
    for name, mt in (("TTCA_LapDropout", "tt"), ("ITCA_LapDropout", "it")):
        phase(f"zoo: {name} at TrainAndTest()'s bf16 default, train_on(compact_vocab=True), "
              "one epoch")
        res, got, (train_z, test_z) = fit(name + "_bf16", mt, "lapacian_dropout",
                                          "double_stream", api16, compact_vocab=True)
        want = zoo_launches(mt, "lapacian_dropout", steps, layers)
        want = {"dp_fwd": {}, "dp_bwd": {}, "attn_fwd": {"bfloat16": want["attn_fwd"]},
                "attn_bwd": {"bfloat16": want["attn_bwd"]}}
        check(got == want, f"{name} bf16: launches {got}, expected {want}")
        tr = api16.trainer
        check(tr.vocab is not None and tr.steps.compute_dtype == torch.bfloat16,
              f"{name} bf16: no compact vocab or not bf16")
        check(float(tr.params["DP"].abs().max()) > 0, f"{name} bf16: DP did not train")
        test_dev = remap_pairing(test_z, tr.vocab).to_device(dev)
        zoo_logits(tr.params, test_dev, tr.fusion_cfg, f"{name} bf16", bf16=True)
        api16.trainer = None
        del tr, test_dev
        torch.cuda.empty_cache()

    phase("zoo: one forward and backward of TICA_DPSGD and of the PriGumbel head, full "
          "width, batch 8, EEG text at S = 80")
    data = D.truncate_pair(zoo_rows(D, rng, "ti", 8), zoo_rows(D, rng, "ti", 8))[0].to_device(dev)
    weight = torch.ones(8, device=dev)
    for name, cfg, init, forward in (
            ("TICA_DPSGD", fusion.config_for("ti", "DPSGD"), fusion.init,
             lambda p, b, c, g, t: fusion.apply(p, b, c, EPS, True, g, t)),
            ("PriGumbel", fusion.config_for("ti", "NDP"), fusion.legacy_pri_gumbel_init,
             lambda p, b, c, g, t: fusion.legacy_pri_gumbel_apply(p, b, c, EPS, gen=g,
                                                                   train=t))):
        params = init(cfg, 0, dev)
        leaves = [t for _, t in tree_items(params)]
        for t in leaves:
            t.requires_grad_()
        for k in all_kernels:
            k.reset()
        logits = forward(params, data, cfg, gen, True)
        grads = torch.autograd.grad(M.cal_loss(logits, data["labels"], weight)[0], leaves)
        got = {k.name: k.launches for k in all_kernels}
        want = {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": layers, "attn_bwd": layers}
        check(got == want, f"{name}: launches {got}, expected {want}")
        check(tuple(logits.shape) == (8, 2) and bool(torch.isfinite(logits).all())
              and all(bool(torch.isfinite(g).all()) for g in grads)
              and max(float(g.abs().max()) for g in grads) > 0,
              f"{name}: logits or gradients not finite, or all zero")
        gw = dict(zip((p for p, _ in tree_items(params)), grads)).get("w")
        extra = "" if gw is None else f", |grad w| max {float(gw.abs().max()):.3g}"
        print(f"  {name}: F = {cfg.concat_width}, logits and gradients finite, launches "
              f"{got}{extra}")
        params = tree_map(torch.Tensor.detach, params)
        if name == "TICA_DPSGD":
            zoo_logits(params, data, cfg, name)
        else:
            card_against_cpu(
                lambda p, b, g, lap: fusion.legacy_pri_gumbel_apply(
                    p, b, cfg, EPS, gumbel=g, lap_noise=lap),
                params, D.gather_batch(data, torch.arange(2, device=dev)),
                [dp_ops.gumbel_noise((768, 2), gen, dev),
                 torch.randn(2, 1, generator=gen, device=dev)], name)
        del params, leaves, grads, logits
    shutil.rmtree(root)
    torch.cuda.empty_cache()


# the accountant's sigma at the smoke's privacy setup (q = 1/8, 16 steps,
# delta = 1/8, eps = 0.1), as the JAX package's accountant gives it
DPSGD_SIGMA = 1.9441650390624998


def run_dpsgd(torch, dev, rng, all_kernels, layers, steps):
    """Main path 6, DP-SGD: ``TrainAndTest(epochs=2).train_on(...,
    dp_mode="DPSGD")`` at full width (TICA_DPSGD, F = 1536, S = 80, 64 / 32
    rows, batch 8, eps 0.1) at the API's bf16 default, which DP-SGD must
    not take: sigma, q, delta, steps and window; launches (f32 only, no DP
    kernel); frozen leaves bit-equal to the init, every trainable leaf
    moved; records with sigma and delta. Then one more epoch under
    ``torch.cuda.set_sync_debug_mode("error")``; the per-example gradients
    on 4 rows (dropout off) card against CPU, and against four batch-1
    passes, and their clipped, weighted aggregate card against CPU; one
    steady-state step profiled, with the peak memory of a step."""
    import contextlib
    import io

    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.dp import dpsgd
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.train import metrics as M
    from eeg_multimodal_torch.train.api import TrainAndTest
    from eeg_multimodal_torch.train.dpsgd_trainer import DPSGDTrainer
    from eeg_multimodal_torch.utils.seeding import DEFAULT_SEED, derive_seed, generator
    from eeg_multimodal_torch.utils.trees import tree_items, tree_map

    phase("main path 6: DP-SGD, TICA_DPSGD through TrainAndTest(epochs=2).train_on("
          "dp_mode='DPSGD'), full width, S = 80, eps 0.1")
    train, test = zoo_rows(D, rng, "ti", N_TRAIN), zoo_rows(D, rng, "ti", N_EVAL)
    root = tempfile.mkdtemp(prefix="chip_smoke_dpsgd_")
    api = TrainAndTest(epochs=2, artifacts_root=root)
    check(api.compute_dtype == "bfloat16", f"TrainAndTest defaults to {api.compute_dtype}")
    for k in all_kernels:
        k.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    echo = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(echo):
        res = api.train_on(train, test, "DPMLD", "DPSGD/", "ti", "DPSGD", epsilon=EPS)
    wall = time.perf_counter() - t0
    launches = {k.name: dict(k.by_dtype) for k in all_kernels}
    tr = api.trainer
    line = [ln for ln in echo.getvalue().splitlines() if ln.startswith("DP-SGD:")]
    print(f"  {line[0] if line else 'no DP-SGD echo line'}")
    print_rows(res["history"], steps)
    print(f"  train_on {wall:.2f} s (accountant, init, 2 epochs); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches by dtype {launches}")
    check(isinstance(tr, DPSGDTrainer), "train_on did not take the DP-SGD trainer")
    check(line == [f"DP-SGD: sigma={DPSGD_SIGMA:.3f} q=0.12500 delta=0.12500 steps/epoch={steps} "
                   f"(target eps={EPS})"], f"the echo line {line}")
    check(res["sigma"] == DPSGD_SIGMA and res["delta"] == 1 / 8,
          f"sigma {res['sigma']!r}, delta {res['delta']!r}")
    q = tr.dp_cfg.batch_size / N_TRAIN
    window = dpsgd.window_size(N_TRAIN, q)
    check(q == 0.125 and window == 24, f"q {q}, window {window}")
    windows, eval_b = dpsgd_batches()  # the B the attention checks held
    check(window in windows, f"window {window} outside the attention checks' {windows}")
    check(len(res["history"]) == 2 and all(
        math.isfinite(r[k]) for r in res["history"] for k in ("train_loss", "test_loss", "f1")),
        "DP-SGD: non-finite loss")
    per_epoch = zoo_launches("ti", "DPSGD", steps, layers)
    want = {k: ({"float32": 2 * n} if n else {}) for k, n in per_epoch.items()}
    check(launches == want, f"DP-SGD launches {launches}, expected {want}")
    check(tr.eval_steps.compute_dtype == torch.float32
          and all(t.dtype == torch.float32 for _, t in tree_items(tr.params)), "not f32")
    init = dict(tree_items(fusion.init(tr.fusion_cfg, derive_seed(DEFAULT_SEED, "init"), dev)))
    n_train = 0
    for path, t in tree_items(tr.params):
        same = torch.equal(t, init[path])
        check(same != tr.trainable(path), f"{path}: {'did not move' if same else 'moved'}")
        n_train += t.numel() if tr.trainable(path) else 0
    del init
    logs = os.path.join(root, "logs", "DPMLD", "DPSGD")
    recs = [json.loads(ln) for ln in open(os.path.join(logs, "metrics.jsonl"))]
    check(len(recs) == 2 and all(r["sigma"] == DPSGD_SIGMA and r["delta"] == 1 / 8
                                 for r in recs), "the records lack sigma and delta")
    check(open(os.path.join(logs, "whole_record.txt")).read().count("Epochs:") == 2,
          "whole_record.txt does not hold two epochs")
    print(f"  {n_train} trainable parameters moved, every frozen leaf bit-equal to the init; "
          "records carry sigma and delta")

    phase("main path 6: one more DP-SGD epoch (train and eval) under "
          "torch.cuda.set_sync_debug_mode('error')")
    train_t, test_t = D.truncate_pair(train, test)
    check(train_t.eeg_input.shape[1] == 80, f"S = {train_t.eeg_input.shape[1]}, not 80")
    data, test_dev = train_t.to_device(dev), test_t.to_device(dev)
    sigma, C = res["sigma"], tr.dp_cfg.max_grad_norm
    step = dpsgd.make_dpsgd_step(tr.example_losses, tr.trainable, tr.optimizer, sigma, C,
                                 tr.dp_cfg.batch_size)
    state = [tr.optimizer.init(dpsgd.trainable_leaves(tr.params, tr.trainable))]
    gen6 = generator(derive_seed(DEFAULT_SEED, "dpsgd_epoch", 2), dev)
    eidx, ew = D.epoch_indices(N_EVAL, tr.dp_cfg.batch_size, False, device=dev)
    check(eidx.numel() == eval_b, f"the eval's {eidx.numel()} rows, not the checked {eval_b}")
    for k in all_kernels:
        k.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host sync in the epoch raises
    try:
        state[0], loss, acc = tr.train_epoch(tr.params, state[0], data, N_TRAIN, q, window,
                                             steps, step, gen6)
        te = tr.eval_steps.eval_epoch(tr.params, test_dev, eidx, ew, 0.0, None)
        row = torch.stack([loss, acc, te[0], te[1], M.f1(te[3], te[2], te[5])])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = {k.name: k.launches for k in all_kernels}
    check(got == per_epoch, f"epoch launches {got}, expected {per_epoch}")
    check(all(math.isfinite(x) for x in row.tolist()), "non-finite epoch row")
    print(f"  no host sync; row {[round(x, 4) for x in row.tolist()]}; launches {got}")

    phase("per-example gradients of the trainable subtree, 4 rows, dropout off: card "
          "(attention kernels) against the CPU (plain versions) and against four batch-1 "
          "passes")
    batch = D.gather_batch(data, torch.arange(4, device=dev))

    def losses_fn(b):
        def losses(tree):
            logits = fusion.apply(tree, b, tr.fusion_cfg, 0.0, True, None, True)
            return M.cross_entropy(logits, b["labels"])
        return losses

    paths = [p for p, _ in tree_items(tr.params) if tr.trainable(p)]
    for k in all_kernels:
        k.reset()
    card = dpsgd.per_example_grads(losses_fn(batch), tr.params, tr.trainable, 4)
    got = {k.name: k.launches for k in all_kernels}
    check(got == {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": layers, "attn_bwd": 1},
          f"per-example launches {got}: not one batched forward and one backward")
    cpu_params = tree_map(lambda t: t.cpu(), tr.params)
    cpu_batch = tree_map(lambda t: t.cpu(), batch)
    cpu = dpsgd.per_example_grads(losses_fn(cpu_batch), cpu_params, tr.trainable, 4)
    # each leaf is held to a fraction of its own largest entry, floored at
    # a fraction of the whole gradient's for the key biases, whose gradients
    # are 0 but for rounding (softmax does not move with a shift of every
    # key's score)
    scale = max(float(c.abs().max()) for c in cpu)

    def cpu_atol(c):
        return max(1e-5 * float(c.abs().max()), 1e-6 * scale)

    e_cpu, worst = 0.0, (0.0, "")
    for path, g, c in zip(paths, card, cpu):
        atol = cpu_atol(c)
        torch.testing.assert_close(g.cpu(), c, rtol=2e-3, atol=atol, msg=lambda m: f"{path}: {m}")
        e = float((g.cpu() - c).abs().max())
        e_cpu, worst = max(e_cpu, e), max(worst, (e / atol, path))
    last = f"bert/layers/{tr.fusion_cfg.bert_cfg().num_layers - 1}/attn"
    typical = {}
    for path in (f"{last}/query/kernel", f"{last}/key/kernel"):
        c = cpu[paths.index(path)]
        typical[path] = (cpu_atol(c), float(c.abs().median()))
        check(typical[path][0] < typical[path][1],
              f"{path}: atol {typical[path][0]:.3g} not below its median entry "
              f"{typical[path][1]:.3g}")
    check(bool((card[paths.index("fc1/kernel")].reshape(4, -1).abs().amax(1) > 0).all()),
          "a row without a gradient")
    e_one = 0.0
    for b in range(4):
        one = dpsgd.per_example_grads(
            losses_fn(D.gather_batch(batch, torch.tensor([b], device=dev))), tr.params,
            tr.trainable, 1)
        for path, g, o in zip(paths, card, one):
            torch.testing.assert_close(g[b:b + 1], o, rtol=1e-4, atol=1e-6 * scale,
                                       msg=lambda m: f"row {b} {path}: {m}")
            e_one = max(e_one, float((g[b:b + 1] - o).abs().max()))
    w = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
    noise = [torch.randn(g.shape[1:], generator=gen6, device=dev) for g in card]
    agg = dpsgd.noisy_aggregate(dpsgd.clip_per_example(card, C), w, sigma, C, 8, noise=noise)
    agg_cpu = dpsgd.noisy_aggregate(dpsgd.clip_per_example(cpu, C), w.cpu(), sigma, C, 8,
                                    noise=[z.cpu() for z in noise])
    # the noise dwarfs the clipped sum: hold the sum to a fraction of its own
    # largest entry
    clean = dpsgd.noisy_aggregate(dpsgd.clip_per_example(cpu, C), w.cpu(), sigma, C, 8,
                                  noise=[torch.zeros_like(z, device="cpu") for z in noise])
    agg_atol = 1e-5 * max(float(c.abs().max()) for c in clean)
    e_agg = max(float((a.cpu() - c).abs().max()) for a, c in zip(agg, agg_cpu))
    for a, c in zip(agg, agg_cpu):
        torch.testing.assert_close(a.cpu(), c, rtol=2e-3, atol=agg_atol)
    print(f"  {len(paths)} trainable leaves; max|card - cpu| {e_cpu:.3g} (rtol 2e-3, atol "
          f"1e-5 of the leaf's largest entry, at least 1e-6 of the largest entry {scale:.3g}; "
          f"the closest leaf at {worst[0]:.3g} of its atol, {worst[1]}); (atol, median "
          f"|entry|) of the last layer's query and key kernels "
          + ", ".join(f"({a:.3g}, {m:.3g})" for a, m in typical.values())
          + f"; max|batched - batch-1 pass| {e_one:.3g} (rtol 1e-4, atol 1e-6 of the largest "
          f"entry); clipped aggregate with weights [1, 1, 1, 0], the noise handed in: "
          f"max|card - cpu| {e_agg:.3g} (rtol 2e-3, atol {agg_atol:.3g}: 1e-5 of the clipped "
          f"sum's largest entry)")
    del card, cpu, cpu_params, agg, agg_cpu, clean, noise

    phase("profile: one steady-state DP-SGD step (a window of 24 rows: per-example forward, "
          "backward to the last BERT layer, clip, noise, Adam, metric forward)")

    def dp_step():
        state[0] = tr.train_epoch(tr.params, state[0], data, N_TRAIN, q, window, 1, step,
                                  gen6)[0]

    dp_step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dp_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"  peak memory of a step above the live params and moments {peak / 2**30:.3f} GiB; "
          f"the per-example gradients alone {n_train * window * 4 / 2**30:.3f} GiB "
          f"({n_train} trainable x {window} rows x 4 bytes)")
    fwd = forward_matmul_flops(window, 80, dec_layers=0, F=1536)
    last = forward_matmul_flops(window, 80, layers=1, dec_layers=0, F=1536)
    by_kernel = profile_step(torch, dp_step, "DP-SGD step, S = 80, f32", 2 * fwd + 2 * last,
                             work="2 forwards + the last layer's backward")
    if by_kernel:
        tc_us, simt_us = gemm_split(by_kernel)
        print(f"  GEMMs on the tensor cores {tc_us / 1e3:.2f} ms, on the CUDA cores "
              f"{simt_us / 1e3:.2f} ms")
    api.trainer = None
    del tr, step, state, data, test_dev
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def run_drivers(torch, dev, rng, all_kernels, layers, steps):
    """``ComparePrivateScheme(python_job=...).run()``: the four schemes
    through ``TrainAndTest.train`` from the reference's files (64 / 32 rows
    written by ``write_split``), one epoch each at the API's defaults (bf16,
    composed DP; DP-SGD in f32), each held to ``zoo_launches``; every
    scheme's whole record written; then ``run(skip_completed=True)``
    skips exactly the schemes that wrote a best record (the three of
    ``Trainer``, whose F1 threshold is set below any F1, and DP-SGD if an
    epoch beat its fixed 0.5) and trains the others again."""
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.experiments.drivers import ComparePrivateScheme
    from eeg_multimodal_torch.train.api import TrainAndTest

    phase("drivers: ComparePrivateScheme().run() through TrainAndTest.train, the four "
          "schemes, one epoch each, from the reference's files (64 / 32 rows)")
    root = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    write_split(root, "train", zoo_rows(D, rng, "ti", N_TRAIN))
    write_split(root, "test", zoo_rows(D, rng, "ti", N_EVAL))

    class DriverJob(TrainAndTest):
        """``TrainAndTest`` that counts each scheme's launches, with
        ``Trainer``'s F1 threshold below any F1, so that its runs write
        their best records (DP-SGD's threshold is not a setting)."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.launches = {}

        def run_configs(self, fusion_cfg, train_cfg):
            return fusion_cfg, dataclasses.replace(train_cfg, f1_best_init=-1.0)

        def train(self, **cfg):
            for k in all_kernels:
                k.reset()
            t0 = time.perf_counter()
            out = super().train(**cfg)
            self.launches[cfg["dp_mode"]] = ({k.name: dict(k.by_dtype) for k in all_kernels},
                                             time.perf_counter() - t0)
            return out

    job = DriverJob(epochs=1, data_root=root, echo=False)
    driver = ComparePrivateScheme(python_job=job)
    res = driver.run()
    for cfg in driver.configs():
        scheme = cfg["dp_mode"]
        got, wall = job.launches[scheme]
        dtype = "float32" if scheme == "DPSGD" else "bfloat16"
        want = {k: ({dtype: n} if n and k.startswith("attn") else {})
                for k, n in zoo_launches("ti", scheme, steps, layers).items()}
        row = res[cfg["path_suffix"]]["history"][0]
        print(f"  {scheme}: train loss {row['train_loss']:.4f}, test loss "
              f"{row['test_loss']:.4f}, f1 {row['f1']:.3f}; train {wall:.2f} s; launches {got}")
        check(got == want, f"{scheme}: launches {got}, expected {want}")
        check(all(math.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1")),
              f"{scheme}: non-finite loss")
        check(os.path.exists(os.path.join(root, "logs", "compare_private_scheme", scheme,
                                          "whole_record.txt")), f"{scheme}: no whole record")
    done = {c["path_suffix"] for c in driver.configs() if os.path.exists(
        os.path.join(root, "logs", "compare_private_scheme", c["path_suffix"], "best_record.txt"))}
    check({"lapacian_dropout/", "lapacian_dropout_equal_weight/", "NDP/"} <= done,
          f"best records only for {sorted(done)}")
    again = driver.run(skip_completed=True)
    skipped = {k for k, v in again.items() if v == "skipped (completed)"}
    check(skipped == done and all(isinstance(again[k], dict) for k in set(again) - done),
          f"skip_completed: {again}, with best records for {sorted(done)}")
    print(f"  every scheme wrote its records; run(skip_completed=True) skipped the "
          f"{len(done)} with a best record ({sorted(done)}) and trained the others again")
    job.trainer = None
    shutil.rmtree(root)
    torch.cuda.empty_cache()


# f32 member step against single-member steps: cuBLAS's batched and single
# GEMMs sum in other orders (the attention kernels and the DP block are bit
# for bit per member), the tolerance of the CPU parity tests
MEMBER_TOL = dict(rtol=1e-4, atol=1e-5)


def launches_by_name(all_kernels):
    return {k.name: k.launches for k in all_kernels}


def check_launches(got, want, where):
    print(f"  {where}: launches {got}, predicted from the code {want}")
    check(got == want, f"{where}: launches {got}, expected {want}")


def run_sweep(torch, dev, rng, all_kernels, layers, steps):
    """Main path 7, the batched sweep: ``SweepRunner`` over
    ``privacy_utility_frontier()`` (5 members, epsilon 0.1 to 10), the
    flagship with the fused DP block in f32, two epochs at 64 / 32 rows, held
    to path 1's launches (one set of launches a step, whatever M) and its
    records; one more epoch under ``torch.cuda.set_sync_debug_mode("error")``
    (the (M, 5) row fetched after it); one member step against five
    single-member steps from the same weights, the noise handed in and
    dropout off (``MEMBER_TOL``); the member step profiled in turns against
    five single-member steps, with the peak memory each adds; then the
    bench configuration as a 5-member sweep for one epoch. Returns the
    launches of the f32 sweep."""
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.data.compact_vocab import build_compact_vocab, remap_pairing
    from eeg_multimodal_torch.models import bert as bert_mod
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.train.records import parse_legacy_records
    from eeg_multimodal_torch.train.sweep import MemberSteps, SweepRunner, privacy_utility_frontier
    from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig
    from eeg_multimodal_torch.utils.trees import tree_items, tree_map

    members = privacy_utility_frontier()
    M = len(members)
    phase(f"main path 7: SweepRunner over privacy_utility_frontier() ({M} members, epsilon "
          "0.1 to 10), TICA_LapDropout fused DP, f32, S = 80, two epochs of 64 / 32 rows")
    train, test = D.truncate_pair(synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL))
    fc = dataclasses.replace(fusion.config_for("ti", "lapacian_dropout"), fused_dp_kernel=True)
    tc = TrainConfig(epochs=2, f1_best_init=-1.0)  # every member writes a best record
    root = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    runner = SweepRunner(fc, tc, members)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in all_kernels:
        k.reset()
    t0 = time.perf_counter()
    res = runner.run(train, test, log_root=root, echo=True)
    wall = time.perf_counter() - t0
    launches = launches_by_name(all_kernels)
    print(f"  {wall:.2f} s for both epochs (init included); peak memory "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB")
    for r in res:
        print(f"  {r['member']['epsilon']:>5}: " + "; ".join(
            f"epoch {h['epoch']} train loss {h['train_loss']:.4f} test loss {h['test_loss']:.4f} "
            f"f1 {h['f1']:.3f}" for h in r["history"]))
    check_launches(launches, {"dp_fwd": 2 * (2 * steps + 1), "dp_bwd": 2 * 2 * steps,
                              "attn_fwd": layers * (2 * steps + 1) * 2,
                              "attn_bwd": layers * steps * 2}, f"{M}-member sweep, 2 epochs")
    check(all(set(k.by_dtype) == {"float32"} for k in all_kernels if k.launches),
          "the f32 sweep launched another instantiation")
    for r, m in zip(res, members):
        check(len(r["history"]) == 2 and all(math.isfinite(h[k]) for h in r["history"]
                                             for k in ROW), f"{m.name}: rows {r['history']}")
        logs = os.path.join(root, m.name)
        recs = parse_legacy_records(open(os.path.join(logs, "whole_record.txt")).read())
        check([x["epoch"] for x in recs] == [1, 2], f"{m.name}: whole_record.txt {recs}")
        jsonl = [json.loads(x) for x in open(os.path.join(logs, "metrics.jsonl"))]
        check([(x["epsilon"], x["seed"]) for x in jsonl] == [(m.epsilon, m.seed)] * 2,
              f"{m.name}: metrics.jsonl {jsonl}")
        check(os.path.exists(os.path.join(logs, "best_record.txt")), f"{m.name}: no best record")
    check(len({r["history"][-1]["train_loss"] for r in res}) == M, "the members trained alike")
    print(f"  records under <log_root>/{members[0].name}/ ... for every member")
    shutil.rmtree(root)

    phase("main path 7: one more sweep epoch under torch.cuda.set_sync_debug_mode('error'), "
          "the (M, 5) row fetched after it")
    steps_m, params, dp_os, model_os = runner.init_members(members)
    eps_t = torch.tensor([m.epsilon for m in members], dtype=torch.float64, device=dev)
    train_dev, test_dev = train.to_device(dev), test.to_device(dev)
    inputs = runner.epoch_inputs(members, 0, N_TRAIN, N_EVAL)
    for k in all_kernels:
        k.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside the epoch raises
    try:
        dp_os, model_os, rows = steps_m.epoch(params, dp_os, model_os, train_dev, test_dev,
                                              *inputs, eps_t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rows = rows.tolist()
    check(len(rows) == M and all(math.isfinite(x) for r in rows for x in r), f"rows {rows}")
    check_launches(launches_by_name(all_kernels),
                   {"dp_fwd": 2 * steps + 1, "dp_bwd": 2 * steps,
                    "attn_fwd": layers * (2 * steps + 1), "attn_bwd": layers * steps},
                   "one sweep epoch with no host sync")

    phase(f"main path 7: a {M}-member step against {M} single-member steps from the same "
          "weights, the noise handed in, dropout off (composed DP block)")
    fc_c = dataclasses.replace(fc, fused_dp_kernel=False)
    B, F = tc.batch_size, fc.concat_width
    batch = D.gather_batch(train_dev, torch.arange(B, device=dev))
    w = torch.ones(B, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    noise = tuple(torch.randn(M * B, F, generator=gen, device=dev) for _ in range(2))
    ms = MemberSteps(fc_c, tc, M, dev)
    p_m = tree_map(torch.clone, params)
    with torch.no_grad():
        logits_m = ms.forward(p_m, batch, eps_t, True, None, False, noise[1])
    states = ms.init_opt_states(p_m)
    unused = torch.Generator(device=dev)  # nothing is drawn: noise handed in, dropout off
    loss_m = ms.train_step(p_m, *states, batch, w, eps_t, (unused,) * M, dp_noise=noise,
                           dropout=False)[2]
    ss = StepFunctions(fc_c, tc, dev)
    worst = {"logits": 0.0, "loss": 0.0, "params": 0.0}
    for m in range(M):
        r = slice(m * B, (m + 1) * B)
        p1 = tree_map(lambda t: t[m].clone(), params)
        with torch.no_grad():
            logits_1 = ss.forward(p1, batch, members[m].epsilon, True, None, False, noise[1][r])
        loss_1 = ss.train_step(p1, *ss.init_opt_states(p1), batch, w, members[m].epsilon,
                               unused, dp_noise=(noise[0][r], noise[1][r]), dropout=False)[2]
        torch.testing.assert_close(logits_m[r], logits_1, **MEMBER_TOL)
        torch.testing.assert_close(loss_m[m], loss_1, **MEMBER_TOL)
        worst["logits"] = max(worst["logits"], float((logits_m[r] - logits_1).abs().max()))
        worst["loss"] = max(worst["loss"], float((loss_m[m] - loss_1).abs()))
        for (path, a), (_, b) in zip(tree_items(p_m), tree_items(p1)):
            torch.testing.assert_close(a[m], b, **MEMBER_TOL, msg=lambda e: f"{path}: {e}")
            worst["params"] = max(worst["params"], float((a[m] - b).abs().max()))
        del p1
    print(f"  per member, max |member - single|: logits {worst['logits']:.3g}, loss "
          f"{worst['loss']:.3g}, updated params {worst['params']:.3g} (tolerance {MEMBER_TOL})")
    del p_m, ms, states

    phase(f"profile: the {M}-member step against {M} single-member steps, in turns "
          "(fused DP, f32, S = 80)")
    gens = tuple(torch.Generator(device=dev).manual_seed(40 + m) for m in range(M))
    member_states = [dp_os, model_os]

    def member_step():
        member_states[:] = steps_m.train_step(params, *member_states, batch, w, eps_t, gens)[:2]

    single_steps = StepFunctions(fc, tc, dev)
    singles = []
    for m in range(M):
        p1 = tree_map(lambda t: t[m].clone(), params)
        singles.append([p1, *single_steps.init_opt_states(p1)])

    def single_member_steps():
        for (p1, *st), g, mem in zip(singles, gens, members):
            st[:] = single_steps.train_step(p1, *st, batch, w, mem.epsilon, g)[:2]

    for label, fn in (("members", member_step), ("singles", single_member_steps),
                      ("singles", single_member_steps), ("members", member_step)):
        profile_step(torch, fn, f"{M} members as one step" if label == "members"
                     else f"{M} single-member steps")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        print(f"  peak memory above the params and Adam states: "
              f"{(torch.cuda.max_memory_allocated() - before) / 2**30:.2f} GiB "
              f"({(torch.cuda.max_memory_allocated() - before) / 2**30 / M:.2f} GiB a member)")
    del singles, params, steps_m, member_states, dp_os, model_os
    torch.cuda.empty_cache()

    phase(f"main path 7: bench.py's configuration as a {M}-member sweep (bf16 compute and "
          "Adam moments, precast_params, compact vocab, composed DP), one epoch")
    train_b, test_b = D.truncate_pair(synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL))
    vocab = build_compact_vocab([train_b.eeg_input, test_b.eeg_input])
    train_b, test_b = remap_pairing(train_b, vocab), remap_pairing(test_b, vocab)
    fc_b = dataclasses.replace(fusion.config_for("ti", "lapacian_dropout"),
                               bert_config=bert_mod.BertConfig(vocab_size=vocab.size))
    tc_b = TrainConfig(compute_dtype="bfloat16", adam_mu_dtype="bfloat16",
                       adam_nu_dtype="bfloat16", precast_params=True, epochs=1)
    for k in all_kernels:
        k.reset()
    t0 = time.perf_counter()
    res_b = SweepRunner(fc_b, tc_b, members).run(train_b, test_b, echo=True)
    got = {k.name: dict(k.by_dtype) for k in all_kernels}
    print(f"  {time.perf_counter() - t0:.2f} s (init included); compact vocab {vocab.size} rows")
    want = {"dp_fwd": {}, "dp_bwd": {}, "attn_fwd": {"bfloat16": layers * (2 * steps + 1)},
            "attn_bwd": {"bfloat16": layers * steps}}
    check_launches(got, want, "bf16 bench configuration sweep, 1 epoch")
    check(all(math.isfinite(r["history"][0][k]) for r in res_b for k in ROW),
          "bf16 sweep: non-finite row")
    torch.cuda.empty_cache()
    return launches


def run_legacy(torch, dev, rng, all_kernels, layers, steps):
    """The legacy drivers, each at full width, S = 80, 64 / 32 rows, one
    epoch, its launches held to those predicted from the code:
    ``EpsExperiment.run_all_vmapped`` (20 members in two chunks of 10,
    records under <out_root>/<eps>/), ``extract_feawei`` then
    ``dp_inits.feawei`` then ``run_index(i, dp_init=...)``,
    ``MetricTrainer.fit`` (n_para = 2, n_eval = 5, three metrics, writing
    results.pkl and model.pth), ``PriGumbelPretrainer.pretrain`` and
    ``AlphaSweep.run`` over two alphas."""
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.experiments.legacy_drivers import (AlphaSweep, EpsExperiment,
                                                                 eps_experiment_epsilons,
                                                                 extract_feawei)
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.ops import dp_inits
    from eeg_multimodal_torch.train.legacy import (MetricTrainConfig, MetricTrainer,
                                                   PriGumbelConfig, PriGumbelPretrainer)
    from eeg_multimodal_torch.train.trainer import TrainConfig

    train, test = D.truncate_pair(synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL))
    root = tempfile.mkdtemp(prefix="chip_smoke_legacy_")
    eval_batches = -(-N_EVAL // 8)
    no_dp = {"dp_fwd": 0, "dp_bwd": 0}

    def counted(fn):
        for k in all_kernels:
            k.reset()
        t0 = time.perf_counter()
        out = fn()
        print(f"  {time.perf_counter() - t0:.2f} s")
        return out, launches_by_name(all_kernels)

    phase("legacy drivers: EpsExperiment.run_all_vmapped, 20 members in two chunks of 10, one "
          "epoch, f32, composed DP")
    out_root = os.path.join(root, "eps_experiment")
    exp = EpsExperiment(train_cfg=TrainConfig(epochs=1, f1_best_init=-1.0), out_root=out_root)
    res, got = counted(lambda: exp.run_all_vmapped(train, test))
    check_launches(got, {**no_dp, "attn_fwd": 2 * layers * (2 * steps + 1),
                         "attn_bwd": 2 * layers * steps}, "run_all_vmapped, 2 chunks")
    epsilons = eps_experiment_epsilons()
    check([r["member"]["label"] for r in res] == [str(e) for e in epsilons], "member labels")
    check(all(math.isfinite(r["history"][0][k]) for r in res for k in ROW), "non-finite rows")
    check(all(os.path.exists(os.path.join(out_root, str(e), "whole_record.txt"))
              for e in epsilons), "a member wrote no records under <out_root>/<eps>/")
    print(f"  20 members' records under <out_root>/<eps>/; test acc "
          + " ".join(f"{r['history'][0]['test_acc']:.3f}" for r in res))

    phase("legacy drivers: extract_feawei, dp_inits.feawei, EpsExperiment.run_index(5, "
          "dp_init=...), one epoch")
    fc = exp.fusion_cfg
    params = fusion.init(fc, 1, dev)
    feats, got = counted(lambda: extract_feawei(params, fc, train,
                                                out_path=os.path.join(root, "feawei.pkl")))
    check_launches(got, {**no_dp, "attn_fwd": layers * -(-N_TRAIN // 8), "attn_bwd": 0},
                   "extract_feawei")
    check(feats.shape == (N_TRAIN, fc.concat_width) and np.isfinite(feats).all()
          and feats.min() >= 0.0 and feats.max() <= 1.0, f"features {feats.shape}")
    init = dp_inits.feawei(feats)
    check(init.shape == (1, fc.concat_width) and bool(torch.isfinite(init).all()), "feawei init")
    out, got = counted(lambda: exp.run_index(5, train, test, dp_init=init))
    check_launches(got, {**no_dp, "attn_fwd": layers * (2 * steps + 1),
                         "attn_bwd": layers * steps}, "run_index")
    eps5 = os.path.join(out_root, str(float(epsilons[5])))
    check(os.path.exists(os.path.join(eps5, "best_f1.pickle")), "run_index wrote no checkpoint")
    print(f"  features {feats.shape}, DP init in [{float(init.min()):.3f}, "
          f"{float(init.max()):.3f}]; run_index f1 {out['history'][0]['f1']:.3f}")
    del params

    phase("legacy: MetricTrainer.fit, n_para = 2, n_eval = 5, Accuracy,F1Score,AUROC, "
          "one epoch")
    cfg = MetricTrainConfig(n_para=2, n_eval=5, n_epochs=1, metrics="Accuracy,F1Score,AUROC")
    base = os.path.join(root, "metric")
    out, got = counted(lambda: MetricTrainer(fc, cfg).fit(train, test, base_path=base,
                                                         echo=False))
    check_launches(got, {**no_dp, "attn_fwd": layers * (2 * steps + 1),
                         "attn_bwd": layers * 2 * steps}, "MetricTrainer.fit")
    with open(os.path.join(base, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    check(sorted(results) == sorted(["train_loss", "logits", "pred", "val_loss", "DP_params",
                                     "Accuracy", "F1Score", "AUROC"]), f"keys {sorted(results)}")
    check(results["pred"][0].shape == (N_EVAL, 5), f"pred {results['pred'][0].shape}")
    check(os.path.exists(os.path.join(base, "model.pth")) == (out["best_acc"] > 0),
          "model.pth and the best accuracy disagree")
    print("  results.pkl: " + ", ".join(f"{k} {np.asarray(results[k][0]).mean():.3f}"
                                        for k in ("Accuracy", "F1Score", "AUROC"))
          + f"; model.pth written: {out['best_acc'] > 0}")

    phase("legacy: PriGumbelPretrainer.pretrain and AlphaSweep.run(alphas=[0.1, 1.0]), one "
          "epoch each")
    pg_fc = fusion.config_for("ti", "NDP")
    per_run = {**no_dp, "attn_fwd": layers * (steps + eval_batches), "attn_bwd": layers * steps}
    path = os.path.join(root, "pri_gumbel")
    out, got = counted(lambda: PriGumbelPretrainer(pg_fc, PriGumbelConfig(epochs=1)).pretrain(
        train, test, path=path, echo=False))
    check_launches(got, per_run, "PriGumbelPretrainer.pretrain")
    with open(os.path.join(path, "result.pkl"), "rb") as f:
        curves = pickle.load(f)
    check(len(curves) == 7 and all(len(v) == 1 for v in curves.values()), f"curves {curves}")
    print(f"  privacy budget max {curves['privacy_budget_max'][0]:.4f}, mean "
          f"{curves['privacy_budget_avg'][0]:.4f}; f1 {curves['f1'][0]:.3f}")
    sweep = AlphaSweep(pg_fc, out_root=os.path.join(root, "alpha"))
    sweep.base_cfg = dataclasses.replace(sweep.base_cfg, epochs=1)
    out, got = counted(lambda: sweep.run(train, test, alphas=[0.1, 1.0]))
    check_launches(got, {k: 2 * v for k, v in per_run.items()}, "AlphaSweep, two alphas")
    check(sorted(os.listdir(os.path.join(root, "alpha"))) == ["0.1000", "1.0000"],
          "AlphaSweep's directories")
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def run_embedding(torch, dev, all_kernels, layers):
    """Main path 8, raw rows to a trained model, at full width: raw task
    txt files of ``RAW_ROWS`` rows made with numpy (integer features, binary
    labels, EEG values whose text stays within BERT's 80-token cut) through
    ``process``; ``GetEmbedding(["act", "EEG"], ["train", "test"]).run``
    with CLIP ViT-B/32 and ResNet-34 at 224 x 224 and the uncased
    (recovered) and cased (synthetic) tokenizers, its ``attn_fwd`` launches
    held to 12 per chunk of 16 rows and no other kernel, images/s per tower,
    every token row of the C++ engine against the Python engine; ViT-B/16
    on the test split; both towers card against CPU on 4 images and against
    the written features; a ViT-B/32 chunk profiled; then one epoch of the
    flagship (f32, fused DP) through ``TrainAndTest.train`` from the tree
    written, held to its launches. Returns the embed's ``attn_fwd``
    launches by tower."""
    from eeg_multimodal_torch import native
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.data import image_transform as IT
    from eeg_multimodal_torch.data import process
    from eeg_multimodal_torch.data.embedding import (ENCODE_BATCH, INIT_SEED, GetEmbedding,
                                                     standardize_coef)
    from eeg_multimodal_torch.data.tokenizer import MAX_LEN, serialize_row
    from eeg_multimodal_torch.models import resnet, vit
    from eeg_multimodal_torch.ops import attention as A
    from eeg_multimodal_torch.train.api import TrainAndTest
    from eeg_multimodal_torch.utils.trees import tree_map

    phase("main path 8: raw rows -> process -> GetEmbedding (CLIP ViT-B/32, ResNet-34, "
          "WordPiece) -> TrainAndTest, full width")
    check(native.available(), f"the native WordPiece is not available: {native.build_error()}")
    root = tempfile.mkdtemp(prefix="chip_smoke_embed_")
    os.makedirs(os.path.join(root, "raw"))
    rng = np.random.RandomState(8)
    raws = []
    for i, n in enumerate(RAW_ROWS):  # time, 25 motion channels, 30 EEG channels, a label
        data = np.concatenate([np.arange(n)[:, None], rng.randint(-2048, 2048, (n, 25)),
                               rng.randint(-300, 300, (n, 30)), rng.randint(0, 2, (n, 1))],
                              axis=1)
        raws.append(os.path.join(root, "raw", f"task_{i + 1}.txt"))
        np.savetxt(raws[-1], data, fmt="%.1f")
    processed = os.path.join(root, "data", "processed")
    t0 = time.perf_counter()
    process.process(raws, processed)
    n_rows = {s: len(D.load_label_csv(os.path.join(processed, f"{s}_label.csv")))
              for s in ("train", "test")}
    print(f"  process: {sum(RAW_ROWS)} raw rows in {len(raws)} task files, "
          f"{time.perf_counter() - t0:.2f} s -> {sorted(os.listdir(processed))}; rows {n_rows}")
    check(n_rows == {"train": 2402, "test": 601}, f"the split {n_rows}")

    def csv(split, modal):
        return os.path.join(processed, f"{split}_{modal}.csv")

    def timed_towers(job):
        """Time each of ``job``'s img_encode calls (each ends in its one
        device-to-host copy) and count its attn_fwd launches."""
        calls = []
        real = job.img_encode

        def img_encode(path, modal, model, coef):
            before = A.attn_fwd.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(path, modal, model, coef)
            calls.append((modal, os.path.basename(path).split("_")[0], coef, len(out),
                          time.perf_counter() - t, A.attn_fwd.launches - before))
            return out

        job.img_encode = img_encode
        return calls

    def report(calls, cfg):
        for modal, split, coef, n, sec, attn in calls:
            print(f"  {modal} {split} {coef}: {n} images in {sec:.3f} s = {n / sec:.1f} images/s; "
                  f"attn_fwd {attn}")
            want = cfg.layers * -(-n // ENCODE_BATCH) if coef.startswith("ViT") else 0
            check(attn == want, f"{modal} {split} {coef}: attn_fwd {attn}, expected {want}")

    img = [["clip", "ViT-B/32"], ["resnet", "resnet34"]]
    txt = [["bert", "bert-base-uncased"], ["bert", "bert-base-cased"]]
    cfg32, cfg16 = vit.ViTConfig.for_coef("ViT-B/32"), vit.ViTConfig.for_coef("ViT-B/16")
    check((cfg32.seq_len, cfg16.seq_len, cfg32.width, cfg32.heads) == (50, 197, 768, 12),
          "the towers' widths")
    job = GetEmbedding(["act", "EEG"], ["train", "test"], data_root=root)
    calls = timed_towers(job)
    for k in all_kernels:
        k.reset()
    t0 = time.perf_counter()
    job.run(img, txt)
    got = launches_by_name(all_kernels)
    chunks = {s: -(-n // ENCODE_BATCH) for s, n in n_rows.items()}
    embed = {"vit_b32": 2 * cfg32.layers * sum(chunks.values())}
    print(f"  GetEmbedding.run: {time.perf_counter() - t0:.2f} s (the first call of each tower "
          "includes its random init on the CPU)")
    report(calls, cfg32)
    check_launches(got, {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": embed["vit_b32"], "attn_bwd": 0},
                   "GetEmbedding.run, ViT-B/32 and ResNet-34 over both modals and splits")
    check(embed["vit_b32"] == 4536 and A.attn_fwd.by_dtype == {"float32": 4536},
          f"attn_fwd {A.attn_fwd.by_dtype}, not 4536 f32")

    job16 = GetEmbedding(["act", "EEG"], ["test"], data_root=root)
    calls16 = timed_towers(job16)
    for k in all_kernels:
        k.reset()
    job16.run([["clip", "ViT-B/16"]], [])
    embed["vit_b16"] = 2 * cfg16.layers * chunks["test"]
    report(calls16, cfg16)
    check_launches(launches_by_name(all_kernels), {"dp_fwd": 0, "dp_bwd": 0,
                                                   "attn_fwd": embed["vit_b16"], "attn_bwd": 0},
                   "GetEmbedding.run, ViT-B/16 over both modals' test split")

    base = os.path.join(root, "data", "embedding")
    written = sorted(os.path.relpath(os.path.join(d, f), base)
                     for d, _, files in os.walk(base) for f in files)
    check(len(written) == 2 * (2 * 2 + 2 * 2) + 2, f"{len(written)} files written")
    feats = {}
    for rel in written:
        with open(os.path.join(base, rel), "rb") as f:
            obj = pickle.load(f)
        n = n_rows[os.path.basename(rel).split(".")[0]]
        if "/img/" in rel:
            check(type(obj) is np.ndarray and obj.dtype == np.float32 and obj.shape == (n, 512)
                  and np.isfinite(obj).all(), f"{rel}: {type(obj)} {getattr(obj, 'shape', '')}")
            feats[rel] = obj
            print(f"  wrote {rel}: {obj.shape} float32, |x| max {np.abs(obj).max():.4g}")
        else:
            check(len(obj) == n and all(
                sorted(e) == ["attention_mask", "input_ids"] and all(
                    type(a) is np.ndarray and a.dtype == np.int32 and a.shape == (MAX_LEN,)
                    for a in e.values()) for e in obj), f"{rel}: not {n} int32 token rows")
            print(f"  wrote {rel}: {n} rows of int32 (512,) input_ids and attention_mask")

    t0 = time.perf_counter()
    longest, rows_checked = {}, 0
    for modal in ("act", "EEG"):
        for split in n_rows:
            texts = [serialize_row(int(v) for v in row) for row in D.load_feature_csv(csv(split,
                                                                                        modal))]
            for model, coef in txt:
                path = os.path.join(base, modal, "txt", f"{model}_{standardize_coef(coef)}",
                                    f"{split}.pickle")
                tok = D.load_bert_pickle(path)
                py_ids, py_mask = job.tokenizer_for_coef(coef).encode_batch(texts, MAX_LEN)
                check(np.array_equal(tok["input_ids"], py_ids)
                      and np.array_equal(tok["attention_mask"], py_mask),
                      f"{modal} {split} {coef}: the native engine's tokens differ from Python's")
                rows_checked += len(texts)
                key = (modal, coef)
                longest[key] = max(longest.get(key, 0), int(py_mask.sum(1).max()))
    print(f"  the C++ WordPiece's ids and masks equal the Python engine's on all "
          f"{rows_checked} rows ({time.perf_counter() - t0:.2f} s for the Python engine); "
          f"longest texts {longest}")
    check(64 < longest[("EEG", "bert-base-uncased")] <= 80,
          "the EEG text does not cut to BERT's S = 80")

    phase("reference check: CLIP ViT-B/32 and ResNet-34 on 4 images, card against CPU and "
          "against the written features")
    rows = {m: D.load_feature_csv(csv("test", m))[:2] for m in ("act", "EEG")}
    imgs = torch.cat([IT.act_to_images(torch.from_numpy(rows["act"])),
                      IT.eeg_to_images(torch.from_numpy(rows["EEG"]))])
    on_card = torch.cat([IT.act_to_images(torch.from_numpy(rows["act"]).to(dev)),
                         IT.eeg_to_images(torch.from_numpy(rows["EEG"]).to(dev))]).cpu()
    check(torch.equal(on_card[:2], imgs[:2]), "the act images differ between card and CPU")
    torch.testing.assert_close(on_card[2:], imgs[2:], rtol=1e-5, atol=1e-6)
    towers = (("ViT-B/32", "clip_ViT_B_32", cfg32.layers,
               lambda p, x: vit.encode_image(p, x, cfg32),
               vit.init(torch.Generator().manual_seed(INIT_SEED), cfg32, "cpu")),
              ("ResNet-34", "resnet_resnet34", 0, resnet.features,
               resnet.init(torch.Generator().manual_seed(INIT_SEED), "cpu")))
    cpu_vit = towers[0][4]
    for name, sub, attn, fn, params in towers:
        before = A.attn_fwd.launches
        with torch.inference_mode():
            card = fn(tree_map(lambda t: t.to(dev), params), imgs.to(dev)).cpu()
            cpu = fn(params, imgs)
        check(A.attn_fwd.launches - before == attn, f"{name}: attn_fwd launched "
                                                    f"{A.attn_fwd.launches - before} times")
        wrote = torch.from_numpy(np.concatenate([feats[f"{m}/img/{sub}/test.pickle"][:2]
                                                 for m in ("act", "EEG")]))
        torch.testing.assert_close(card, cpu, **EMBED_TOL)
        torch.testing.assert_close(wrote, cpu, **EMBED_TOL)
        print(f"  {name}: (4, 512) max|card - cpu| {float((card - cpu).abs().max()):.3g}, "
              f"max|written - cpu| {float((wrote - cpu).abs().max()):.3g} (|cpu| max "
              f"{float(cpu.abs().max()):.4g}); attn_fwd {attn}")
    del towers

    phase("profile: one ViT-B/32 chunk of 16 act rows (images and tower; device time by kind, "
          "host launches)")
    p32 = tree_map(lambda t: t.to(dev), cpu_vit)
    chunk = torch.from_numpy(D.load_feature_csv(csv("train", "act"))[:ENCODE_BATCH]).to(dev)

    def encode():
        with torch.inference_mode():
            return vit.encode_image(p32, IT.act_to_images(chunk), cfg32)

    ev_ms = time_ms(torch, encode, 20, 5)
    host = {}
    by_kernel = device_us(torch, encode, n=20, host=host)
    total = sum(by_kernel.values())
    kinds = {"GEMMs": sum(v for k, v in by_kernel.items() if GEMM.search(k)),
             "attention": sum(v for k, v in by_kernel.items() if "attn_" in k),
             "layer norms": sum(v for k, v in by_kernel.items() if "layer_norm" in k)}
    kinds["the rest"] = total - sum(kinds.values())
    launched = sum(c for k, (c, _) in host.items() if LAUNCH_API.match(k))
    print(f"  {ev_ms:.3f} ms a chunk (CUDA events) = {ENCODE_BATCH / ev_ms * 1e3:.1f} images/s; "
          f"device {total:.1f} us: " + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items())
          + f"; idle share {max(0.0, 1 - total / (ev_ms * 1e3)):.3f}; {launched:.0f} host "
          "kernel launches a chunk; top kernels (us):")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us:9.1f}  {name[:90]}")
    del p32, cpu_vit, job, job16

    phase("main path 8: TrainAndTest(data_root=<the tree>, epochs=1).train(ti, "
          "lapacian_dropout, bert-base-uncased, clip ViT-B/32), f32, fused DP, 2402 / 601 rows")

    class FusedDP(TrainAndTest):
        def run_configs(self, fusion_cfg, train_cfg):
            return dataclasses.replace(fusion_cfg, fused_dp_kernel=True), train_cfg

    api = FusedDP(compute_dtype="float32", data_root=root, epochs=1, echo=False)
    for k in all_kernels:
        k.reset()
    t0 = time.perf_counter()
    res = api.train("DPMLD", "embed/", "ti", "lapacian_dropout", "bert", "bert-base-uncased",
                    "clip", "ViT-B/32", "double_stream", EPS)
    sec = time.perf_counter() - t0
    steps = -(-n_rows["train"] // api.batch_size)
    got = launches_by_name(all_kernels)
    print_rows(res["history"], steps)
    print(f"  {sec:.2f} s for the call (loading and init included), {steps} steps")
    check_launches(got, {"dp_fwd": 2 * steps + 1, "dp_bwd": 2 * steps,
                         "attn_fwd": layers * (2 * steps + 1), "attn_bwd": layers * steps},
                   "one epoch from the written tree")
    check(all(set(k.by_dtype) == {"float32"} for k in all_kernels), "not all f32 launches")
    row = res["history"][0]
    check(all(math.isfinite(row[k]) for k in ROW) and 0.0 <= row["f1"] <= 1.0, f"row {row}")
    check(float(api.trainer.params["DP"].abs().max()) > 0, "DP did not train")
    del api
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return embed


def time_vit_attention(torch, A, gen, dev, embed, vit_err):
    """The attention forward at the ViT's full batches, S = 50 and 197 (f32,
    zero bias, p = 0): CUDA-event and device times against the bound,
    ``attention_plain`` and SDPA; rows of the kernels line."""
    import torch.nn.functional as TF

    rows = []
    for name, shape, launches in (("attn_fwd_vit_b32", (16, 12, 50, 64), embed["vit_b32"]),
                                  ("attn_fwd_vit_b16", (16, 12, 197, 64), embed["vit_b16"])):
        B, H, S, D = shape
        q, k, v = vit_qkv(torch, gen, dev, B, H, S, D)
        bias = torch.zeros(B, S, device=dev)
        seed = torch.zeros(1, dtype=torch.int64, device=dev)

        def kern():
            return A.attn_fwd(q, k, v, bias, seed, 0.0)

        def plain():
            return A.attention_plain(q, k, v, bias)

        def sdpa():
            return TF.scaled_dot_product_attention(q, k, v, attn_mask=bias[:, None, None, :])

        t = {"kernel": time_ms(torch, kern, 50, 5), "plain": time_ms(torch, plain, 50, 5),
             "sdpa": time_ms(torch, sdpa, 50, 5)}
        dev_t = {"kernel": sum(device_us(torch, kern, 10).values()),
                 "sdpa": sum(device_us(torch, sdpa, 10).values())}
        bms, by = attn_bound_ms("attn_fwd", B, H, S, D, 4)
        print(f"  {shape}: " + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in t.items())
              + f" (CUDA events); device time kernel {dev_t['kernel']:.1f} us, SDPA "
              f"{dev_t['sdpa']:.1f} us; bound (3xTF32) {bms * 1e3:.2f} us ({by})")
        rows.append({
            "name": name, "route": ROUTES["attn_fwd"], "source": SOURCES["attn_fwd"],
            "replaces": REPLACES["attn_fwd"], "launches": launches,
            "max_abs_err": vit_err[shape], "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": bms, "bound_by": by, "library_ms": t["sdpa"],
        })
    return rows


# cuBLAS's kernel names: nvjet_* are its Hopper tensor-core (wgmma) GEMMs;
# *_simt_sgemm_*, *_f32f32_*_ffma_*, gemv and gemmSN its CUDA-core ones
GEMM = re.compile(r"gemm|gemv|xmma|cutlass|nvjet", re.I)
TENSOR_CORE = re.compile(r"nvjet|bf16|s16816|h16816|hmma|gmma|tf32", re.I)


def gemm_split(by_kernel):
    """The device us of a step's GEMMs on the tensor cores (nvjet, bf16,
    hmma, gmma and the like in the name) and on the CUDA cores (the other
    GEMMs)."""
    tc = sum(v for k, v in by_kernel.items() if GEMM.search(k) and TENSOR_CORE.search(k))
    simt = sum(v for k, v in by_kernel.items() if GEMM.search(k) and not TENSOR_CORE.search(k))
    return tc, simt


def main():
    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.data.compact_vocab import build_compact_vocab, remap_pairing
    from eeg_multimodal_torch.models import bert as bert_mod
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.ops import _build
    from eeg_multimodal_torch.ops import attention as A
    from eeg_multimodal_torch.ops import dp as dp_ops
    from eeg_multimodal_torch.ops import dp_fused as K
    from eeg_multimodal_torch.ops import optim as O
    from eeg_multimodal_torch.train.api import TrainAndTest
    from eeg_multimodal_torch.train.checkpoint import load_torch_checkpoint, save_torch_checkpoint
    from eeg_multimodal_torch.train.records import parse_legacy_records
    from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig, Trainer
    from eeg_multimodal_torch.utils.device import resolve_device
    from eeg_multimodal_torch.utils.seeding import DEFAULT_SEED, generator
    from eeg_multimodal_torch.utils.trees import tree_cast, tree_items, tree_map, tree_size

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
    per_process = re.findall(r"^nvcc (\S+): ([\d.]+) s$", build_log, re.M)
    print(f"  nvcc {nvcc_s:.1f} s, build + load {time.time() - t0:.1f} s; each process's "
          f"wall s (compiles together, then the link): {dict(per_process)}")
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

    phase("DP kernels with a member axis (the sweep's), against the plain versions and "
          "M single calls")
    for name, e in check_member_dp(torch, K, gen, dev).items():
        err[name] = max(err[name], e)

    phase("attention kernels against attention_plain / attention_bwd_plain")
    t0 = time.time()
    err.update(check_attention_kernels(torch, A, gen, dev, zoo_seq_lens(D), dpsgd_batches()))
    vit_err = check_vit_attention(torch, A, gen, dev)
    for G in (2, 5):  # the paired phase encode's 2B forward; the 5-member sweep's rows
        print(f"  G = {G} max errors: " + ", ".join(
            f"{name} {dt} {e:.3g}" for (name, dt), e in check_grouped_attention(
                torch, A, gen, dev, G).items()))
    print(f"  (checks {time.time() - t0:.1f} s)")

    phase("reference check: 2-layer BERT at S = 512, card (attention kernels) against CPU")
    check_bert_card_against_cpu(torch, bert_mod, A, tree_map, dev)

    phase("stochastic rounding of the bf16 Adam moment on the card")
    check_stochastic_rounding(torch, O, dev)

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
        k.reset()
    rows = []
    for epoch in range(2):
        rows.append(trainer.run_epoch(epoch, train_dev, test_dev, N_TRAIN, N_EVAL, EPS))
        if epoch == 0:
            dp_changed = not torch.equal(trainer.params["DP"], dp0)
    launches_80 = {k.name: k.launches for k in all_kernels}
    steps = N_TRAIN // tc.batch_size
    print_rows(rows, steps)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches_80}")
    for row in rows:
        check(all(math.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1")),
              "non-finite loss")
        check(0.0 <= row["f1"] <= 1.0, "F1 outside [0, 1]")
    check(dp_changed, "DP did not change in the first epoch")
    # the H100 attention gate takes S = 80: every BERT layer of both phases'
    # forwards and of the eval's one batched forward an epoch, and of the
    # phase-2 backward
    layers = fusion.config_for("ti", "lapacian_dropout").bert_cfg().num_layers
    want = {"dp_fwd": 2 * (2 * steps + 1), "dp_bwd": 2 * 2 * steps,
            "attn_fwd": layers * (2 * steps + 1) * 2, "attn_bwd": layers * steps * 2}
    check(launches_80 == want, f"launches {launches_80}, expected {want}")
    check(all(set(k.by_dtype) == {"float32"} for k in all_kernels if k.launches),
          "an f32 path launched another instantiation")

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

    def step_fn(tr, data, steps=None):
        """One train step of ``tr`` on the first batch of ``data``, through
        ``steps`` (by default the trainer's own StepFunctions)."""
        steps = steps or tr.steps
        batch = D.gather_batch(data, torch.arange(tc.batch_size, device=dev))
        w = torch.ones(tc.batch_size, device=dev)
        states = [tr.dp_os, tr.model_os]
        params_c = steps.precast_copy(tr.params) if steps.precast else None

        def train_step():
            states[:] = steps.train_step(tr.params, *states, batch, w, EPS, gen,
                                         params_c=params_c)[:2]
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
    del step_80
    run_epoch = Trainer.run_epoch

    def snapshotting(snaps):
        """Trainer.run_epoch, keeping host copies of the params after each
        epoch in ``snaps`` (for the checkpoint checks)."""
        def snapshot_epoch(self, *args, **kwargs):
            row = run_epoch(self, *args, **kwargs)
            snaps[row["epoch"]] = tree_map(lambda t: t.detach().cpu().clone(), self.params)
            return row
        return snapshot_epoch

    def check_history(history, where):
        check(len(history) == 2, f"{where}: fit ran another number of epochs")
        for row in history:
            check(all(math.isfinite(row[k]) for k in ("train_loss", "test_loss", "f1")),
                  f"{where}: non-finite loss")
            check(0.0 <= row["f1"] <= 1.0, f"{where}: F1 outside [0, 1]")

    def check_records(logs, where):
        recs = parse_legacy_records(open(os.path.join(logs, "whole_record.txt")).read())
        check([r["epoch"] for r in recs] == [1, 2], f"{where}: whole_record.txt epochs {recs}")
        check(len(open(os.path.join(logs, "metrics.jsonl")).read().splitlines()) == 2,
              f"{where}: metrics.jsonl does not hold two epochs")

    # bf16: the attention kernels' bf16 instantiations, in every BERT layer of
    # both phases' forwards, of the eval's one batched forward an epoch, and
    # of the phase-2 backward; composed DP, so no DP kernel
    want_bf16 = {"dp_fwd": {}, "dp_bwd": {},
                 "attn_fwd": {"bfloat16": layers * (2 * steps + 1) * 2},
                 "attn_bwd": {"bfloat16": layers * steps * 2}}

    phase("main path 3: TrainAndTest(epochs=2) at its default bf16 compute, "
          "train_on(compact_vocab=True), S = 80")
    train3, test3 = synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL)
    root3 = tempfile.mkdtemp(prefix="chip_smoke_")
    api3 = TrainAndTest(epochs=2, artifacts_root=root3, echo=False)
    check(api3.compute_dtype == "bfloat16", f"TrainAndTest defaults to {api3.compute_dtype}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in all_kernels:
        k.reset()
    result3 = api3.train_on(train3, test3, "DPMLD", "bf16/", "ti", "lapacian_dropout",
                            compact_vocab=True)
    launches_bf16 = {k.name: dict(k.by_dtype) for k in all_kernels}
    tr3 = api3.trainer
    words = tr3.params["bert"]["embeddings"]["word"].shape[0]
    print_rows(result3["history"], steps)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches by "
          f"dtype {launches_bf16}; compact vocab {words} of 30522 rows; f1_best "
          f"{result3['f1_best']:.4f}")
    check_history(result3["history"], "path 3")
    check(tr3.steps.compute_dtype == torch.bfloat16, "path 3 did not compute in bf16")
    check(tr3.vocab is not None and words == tr3.vocab.size < 30522, "no compact vocab")
    check(float(tr3.params["DP"].abs().max()) > 0, "DP did not train on path 3")
    check(launches_bf16 == want_bf16, f"launches {launches_bf16}, expected {want_bf16}")
    check_records(os.path.join(root3, "logs", "DPMLD", "bf16"), "path 3")

    phase("reference check: bf16 forward, card against CPU on 2 rows (composed DP, the "
          "noise handed across)")
    test3_dev = remap_pairing(D.truncate_pair(train3, test3)[1], tr3.vocab).to_device(dev)
    batch = D.gather_batch(test3_dev, torch.arange(2, device=dev))
    noise = torch.randn(2, fc.concat_width, generator=gen, device=dev)
    fc3 = tr3.fusion_cfg
    before = A.attn_fwd.by_dtype.get("bfloat16", 0)
    with torch.no_grad():
        p16 = tree_cast(tr3.params, torch.bfloat16)
        on_card = fusion.apply(p16, batch, fc3, EPS, True, None, False, dp_noise=noise)
        f32_card = fusion.apply(tr3.params, batch, fc3, EPS, True, None, False, dp_noise=noise)
        on_cpu = fusion.apply(tree_map(torch.Tensor.cpu, p16), tree_map(torch.Tensor.cpu, batch),
                              fc3, EPS, True, None, False, dp_noise=noise.cpu())
    check(A.attn_fwd.by_dtype.get("bfloat16", 0) - before == layers,
          "the card's bf16 forward did not go through the bf16 attention kernel")
    check(on_card.dtype == torch.float32 and tuple(on_card.shape) == (2, 2)
          and bool(torch.isfinite(on_card).all()), "bf16 logits not finite f32 (2, 2)")
    print(f"  logits max|card - cpu| {float((on_card.cpu() - on_cpu).abs().max()):.3g} (bf16, "
          f"tolerance {BF16_LOGIT_TOL}); for scale, max|bf16 - f32| on the card "
          f"{float((on_card - f32_card).abs().max()):.3g}, max|logit| "
          f"{float(f32_card.abs().max()):.3g}")
    torch.testing.assert_close(on_card.cpu(), on_cpu, **BF16_LOGIT_TOL)
    del p16, test3_dev

    phase("bench.py's configuration through Trainer.fit: bf16 compute and Adam moments, "
          "precast_params, compact vocab, composed DP, S = 80")
    train_b, test_b = D.truncate_pair(synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL))
    test_b_full = test_b  # full-vocab ids, for predict on the exported checkpoint
    vocab = build_compact_vocab([train_b.eeg_input, test_b.eeg_input])
    train_b, test_b = remap_pairing(train_b, vocab), remap_pairing(test_b, vocab)
    fc_full = fusion.config_for("ti", "lapacian_dropout")
    fc_b = dataclasses.replace(fc_full, bert_config=bert_mod.BertConfig(vocab_size=vocab.size))
    tc_b = TrainConfig(compute_dtype="bfloat16", adam_mu_dtype="bfloat16",
                       adam_nu_dtype="bfloat16", precast_params=True, epochs=2,
                       f1_best_init=0.0)
    bench = Trainer(fc_b, tc_b, vocab=vocab)
    ckpt_b = os.path.join(root3, "bench", "best_f1.pickle")
    snaps = {}
    for k in all_kernels:
        k.reset()
    Trainer.run_epoch = snapshotting(snaps)
    try:
        res_b = bench.fit(train_b, test_b, EPS, log_path=os.path.join(root3, "bench"),
                          model_path=ckpt_b, echo=False)
    finally:
        Trainer.run_epoch = run_epoch
    launches_b = {k.name: dict(k.by_dtype) for k in all_kernels}
    print_rows(res_b["history"], steps)
    print(f"  launches by dtype {launches_b}; f1_best {res_b['f1_best']:.4f} (best epoch "
          f"{res_b['best'] and res_b['best']['epoch']})")
    check_history(res_b["history"], "bench configuration")
    check(launches_b == want_bf16, f"launches {launches_b}, expected {want_bf16}")
    check_records(os.path.join(root3, "bench"), "bench configuration")
    check(res_b["best"] is not None and os.path.exists(ckpt_b),
          "F1 never passed 0.0: no best checkpoint to check")
    loaded = load_torch_checkpoint(ckpt_b, fc_full, device="cpu")
    best = dict(tree_items(snaps[res_b["best"]["epoch"]]))
    word = loaded["bert"]["embeddings"]["word"]
    used = torch.from_numpy(vocab.new_to_old).long()
    unused = torch.ones(word.shape[0], dtype=torch.bool)
    unused[used] = False
    check(tuple(word.shape) == (30522, 768), f"checkpoint word table {tuple(word.shape)}")
    check(torch.equal(word[used], best["bert/embeddings/word"])
          and float(word[unused].abs().max()) == 0.0,
          "the checkpoint's word rows are not the compact table scattered to full vocab")
    check(all(torch.equal(leaf, best[path]) for path, leaf in tree_items(loaded)
              if path != "bert/embeddings/word"), "the checkpoint differs from the best params")
    moments = bench.model_os
    check(all(t.dtype == torch.bfloat16 for t in moments.mu + moments.nu)
          and bool(torch.isfinite(moments.packed["nu"]).all())
          and float(moments.packed["nu"].float().max()) > 0,
          "the stored Adam moments are not bf16, finite and trained")
    print(f"  checkpoint of epoch {res_b['best']['epoch']} loads with {word.shape[0]} word "
          f"rows ({vocab.size} trained, the rest 0) and equals the best params; Adam moments "
          f"bf16, {moments.packed['nu'].numel()} each, nu finite")
    del loaded, best, word, snaps

    phase("profile: steady-state S = 80 train step, the bench configuration (bf16) with "
          "precast_params and with the in-step cast, in turns with path 1's f32 step")
    train_b_dev, test_b_dev = train_b.to_device(dev), test_b.to_device(dev)
    in_step = StepFunctions(fc_b, dataclasses.replace(tc_b, precast_params=False), dev)
    steps_by_label = {"f32, path 1": step_fn(trainer, train_dev),
                      "bf16, bench, precast": step_fn(bench, train_b_dev),
                      "bf16, bench, in-step cast": step_fn(bench, train_b_dev, in_step)}
    for label in ("f32, path 1", "bf16, bench, precast", "bf16, bench, in-step cast",
                  "bf16, bench, in-step cast", "bf16, bench, precast", "f32, path 1"):
        by_kernel = profile_step(torch, steps_by_label[label], f"S = 80, {label}",
                                 4 * forward_matmul_flops(tc.batch_size, 80))
        if by_kernel:
            tc_us, simt_us = gemm_split(by_kernel)
            attn = sum(v for k, v in by_kernel.items() if "attn_" in k)
            print(f"  GEMMs on the tensor cores {tc_us / 1e3:.2f} ms/step, on the CUDA cores "
                  f"{simt_us / 1e3:.2f} ms/step; attention kernels {attn:.1f} us/step; "
                  "top GEMMs (us/step):")
            gemms = sorted(((v, k) for k, v in by_kernel.items() if GEMM.search(k)), reverse=True)
            for us, name in gemms[:5]:
                print(f"    {us:9.1f}  {'TC  ' if TENSOR_CORE.search(name) else 'SIMT'} "
                      f"{name[:84]}")
    del steps_by_label, in_step

    phase("eval epoch: one batched forward (eval_vmap_batches) against the batch loop, bench "
          "configuration, 601 rows in 76 batches, in turns")
    n_rows = 601  # the reference's eval set (bench.py:27)
    flat = torch.arange(-(-n_rows // tc.batch_size) * tc.batch_size, device=dev)
    eidx = (flat % N_EVAL).reshape(-1, tc.batch_size)  # the 32 eval rows, cycled
    ew = (flat < n_rows).float().reshape(-1, tc.batch_size)
    evals = {"batched": bench.steps,
             "loop": StepFunctions(fc_b, dataclasses.replace(tc_b, eval_vmap_batches=False), dev)}
    eval_ms = {label: [] for label in evals}
    for label in ("batched", "loop", "loop", "batched"):
        def eval_epoch(steps=evals[label]):
            return steps.eval_epoch(bench.params, test_b_dev, eidx, ew, EPS, gen)[0]
        eval_epoch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            eval_epoch()
        torch.cuda.synchronize()
        eval_ms[label].append((time.perf_counter() - t0) / 3 * 1e3)
        if len(eval_ms[label]) == 1:
            busy = sum(device_us(torch, eval_epoch, 1).values()) / 1e3
            print(f"  {label}: device busy {busy:.2f} ms per eval epoch")
    print("  eval epoch, host ms in turns (batched, loop, loop, batched): "
          f"{eval_ms['batched'][0]:.2f}, {eval_ms['loop'][0]:.2f}, {eval_ms['loop'][1]:.2f}, "
          f"{eval_ms['batched'][1]:.2f}")
    del evals

    # -- the rest of the trainer: the fast modes, n_eval, shuffle_eval ---------
    def by_dtype(dp, attn_f, attn_b, dtype="float32"):
        """Launch counts as KernelWrapper.by_dtype gives them."""
        return {name: ({dtype: n} if n else {}) for name, n in
                (("dp_fwd", dp[0]), ("dp_bwd", dp[1]), ("attn_fwd", attn_f),
                 ("attn_bwd", attn_b))}

    def fit_path(label, fc_, tc_, want):
        """Two epochs of ``Trainer.fit`` on path 1's rows; checks the
        launches by dtype, finite losses, F1 in [0, 1] and DP trained."""
        tr = Trainer(fc_, tc_)
        dp_before = tr.params["DP"].clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in all_kernels:
            k.reset()
        res = tr.fit(train, test, EPS, echo=False)
        got = {k.name: dict(k.by_dtype) for k in all_kernels}
        print_rows(res["history"], steps)
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches by "
              f"dtype {got}")
        check_history(res["history"], label)
        check(not torch.equal(tr.params["DP"], dp_before), f"{label}: DP did not train")
        check(got == want, f"{label}: launches {got}, expected {want}")
        return tr, res["history"]

    # eval: one batched forward an epoch; the fused DP block once per forward
    eval_fwd = 2 * layers
    phase("main path 4: share_phase_dropout (features encoded once, reuse_phase_features), "
          "fused DP, f32, S = 80, through Trainer.fit")
    tr4, rows4 = fit_path("path 4", fc, TrainConfig(share_phase_dropout=True, epochs=2),
                   by_dtype((2 * (2 * steps + 1), 2 * 2 * steps),
                            layers * steps * 2 + eval_fwd, layers * steps * 2))
    phase("share_phase_dropout without reuse_phase_features, fused DP, f32, S = 80, through "
          "Trainer.fit")
    _, rows_shared = fit_path(
        "share without reuse", fc,
        TrainConfig(share_phase_dropout=True, reuse_phase_features=False, epochs=2),
        by_dtype((2 * (2 * steps + 1), 2 * 2 * steps), layers * 2 * steps * 2 + eval_fwd,
                 layers * steps * 2))
    # reuse is a rewrite of sharing without it: the same draws, one encoder pass
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(rows4, rows_shared)
              for k in ROW)
    print(f"  path 4's rows against sharing without reuse: max relative difference {rel:.3g}")
    check(rel <= 1e-5, "reuse_phase_features differs from sharing without it")
    phase("main path 5: paired_phase_encode (both phases' encoder forwards as one at 2B "
          "rows), bf16 with the in-step cast, composed DP, S = 80, through Trainer.fit")
    tr5, _ = fit_path("path 5", fc_full, TrainConfig(paired_phase_encode=True,
                                                  compute_dtype="bfloat16", epochs=2),
                   by_dtype((0, 0), layers * steps * 2 + eval_fwd, layers * steps * 2,
                            "bfloat16"))
    for label, extra in (("n_eval=4", dict(n_eval=4)), ("shuffle_eval", dict(shuffle_eval=True))):
        phase(f"TrainConfig({label}), path 1's configuration otherwise, through Trainer.fit "
              f"(the eval {'4 x ' if 'n_eval' in extra else ''}32 rows in one forward)")
        fit_path(label, fc, TrainConfig(epochs=2, **extra),
                 by_dtype((2 * (2 * steps + 1), 2 * 2 * steps),
                          layers * 2 * steps * 2 + eval_fwd, layers * steps * 2))

    phase("profile: steady-state S = 80 train step of the fast modes, in turns with path 1's "
          "faithful f32 step")
    mode_steps = {"f32, path 1": (step_fn(trainer, train_dev), 4, "2 forwards + 1 backward"),
                  "f32, share + reuse, path 4": (step_fn(tr4, train_dev), 3,
                                                 "1 forward + 1 backward"),
                  "bf16, paired, path 5": (step_fn(tr5, train_dev), 6,
                                           "1 forward + 1 backward at 2B")}
    for label in ("f32, path 1", "f32, share + reuse, path 4", "bf16, paired, path 5",
                  "bf16, paired, path 5", "f32, share + reuse, path 4", "f32, path 1"):
        fn, forwards, work = mode_steps[label]
        by_kernel = profile_step(torch, fn, f"S = 80, {label}",
                                 forwards * forward_matmul_flops(tc.batch_size, 80),
                                 f"{work} ~ {forwards} forwards")
        if by_kernel:
            tc_us, simt_us = gemm_split(by_kernel)
            attn = sum(v for k, v in by_kernel.items() if "attn_" in k)
            print(f"  GEMMs on the tensor cores {tc_us / 1e3:.2f} ms/step, on the CUDA cores "
                  f"{simt_us / 1e3:.2f} ms/step; attention kernels {attn:.1f} us/step")
    del mode_steps, tr4, tr5

    phase("StepFunctions.cycle: K = 2 epochs of the bench configuration under "
          "torch.cuda.set_sync_debug_mode('error'), against two Trainer.run_epoch calls from "
          "the same state")
    by_epoch, cycled = Trainer(fc_b, tc_b, vocab=vocab), Trainer(fc_b, tc_b, vocab=vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_rows = [[row[k] for k in ROW] for row in
                 (by_epoch.run_epoch(e, train_b_dev, test_b_dev, N_TRAIN, N_EVAL, EPS)
                  for e in range(2))]
    epochs_ms = (time.perf_counter() - t0) * 1e3
    cycle_in = cycled.cycle_inputs(range(2), N_TRAIN, N_EVAL)
    torch.cuda.synchronize()
    for k in all_kernels:
        k.reset()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cycled.dp_os, cycled.model_os, out = cycled.steps.cycle(
            cycled.params, cycled.dp_os, cycled.model_os, train_b_dev, test_b_dev, *cycle_in, EPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    enqueued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycle_ms = (time.perf_counter() - t0) * 1e3
    launches_cycle = {k.name: dict(k.by_dtype) for k in all_kernels}
    rows = out.tolist()
    print(f"  rows {rows}")
    print(f"  cycle {cycle_ms:.1f} ms host (returned after {enqueued_ms:.1f} ms, no sync); two "
          f"run_epoch calls before it {epochs_ms:.1f} ms; launches by dtype {launches_cycle}")
    check(launches_cycle == want_bf16, f"cycle launches {launches_cycle}, expected {want_bf16}")
    check(rows == want_rows, f"cycle rows {rows} differ from run_epoch's {want_rows}")
    check(all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(cycled.params),
                                                          tree_items(by_epoch.params))),
          "cycle's params differ from run_epoch's")
    print("  no host sync inside cycle; its rows and params equal two run_epoch calls' exactly")
    del by_epoch, cycled, cycle_in, out

    phase("TrainAndTest.predict on the bench configuration's best checkpoint (full-vocab "
          "rows), bf16, n_eval = 1 and 4; 601 rows timed; the vocabulary range check")
    write_split(root3, "test", test_b_full)
    rows601 = np.arange(601) % N_EVAL  # the reference's eval size, the 32 rows cycled
    write_split(root3, "val601", dataclasses.replace(
        test_b_full, eeg_input=test_b_full.eeg_input[rows601],
        eeg_mask=test_b_full.eeg_mask[rows601], act_input=test_b_full.act_input[rows601],
        act_mask=test_b_full.act_mask[rows601], labels=test_b_full.labels[rows601]))
    api_p = TrainAndTest(data_root=root3, echo=False)  # the bf16 default, batch 8
    loaded = load_torch_checkpoint(ckpt_b, fc_full, dev)
    pred_dev = D.truncate_tokens(test_b_full).to_device(dev)
    pidx, pw = D.epoch_indices(N_EVAL, api_p.batch_size, False, device=dev)
    for n_eval in (1, 4):
        for k in all_kernels:
            k.reset()
        csv_path = os.path.join(root3, f"predict_{n_eval}.csv")
        res_p = api_p.predict(ckpt_b, n_eval=n_eval, epsilon=EPS, out_csv=csv_path)
        got = {k.name: dict(k.by_dtype) for k in all_kernels}
        want_p = by_dtype((0, 0), layers, 0, "bfloat16")
        check(got == want_p, f"predict n_eval={n_eval}: launches {got}, expected {want_p}")
        steps_p = StepFunctions(fc_full, TrainConfig(compute_dtype="bfloat16", n_eval=n_eval), dev)
        loss_p, _, preds_p, _, scores_p, _ = steps_p.eval_epoch(
            loaded, pred_dev, pidx, pw, EPS, generator(DEFAULT_SEED, dev))
        check(res_p["loss"] == float(loss_p)
              and np.array_equal(res_p["predictions"], preds_p.cpu().numpy())
              and np.array_equal(res_p["scores"], scores_p.float().cpu().numpy()),
              f"predict n_eval={n_eval} differs from eval_epoch on the loaded params")
        n_lines = len(open(csv_path).read().splitlines())
        check(n_lines == N_EVAL + 1, f"the CSV has {n_lines} lines, not {N_EVAL + 1}")
        print(f"  n_eval = {n_eval}: loss {res_p['loss']:.4f}, accuracy {res_p['accuracy']:.3f}, "
              f"f1 {res_p['f1']:.3f}; equal to eval_epoch on the loaded params; CSV {n_lines} "
              f"lines; launches {got} (one forward of {n_eval} x {N_EVAL} rows)")
    for n_eval in (1, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res_p = api_p.predict(ckpt_b, split="val601", n_eval=n_eval, epsilon=EPS)
        predict_ms = (time.perf_counter() - t0) * 1e3
        check(len(res_p["predictions"]) == 601, "predict did not return 601 rows")
        steps_p = StepFunctions(fc_full, TrainConfig(compute_dtype="bfloat16", n_eval=n_eval), dev)
        data601 = D.truncate_tokens(api_p._load_split("val601", "ti", "bert", "bert-base-uncased",
                                                      "clip", "ViT-B/32")).to_device(dev)
        idx601, w601 = D.epoch_indices(601, api_p.batch_size, False, device=dev)
        eval_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps_p.eval_epoch(loaded, data601, idx601, w601, EPS, gen)
            torch.cuda.synchronize()
            eval_ms.append((time.perf_counter() - t0) * 1e3)
        busy = sum(device_us(torch, lambda: steps_p.eval_epoch(loaded, data601, idx601, w601,
                                                              EPS, gen), 1).values()) / 1e3
        print(f"  601 rows, n_eval = {n_eval} ({n_eval * idx601.numel()} rows x S = "
              f"{data601['eeg_input'].shape[1]} in one forward): predict {predict_ms:.1f} ms "
              f"host (checkpoint load included), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; its eval epoch alone "
              f"{', '.join(f'{m:.2f}' for m in eval_ms)} ms host, {busy:.2f} ms device busy")
    with open(ckpt_b, "rb") as f:
        sd = pickle.load(f)
    word_key = "bert.embeddings.word_embeddings.weight"
    sd[word_key] = sd[word_key][:1000]
    small = os.path.join(root3, "small_vocab.pickle")
    with open(small, "wb") as f:
        pickle.dump(sd, f)
    del sd
    for k in all_kernels:
        k.reset()
    try:
        api_p.predict(small, n_eval=1, epsilon=EPS)
        fail("predict took ids past a 1000-row word table")
    except ValueError as e:
        print(f"  1000-row word table: ValueError before any launch: {str(e)[:90]}")
    check(all(k.launches == 0 for k in all_kernels), "predict launched a kernel before raising")
    torch.cuda.synchronize()  # a device-side assert would surface here, and below
    check(float(torch.ones(8, device=dev).sum()) == 8.0, "the CUDA context is unusable")
    print("  the CUDA context is still usable")
    shutil.rmtree(root3)
    del loaded, pred_dev, data601, api_p, steps_p

    del trainer, train_dev, test_dev, bench, api3, tr3, train_b_dev, test_b_dev
    run_zoo(torch, dev, rng, gen, all_kernels, layers, steps, step_fn)
    run_dpsgd(torch, dev, rng, all_kernels, layers, steps)
    run_drivers(torch, dev, rng, all_kernels, layers, steps)
    launches_sweep = run_sweep(torch, dev, rng, all_kernels, layers, steps)
    run_legacy(torch, dev, rng, all_kernels, layers, steps)
    embed = run_embedding(torch, dev, all_kernels, layers)

    phase("main path 2: TrainAndTest.train_on(auto_truncate=False) -> Trainer.fit, S = 512")
    train, test = synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL)
    check(train.eeg_input.shape == (N_TRAIN, 512), "the 512-token rows were cut")
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    snaps = {}  # host copies of the params after each epoch, for the checkpoint check
    api = TrainAndTest(compute_dtype="float32", epochs=2, artifacts_root=root, echo=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in all_kernels:
        k.reset()
    Trainer.run_epoch = snapshotting(snaps)
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
    check_history(history, "S = 512")
    want = {"attn_fwd": layers * (2 * steps + 1) * 2,
            "attn_bwd": layers * steps * 2, "dp_fwd": 0, "dp_bwd": 0}
    check(launches == want, f"launches {launches}, expected {want}")
    final = api.trainer.params
    check(not torch.equal(final["DP"].cpu(), snaps[1]["DP"])
          and float(final["DP"].abs().max()) > 0, "DP did not train at S = 512")
    logs = os.path.join(root, "logs", "DPMLD", "smoke")
    check_records(logs, "S = 512")
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

    M = len(MEMBER_EPS)
    phase(f"timing: DP kernels with the member axis at ({M} x {B}, {F}), the sweep's, "
          f"against {M} single calls")
    fm, gm = torch.randn(M * B, F, generator=gen, device=dev), torch.randn(M * B, F, generator=gen,
                                                                          device=dev)
    dpm = torch.randn(M, F, generator=gen, device=dev)
    eps_m = torch.tensor(MEMBER_EPS, dtype=torch.float64, device=dev)
    sm = torch.arange(5, 5 + M, dtype=torch.int64, device=dev)
    rows = [slice(m * B, (m + 1) * B) for m in range(M)]

    def noise_m():
        return K.laplace_plain(sm.tolist(), (M * B, F), dev)

    timed_m = {
        "dp_fwd": (lambda: K.dp_fwd(fm, dpm, eps_m, sm),
                   lambda: [K.dp_fwd(fm[r], dpm[m:m + 1], MEMBER_EPS[m], sm[m:m + 1])
                            for m, r in enumerate(rows)],
                   lambda: K.dp_block_plain(fm, dpm, eps_m, noise_m())),
        "dp_bwd": (lambda: K.dp_bwd(fm, dpm, eps_m, sm, gm),
                   lambda: [K.dp_bwd(fm[r], dpm[m:m + 1], MEMBER_EPS[m], sm[m:m + 1], gm[r])
                            for m, r in enumerate(rows)],
                   lambda: K.dp_block_bwd_plain(fm, dpm, eps_m, noise_m(), gm)),
    }
    for name, (kern, singles, plain) in timed_m.items():
        ms, single_ms = time_ms(torch, kern), time_ms(torch, singles, 50, 5)
        plain_ms = time_ms(torch, plain, 10, 3)
        dev_k = sum(device_us(torch, kern).values())
        dev_s = sum(device_us(torch, singles, 10).values())
        bms, by = dp_bound_ms(name, M * B, F, M)
        print(f"  {name} members: kernel {ms * 1e3:.2f} us, {M} single calls "
              f"{single_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us (CUDA events); device "
              f"time kernel {dev_k:.2f} us, {M} single calls {dev_s:.2f} us; bound "
              f"{bms * 1e3:.4f} us ({by})")
        kernels.append({
            "name": name + "_members", "route": ROUTES[name], "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches_sweep[name],
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
                    "max_abs_err": err[(name, "float32", (B, H, S, D))], "ms": t[key],
                    "plain_ms": t[key + " plain"],
                    "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                    "library_ms": t[key + " sdpa"],
                })

    phase("timing: attention kernels, bf16, p = 0.1 (path 3's S = 80, and S = 512)")
    for S in (80, 512):
        B, H, D = 8, 12, 64
        qkv = torch.randn(B, S, 3, H, D, generator=gen, device=dev, dtype=torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias = torch.zeros(B, S, device=dev)
        bias[:, VALID_TOKENS:] = NEG
        bias4 = bias[:, None, None, :]
        dout = torch.randn(B, H, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
        s = seed(13)
        out, stats = A.attn_fwd(q, k, v, bias, s, ATTN_DROP)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def keep():
            return torch.rand(B, H, S, S, generator=gen, device=dev) < 1 - ATTN_DROP

        def fwd():
            return A.attn_fwd(q, k, v, bias, s, ATTN_DROP)

        def bwd():
            return A.attn_bwd(q, k, v, bias, s, ATTN_DROP, out, stats, dout)

        n = 20 if S == 512 else 50
        t = {"fwd": time_ms(torch, fwd, n, 5), "bwd": time_ms(torch, bwd, n, 5),
             "fwd plain": time_ms(torch, lambda: A.attention_plain(q, k, v, bias, keep(),
                                                                   ATTN_DROP), n, 5),
             "bwd plain": time_ms(torch, lambda: A.attention_bwd_plain(
                 q, k, v, bias, keep(), ATTN_DROP, dout), n, 5),
             "fwd sdpa": time_ms(torch, lambda: TF.scaled_dot_product_attention(
                 q, k, v, attn_mask=bias4, dropout_p=ATTN_DROP), n, 5),
             "fwd+bwd sdpa": time_ms(torch, lambda: torch.autograd.grad(
                 TF.scaled_dot_product_attention(*leaves, attn_mask=bias4, dropout_p=ATTN_DROP),
                 leaves, dout), n, 5)}
        t["bwd sdpa"] = t["fwd+bwd sdpa"] - t["fwd sdpa"]
        dev_t = {"fwd": sum(device_us(torch, fwd, 10).values()),
                 "bwd": sum(device_us(torch, bwd, 10).values())}
        bounds = {name: attn_bound_ms(name, B, H, S, D, 2) for name in ("attn_fwd", "attn_bwd")}
        print(f"  S = {S}: " + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in t.items()))
        print(f"  S = {S}: device time fwd {dev_t['fwd']:.1f} us, bwd {dev_t['bwd']:.1f} us; "
              f"bound (bf16 tensor cores) fwd {bounds['attn_fwd'][0] * 1e3:.2f} us "
              f"({bounds['attn_fwd'][1]}), bwd {bounds['attn_bwd'][0] * 1e3:.2f} us "
              f"({bounds['attn_bwd'][1]})")
        if S == 80:  # path 3's shape
            for name, key in (("attn_fwd", "fwd"), ("attn_bwd", "bwd")):
                kernels.append({
                    "name": name + "_bf16", "route": ROUTES[name], "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": launches_bf16[name].get("bfloat16", 0),
                    "max_abs_err": err[(name, "bfloat16", (B, H, S, D))], "ms": t[key],
                    "plain_ms": t[key + " plain"], "bound_ms": bounds[name][0],
                    "bound_by": bounds[name][1], "library_ms": t[key + " sdpa"],
                })

    phase("timing: attention forward at the ViT's shapes, f32, zero bias, p = 0 (main path 8)")
    kernels += time_vit_attention(torch, A, gen, dev, embed, vit_err)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
