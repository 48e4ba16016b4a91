#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA C++ kernels from this checkout, one nvcc process
per source, started together (the DP block, forward and backward;
attention, forward, backward on the tensor cores and the dropout-mask test
hook: f32 as 3xTF32 on wgmma, bf16 on wgmma with TMA loads, at D = 64 and
128 and at sequence lengths no multiple of the tiles), and holds each against its
plain PyTorch version: the DP forward bit for bit where the card's math
library allows (within 1e-5 in any case) with ``laplace_plain``'s noise, the
attention mask bit for bit against ``keep_mask_plain``, also with a seed
vector of G = 2 over 2B rows and of G = 5 over the sweep's 5 members'
rows (equal to G calls of G = 1, bit for bit, the forward and backward
too), the DP kernels with a member axis (equal to M single calls and their
plain versions, bit for bit), the attention forward at the ViT's shapes
(S = 50 at 16, 2 and 9 rows, S = 197; zero bias, p = 0), both attention
kernels at path 9's bf16 shapes ((128, 12, 128, 64), p = 0.1, keys padded
past 65; (128, 12, 50, 64), p = 0, forward and backward; tails of 2); the
kernels' global offsets (each block of a (2, 2) layout of (8, 12, S, 64)
against the global call: the mask bit for bit, the outputs within the
tolerances; the DP block's rows 4-7 with r0 = 4 bit for bit); and a 2-layer
BERT at S = 512 on the card against the CPU. Checks the bf16 Adam moment's
stochastic rounding on the card. Then drives the main paths at full width
(BERT-base, 3-layer cross-attention decoder, F = 2304, batch 8):

1. the flagship TICA_LapDropout fused-DP trainer in f32 at the truncated
   S = 80, two train+eval epochs through ``Trainer.run_epoch``, where both
   DP kernels and (the H100's gate) both attention kernels run;
3. ``TrainAndTest(epochs=2)`` at its default bf16 compute through
   ``train_on(compact_vocab=True)`` at S = 80, where the bf16 attention
   kernels run; then ``bench.py``'s
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
   weights, the step profiled beside five single-member steps,
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
9. the pretext pipeline from that tree: ``cli distill`` (a seeded stand-in
   for the real test-split CLIP array, which the repo does not hold) into
   a new tree; the rendering-inversion ``ContrastivePretrainer`` at
   ViT-B/32, batch 128, bf16 (both attention kernels, 24 launches a step),
   its tower re-embedding the images; ``cli pretrain`` with every pretext
   at BERT-base on the compact vocab, bf16 (12 / 12 a MLM step at (128,
   12, 128, 64)), then one bf16 DP-MLD epoch at 2402 / 601;
   ``ResumableTrainer`` resumed against an unbroken run (f32, bit for bit);
   ``pretrain_finetune``; a MLM and a contrastive step profiled and run
   under sync debug mode "error";
7. (again) the sweep's fast modes: the 5-member sweep with share + reuse
   (f32, fused DP) and with the paired encode (bf16), each held to one
   model's fit with that mode (its launches) and its member step profiled
   beside the faithful one;
10. the (data, model) mesh (``parallel/``): the flagship meshless, then on
   a (1, 2) and a (2, 1) mesh of two ranks spawned on the one card over
   gloo (parity, not speed: gloo stages CUDA tensors through the host)
   and a (1, 1) mesh over NCCL with a step under sync debug mode "error";
   losses within rtol 2e-4, F1 equal, the gathered params within the
   stated bounds, every rank path 1's launches; ``shard_dpsgd_trainer`` at
   (1, 2), a 3-member ``SweepRunner(mesh=(2, 1))`` against the meshless
   sweep, the fast phase modes (shared features, the paired encode) one
   epoch each on a (2, 1) mesh against their meshless fits, the flagship
   tree through ``save_pytree_dcp`` and back;
11. the entry points outside the package, through their ``main``s, on a
   seeded stand-in for the reference's test split (``bench.write_stand_in``,
   601 rows, under a temporary ``REFERENCE_DIR``): ``python -m
   eeg_multimodal_torch.bench`` at 2402 / 601 with K = 1 and R = 1 (its
   JSON line parsed, the bf16 attention launches of two epochs), the step
   roofline at N = 2 and 8 (every row a bound and a share of at most 1),
   the attention table, ``train_demo`` plain and ``--fused_dp``; then a
   user tree from 80 raw rows (``process``, ``GetEmbedding``) and every
   ported example and ``tools.validate_bf16_moments`` at its smallest
   epoch count, in order, each held to the file it writes and to
   launching the attention kernels;
12. the JAX system's remaining entry points through their ports' ``main``s:
   the fused-DP NaN repro at 1200 steps (every variant PASS, the DP
   kernels' launches as counted), ``import_hf_bert`` on a synthetic
   BERT-base state dict as ``.bin`` and as ``.safetensors`` (the trees equal
   bit for bit, the imported BERT card against CPU), ``recover_vocab`` on a
   seeded mini-reference (every row byte-exact), the graft entry's check (4
   bf16 attention launches) and its full-size dry run on two ranks over gloo
   (mesh against single-rank parity), ``r5_modal_seeds`` at one epoch on
   path 11's tree and run directory, ``scripts.data`` on path 11's raw rows
   and ``r5_accuracy``'s tree phase on the mini-reference;
2. the untruncated 512-token f32 trainer through
   ``TrainAndTest.train_on(auto_truncate=False)`` and ``Trainer.fit``, two
   epochs, where every BERT self-attention runs the attention kernels;

checks that each path went through its kernels (launches by dtype, the
eval as one batched forward an epoch) and its logits on the card against
the CPU (f32 with the composed and the fused DP block; bf16 at a bf16
tolerance), profiles one train step of each (device time by kernel, the
host's kernel launches and top host ops; at S = 80 with the attention gate
open and closed, bf16 with ``precast_params`` and with the in-step cast
beside f32, and the fast modes beside f32, each once), times the eval epoch
batched against the batch loop at 601 rows, and times every kernel
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
           "attn_fwd": "eeg_multimodal_torch/csrc/attention_f32.cu",
           "attn_bwd": "eeg_multimodal_torch/csrc/attention_f32.cu"}
# the bf16 attention kernels (wgmma + TMA) have a source of their own
BF16_SOURCE = "eeg_multimodal_torch/csrc/attention_bf16.cu"
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
# main path 9's attention: the MLM pretrainer's BERT-base at batch 128 and
# S = 128 (build_corpus rounds the longest corpus row up to 128) with keys
# padded past the committed rows' 65 tokens, bf16, p = 0.1; the contrastive
# pretrainer's ViT-B/32 in training at batch 128, S = 50, bf16, zero bias,
# p = 0, forward and backward; each with a tail batch of 2
MLM_ATTN_SHAPES = ((128, 12, 128, 64), (2, 12, 128, 64))
VIT_TRAIN_SHAPES = ((128, 12, 50, 64), (2, 12, 50, 64))
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


_START = time.time()


def phase(name):
    print(f"== [{time.time() - _START:.0f} s] {name}", flush=True)


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
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"  {label}: train step {step_ms:.2f} ms ({1e3 / step_ms:.2f} steps/s)" + (
        f"; matmul work ~{flops / 1e9:.0f} GFLOP/step ({work}) = "
        f"{flops / F32_OPS_PER_S * 1e3:.2f} ms at the f32 peak" if flops else ""))
    host = {}
    by_kernel = device_us(torch, step, n=2, host=host)
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
    shapes (8, 12, 80, 64) and (8, 12, 512, 64), path 9's MLM shapes
    (``MLM_ATTN_SHAPES``, bf16, the keys past 65 masked), the DP-SGD path's
    (B, 12, 80, 64) f32 for each B of ``dpsgd_bs`` (``dpsgd_batches``: the
    windows at the smoke's and the paper's rows, and the batched eval),
    and (8, 12, S, 64) for each S of ``zoo_seqs`` (the zoo phase's text
    lengths), in f32 and bf16, and at smaller ones (the tiles' edges: S = 32,
    50, 65, 150, 197 and D = 128 at S = 65 to 512); at each DP-SGD window
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
    # the f32 kernels' tiles (attention_f32.cu): S no multiple of the 32-key
    # and 32-query tiles or of the two-warpgroup blocks' 128 rows, and S
    # whose two-warpgroup dQ blocks reach past the mask bytes' 64-row tiles
    # (32, 50, 150); D = 128, its own tiles
    cases += [(2, 3, 65, 64, torch.float32), (2, 3, 197, 64, torch.float32),
              (2, 3, 32, 64, torch.float32), (2, 3, 50, 64, torch.float32),
              (2, 3, 150, 64, torch.float32), (2, 3, 65, 128, torch.float32),
              (2, 3, 128, 128, torch.float32), (2, 3, 197, 128, torch.float32),
              (2, 3, 256, 128, torch.float32)]
    # the bf16 kernels' tiles: 64 rows a block, 64 keys (32 queries in dK/dV)
    # a tile, D in two 64-column panels at 128, S no multiple of 64
    cases += [(8, 12, 128, 64, torch.bfloat16), (8, 12, 256, 64, torch.bfloat16),
              (2, 3, 65, 64, torch.bfloat16), (2, 3, 197, 64, torch.bfloat16),
              (1, 2, 512, 128, torch.bfloat16), (2, 3, 128, 128, torch.bfloat16),
              (2, 3, 256, 128, torch.bfloat16), (2, 3, 65, 128, torch.bfloat16),
              (2, 3, 197, 128, torch.bfloat16)]
    windows, eval_b = dpsgd_bs
    cases += [(B, 12, 80, 64, torch.float32) for B in windows + (eval_b,)
              if (B, 12, 80, 64, torch.float32) not in cases]
    cases += [(8, 12, S, 64, dtype) for S in sorted(zoo_seqs)
              for dtype in (torch.float32, torch.bfloat16)
              if (8, 12, S, 64, dtype) not in cases]
    mlm = [(*shape, torch.bfloat16) for shape in MLM_ATTN_SHAPES]  # path 9's MLM
    for B, H, S, D, dtype in cases + mlm:
        f32 = dtype == torch.float32
        fwd_tol = ATTN_TOL["f32_fwd" if f32 else "bf16"]
        bwd_tol = ATTN_TOL["f32_bwd" if f32 else "bf16"]
        # packed (B, S, 3, H, D) projections: q, k, v are strided views, as
        # the BERT path passes them
        qkv = torch.randn(B, S, 3, H, D, generator=gen, device=dev).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias = torch.zeros(B, S, device=dev)
        if (B, H, S, D, dtype) in mlm:  # the corpus rows' padding past 65 tokens
            bias[:, VALID_TOKENS:] = NEG
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


OFFSET_SHAPES = ((8, 12, 80, 64, "float32"), (8, 12, 80, 64, "bfloat16"),
                 (8, 12, 128, 64, "float32"))
# the blocks of a (2, 2) layout: (b0, h0) of 4 rows and 6 heads
OFFSET_BLOCKS = ((0, 0), (0, 6), (4, 0), (4, 6))


def check_offset_kernels(torch, A, K, gen, dev):
    """The kernels' global offsets (a rank's block of a (data, model)
    layout): at path 1's (8, 12, 80, 64) in f32 and bf16 and at (8, 12, 128,
    64) f32, each (b0, h0) block of 4 rows and 6 heads of a (2, 2) layout,
    its mask (``attn_dropout_mask`` with the block, and ``keep_mask_plain``
    with it) equal to the slice of the global mask, bit for bit, and its
    forward and backward outputs the slices of the global call's, within
    the existing tolerances; the DP block at (8, 2304) with r0 = 4 equal to
    rows 4-7 of the global call, forward and df bit for bit, and dDP the
    plain version's of those rows. Returns the max errors by kernel."""
    err = {"attn_fwd_block": 0.0, "attn_bwd_block": 0.0, "dp_fwd_r0": 0.0, "dp_bwd_r0": 0.0}
    bits = []
    for B, H, S, D, dt in OFFSET_SHAPES:
        dtype = getattr(torch, dt)
        f32 = dtype == torch.float32
        fwd_tol = ATTN_TOL["f32_fwd" if f32 else "bf16"]
        bwd_tol = ATTN_TOL["f32_bwd" if f32 else "bf16"]
        qkv = torch.randn(B, S, 3, H, D, generator=gen, device=dev).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias = torch.zeros(B, S, device=dev)
        bias[:, VALID_TOKENS:] = NEG
        dout = torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
        seed = torch.tensor([31 + S], dtype=torch.int64, device=dev)
        mask = A.attn_dropout_mask(seed, B, H, S, ATTN_DROP)
        out, stats = A.attn_fwd(q, k, v, bias, seed, ATTN_DROP)
        grads = A.attn_bwd(q, k, v, bias, seed, ATTN_DROP, out, stats, dout)
        equal = True
        for b0, h0 in OFFSET_BLOCKS:
            blk = A.Block(b0, B, h0, H)
            rows, heads = slice(b0, b0 + B // 2), slice(h0, h0 + H // 2)
            part = A.attn_dropout_mask(seed, B // 2, H // 2, S, ATTN_DROP, blk)
            check(torch.equal(part, mask[rows, heads]),
                  f"the mask of block {(b0, h0)} at {(B, H, S, D)} is not the global slice")
            check(torch.equal(part.bool(), A.keep_mask_plain(seed.tolist(), B // 2, H // 2, S,
                                                             ATTN_DROP, dev, blk)),
                  f"attn_dropout_mask differs from keep_mask_plain at block {(b0, h0)}")
            qb, kb, vb = (t[rows, heads] for t in (q, k, v))
            ob, sb = A.attn_fwd(qb, kb, vb, bias[rows], seed, ATTN_DROP, blk)
            torch.testing.assert_close(ob.float(), out[rows, heads].float(), **fwd_tol)
            gb = A.attn_bwd(qb, kb, vb, bias[rows], seed, ATTN_DROP, ob, sb,
                            dout[rows, heads].contiguous(), blk)
            e_b = 0.0
            for name, g, want in zip("qkv", gb, grads):
                torch.testing.assert_close(g.float(), want[rows, heads].float(), **bwd_tol,
                                           msg=lambda m: f"d{name} of block {(b0, h0)}: {m}")
                e_b = max(e_b, float((g.float() - want[rows, heads].float()).abs().max()))
                equal &= torch.equal(g, want[rows, heads])
            equal &= torch.equal(ob, out[rows, heads])
            err["attn_fwd_block"] = max(err["attn_fwd_block"],
                                        float((ob.float() - out[rows, heads].float()).abs().max()))
            err["attn_bwd_block"] = max(err["attn_bwd_block"], e_b)
        bits.append(f"{(B, H, S, D)} {dt}: {'bit for bit' if equal else 'within tolerance'}")
    print("  attention blocks of a (2, 2) layout: masks equal the global slices bit for bit; "
          "outputs " + "; ".join(bits))
    B, F = 8, 2304
    f = torch.randn(B, F, generator=gen, device=dev)
    dp = torch.randn(1, F, generator=gen, device=dev)
    g = torch.randn(B, F, generator=gen, device=dev)
    s = torch.tensor([77], dtype=torch.int64, device=dev)
    whole = K.dp_fwd(f, dp, EPS, s)
    part = K.dp_fwd(f[4:].contiguous(), dp, EPS, s, 4)
    check(torch.equal(part, whole[4:]), "the DP forward at r0 = 4 is not rows 4-7 of the call")
    noise = K.laplace_plain(77, (4, F), dev, r0=4)
    check(torch.equal(noise, K.laplace_plain(77, (B, F), dev)[4:]),
          "laplace_plain at r0 = 4 is not rows 4-7")
    plain = K.dp_block_plain(f[4:], dp, EPS, noise)
    err["dp_fwd_r0"] = float((part - plain).abs().max())
    df_w, _ = K.dp_bwd(f, dp, EPS, s, g)
    df, ddp = K.dp_bwd(f[4:].contiguous(), dp, EPS, s, g[4:].contiguous(), r0=4)
    check(torch.equal(df, df_w[4:]), "the DP backward's df at r0 = 4 is not rows 4-7")
    df_p, ddp_p = K.dp_block_bwd_plain(f[4:], dp, EPS, noise, g[4:])
    torch.testing.assert_close(ddp, ddp_p, rtol=2e-3, atol=1e-4)
    err["dp_bwd_r0"] = max(float((ddp - ddp_p).abs().max()), float((df - df_p).abs().max()))
    print(f"  DP block at (8, 2304), r0 = 4: forward and df equal rows 4-7 of the global call "
          f"bit for bit; max|kernel - plain| forward {err['dp_fwd_r0']:.3g}, backward "
          f"{err['dp_bwd_r0']:.3g}")
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
    equal to the kernel bit for bit. Then the tower in training, path 9's
    shapes (``VIT_TRAIN_SHAPES``, bf16): ``attn_fwd`` and ``attn_bwd``
    against their plain versions at the bf16 tolerance, the ragged S = 50
    in the backward's 16-query / 64-key tiles, and ``vit.attention``'s
    autograd gradients equal to ``attn_bwd``'s. Returns ``{(B, H, S, D):
    max |kernel - plain|}`` (f32 forward) and ``{(kernel, (B, H, S, D)):
    max |kernel - plain|}`` (bf16)."""
    from eeg_multimodal_torch.models import vit

    train_err = {}
    for B, H, S, D in VIT_TRAIN_SHAPES:
        q, k, v = (t.to(torch.bfloat16) for t in vit_qkv(torch, gen, dev, B, H, S, D))
        W = H * D  # the packed bf16 projection's views, as the bf16 tower passes them
        qkv = torch.cat([t.transpose(1, 2).reshape(B, S, W) for t in (q, k, v)], dim=-1)
        q, k, v = (qkv[..., i * W:(i + 1) * W].reshape(B, S, H, D).transpose(1, 2)
                   for i in range(3))
        bias = torch.zeros(B, S, device=dev)
        seed = torch.zeros(1, dtype=torch.int64, device=dev)
        dout = torch.randn(B, H, S, D, generator=gen, device=dev).to(torch.bfloat16)
        out, stats = A.attn_fwd(q, k, v, bias, seed, 0.0)
        plain = A.attention_plain(q, k, v, bias)
        torch.testing.assert_close(out.float(), plain.float(), **ATTN_TOL["bf16"])
        grads = A.attn_bwd(q, k, v, bias, seed, 0.0, out, stats, dout)
        plain_g = A.attention_bwd_plain(q, k, v, bias, None, 0.0, dout)
        for name, g, pg in zip("qkv", grads, plain_g):
            torch.testing.assert_close(g.float(), pg.float(), **ATTN_TOL["bf16"],
                                       msg=lambda m: f"d{name}: {m}")
        train_err[("attn_fwd", (B, H, S, D))] = float((out.float() - plain.float()).abs().max())
        train_err[("attn_bwd", (B, H, S, D))] = max(float((g.float() - pg.float()).abs().max())
                                                    for g, pg in zip(grads, plain_g))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(vit.attention(*leaves), leaves, dout)
        check(all(torch.equal(a, g) for a, g in zip(auto, grads)),
              "the training tower's attention gradients differ from attn_bwd's")
        print(f"  {(B, H, S, D)} bf16 p=0, zero bias, packed-QKV views, forward and backward: "
              f"max|out - plain| {train_err[('attn_fwd', (B, H, S, D))]:.3g}, max|grad - plain| "
              f"{train_err[('attn_bwd', (B, H, S, D))]:.3g}")

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
    return err, train_err


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


# the bf16 attention launches at S = 512 of path 11's bench_attention run
# (its S = 512 rows), for the kernels line's S = 512 bf16 rows
SEQ_LAUNCHES = {}


class LaunchesAt:
    """Counts, beside the wrappers' own counts, the launches of each kernel
    whose first argument is a (B, H, S, D) tensor of ``dtype`` at the given
    S: ``counts`` by kernel name. The wrappers' counts are by dtype only."""

    def __init__(self, kernels, dtype, seq):
        self.kernels, self.dtype, self.seq = kernels, dtype, seq
        self.counts = {k.name: 0 for k in kernels}

    def __enter__(self):
        self.saved = [k._launch for k in self.kernels]
        for k, launch in zip(self.kernels, self.saved):
            def counted(*args, _launch=launch, _name=k.name, **kwargs):
                out = _launch(*args, **kwargs)
                if args[0].dtype == self.dtype and args[0].shape[2] == self.seq:
                    self.counts[_name] += 1
                return out
            k._launch = counted
        return self

    def __exit__(self, *exc):
        for k, launch in zip(self.kernels, self.saved):
            k._launch = launch


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
    dropout off (``MEMBER_TOL``); the member step profiled beside five
    single-member steps, with the peak memory each adds; then the
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

    phase(f"profile: the {M}-member step beside {M} single-member steps "
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

    # once each, not in turns: the smoke's time limit
    for label, fn in (("members", member_step), ("singles", single_member_steps)):
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


# Each fast-mode sweep member against its own Trainer.fit on the card, set
# before the check's first run: the f32 losses and accuracies as path 7's
# member step (MEMBER_TOL) and F1 within 1e-6; bf16's losses within 5e-3
# relative (the batched and the single GEMMs round apart, once each, in
# bf16), its accuracies and F1 printed (a prediction at a near-tie may flip).
FAST_SWEEP_F1_ABS, FAST_SWEEP_BF16_RTOL = 1e-6, 5e-3


def run_fast_sweeps(torch, dev, rng, all_kernels, layers, steps):
    """Main path 7's fast modes: the 5-member sweep over
    ``privacy_utility_frontier()`` with ``share_phase_dropout`` (features
    encoded once, f32, fused DP) and with ``paired_phase_encode`` (bf16
    compute), one epoch each, held to one single model's ``Trainer.fit``
    with that mode (launches by dtype equal: one set a step, whatever M),
    and each member's row to its own ``Trainer.fit`` (the bounds above);
    the member step of each mode profiled beside the faithful member step
    (one profile each: the smoke's time limit)."""
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.train.sweep import MemberSteps, SweepRunner, privacy_utility_frontier
    from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer

    members = privacy_utility_frontier()
    M = len(members)
    train, test = D.truncate_pair(synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL))
    fused = dataclasses.replace(fusion.config_for("ti", "lapacian_dropout"), fused_dp_kernel=True)
    cases = (("share_phase_dropout + reuse, f32", TrainConfig(epochs=1, share_phase_dropout=True)),
             ("paired_phase_encode, bf16", TrainConfig(epochs=1, compute_dtype="bfloat16",
                                                       paired_phase_encode=True)))
    train_dev = train.to_device(dev)
    batch = D.gather_batch(train_dev, torch.arange(8, device=dev))
    w = torch.ones(8, device=dev)
    for label, tc in cases:
        phase(f"main path 7: a {M}-member sweep with {label}, fused DP, S = 80, one epoch, "
              "against one model's fit with that mode")
        for k in all_kernels:
            k.reset()
        single = Trainer(fused, tc).fit(train, test, EPS, echo=False)
        want = {k.name: dict(k.by_dtype) for k in all_kernels}
        for k in all_kernels:
            k.reset()
        t0 = time.perf_counter()
        runner = SweepRunner(fused, tc, members)
        res = runner.run(train, test, echo=False)
        wall = time.perf_counter() - t0
        check_launches({k.name: dict(k.by_dtype) for k in all_kernels}, want,
                       f"{M}-member sweep, {label}")
        check(all(math.isfinite(r["history"][0][key]) for r in res for key in ROW),
              f"{label}: non-finite row")
        check(len({r["history"][0]["train_loss"] for r in res}) == M,
              f"{label}: the members trained alike")
        print(f"  {wall:.2f} s (init included)")
        f32 = tc.compute_dtype == "float32"
        worst = 0.0
        for m, r in zip(members, res):  # one seed: each member is a Trainer at its epsilon
            alone = single if m.epsilon == EPS else Trainer(fused, tc).fit(
                train, test, m.epsilon, echo=False)
            a, b = r["history"][0], alone["history"][0]
            for key in ("train_loss", "test_loss") + (("train_acc", "test_acc") if f32 else ()):
                rtol, atol = ((MEMBER_TOL["rtol"], MEMBER_TOL["atol"]) if f32
                              else (FAST_SWEEP_BF16_RTOL, 0.0))
                check(abs(a[key] - b[key]) <= atol + rtol * abs(b[key]),
                      f"{label}, epsilon {m.epsilon}: {key} {a[key]} against its fit's {b[key]}")
                if key.endswith("loss"):
                    worst = max(worst, abs(a[key] - b[key]) / abs(b[key]))
            if f32:
                check(abs(a["f1"] - b["f1"]) <= FAST_SWEEP_F1_ABS,
                      f"{label}, epsilon {m.epsilon}: F1 {a['f1']} against {b['f1']}")
            print(f"  epsilon {m.epsilon:>5}: member train loss {a['train_loss']:.6f} / fit "
                  f"{b['train_loss']:.6f}, test loss {a['test_loss']:.6f} / "
                  f"{b['test_loss']:.6f}, accuracy {a['test_acc']:.4f} / {b['test_acc']:.4f}, "
                  f"F1 {a['f1']:.4f} / {b['f1']:.4f}")
        print(f"  each member against its own Trainer.fit: max relative loss error {worst:.3g}")
        phase(f"profile: the {M}-member step with {label}, then the faithful member step")
        fast_steps, params, dp_os, model_os = runner.init_members(members)
        faith_steps = MemberSteps(fused, dataclasses.replace(
            tc, share_phase_dropout=False, paired_phase_encode=False), M, dev)
        eps_t = torch.tensor([m.epsilon for m in members], dtype=torch.float64, device=dev)
        gens = tuple(torch.Generator(device=dev).manual_seed(60 + m) for m in range(M))
        states = [dp_os, model_os]

        def step_with(steps_m):
            def step():
                states[:] = steps_m.train_step(params, *states, batch, w, eps_t, gens)[:2]
            return step

        for name, st in (("fast", fast_steps), ("faithful", faith_steps)):
            profile_step(torch, step_with(st),
                         f"{M} members, {label if name == 'fast' else 'the faithful step'}")
        del params, states, fast_steps, faith_steps, runner
        torch.cuda.empty_cache()


def time_offset_calls(torch, A, K, gen, dev, err, block_launches):
    """The offset calls of path 10's ranks, timed: the attention kernels on
    a (4, 6, 80, 64) f32 block (b0 = 4, h0 = 6 of (8, 12)), p = 0.1, and the
    DP kernels on rows 4-7 of (8, 2304); each beside the call of its own at
    the same shape (their times should agree within noise), its plain
    version and, for attention, SDPA. Returns the kernels line's rows."""
    import torch.nn.functional as TF

    rows = []
    B, H, S, D = 4, 6, 80, 64
    qkv = torch.randn(2 * B, S, 3, 2 * H, D, generator=gen, device=dev)
    q, k, v = (qkv[4:, :, i, 6:].transpose(1, 2) for i in range(3))
    bias = torch.zeros(B, S, device=dev)
    bias[:, VALID_TOKENS:] = NEG
    dout = torch.randn(B, H, S, D, generator=gen, device=dev)
    s = torch.tensor([13], dtype=torch.int64, device=dev)
    blk = A.Block(4, 2 * B, 6, 2 * H)
    out, stats = A.attn_fwd(q, k, v, bias, s, ATTN_DROP, blk)
    keep = A.attn_dropout_mask(s, B, H, S, ATTN_DROP, blk).bool()
    calls = {
        "attn_fwd": (lambda: A.attn_fwd(q, k, v, bias, s, ATTN_DROP, blk),
                     lambda: A.attn_fwd(q, k, v, bias, s, ATTN_DROP),
                     lambda: A.attention_plain(q, k, v, bias, keep, ATTN_DROP),
                     lambda: TF.scaled_dot_product_attention(q, k, v,
                                                             attn_mask=bias[:, None, None, :],
                                                             dropout_p=ATTN_DROP)),
        "attn_bwd": (lambda: A.attn_bwd(q, k, v, bias, s, ATTN_DROP, out, stats, dout, blk),
                     lambda: A.attn_bwd(q, k, v, bias, s, ATTN_DROP, out, stats, dout),
                     lambda: A.attention_bwd_plain(q, k, v, bias, keep, ATTN_DROP, dout), None),
    }
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        return torch.autograd.grad(TF.scaled_dot_product_attention(
            *leaves, attn_mask=bias[:, None, None, :], dropout_p=ATTN_DROP), leaves, dout)

    def in_turns(kern, own, iters=200):
        """Each call timed twice, in turns (offset, own, own, offset): the
        means, and the four readings."""
        t = [time_ms(torch, fn, iters, 5) for fn in (kern, own, own, kern)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t

    for name, (kern, own, plain, lib) in calls.items():
        offset, own_ms, turns = in_turns(kern, own, 100)
        t = {"offset": offset, "own": own_ms, "plain": time_ms(torch, plain, 50, 5)}
        if lib is not None:
            t["sdpa"] = time_ms(torch, lib, 100, 5)
        else:
            t["sdpa"] = time_ms(torch, sdpa_fwd_bwd, 100, 5) - time_ms(torch, calls["attn_fwd"][3],
                                                                      100, 5)
        bms, by = attn_bound_ms(name, B, H, S, D, 4)
        print(f"  {name} block {(B, H, S, D)} f32 (b0 = 4, h0 = 6): offset call "
              f"{t['offset'] * 1e3:.2f} us, the call of its own {t['own'] * 1e3:.2f} us (in "
              f"turns: {', '.join(f'{x * 1e3:.2f}' for x in turns)}), plain "
              f"{t['plain'] * 1e3:.2f} us, SDPA {t['sdpa'] * 1e3:.2f} us; bound {bms * 1e3:.3f} "
              f"us ({by})")
        rows.append({"name": f"{name}_block", "route": ROUTES[name], "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": block_launches[f"{name}_block"],
                     "max_abs_err": err[f"{name}_block"], "ms": t["offset"],
                     "plain_ms": t["plain"], "bound_ms": bms, "bound_by": by,
                     "library_ms": t["sdpa"]})
    F = 2304
    f = torch.randn(2 * B, F, generator=gen, device=dev)[4:]
    dp = torch.randn(1, F, generator=gen, device=dev)
    g = torch.randn(B, F, generator=gen, device=dev)
    s = torch.tensor([5], dtype=torch.int64, device=dev)
    calls = {
        "dp_fwd": (lambda: K.dp_fwd(f, dp, EPS, s, 4), lambda: K.dp_fwd(f, dp, EPS, s),
                   lambda: K.dp_block_plain(f, dp, EPS, K.laplace_plain(5, (B, F), dev, r0=4))),
        "dp_bwd": (lambda: K.dp_bwd(f, dp, EPS, s, g, r0=4), lambda: K.dp_bwd(f, dp, EPS, s, g),
                   lambda: K.dp_block_bwd_plain(f, dp, EPS, K.laplace_plain(5, (B, F), dev, r0=4),
                                                g)),
    }
    for name, (kern, own, plain) in calls.items():
        offset, own_ms, turns = in_turns(kern, own)
        t = {"offset": offset, "own": own_ms, "plain": time_ms(torch, plain, 20, 5)}
        bms, by = dp_bound_ms(name, B, F)
        print(f"  {name} rows 4-7 of (8, {F}) (r0 = 4): offset call {t['offset'] * 1e3:.2f} us, "
              f"the call of its own {t['own'] * 1e3:.2f} us (in turns: "
              f"{', '.join(f'{x * 1e3:.2f}' for x in turns)}), plain {t['plain'] * 1e3:.2f} us; "
              f"bound {bms * 1e3:.4f} us ({by})")
        rows.append({"name": f"{name}_r0", "route": ROUTES[name], "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": block_launches[f"{name}_r0"],
                     "max_abs_err": err[f"{name}_r0"], "ms": t["offset"],
                     "plain_ms": t["plain"], "bound_ms": bms, "bound_by": by,
                     "library_ms": None})
    return rows


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


def write_raw_tasks(root, rows, seed=8):
    """Raw task txt files under ``root``/raw, one of ``rows[i]`` rows each,
    made with numpy: time, 25 motion channels, 30 EEG channels (values whose
    text stays within BERT's 80-token cut), a binary label. Returns their
    paths."""
    os.makedirs(os.path.join(root, "raw"))
    rng = np.random.RandomState(seed)
    raws = []
    for i, n in enumerate(rows):
        data = np.concatenate([np.arange(n)[:, None], rng.randint(-2048, 2048, (n, 25)),
                               rng.randint(-300, 300, (n, 30)), rng.randint(0, 2, (n, 1))],
                              axis=1)
        raws.append(os.path.join(root, "raw", f"task_{i + 1}.txt"))
        np.savetxt(raws[-1], data, fmt="%.1f")
    return raws


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
    raws = write_raw_tasks(root, RAW_ROWS)
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
    torch.cuda.empty_cache()
    return embed, root


# main path 9: the distiller's steps (a few hundred of the CLI's 4000), the
# contrastive and MLM pretrainers' steps, the MLM batch (the CLI's default)
DISTILL_STEPS, CLIP_STEPS, MLM_STEPS, MLM_BATCH = 300, 20, 40, 128
# the (601, 512) f32 stand-in for the reference's real test-split CLIP
# array (feature/action/test_clip_v2.pickle), which the repo does not hold
STAND_IN_SEED = 601


def run_pretext(torch, dev, all_kernels, layers, root):
    """Main path 9, the pretext pipeline at full width, from path 8's tree
    ``root`` (2402 / 601 rows): ``cli distill`` (no kernel) into a new tree
    from a seeded stand-in for the real CLIP array; the rendering-inversion
    ``ContrastivePretrainer`` at ViT-B/32, batch 128, bf16 (``attn_fwd`` and
    ``attn_bwd`` 24 a step), its tower pickled and re-embedded through
    ``GetEmbedding(clip_weights=...)``; ``cli pretrain`` with every pretext
    at BERT-base on the compact vocab, bf16 (12 / 12 a MLM step at (128,
    12, 128, 64)), then one DP-MLD epoch at 2402 / 601 (path 8's counts, in
    bf16); ``ResumableTrainer`` (f32, 64 / 32 rows) resumed against an
    unbroken run; ``pretrain_finetune`` one epoch a stage. Every count is
    held to its prediction; the MLM and contrastive steps are profiled and
    run once under sync debug mode "error". Returns the attention launches
    by pretrainer."""
    from eeg_multimodal_torch import cli
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.data import image_transform as IT
    from eeg_multimodal_torch.data.embedding import GetEmbedding
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.models import vit
    from eeg_multimodal_torch.train import api, contrastive as C, distill, mlm
    from eeg_multimodal_torch.train import pipeline as P
    from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
    from eeg_multimodal_torch.utils.trees import tree_items, tree_map

    def reset():
        for k in all_kernels:
            k.reset()

    def by_dtype():
        return {k.name: dict(k.by_dtype) for k in all_kernels if k.launches}

    out = {}
    phase("main path 9: cli distill (the act CLIP arrays of the train split from the test "
          "split's), no kernel")
    tree9 = os.path.join(root, "pretext_tree")
    stand_in = os.path.join(root, "test_clip_stand_in.pickle")
    with open(stand_in, "wb") as f:
        pickle.dump(np.random.RandomState(STAND_IN_SEED).randn(601, 512).astype(np.float32), f)
    print(f"  the real CLIP array (feature/action/test_clip_v2.pickle) is not in the repo: a "
          f"(601, 512) f32 array from numpy seed {STAND_IN_SEED} stands in for it")
    metrics = []
    real_build = distill.build_distilled_act_tree

    def build(*a, **kw):
        metrics.append(real_build(*a, **kw))
        return metrics[-1]

    distill.build_distilled_act_tree = build
    reset()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["distill", "--data_root", root, "--out", tree9, "--real_test_pickle",
                       stand_in, "--steps", str(DISTILL_STEPS)])
    finally:
        distill.build_distilled_act_tree = real_build
    print(f"  cli distill: rc {rc}, {time.perf_counter() - t0:.2f} s for {DISTILL_STEPS} steps "
          f"x 2 fits; metrics {metrics[0]}")
    check(rc == 0 and math.isfinite(metrics[0]["val_cosine_mean"]), "distill failed")
    check_launches(launches_by_name(all_kernels),
                   {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": 0, "attn_bwd": 0}, "cli distill")
    save = os.path.join(tree9, "data", "embedding", "act", "img", "clip_ViT_B_32")
    for split, n in (("train", 2402), ("test", 601)):
        with open(os.path.join(save, f"{split}.pickle"), "rb") as f:
            arr = pickle.load(f)
        check(type(arr) is np.ndarray and arr.dtype == np.float32 and arr.shape == (n, 512)
              and np.isfinite(arr).all(), f"distilled {split}: {getattr(arr, 'shape', arr)}")
        print(f"  wrote act/img/clip_ViT_B_32/{split}.pickle: {arr.shape} float32")

    phase("main path 9: ContrastivePretrainer, ViT-B/32 (width 768, 12 layers), batch 128, "
          f"bf16, {CLIP_STEPS} steps")
    proc = os.path.join(tree9, "data", "processed")
    eeg_rows = D.load_feature_csv(os.path.join(proc, "train_EEG.csv"))
    act_rows = D.load_feature_csv(os.path.join(proc, "train_act.csv"))
    ccfg = C.ContrastiveConfig(total_steps=CLIP_STEPS, log_every=10, warmup_steps=5)
    vcfg = vit.ViTConfig()
    check((ccfg.batch_size, ccfg.compute_dtype, vcfg.width, vcfg.layers, vcfg.seq_len)
          == (128, "bfloat16", 768, 12, 50), "not the full-width contrastive configuration")
    pre = C.ContrastivePretrainer(vcfg, ccfg, eeg_dim=eeg_rows.shape[1],
                                  act_dim=act_rows.shape[1])
    conv0 = pre.params["vit"]["conv"].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    tower, hist = pre.fit(eeg_rows, act_rows, echo=False)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out["clip"] = launches_by_name(all_kernels)
    print(f"  {sec:.2f} s for {CLIP_STEPS} steps ({sec / CLIP_STEPS * 1e3:.1f} ms a step with "
          f"the first's warm-up, {CLIP_STEPS * 2 * ccfg.batch_size / sec:.1f} images/s); history "
          f"{hist}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; by dtype "
          f"{by_dtype()}")
    per = 2 * vcfg.layers * CLIP_STEPS  # two tower passes a step, a launch a layer each
    check_launches(out["clip"], {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": per, "attn_bwd": per},
                   "ContrastivePretrainer.fit")
    check(attention_dtypes(all_kernels) == {"bfloat16"},
          "the bf16 tower launched another dtype")
    check(all(math.isfinite(h["loss"]) for h in hist), f"non-finite loss {hist}")
    check(not torch.equal(tower["conv"], conv0), "the tower did not change")

    phase("profile: one contrastive step (batch 128, both towers, bf16)")
    n = eeg_rows.shape[0]
    rows = {"eeg": torch.as_tensor(eeg_rows, device=dev),
            "act": torch.as_tensor(act_rows, device=dev)}
    rows["eeg_t"], rows["act_t"] = C.standardize(rows["eeg"]), C.standardize(rows["act"])
    g = torch.Generator(device=dev).manual_seed(9)
    torch.cuda.reset_peak_memory_stats()
    profile_step(torch, lambda: pre.step(rows, torch.randint(0, n, (128,), generator=g,
                                                             device=dev)),
                 "contrastive step", work="2 tower forwards + backward")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    no_sync_step(torch, lambda: pre.step(rows, torch.randint(0, n, (128,), generator=g,
                                                             device=dev)), "contrastive")

    phase("main path 9: the pretrained tower through GetEmbedding(clip_weights=...), "
          "ViT-B/32, both modals and splits")
    tower_path = os.path.join(root, "vit_clip.pickle")
    with open(tower_path, "wb") as f:
        pickle.dump(tree_map(lambda t: t.detach().cpu().numpy(), tower), f)
    del pre, rows
    reset()
    t0 = time.perf_counter()
    GetEmbedding(["act", "EEG"], ["train", "test"], data_root=tree9,
                 clip_weights=tower_path).get_img_encode([["clip", "ViT-B/32"]])
    chunks = -(-2402 // 16) + -(-601 // 16)
    check_launches(launches_by_name(all_kernels), {"dp_fwd": 0, "dp_bwd": 0,
                                                   "attn_fwd": 2 * 12 * chunks, "attn_bwd": 0},
                   "GetEmbedding with the pretrained tower")
    print(f"  {time.perf_counter() - t0:.2f} s")
    for modal in ("act", "EEG"):
        with open(os.path.join(tree9, "data", "embedding", modal, "img", "clip_ViT_B_32",
                               "test.pickle"), "rb") as f:
            feats = pickle.load(f)
        check(feats.shape == (601, 512) and np.isfinite(feats).all(), f"{modal} features")
        with torch.inference_mode():
            rows2 = torch.from_numpy(D.load_feature_csv(os.path.join(
                proc, f"test_{modal}.csv"))[:4]).to(dev)
            to_img = IT.act_to_images if modal == "act" else IT.eeg_to_images
            want = vit.encode_image(tree_map(lambda t: t.to(dev), tower), to_img(rows2),
                                    vcfg).cpu().numpy()
        np.testing.assert_allclose(feats[:4], want, **EMBED_TOL)
        print(f"  {modal} test features (601, 512) equal the tower's own on 4 rows "
              f"(max diff {np.abs(feats[:4] - want).max():.3g})")

    phase(f"main path 9: cli pretrain, BERT-base on the compact vocab, bf16, every pretext, "
          f"{MLM_STEPS} MLM steps at batch {MLM_BATCH}, then one DP-MLD epoch at 2402 / 601")
    run9 = os.path.join(root, "mlm_run")
    seen = {"losses": []}
    real_fit, real_step = mlm.MLMPretrainer.fit, mlm.MLMPretrainer.step
    real_train_on = api.TrainAndTest.train_on

    def step(self, *a, **kw):  # keeps each step's loss, a device scalar: no sync
        seen["losses"].append(real_step(self, *a, **kw))
        return seen["losses"][-1]

    def fit(self, *a, **kw):
        seen["pre"], seen["fit"] = self, (a, kw)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = real_fit(self, *a, **kw)
        torch.cuda.synchronize()
        seen["mlm_s"], seen["mlm_peak"] = time.perf_counter() - t, torch.cuda.max_memory_allocated()
        return res

    def train_on(self, *a, **kw):
        seen["mlm_launches"], seen["mlm_dtypes"] = launches_by_name(all_kernels), by_dtype()
        seen["fine_t0"] = time.perf_counter()
        reset()
        return real_train_on(self, *a, **kw)

    mlm.MLMPretrainer.fit, mlm.MLMPretrainer.step = fit, step
    api.TrainAndTest.train_on = train_on
    reset()
    try:
        rc = cli.main(["pretrain", "--data_root", tree9, "--out", run9, "--mlm_steps",
                       str(MLM_STEPS), "--mlm_batch", str(MLM_BATCH), "--epochs", "1",
                       "--row_reg_weight", "1.0", "--aug_factor", "1", "--whole_word",
                       "--clip_weight", "0.5"])
    finally:
        mlm.MLMPretrainer.fit, mlm.MLMPretrainer.step = real_fit, real_step
        api.TrainAndTest.train_on = real_train_on
    fine_s = time.perf_counter() - seen["fine_t0"]
    pre9 = seen["pre"]
    corpus_ids = seen["fit"][0][0]
    print(f"  cli pretrain: rc {rc}; MLM corpus {corpus_ids.shape} (S = "
          f"{corpus_ids.shape[1]}), compact vocab {pre9.bert_cfg.vocab_size}, BERT "
          f"{pre9.bert_cfg.num_layers} layers x {pre9.bert_cfg.hidden_size}; MLM "
          f"{seen['mlm_s']:.2f} s ({seen['mlm_s'] / MLM_STEPS * 1e3:.1f} ms a step with the "
          f"first's warm-up, {MLM_STEPS * MLM_BATCH * corpus_ids.shape[1] / seen['mlm_s']:.0f} "
          f"tokens/s), peak {seen['mlm_peak'] / 2**30:.2f} GiB; the fine-tune {fine_s:.2f} s")
    check(rc == 0, f"cli pretrain returned {rc}")
    check(corpus_ids.shape == (4 * 2402, 128) and pre9.bert_cfg.num_layers == 12
          and pre9.bert_cfg.hidden_size == 768 and pre9.cfg.compute_dtype == "bfloat16"
          and pre9.cfg.row_reg_weight and pre9.cfg.whole_word and pre9.cfg.clip_weight,
          "not the full-width MLM configuration with every pretext")
    out["mlm"] = seen["mlm_launches"]
    check_launches(out["mlm"], {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": layers * MLM_STEPS,
                                "attn_bwd": layers * MLM_STEPS}, "the MLM stage")
    check(seen["mlm_dtypes"] == {"attn_fwd": {"bfloat16": layers * MLM_STEPS},
                                 "attn_bwd": {"bfloat16": layers * MLM_STEPS}},
          f"MLM dtypes {seen['mlm_dtypes']}")
    steps = -(-2402 // 8)
    check_launches(launches_by_name(all_kernels),
                   {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": layers * (2 * steps + 1),
                    "attn_bwd": layers * steps}, "the DP-MLD fine-tune epoch (bf16, composed DP)")
    check(attention_dtypes(all_kernels) == {"bfloat16"},
          "the bf16 fine-tune launched f32 attention")
    with open(os.path.join(run9, "mlm_history.json")) as f:
        hist = json.load(f)
    losses = torch.stack(seen["losses"]).tolist()
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"  mlm_history.json {hist}; the loss's first 5 steps {head:.4f}, last 5 {tail:.4f}")
    check(len(losses) == MLM_STEPS and all(map(math.isfinite, losses)), "MLM losses")
    check(len(hist) == 1 and math.isfinite(hist[0]["loss"]), "MLM history")
    check(tail < head, f"the MLM loss did not fall: {head:.4f} -> {tail:.4f}")
    for name in ("bert_mlm.pickle", "compact_vocab.npz",
                 "logs/demo/DPMLD/whole_record.txt"):
        check(os.path.exists(os.path.join(run9, name)), f"{name} not written")

    phase("profile: one MLM step (batch 128, S = 128, BERT-base, bf16, every pretext)")
    a, kw = seen["fit"]
    corpus = pre9.corpus_on_device(a[0], a[1], kw["corpus_vals"], kw["corpus_val_mask"],
                                   kw["corpus_word_start"], kw["corpus_clip"])
    g = torch.Generator(device=dev).manual_seed(10)
    torch.cuda.reset_peak_memory_stats()
    profile_step(torch, lambda: pre9.step(corpus, g), "MLM step",
                 work="1 forward + 1 backward")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    no_sync_step(torch, lambda: pre9.step(corpus, g), "MLM")
    del corpus, pre9, seen

    phase("main path 9: ResumableTrainer (f32 flagship, 64 / 32 rows): 1 epoch, resumed to 2, "
          "against an unbroken 2-epoch run")
    rng = np.random.RandomState(9)
    train, test = D.truncate_pair(synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL))
    fc = fusion.config_for("ti", "lapacian_dropout")
    log = os.path.join(root, "resumable")
    s8 = N_TRAIN // 8
    epoch = {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": layers * (2 * s8 + 1), "attn_bwd": layers * s8}
    for epochs in (1, 2):  # the second run resumes from the first's train_state.pickle
        reset()
        resumed = P.ResumableTrainer(fc, TrainConfig(epochs=epochs))
        res = resumed.fit(train, test, EPS, log_path=log, echo=False)
        check([r["epoch"] for r in res["history"]] == [epochs], f"resumable run {epochs}")
        check_launches(launches_by_name(all_kernels), epoch, f"ResumableTrainer to {epochs}")
    reset()
    whole = Trainer(fc, TrainConfig(epochs=2))
    whole.fit(train, test, EPS, echo=False)
    check_launches(launches_by_name(all_kernels), {k: 2 * v for k, v in epoch.items()},
                   "the unbroken 2-epoch fit")
    worst = 0.0
    for (path, a_), (_, b_) in zip(tree_items(resumed.params), tree_items(whole.params)):
        torch.testing.assert_close(a_, b_, rtol=1e-5, atol=1e-6, msg=lambda m: f"{path}: {m}")
        worst = max(worst, float((a_ - b_).abs().max()))
    print(f"  resumed params against the unbroken run: max diff {worst:.3g} (bit for bit: "
          f"{worst == 0.0})")
    done = P.ResumableTrainer(fc, TrainConfig(epochs=2)).fit(train, test, EPS, log_path=log,
                                                              echo=False)
    check(done.get("resumed_complete"), "a finished run was not reported complete")
    del resumed, whole

    phase("main path 9: pretrain_finetune (NDP, then feature_all_lap), f32, one epoch a stage")
    reset()
    pf = P.pretrain_finetune(train, test, os.path.join(root, "pipeline"),
                             P.PipelineConfig(pretrain_epochs=1, finetune_epochs=1), echo=False)
    single = {"dp_fwd": 0, "dp_bwd": 0, "attn_fwd": 2 * layers * (s8 + 1),
              "attn_bwd": 2 * layers * s8}
    check_launches(launches_by_name(all_kernels), single, "pretrain_finetune")
    for stage in ("pretrain", "finetune"):
        row = pf[stage]["history"][0]
        check(all(math.isfinite(row[k]) for k in ROW), f"{stage} row {row}")
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return out


def no_sync_step(torch, step, name):
    """One ``step`` under ``torch.cuda.set_sync_debug_mode("error")``: a
    host sync inside it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  one {name} step under sync debug mode \"error\": no host sync")


def attention_dtypes(all_kernels):
    """The dtypes of every attention launch since the counts were reset."""
    return {d for k in all_kernels if k.name.startswith("attn_") for d in k.by_dtype}


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


def time_pretext_attention(torch, A, gen, dev, pretext, err, vit_train_err):
    """Both attention kernels, bf16, at path 9's shapes: the MLM's (128,
    12, 128, 64), p = 0.1, the keys past 65 masked, and the training ViT's
    (128, 12, 50, 64), p = 0, zero bias: CUDA-event and device times against
    the bound, the plain versions and SDPA (the backward's as SDPA's
    forward + backward less its forward); rows of the kernels line."""
    import torch.nn.functional as TF

    rows = []
    for tag, (B, H, S, D), rate, launches in (
            ("mlm", MLM_ATTN_SHAPES[0], ATTN_DROP, pretext["mlm"]),
            ("vit_train", VIT_TRAIN_SHAPES[0], 0.0, pretext["clip"])):
        qkv = torch.randn(B, S, 3, H, D, generator=gen, device=dev, dtype=torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias = torch.zeros(B, S, device=dev)
        if tag == "mlm":
            bias[:, VALID_TOKENS:] = NEG
        bias4 = bias[:, None, None, :]
        dout = torch.randn(B, H, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
        seed = torch.tensor([17], dtype=torch.int64, device=dev)
        out, stats = A.attn_fwd(q, k, v, bias, seed, rate)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def keep():
            return torch.rand(B, H, S, S, generator=gen, device=dev) < 1 - rate if rate else None

        def fwd():
            return A.attn_fwd(q, k, v, bias, seed, rate)

        def bwd():
            return A.attn_bwd(q, k, v, bias, seed, rate, out, stats, dout)

        t = {"fwd": time_ms(torch, fwd, 20, 5), "bwd": time_ms(torch, bwd, 20, 5),
             "fwd plain": time_ms(torch, lambda: A.attention_plain(q, k, v, bias, keep(), rate),
                                  10, 3),
             "bwd plain": time_ms(torch, lambda: A.attention_bwd_plain(q, k, v, bias, keep(),
                                                                       rate, dout), 10, 3),
             "fwd sdpa": time_ms(torch, lambda: TF.scaled_dot_product_attention(
                 q, k, v, attn_mask=bias4, dropout_p=rate), 20, 5),
             "fwd+bwd sdpa": time_ms(torch, lambda: torch.autograd.grad(
                 TF.scaled_dot_product_attention(*leaves, attn_mask=bias4, dropout_p=rate),
                 leaves, dout), 20, 5)}
        t["bwd sdpa"] = t["fwd+bwd sdpa"] - t["fwd sdpa"]
        dev_t = {"fwd": sum(device_us(torch, fwd, 10).values()),
                 "bwd": sum(device_us(torch, bwd, 10).values())}
        bounds = {n: attn_bound_ms(n, B, H, S, D, 2) for n in ("attn_fwd", "attn_bwd")}
        print(f"  {tag} {(B, H, S, D)} p={rate}: " + ", ".join(
            f"{k} {v * 1e3:.1f} us" for k, v in t.items()))
        print(f"  {tag}: device time fwd {dev_t['fwd']:.1f} us, bwd {dev_t['bwd']:.1f} us; bound "
              f"(bf16 tensor cores) fwd {bounds['attn_fwd'][0] * 1e3:.2f} us "
              f"({bounds['attn_fwd'][1]}), bwd {bounds['attn_bwd'][0] * 1e3:.2f} us "
              f"({bounds['attn_bwd'][1]})")
        for name, key in (("attn_fwd", "fwd"), ("attn_bwd", "bwd")):
            e = (err[(name, "bfloat16", (B, H, S, D))] if tag == "mlm"
                 else vit_train_err[(name, (B, H, S, D))])
            rows.append({
                "name": f"{name}_{tag}_bf16", "route": ROUTES[name], "source": BF16_SOURCE,
                "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": e,
                "ms": t[key], "plain_ms": t[key + " plain"], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": t[key + " sdpa"],
            })
    return rows


# cuBLAS's kernel names: nvjet_* are its Hopper tensor-core (wgmma) GEMMs;
# *_simt_sgemm_*, *_f32f32_*_ffma_*, gemv and gemmSN its CUDA-core ones
# Main path 10's parity bounds, set before its first run on the card: the
# losses and F1 as the JAX package's mesh tests (tests/test_parallel.py:91-92,
# 126-127); the gathered params: each leaf's update within 1e-2 of the
# meshless update in L2 (the GEMMs of a shard may take other cuBLAS
# algorithms), every element within 4 x lr x steps (Adam's scale).
MESH_LOSS_RTOL, MESH_F1_ABS, MESH_UPDATE_RTOL = 2e-4, 1e-6, 1e-2
MESH_RUNS = (("gloo", (1, 2)), ("gloo", (2, 1)), ("nccl", (1, 1)))
MESH_SPAWN_S = 420  # a spawned run's limit


def mesh_rank(rank, world, backend, store_path, job, kw, out):
    """One rank of a spawned mesh run on the card (``torch.multiprocessing``,
    one process a rank, all on card 0): joins the group through a
    ``FileStore``, runs ``MESH_JOBS[job]`` and pickles its result to
    ``<out>.<rank>``. The kernels come from the library the parent built."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        result = MESH_JOBS[job](torch, rank, **kw)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_mesh(torch, root, backend, world, job, **kw):
    """Run ``job`` on ``world`` ranks over ``backend``; every rank's result."""
    import torch.multiprocessing as mp

    # a new store file for every group: one left by an earlier group would be read as its own
    store = os.path.join(root, f"store_{job}_{backend}_{time.time_ns()}")
    out = os.path.join(root, job)
    ctx = mp.start_processes(mesh_rank, args=(world, backend, store, job, kw, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + MESH_SPAWN_S
    while not ctx.join(timeout=5):  # raises if a rank failed
        if time.time() > deadline:  # a collective the ranks do not pair up hangs: stop them
            for proc in ctx.processes:
                proc.kill()
            fail(f"the {job} ranks over {backend} ran past {MESH_SPAWN_S} s")
    results = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as f:
            results.append(pickle.load(f))
        os.remove(f"{out}.{r}")
    return results


def mesh_step_times(torch, step, rank, label, n=3):
    """Host ms per step over ``n`` steps and device busy ms per step from one
    profiler session of ``n`` steps, the same calls on every rank (the
    steps' collectives pair up). Returns (host ms, device ms or None)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n / 1e3
    busy = busy or None
    print(f"  [{label} rank {rank}] train step {host:.2f} ms host, device busy "
          + ("not measured" if busy is None else
             f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / host):.3f}"), flush=True)
    return host, busy


def mesh_fit_job(torch, rank, mesh_shape, data_path, out_dir, sync_step, tc_kw=None,
                 fast=(), profile=True):
    """``shard_trainer`` + ``Trainer.fit`` of the flagship (fused DP, f32,
    two epochs, or the ``TrainConfig`` fields ``tc_kw``) on this rank; its
    launches, its history, the gathered params (rank 0, as numpy) and, with
    ``profile``, a profiled step; with ``sync_step`` one more step under
    ``torch.cuda.set_sync_debug_mode("error")``. ``fast``: (name,
    ``TrainConfig`` fields) of more fits in the same group after it, each
    without a profile, their results under "fast" by name."""
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.ops import attention as A
    from eeg_multimodal_torch.ops import dp_fused as K
    from eeg_multimodal_torch.parallel.mesh import make_mesh
    from eeg_multimodal_torch.parallel.sharding import gather_params
    from eeg_multimodal_torch.parallel.train import shard_trainer
    from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
    from eeg_multimodal_torch.utils.trees import tree_items

    with open(data_path, "rb") as f:
        train, test = pickle.load(f)
    dev = torch.device("cuda", 0)
    fc = dataclasses.replace(fusion.config_for("ti", "lapacian_dropout"), fused_dp_kernel=True)
    tr = Trainer(fc, TrainConfig(**{"epochs": 2, "f1_best_init": -1.0, **(tc_kw or {})}),
                 device=dev)
    label = f"mesh {mesh_shape}" + "".join(f" {k}" for k, v in (tc_kw or {}).items() if v is True)
    mesh = shard_trainer(tr, make_mesh(*mesh_shape))
    kernels = K.KERNELS + A.KERNELS
    for k in kernels:
        k.reset()
    t0 = time.perf_counter()
    out = tr.fit(train, test, EPS, log_path=os.path.join(out_dir, "log") + "/",
                 model_path=os.path.join(out_dir, "best.pickle"), echo=False)
    wall = time.perf_counter() - t0
    launches = {k.name: dict(k.by_dtype) for k in kernels}
    whole = gather_params(mesh, tr.params)
    params = {p: t.cpu().numpy() for p, t in tree_items(whole)} if rank == 0 else None
    del whole
    train_dev = train.to_device(dev)
    batch = D.gather_batch(train_dev, torch.arange(8, device=dev))
    w = torch.ones(8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    states = [tr.dp_os, tr.model_os]

    def step():
        states[:] = tr.steps.train_step(tr.params, *states, batch, w, EPS, gen)[:2]

    host = busy = None
    if profile:
        host, busy = mesh_step_times(torch, step, rank, label)
    if sync_step:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside the step raises
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    shard = tuple(tr.params["bert"]["layers"][0]["attn"]["query"]["kernel"].shape)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del tr, states
    return {"history": out["history"], "launches": launches, "params": params, "wall": wall,
            "host_ms": host, "device_ms": busy, "shard": shard, "peak_gib": peak,
            "fast": {name: mesh_fit_job(torch, rank, mesh_shape, data_path,
                                        os.path.join(out_dir, name), False, kw, profile=False)
                     for name, kw in fast}}


def mesh_dpsgd_job(torch, rank, mesh_shape, data_path):
    """``shard_dpsgd_trainer`` + ``DPSGDTrainer.fit``, one epoch."""
    from eeg_multimodal_torch.dp.dpsgd import DPSGDConfig
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.parallel.mesh import make_mesh
    from eeg_multimodal_torch.parallel.train import shard_dpsgd_trainer
    from eeg_multimodal_torch.train.dpsgd_trainer import DPSGDTrainer

    with open(data_path, "rb") as f:
        train, test = pickle.load(f)
    tr = DPSGDTrainer(fusion.config_for("ti", "DPSGD"), DPSGDConfig(EPS, epochs=1),
                      device=torch.device("cuda", 0))
    shard_dpsgd_trainer(tr, make_mesh(*mesh_shape))
    out = tr.fit(train, test, echo=False)
    return {"history": out["history"], "sigma": out["sigma"]}


def mesh_sweep_job(torch, rank, mesh_shape, data_path, epsilons):
    """A ``SweepRunner(mesh=)`` over ``epsilons`` (fused DP, f32, one epoch)."""
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.ops import attention as A
    from eeg_multimodal_torch.ops import dp_fused as K
    from eeg_multimodal_torch.parallel.mesh import make_mesh
    from eeg_multimodal_torch.train.sweep import SweepMember, SweepRunner
    from eeg_multimodal_torch.train.trainer import TrainConfig

    with open(data_path, "rb") as f:
        train, test = pickle.load(f)
    fc = dataclasses.replace(fusion.config_for("ti", "lapacian_dropout"), fused_dp_kernel=True)
    runner = SweepRunner(fc, TrainConfig(epochs=1), [SweepMember(e) for e in epsilons],
                         mesh=make_mesh(*mesh_shape), device=torch.device("cuda", 0))
    for k in K.KERNELS + A.KERNELS:
        k.reset()
    res = runner.run(train, test, echo=False)
    return {"results": res, "launches": {k.name: dict(k.by_dtype) for k in K.KERNELS + A.KERNELS}}


MESH_JOBS = {"fit": mesh_fit_job, "dpsgd": mesh_dpsgd_job, "sweep": mesh_sweep_job}
# path 10's fast phase modes, each one epoch in the (2, 1) run's group after
# its fit: features encoded once for both phases, and both phases' encoders
# as one forward over the batch stacked twice (under 'data' each stacked
# copy's rows are a call of their own: two attention launches a layer)
MESH_FAST = (("shared", {"epochs": 1, "share_phase_dropout": True}),
             ("paired", {"epochs": 1, "paired_phase_encode": True}))


def check_mesh_fit(torch, label, res, want_history, params, init, launches, moves):
    """Every rank's history of a meshed fit against the meshless
    ``want_history`` (losses within ``MESH_LOSS_RTOL``, F1 within
    ``MESH_F1_ABS``), its launches equal to ``launches``, rank 0's gathered
    params against the meshless ``params`` (each element within 4 x
    ``moves``, the learning rate x the steps; each leaf's update within
    ``MESH_UPDATE_RTOL``, the leaves whose exact gradient is 0 left out).
    Returns (worst loss rtol, worst element, worst update rtol)."""
    from eeg_multimodal_torch.utils.trees import tree_items

    worst_loss = worst_el = worst_upd = 0.0
    for rank, r in enumerate(res):
        for a, b in zip(r["history"], want_history):
            for key in ("train_loss", "test_loss"):
                rel = abs(a[key] - b[key]) / abs(b[key])
                worst_loss = max(worst_loss, rel)
                check(rel <= MESH_LOSS_RTOL, f"{label} rank {rank}: {key} {a[key]} against "
                      f"{b[key]} (rtol {rel:.3g})")
            check(abs(a["f1"] - b["f1"]) <= MESH_F1_ABS,
                  f"{label} rank {rank}: F1 {a['f1']} against {b['f1']}")
        check_launches(r["launches"], launches, f"{label} rank {rank}")
    got = res[0]["params"]
    for path, t in tree_items(params):
        g = torch.from_numpy(got[path]).to(t.device)
        el = float((g - t).abs().max())
        check(el <= 4 * moves, f"{label}: {path} moved {el} from the meshless")
        upd = t - init[path]
        rel = float((g - init[path] - upd).norm() / upd.norm().clamp_min(1e-30))
        if not path.endswith(("attn/key/bias", "in_proj_bias")):  # exact gradient 0 (key)
            check(rel <= MESH_UPDATE_RTOL, f"{label}: {path} update off by {rel:.3g}")
            worst_upd = max(worst_upd, rel)
        worst_el = max(worst_el, el)
    return worst_loss, worst_el, worst_upd


def run_mesh(torch, dev, rng, all_kernels, layers, steps):
    """Main path 10, the (data, model) mesh at full width (the counterpart of
    ``__graft_entry__.py``'s stage 2): the flagship TICA_LapDropout (BERT-base,
    the 3-layer decoder, F = 2304, S = 80, batch 8, f32, fused DP) for two
    epochs at 64 / 32 rows, meshless in this process, then on a (1, 2) and a
    (2, 1) mesh of two ranks spawned on the one card over gloo (which stages
    CUDA tensors through the host: parity, not speed) and a (1, 1) mesh over
    NCCL with one step under sync debug mode "error". Each mesh run's losses
    within ``MESH_LOSS_RTOL`` of the meshless run's, its F1 equal, its
    gathered params within the bounds above, each rank's launches path 1's.
    Then ``shard_dpsgd_trainer`` at (1, 2), one epoch, sigma equal; a
    3-member ``SweepRunner(mesh=)`` at (2, 1) against the meshless sweep
    (the pad member dropped); the flagship tree through ``save_pytree_dcp``
    and back, bit for bit. Returns the launches of the offset blocks (rank 1
    of the (1, 2) and the (2, 1) runs) and the mesh numbers."""
    from eeg_multimodal_torch.data import datasets as D
    from eeg_multimodal_torch.dp.dpsgd import DPSGDConfig
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.train.checkpoint import load_pytree_dcp, save_pytree_dcp
    from eeg_multimodal_torch.train.dpsgd_trainer import DPSGDTrainer
    from eeg_multimodal_torch.train.sweep import SweepMember, SweepRunner
    from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
    from eeg_multimodal_torch.utils.trees import tree_items

    phase("main path 10: the (data, model) mesh, TICA_LapDropout fused DP, f32, S = 80, two "
          "epochs of 64 / 32 rows: meshless, then (1, 2) and (2, 1) over gloo and (1, 1) over "
          "NCCL, two ranks on the one card")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    train, test = D.truncate_pair(synth_rows(D, rng, N_TRAIN), synth_rows(D, rng, N_EVAL))
    data_path = os.path.join(root, "rows.pickle")
    with open(data_path, "wb") as f:
        pickle.dump((train, test), f)
    fc = dataclasses.replace(fusion.config_for("ti", "lapacian_dropout"), fused_dp_kernel=True)
    tc = TrainConfig(epochs=2, f1_best_init=-1.0)
    plain = Trainer(fc, tc)
    init = {p: t.detach().clone() for p, t in tree_items(plain.params)}
    for k in all_kernels:
        k.reset()
    t0 = time.perf_counter()
    want = plain.fit(train, test, EPS, echo=False)
    print(f"  meshless fit {time.perf_counter() - t0:.2f} s: " + "; ".join(
        f"epoch {h['epoch']} train loss {h['train_loss']:.6f} test loss {h['test_loss']:.6f} "
        f"f1 {h['f1']:.4f}" for h in want["history"]))
    path1 = {"dp_fwd": {"float32": 2 * (2 * steps + 1)}, "dp_bwd": {"float32": 2 * 2 * steps},
             "attn_fwd": {"float32": layers * (2 * steps + 1) * 2},
             "attn_bwd": {"float32": layers * steps * 2}}
    check_launches({k.name: dict(k.by_dtype) for k in all_kernels}, path1, "meshless fit")
    lr = tc.learning_rate
    summary, block_launches = {}, {}
    for backend, shape in MESH_RUNS:
        world = shape[0] * shape[1]
        label = f"{shape} over {backend}"
        run_root = os.path.join(root, f"{backend}_{shape[0]}x{shape[1]}")
        os.makedirs(run_root)
        t0 = time.perf_counter()
        fast = MESH_FAST if shape == (2, 1) else ()
        for name, _ in fast:
            os.makedirs(os.path.join(run_root, name))
        res = spawn_mesh(torch, root, backend, world, "fit", mesh_shape=shape,
                         data_path=data_path, out_dir=run_root, sync_step=backend == "nccl",
                         fast=fast)
        wall = time.perf_counter() - t0
        worst_loss, worst_el, worst_upd = check_mesh_fit(
            torch, label, res, want["history"], plain.params, init, path1, lr * 2 * steps)
        check(sorted(os.listdir(os.path.join(run_root, "log"))) ==
              ["best_record.txt", "metrics.jsonl", "whole_record.txt"], f"{label}: records")
        check(len(open(os.path.join(run_root, "log", "metrics.jsonl")).read().splitlines()) == 2,
              f"{label}: rank (0, 0) alone writes two epochs")
        check(os.path.exists(os.path.join(run_root, "best.pickle")), f"{label}: no checkpoint")
        print(f"  {label}: {wall:.1f} s for the spawn and fit; shard of a query kernel "
              f"{res[0]['shard']}; max rel loss error {worst_loss:.3g}, F1 equal; gathered "
              f"params: max |mesh - meshless| {worst_el:.3g}, max rel update error "
              f"{worst_upd:.3g}; per rank: " + "; ".join(
                  f"fit {r['wall']:.1f} s, step {r['host_ms']:.1f} ms host / "
                  + ("device not measured" if r["device_ms"] is None else
                     f"{r['device_ms']:.1f} ms device") + f", peak {r['peak_gib']:.2f} GiB"
                  for r in res))
        summary[label] = {"host_ms": [r["host_ms"] for r in res],
                          "device_ms": [r["device_ms"] for r in res], "loss_rel": worst_loss,
                          "param_abs": worst_el, "update_rel": worst_upd}
        if shape == (1, 2):
            block_launches.update({f"{k}_block": sum(v.values()) for k, v in
                                   res[1]["launches"].items() if k.startswith("attn")})
        if shape == (2, 1):
            block_launches.update({f"{k}_r0": sum(v.values()) for k, v in
                                   res[1]["launches"].items() if k.startswith("dp")})
            fast_res = [r["fast"] for r in res]
        del res
    del plain, init

    phase("main path 10: the fast phase modes (shared features, paired encode), one epoch "
          "each in the (2, 1) run's group, against the meshless fits")
    fast_launches = {
        "shared": {"dp_fwd": {"float32": 2 * steps + 1}, "dp_bwd": {"float32": 2 * steps},
                   "attn_fwd": {"float32": layers * (steps + 1)},
                   "attn_bwd": {"float32": layers * steps}},
        "paired": {"dp_fwd": {"float32": 2 * steps + 1}, "dp_bwd": {"float32": 2 * steps},
                   "attn_fwd": {"float32": layers * (2 * steps + 1)},
                   "attn_bwd": {"float32": layers * 2 * steps}}}
    for name, tc_kw in MESH_FAST:
        ref = Trainer(fc, TrainConfig(**{"f1_best_init": -1.0, **tc_kw}))
        init = {p: t.detach().clone() for p, t in tree_items(ref.params)}
        want_fast = ref.fit(train, test, EPS, echo=False)
        label = f"(2, 1) over gloo, {name}"
        worst = check_mesh_fit(torch, label, [r[name] for r in fast_res], want_fast["history"],
                               ref.params, init, fast_launches[name], lr * steps)
        print(f"  {label}: max rel loss error {worst[0]:.3g}, F1 equal; gathered params: max "
              f"|mesh - meshless| {worst[1]:.3g}, max rel update error {worst[2]:.3g}; "
              f"per rank: " + "; ".join(f"fit {r[name]['wall']:.1f} s" for r in fast_res))
        summary[label] = {"loss_rel": worst[0], "param_abs": worst[1], "update_rel": worst[2]}
        del ref, init
    del fast_res

    phase("main path 10: shard_dpsgd_trainer at (1, 2) over gloo, one epoch, against the "
          "meshless DPSGDTrainer")
    t0 = time.perf_counter()
    dp_plain = DPSGDTrainer(fusion.config_for("ti", "DPSGD"), DPSGDConfig(EPS, epochs=1))
    want_dp = dp_plain.fit(train, test, echo=False)
    res = spawn_mesh(torch, root, "gloo", 2, "dpsgd", mesh_shape=(1, 2), data_path=data_path)
    for rank, r in enumerate(res):
        check(r["sigma"] == want_dp["sigma"], f"DP-SGD rank {rank}: sigma {r['sigma']}")
        for a, b in zip(r["history"], want_dp["history"]):
            for key in ("train_loss", "test_loss"):
                check(abs(a[key] - b[key]) <= MESH_LOSS_RTOL * abs(b[key]),
                      f"DP-SGD rank {rank}: {key} {a[key]} against {b[key]}")
            check(abs(a["f1"] - b["f1"]) <= MESH_F1_ABS, f"DP-SGD rank {rank}: F1")
    h = res[0]["history"][0]
    print(f"  sigma {res[0]['sigma']!r} equal; train loss {h['train_loss']:.6f} against "
          f"{want_dp['history'][0]['train_loss']:.6f}, test loss {h['test_loss']:.6f} against "
          f"{want_dp['history'][0]['test_loss']:.6f} ({time.perf_counter() - t0:.1f} s)")
    del dp_plain

    eps3 = (0.1, 1.0, 5.0)
    phase(f"main path 10: a {len(eps3)}-member SweepRunner(mesh=(2, 1)) over gloo against "
          "the meshless sweep, one epoch (a __pad__ member tiles the data axis)")
    fc1 = TrainConfig(epochs=1)
    plain_s = SweepRunner(fc, fc1, [SweepMember(e) for e in eps3]).run(train, test, echo=False)
    res = spawn_mesh(torch, root, "gloo", 2, "sweep", mesh_shape=(2, 1), data_path=data_path,
                     epsilons=eps3)
    one_epoch = {"dp_fwd": {"float32": 2 * steps + 1}, "dp_bwd": {"float32": 2 * steps},
                 "attn_fwd": {"float32": layers * (2 * steps + 1)},
                 "attn_bwd": {"float32": layers * steps}}
    for rank, r in enumerate(res):
        check([x["member"] for x in r["results"]] == [x["member"] for x in plain_s],
              f"sweep rank {rank}: members {[x['member'] for x in r['results']]}")
        for a, b in zip(r["results"], plain_s):
            for ra, rb in zip(a["history"], b["history"]):
                for key in ("train_loss", "test_loss"):
                    check(abs(ra[key] - rb[key]) <= MESH_LOSS_RTOL * abs(rb[key]),
                          f"sweep rank {rank} {a['member']}: {key}")
                check(abs(ra["f1"] - rb["f1"]) <= MESH_F1_ABS, f"sweep rank {rank}: F1")
        check_launches(r["launches"], one_epoch, f"sweep rank {rank} (two members)")
    print("  every rank returns the three members' rows, equal to the meshless sweep's")

    phase("main path 10: the flagship tree through save_pytree_dcp / load_pytree_dcp")
    tree = fusion.init(fc, 3)
    path = os.path.join(root, "dcp")
    t0 = time.perf_counter()
    save_pytree_dcp(path, tree)
    save_s = time.perf_counter() - t0
    back = load_pytree_dcp(path)
    like = load_pytree_dcp(path, like=fusion.init(fc, 4))
    for (p, a), (_, b), (_, c) in zip(tree_items(tree), tree_items(back), tree_items(like)):
        check(torch.equal(a, b) and torch.equal(a, c), f"DCP round trip: {p} differs")
    print(f"  {len(tree_items(tree))} leaves bit for bit, from the metadata and into a like "
          f"tree; save {save_s:.1f} s")
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return block_launches, summary


ENTRY_ENV = {"EEG_BENCH_EPOCHS_PER_CALL": "1", "EEG_BENCH_WINDOWS": "1",
             "ROOFLINE_N_SHORT": "2", "ROOFLINE_N_LONG": "8"}


def run_entry_points(torch, all_kernels, layers):
    """Main path 11, the entry points outside the package, through their
    ``main``s as ``python -m`` runs them, on a seeded stand-in for the
    reference's committed test split (601 rows of at most 65 tokens, under a
    temporary ``REFERENCE_DIR``): the bench at 2402 / 601 with K = 1 and
    R = 1 (its JSON line parsed, finite and positive; bf16 attention
    launches of two epochs), the step roofline at N = 2 and 8 (every row
    a bound and a share of at most 1), the attention table, and
    ``train_demo`` at 64 rows, one epoch, plain and ``--fused_dp`` (the DP
    kernels in the latter)."""
    import contextlib
    import io

    from eeg_multimodal_torch import bench
    from eeg_multimodal_torch.examples import train_demo
    from eeg_multimodal_torch.ops import attention as A
    from eeg_multimodal_torch.tools import bench_attention, roofline_step

    def reset():
        for k in all_kernels:
            k.reset()

    def by_dtype():
        return {k.name: dict(k.by_dtype) for k in all_kernels if k.launches}

    root = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    ref = bench.write_stand_in(os.path.join(root, "reference"))
    env = dict(ENTRY_ENV, REFERENCE_DIR=ref)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        phase("main path 11: python -m eeg_multimodal_torch.bench on a seeded stand-in of the "
              "reference's test split (2402 / 601 rows, S = 80), K = 1, R = 1")
        print(f"  the reference's files are not in the repo: bench.write_stand_in writes 601 "
              f"rows from numpy seed 601 under {ref}; every number here is the seeded "
              "stand-in's")
        reset()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = bench.main([])
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        print("  " + text.strip().replace("\n", "\n  "))
        line = json.loads(text.strip().splitlines()[-1])
        check(set(line) == {"metric", "value", "unit", "vs_baseline"} and line == result,
              f"the bench's line {line}")
        check(math.isfinite(line["value"]) and line["value"] > 0, f"steps/s {line['value']}")
        steps = -(-bench.N_TRAIN // bench.BATCH)
        # the warm-up window and the timed ones
        epochs = int(env["EEG_BENCH_EPOCHS_PER_CALL"]) * (1 + int(env["EEG_BENCH_WINDOWS"]))
        want = {"attn_fwd": {"bfloat16": epochs * layers * (2 * steps + 1)},
                "attn_bwd": {"bfloat16": epochs * layers * steps}}
        check_launches(by_dtype(), want, "the bench (bf16 compute, composed DP)")
        print(f"  {wall:.1f} s for the call; per step attn_fwd {2 * layers} + the eval's "
              f"{layers} an epoch, attn_bwd {layers}")

        phase("main path 11: python -m eeg_multimodal_torch.tools.roofline_step on the stand-in, "
              "N = 2 and 8")
        reset()
        rows, summary = roofline_step.main([])
        print(f"  summary {summary}")
        for row in rows:
            check(row["bound_s"] > 0 and 0 < row["share"] <= 1
                  and (row["share_busy"] is None or row["share_busy"] <= 1),
                  f"roofline row {row}")
        check(len(rows) == 6, f"roofline rows {[r['name'] for r in rows]}")

        phase("main path 11: python -m eeg_multimodal_torch.tools.bench_attention (BERT-base, "
              "batch 8, bf16, p = 0.1, S = 128 / 256 / 512)")
        reset()
        with LaunchesAt(A.KERNELS, torch.bfloat16, 512) as at_512:
            table = bench_attention.main([])
        SEQ_LAUNCHES.update(at_512.counts)
        print(f"  bf16 launches at S = 512: {at_512.counts}")
        check(len(table) == 6 and all(math.isfinite(p) and math.isfinite(k) and p > 0 and k > 0
                                      for _, _, p, k, _, _ in table), f"attention table {table}")
        got = by_dtype()
        check(set(got) == {"attn_fwd", "attn_bwd"} and set(got["attn_fwd"]) == {"bfloat16"},
              f"the kernel rows did not launch the bf16 kernels: {got}")

        for fused in (False, True):
            label = "--fused_dp" if fused else "plain"
            phase(f"main path 11: python -m eeg_multimodal_torch.examples.train_demo --n 64 "
                  f"--epochs 1 ({label}), the stand-in's first 64 rows and the next 128")
            reset()
            log = os.path.join(root, f"demo_{label.strip('-')}")
            out = train_demo.main(["--n", "64", "--epochs", "1", "--log", log]
                                  + (["--fused_dp"] if fused else []))
            check(len(out["history"]) == 1 and all(
                math.isfinite(out["history"][0][k]) for k in ROW), f"train_demo {out}")
            check(os.path.exists(os.path.join(log, "whole_record.txt")), "no whole_record.txt")
            steps = 64 // bench.BATCH
            want = {"attn_fwd": {"bfloat16": layers * (2 * steps + 1)},
                    "attn_bwd": {"bfloat16": layers * steps}}
            if fused:
                want.update(dp_fwd={"float32": 2 * steps + 1}, dp_bwd={"float32": 2 * steps})
            check_launches(by_dtype(), want, f"train_demo {label}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root)


EXAMPLE_RAW_ROWS = (40, 40)  # a 64 / 16 split: eight train steps an epoch (DP-SGD q = 1/8)


def write_user_tree(root, rows=EXAMPLE_RAW_ROWS, device=None):
    """The tree a user's examples read, from raw rows: ``write_raw_tasks``,
    ``process``, then ``GetEmbedding.run`` with CLIP ViT-B/32 and B/16,
    ResNet-34 and both tokenizers over both modals and splits (random
    towers). Returns ``root``."""
    from eeg_multimodal_torch.data import process
    from eeg_multimodal_torch.data.embedding import GetEmbedding

    process.process(write_raw_tasks(root, rows), os.path.join(root, "data", "processed"))
    GetEmbedding(["act", "EEG"], ["train", "test"], data_root=root, device=device).run(
        [["clip", "ViT-B/32"], ["clip", "ViT-B/16"], ["resnet", "resnet34"]],
        [["bert", "bert-base-uncased"], ["bert", "bert-base-cased"]])
    return root


def numeric_vocab(WordPiece):
    """A BERT-like numeric vocab: the specials at BERT's ids, '-', the whole
    numbers below 100 and every seventh below 1000, '##' continuations of
    one and two digits."""
    vocab = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "-": 1000}
    words = [str(n) for n in range(100)] + [str(n) for n in range(0, 1000, 7)]
    words += ["##" + d for d in "0123456789"]
    words += ["##" + a + b for a in "0123456789" for b in "0123456789"]
    for w in words:
        vocab.setdefault(w, 1000 + len(vocab) - 4)
    return WordPiece(vocab)


def write_mini_reference(root, n_rows=120, raw_rows=EXAMPLE_RAW_ROWS, seed=15):
    """A seeded stand-in for the reference's files that the vocab recovery
    and r5_accuracy's tree phase read, under ``root``: ``feature/test_EEG.csv``
    (``n_rows`` texts of 30 integers in [-300, 300), the EEG channels of
    :func:`write_raw_tasks`, and 0/1 labels) with
    ``feature/EEG/test_bert.pickle``, each text's ids as :func:`numeric_vocab`
    encodes it (a row of 512 ids and its mask: ids consistent with the
    texts, as HF's are with the committed rows), ``feature/action/
    test_clip_v2.pickle`` ((n_rows, 512) f32) and ``python/data/processed``
    (``process`` over ``raw_rows`` raw rows). Made with numpy; returns
    ``root``."""
    from eeg_multimodal_torch.data import process
    from eeg_multimodal_torch.data.tokenizer import WordPiece

    tok = numeric_vocab(WordPiece)
    rng = np.random.RandomState(seed)
    texts = [" ".join(str(v) for v in rng.randint(-300, 300, 30)) for _ in range(n_rows)]
    items = []
    for text in texts:
        ids, mask = tok.encode(text)
        items.append({"input_ids": ids.astype(np.int64), "attention_mask": mask.astype(np.int64)})
    for sub in ("EEG", "action"):
        os.makedirs(os.path.join(root, "feature", sub), exist_ok=True)
    with open(os.path.join(root, "feature", "test_EEG.csv"), "w") as f:
        f.write("EEG,label\n")
        f.writelines(f"{t},{lab}\n" for t, lab in zip(texts, rng.randint(0, 2, n_rows)))
    with open(os.path.join(root, "feature", "EEG", "test_bert.pickle"), "wb") as f:
        pickle.dump(items, f)
    with open(os.path.join(root, "feature", "action", "test_clip_v2.pickle"), "wb") as f:
        pickle.dump(rng.randn(n_rows, 512).astype(np.float32), f)
    process.process(write_raw_tasks(root, raw_rows, seed),
                    os.path.join(root, "python", "data", "processed"))
    return root


def example_runs(tree, run_dir, out):
    """(module under ``eeg_multimodal_torch``, argv, the file it writes) of
    every ported example, in the order of the port, each at its smallest
    epoch count (``alpha_sweep_legacy`` has none: one alpha, 50 epochs),
    ``pretrain_finetune``'s MLM at 4 steps and ``pretrain_clip`` at 101, the
    fewest past its 100 warm-up steps; ``run_dir`` is the run directory
    ``pretrain_finetune`` writes and the others read."""
    def at(name):
        return os.path.join(out, name)

    pre = ["--run_dir", run_dir, "--data_root", tree]
    return [
        ("examples.train_staged", ["--data_root", tree, "--head_epochs", "1",
                                   "--full_epochs", "1"], None),
        ("examples.pretrain_finetune", ["--data_root", tree, "--out", run_dir, "--mlm_steps",
                                        "4", "--epochs", "1"],
         os.path.join(run_dir, "bert_mlm.pickle")),
        ("examples.eps_frontier_pretrained", pre + ["--out", at("eps"), "--epochs", "1"],
         os.path.join(at("eps"), "frontier.json")),
        ("examples.eps_seeds_frontier", pre + ["--out", at("seeds"), "--epochs", "1"],
         os.path.join(at("seeds"), "frontier_seeds.json")),
        ("examples.ndp_seeds_ablation", pre + ["--out", at("ndp"), "--epochs", "1"],
         os.path.join(at("ndp"), "summary.json")),
        ("examples.compare_modal_pretrained", pre + ["--out", at("modal"), "--epochs", "1"],
         os.path.join(at("modal"), "logs", "compare_modal", "ii", "whole_record.txt")),
        ("examples.compare_schemes_pretrained", pre + ["--out", at("schemes"), "--epochs", "1"],
         os.path.join(at("schemes"), "logs", "compare_private_scheme", "DPSGD",
                      "whole_record.txt")),
        ("examples.compare_streams_pretrained", pre + ["--out", at("streams"), "--epochs", "1"],
         os.path.join(at("streams"), "logs", "compare_corss_model_type", "single_stream",
                      "whole_record.txt")),
        ("examples.compare_init_weight_pretrained", pre + ["--out", at("init"), "--epochs", "1",
                                                           "--cased_mlm_steps", "4"],
         os.path.join(at("init"), "bert_mlm_cased.pickle")),
        ("examples.legacy_heads_pretrained", pre + ["--out", at("legacy"), "--epochs", "1"],
         os.path.join(at("legacy"), "newfrac_10.0eps", "whole_record.txt")),
        ("examples.alpha_sweep_legacy", pre + ["--out", at("alpha"), "--stride", "50"],
         os.path.join(at("alpha"), "alpha_sweep.json")),
        ("examples.pretrain_clip", ["--data_root", tree, "--out", at("clip"), "--steps", "101",
                                    "--batch", "16"],
         os.path.join(at("clip"), "tree", "data", "embedding", "EEG", "img",
                      "clip_ViT_B_32", "test.pickle")),
        ("tools.validate_bf16_moments", pre + ["--out", at("bf16"), "--epochs", "1"],
         os.path.join(at("bf16"), "result_bf16_seed980616.json")),
    ]


def run_examples(torch, all_kernels):
    """Main path 11, the examples: a user tree from 80 raw rows (64 / 16),
    then every ported example through its ``main`` at its smallest epoch
    count, in order (``pretrain_finetune`` writing the run directory the
    others read), each held to its file written and to launching the
    attention kernels. Returns the directory holding the tree (``tree``,
    its raw rows under ``tree/raw``) and the run directory (``run``), for
    path 12, which removes it."""
    import importlib

    phase(f"main path 11: the examples, from a tree of {sum(EXAMPLE_RAW_ROWS)} raw rows "
          "(process, GetEmbedding with ViT-B/32 and B/16, ResNet-34, both tokenizers)")
    root = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    t0 = time.perf_counter()
    tree = write_user_tree(os.path.join(root, "tree"))
    print(f"  the tree in {time.perf_counter() - t0:.1f} s")
    for name, argv, written in example_runs(tree, os.path.join(root, "run"),
                                            os.path.join(root, "out")):
        phase(f"main path 11: python -m eeg_multimodal_torch.{name} {' '.join(argv)}")
        for k in all_kernels:
            k.reset()
        t0 = time.perf_counter()
        result = importlib.import_module(f"eeg_multimodal_torch.{name}").main(argv)
        got = {k.name: dict(k.by_dtype) for k in all_kernels if k.launches}
        print(f"  {time.perf_counter() - t0:.1f} s; launches {got}")
        check(result is not None, f"{name} returned nothing")
        check(written is None or os.path.exists(written), f"{name} did not write {written}")
        check("attn_fwd" in got, f"{name} did not run the attention kernels")
    shutil.rmtree(os.path.join(root, "out"))
    return root


# Main path 12's launch counts, worked out from the code before its first
# run on the card (PERF.md's prediction): the NaN repro's fused variants launch
# each DP kernel once per instance a step (phase 1 dDP only, phase 2 df
# only: one dp_bwd each), the composed one none.
REPRO_STEPS = 1200
REPRO_INSTANCES = {"dual-scan": 2, "single-scan": 1, "dual-python": 2, "dual-scan-barrier": 2,
                   "dual-scan-jaxnoise": 0}
DRYRUN_SPAWN_S = MESH_SPAWN_S  # path 10's limit on a spawned run


def write_safetensors(path, tensors):
    """``tensors`` (name -> contiguous f32 CPU tensor) as a ``.safetensors``
    file: an 8-byte little-endian header length, the JSON header (dtype,
    shape, [begin, end) offsets; ``__metadata__``), padded with spaces to a
    multiple of 8, then each tensor's little-endian bytes. Written here by
    hand: the card's machine has no ``safetensors`` package."""
    import struct

    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        blob = t.contiguous().numpy().astype("<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def bert_base_state_dict(torch, bert_mod, seed):
    """A synthetic HF ``BertModel`` state dict at BERT-base's shapes (f32
    CPU tensors, torch layout): the port's init from ``seed`` through
    ``train/checkpoint.py::bert_to_torch_state_dict``."""
    from eeg_multimodal_torch.train.checkpoint import bert_to_torch_state_dict

    params = bert_mod.init(torch.Generator().manual_seed(seed), bert_mod.BertConfig(), "cpu")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in bert_to_torch_state_dict(params).items()}


def run_remaining_entry_points(torch, all_kernels, layers, examples_root):
    """Main path 12, the JAX system's remaining entry points through their
    ports' ``main``s: the fused-DP NaN repro at 1200 steps (every variant
    PASS, the DP kernels' launches as counted); ``import_hf_bert`` on a
    synthetic BERT-base state dict as ``.bin`` and ``.safetensors`` (the
    trees bit for bit equal, the imported BERT card against CPU);
    ``recover_vocab`` on a seeded mini-reference (every row byte-exact); the
    graft entry's check (4 bf16 ``attn_fwd``) and its dry run at full size
    on two ranks over gloo (parity asserted by rank 0; launches per stage);
    ``r5_modal_seeds`` at one epoch on path 11's tree and run directory;
    ``scripts.data`` on path 11's raw rows; ``r5_accuracy``'s tree phase on
    the mini-reference. Removes ``examples_root``."""
    import contextlib
    import glob
    import io

    from eeg_multimodal_torch import graft_entry
    from eeg_multimodal_torch.models import bert as bert_mod
    from eeg_multimodal_torch.scripts import data as data_script
    from eeg_multimodal_torch.tools import (import_hf_bert, r5_accuracy, r5_modal_seeds,
                                            recover_vocab)
    from eeg_multimodal_torch.tools import repro_fused_dp_scan_nan as repro
    from eeg_multimodal_torch.train.checkpoint import load_pytree
    from eeg_multimodal_torch.utils.trees import tree_items

    def reset():
        for k in all_kernels:
            k.reset()

    def by_dtype():
        return {k.name: dict(k.by_dtype) for k in all_kernels if k.launches}

    def embedding_files(root):
        base = os.path.join(root, "data", "embedding")
        return sorted(os.path.relpath(os.path.join(d, f), base)
                      for d, _, files in os.walk(base) for f in files)

    root = tempfile.mkdtemp(prefix="chip_smoke_entry12_")
    saved = {k: os.environ.get(k) for k in ("REPRO_STEPS", "REFERENCE_DIR")}
    cwd = os.getcwd()
    try:
        os.environ["REPRO_STEPS"] = str(REPRO_STEPS)
        for variant, n in REPRO_INSTANCES.items():
            phase(f"main path 12: python -m eeg_multimodal_torch.tools.repro_fused_dp_scan_nan "
                  f"{variant} (REPRO_STEPS={REPRO_STEPS}, (8, 2304))")
            reset()
            t0 = time.perf_counter()
            result = repro.main([variant])
            wall = time.perf_counter() - t0
            check(result == {variant: True}, f"the repro's {variant}: {result}")
            want = {} if n == 0 else {"dp_fwd": {"float32": n * REPRO_STEPS},
                                      "dp_bwd": {"float32": n * REPRO_STEPS}}
            check_launches(by_dtype(), want, f"repro {variant}")
            print(f"  {wall:.2f} s, {wall / REPRO_STEPS * 1e3:.3f} ms a step")

        phase("main path 12: python -m eeg_multimodal_torch.tools.import_hf_bert on a synthetic "
              "BERT-base state dict, as pytorch_model.bin and as model.safetensors")
        t0 = time.perf_counter()
        sd = bert_base_state_dict(torch, bert_mod, 12)
        trees = {}
        for name in ("pytorch_model.bin", "model.safetensors"):
            hf = os.path.join(root, name.split(".")[1])
            os.makedirs(hf)
            if name.endswith(".bin"):
                torch.save(sd, os.path.join(hf, name))
            else:
                write_safetensors(os.path.join(hf, name), sd)
            out = os.path.join(root, f"{name}.pickle")
            t1 = time.perf_counter()
            import_hf_bert.main([hf, out])
            print(f"  {name}: {os.path.getsize(os.path.join(hf, name)) / 2**20:.0f} MiB "
                  f"imported in {time.perf_counter() - t1:.1f} s")
            trees[name] = load_pytree(out, "cpu")
        a, b = (dict(tree_items(t)) for t in trees.values())
        check(sorted(a) == sorted(b) and all(torch.equal(a[p], b[p]) for p in a),
              "the .bin and .safetensors trees differ")
        cfg = bert_mod.BertConfig()
        last = cfg.num_layers - 1
        check(torch.equal(a["embeddings/word"], sd["embeddings.word_embeddings.weight"]) and
              torch.equal(a[f"layers/{last}/ffn/output/kernel"],
                          sd[f"encoder.layer.{last}.output.dense.weight"].T),
              "the imported tree is not the state dict's")
        rng = np.random.RandomState(12)
        ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, 128))).long()
        mask = torch.ones(8, 128, dtype=torch.int64)
        mask[:, VALID_TOKENS:] = 0
        reset()
        with torch.no_grad():
            on_card = bert_mod.apply(load_pytree(os.path.join(root, "model.safetensors.pickle")),
                                     ids.cuda(), mask.cuda(), cfg)
            on_cpu = bert_mod.apply(trees["model.safetensors"], ids, mask, cfg)
        check_launches(by_dtype(), {"attn_fwd": {"float32": cfg.num_layers}},
                       "the imported BERT's forward")
        for name, x, y in zip(("sequence", "pooled"), on_card, on_cpu):
            print(f"  imported BERT-base, (8, 128): {name} max|card - cpu| "
                  f"{float((x.cpu() - y).abs().max()):.3g}")
            torch.testing.assert_close(x.cpu(), y, rtol=1e-3, atol=1e-4)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        del sd, trees, a, b, on_card, on_cpu
        shutil.rmtree(os.path.join(root, "bin"))
        shutil.rmtree(os.path.join(root, "safetensors"))

        phase("main path 12: python -m eeg_multimodal_torch.tools.recover_vocab on a seeded "
              "mini-reference (120 rows whose ids are their texts' encoding)")
        t0 = time.perf_counter()
        ref = write_mini_reference(os.path.join(root, "reference"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tok = recover_vocab.main(["--reference", ref, "--out",
                                      os.path.join(root, "recovered_vocab.json")])
        print("  " + buf.getvalue().strip())
        check(buf.getvalue().strip().endswith("120/120 rows byte-exact"),
              f"recover_vocab: {buf.getvalue()}")
        check(len(tok.word_memo) > 0, "recover_vocab memoized no word")
        print(f"  ({time.perf_counter() - t0:.1f} s)")

        phase("main path 12: python -m eeg_multimodal_torch.graft_entry (the flagship forward, "
              "4 layers, bf16, batch 8, S = 512)")
        reset()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            logits = graft_entry.main([])
        print("  " + buf.getvalue().strip() + f" ({time.perf_counter() - t0:.1f} s)")
        check(buf.getvalue() == "entry ok: (8, 2) float32\n", f"entry: {buf.getvalue()}")
        check(bool(torch.isfinite(logits).all()), "entry: non-finite logits")
        check_launches(by_dtype(), {"attn_fwd": {"bfloat16": 4}}, "the graft entry")

        phase("main path 12: graft_entry.dryrun_multichip(2), full size, two ranks on the "
              f"card over gloo, {DRYRUN_SPAWN_S} s limit")
        t0 = time.perf_counter()
        results = graft_entry.dryrun_multichip(2, deadline_s=DRYRUN_SPAWN_S)
        print(f"  {time.perf_counter() - t0:.1f} s for the spawn and both stages")
        steps = 2
        tiny = {"attn_fwd": {"float32": 2 * (2 * steps + 1)}, "attn_bwd": {"float32": 2 * steps}}
        full = {"attn_fwd": {"float32": 12 * 2 * steps}, "attn_bwd": {"float32": 12 * steps}}
        check(results[0]["mesh"] == {"data": 1, "model": 2}, f"mesh {results[0]['mesh']}")
        for rank, r in enumerate(results):
            check_launches(r["launches"]["tiny"], tiny, f"dry run stage 1, rank {rank}")
            check_launches(r["launches"]["mesh_arm"], full, f"dry run mesh arm, rank {rank}")
        check_launches(results[0]["launches"]["single_arm"], full, "dry run single-rank arm")
        r = results[0]
        print(f"  stage 1 train loss {r['train_loss']:.6f} eval loss {r['eval_loss']:.6f}; "
              f"stage 2 loss mesh {r['loss_mesh']:.6f} ({r['t_mesh']:.2f} s), single "
              f"{r['loss_one']:.6f} ({r['t_one']:.2f} s), |delta| {r['parity_delta']:.3g}")

        tree, run_dir = (os.path.join(examples_root, d) for d in ("tree", "run"))
        phase("main path 12: python -m eeg_multimodal_torch.tools.r5_modal_seeds --epochs 1 on "
              "path 11's tree and run directory (three seeds)")
        reset()
        t0 = time.perf_counter()
        summary = r5_modal_seeds.main(["--run_dir", run_dir, "--data_root", tree, "--out",
                                       os.path.join(root, "modal3"), "--epochs", "1"])
        print(f"  {time.perf_counter() - t0:.1f} s")
        check([r["seed"] for r in summary["rows"]] == [980616, 1, 2] and all(
            math.isfinite(r["best_acc"]) for r in summary["rows"]), f"r5_modal_seeds {summary}")
        check(os.path.exists(os.path.join(root, "modal3", "summary.json")), "no summary.json")
        n_steps = 64 // 8  # path 11's 64 train rows; its 16 eval rows in one batched forward
        check_launches(by_dtype(), {"attn_fwd": {"bfloat16": 3 * layers * (2 * n_steps + 1)},
                                    "attn_bwd": {"bfloat16": 3 * layers * n_steps}},
                       "r5_modal_seeds, three seeds")

        phase("main path 12: python -m eeg_multimodal_torch.scripts.data on path 11's raw rows")
        work = os.path.join(root, "data_script")
        os.makedirs(work)
        os.chdir(work)
        reset()
        t0 = time.perf_counter()
        check(data_script.main(sorted(glob.glob(os.path.join(tree, "raw", "*.txt")))) == 0,
              "scripts.data")
        os.chdir(cwd)
        print(f"  {time.perf_counter() - t0:.1f} s; launches {by_dtype()}")
        files = embedding_files(work)
        check(files == embedding_files(tree) and len(files) == 20,
              f"scripts.data wrote {files}")
        for rel in files:
            x, y = (open(os.path.join(r, "data", "embedding", rel), "rb").read()
                    for r in (work, tree))
            if "/txt/" in rel:
                check(x == y, f"scripts.data: {rel} differs from path 11's")
            else:
                np.testing.assert_allclose(pickle.loads(x), pickle.loads(y), **EMBED_TOL)
        # ViT-B/32 and B/16: 12 launches a chunk of 16 rows, 4 + 1 chunks a modal
        check_launches(by_dtype(), {"attn_fwd": {"float32": 2 * 2 * 5 * 12}}, "scripts.data")

        phase("main path 12: python -m eeg_multimodal_torch.tools.r5_accuracy tree on the "
              "mini-reference")
        os.environ["REFERENCE_DIR"] = ref
        r5_root = r5_accuracy.R5
        r5_accuracy.R5 = os.path.join(root, "r5")
        reset()
        t0 = time.perf_counter()
        check(r5_accuracy.main(["tree"]) == 0, "r5_accuracy tree")
        print(f"  {time.perf_counter() - t0:.1f} s")
        check(os.path.exists(os.path.join(r5_accuracy.R5, ".done_tree")), "no tree marker")
        check(len(embedding_files(os.path.join(r5_accuracy.R5, "user_tree"))) == 20,
              "r5_accuracy's tree")
        check_launches(by_dtype(), {"attn_fwd": {"float32": 2 * 2 * 5 * 12}},
                       "r5_accuracy tree")
        reset()
        check(r5_accuracy.main(["tree"]) == 0 and by_dtype() == {},
              "r5_accuracy tree again: the marker did not skip the phase")
        r5_accuracy.R5 = r5_root
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root)
        shutil.rmtree(examples_root)
    torch.cuda.empty_cache()


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
            name = re.search(r"\d((?:attn|dp)_\w+?_kernel|empty_kernel)", line)
            targs = re.search(r"kernelI(?:(f|13__nv_bfloat16))?Li(\d+)E", line)
            dtype = {"f": "f32, ", "13__nv_bfloat16": "bf16, "}.get(targs.group(1), "") if targs \
                else ""
            entry = (name.group(1) if name else "?") + (
                f"<{dtype}{targs.group(2)}>" if targs else "")
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
    vit_err, vit_train_err = check_vit_attention(torch, A, gen, dev)
    for G in (2, 5):  # the paired phase encode's 2B forward; the 5-member sweep's rows
        print(f"  G = {G} max errors: " + ", ".join(
            f"{name} {dt} {e:.3g}" for (name, dt), e in check_grouped_attention(
                torch, A, gen, dev, G).items()))
    print(f"  (checks {time.time() - t0:.1f} s)")

    phase("the kernels' global offsets: blocks of a (2, 2) layout against the global call")
    err.update(check_offset_kernels(torch, A, K, gen, dev))

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
    # closed: the unfused branch, as under the JAX package's gate (S >= 512)
    gate = A.attention_available
    step_80 = step_fn(trainer, train_dev)
    for label in ("closed", "open"):  # once each: the smoke's time limit
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
          "precast_params and with the in-step cast, beside path 1's f32 step")
    train_b_dev, test_b_dev = train_b.to_device(dev), test_b.to_device(dev)
    in_step = StepFunctions(fc_b, dataclasses.replace(tc_b, precast_params=False), dev)
    steps_by_label = {"f32, path 1": step_fn(trainer, train_dev),
                      "bf16, bench, precast": step_fn(bench, train_b_dev),
                      "bf16, bench, in-step cast": step_fn(bench, train_b_dev, in_step)}
    for label in ("f32, path 1", "bf16, bench, precast", "bf16, bench, in-step cast"):
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
          "configuration, 601 rows in 76 batches")
    n_rows = 601  # the reference's eval set (bench.py:27)
    flat = torch.arange(-(-n_rows // tc.batch_size) * tc.batch_size, device=dev)
    eidx = (flat % N_EVAL).reshape(-1, tc.batch_size)  # the 32 eval rows, cycled
    ew = (flat < n_rows).float().reshape(-1, tc.batch_size)
    evals = {"batched": bench.steps,
             "loop": StepFunctions(fc_b, dataclasses.replace(tc_b, eval_vmap_batches=False), dev)}
    eval_ms = {}
    for label in ("batched", "loop"):
        def eval_epoch(steps=evals[label]):
            return steps.eval_epoch(bench.params, test_b_dev, eidx, ew, EPS, gen)[0]
        eval_epoch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            eval_epoch()
        torch.cuda.synchronize()
        eval_ms[label] = (time.perf_counter() - t0) / 3 * 1e3
        busy = sum(device_us(torch, eval_epoch, 1).values()) / 1e3
        print(f"  {label}: device busy {busy:.2f} ms per eval epoch")
    print(f"  eval epoch, host ms: batched {eval_ms['batched']:.2f}, loop {eval_ms['loop']:.2f}")
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

    phase("profile: steady-state S = 80 train step of the fast modes, beside path 1's "
          "faithful f32 step")
    mode_steps = {"f32, path 1": (step_fn(trainer, train_dev), 4, "2 forwards + 1 backward"),
                  "f32, share + reuse, path 4": (step_fn(tr4, train_dev), 3,
                                                 "1 forward + 1 backward"),
                  "bf16, paired, path 5": (step_fn(tr5, train_dev), 6,
                                           "1 forward + 1 backward at 2B")}
    for label in ("f32, path 1", "f32, share + reuse, path 4", "bf16, paired, path 5"):
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
    run_fast_sweeps(torch, dev, rng, all_kernels, layers, steps)
    run_legacy(torch, dev, rng, all_kernels, layers, steps)
    embed, tree = run_embedding(torch, dev, all_kernels, layers)
    pretext = run_pretext(torch, dev, all_kernels, layers, tree)
    block_launches, _ = run_mesh(torch, dev, rng, all_kernels, layers, steps)
    run_entry_points(torch, all_kernels, layers)
    examples_root = run_examples(torch, all_kernels)
    run_remaining_entry_points(torch, all_kernels, layers, examples_root)

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

    phase("timing: the offset calls (a rank's block of a (2, 2) layout) beside the same "
          "shapes' calls of their own")
    import torch.nn.functional as TF

    kernels += time_offset_calls(torch, A, K, gen, dev, err, block_launches)

    phase("timing: attention kernels, f32, p = 0.1 (the gate question at S = 80 and 128)")

    f32_device = {}
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
        f32_device[S] = (dev_t["fwd"], dev_t["bwd"])
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

    print("  f32 device time (fwd, bwd): " + "; ".join(
        f"S = {S} {f:.1f} / {b:.1f} us" for S, (f, b) in f32_device.items()))

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
        # S = 80: path 3's shape; S = 512: path 11's bench_attention rows at S = 512
        for name, key in (("attn_fwd", "fwd"), ("attn_bwd", "bwd")):
            kernels.append({
                "name": name + ("_bf16" if S == 80 else "_bf16_512"), "route": ROUTES[name],
                "source": BF16_SOURCE, "replaces": REPLACES[name],
                "launches": (launches_bf16[name].get("bfloat16", 0) if S == 80
                             else SEQ_LAUNCHES[name]),
                "max_abs_err": err[(name, "bfloat16", (B, H, S, D))], "ms": t[key],
                "plain_ms": t[key + " plain"], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": t[key + " sdpa"],
            })

    phase("timing: attention forward at the ViT's shapes, f32, zero bias, p = 0 (main path 8)")
    kernels += time_vit_attention(torch, A, gen, dev, embed, vit_err)

    phase("timing: attention kernels, bf16, at main path 9's shapes (the MLM's and the "
          "training ViT's)")
    kernels += time_pretext_attention(torch, A, gen, dev, pretext, err, vit_train_err)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
