#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds and runs its main path.

    python3 chip_smoke.py [--seed 0] [--svm-iters 4096] [--krr-iters 2048]

Phases (each one fails the run with a non-zero exit):

  1. build    compile every csrc/*.cu (one nvcc each, in parallel); the
              tensor-core flash kernels' SASS (forward, dkv and dq) must
              hold HGMMA and UTMALDG (cuobjdump -sass)
  2. parity   KMV and gram kernels against their plain PyTorch versions
              at the main path's shapes, f32 and bf16, every comparison
              repeating bit for bit: KMV in every regime of kmv_plan (r =
              1 the classical round, 32, 256, a 1024-query block, B = A
              the symmetric full matvec), gram also at the classical 1 x
              1 and the K-SVM 32 x 32 blocks; the KMV check must fail each
              regime's kernel with its last m split left out, the gram
              check the kernel with its last feature split left out
  3. K-SVM    KernelSVM(C=1, rbf) at the news20-like shape (m = 19996,
              n = 8192): s-step DCD (s = 32) and classical DCD on one
              schedule, the duality gap (one full KMV), prediction of
              2048 held-out queries through support-vector compaction
  4. K-RR     KernelRidge(lam=1, rbf), s-step BDCD (s = 8, b = 32) on
              the tolerance path, the relative-residual history, 2048
              predictions.  Phases 3-4's fits run their rounds as
              captured CUDA graphs (core.loop.RoundGraphs); their kmv and
              gram counts must be the launches the fits make (one each a
              round, one kmv a check, gap and prediction block), the
              warm-up rounds' launches printed apart; then (3-4b) each
              fit again with the operator not capturable (the eager
              loop) must give the same alpha and residual history bit for
              bit, and the s-step K-SVM rounds replayed with a stale
              schedule buffer (every run the first run's coordinates)
              must not
  5. stream + Nystrom, on the same data
       a. the streamed KMV pipe (A chunked in pinned host memory) and
          the row gather against their plain versions and the resident
          KMV, f32 and bf16, vector and (m, 4) X, r = 32, 256 and the
          full-matvec piece r = chunk_rows, at chunk_rows = 2048 (ragged
          tail) and 6000 (four chunks); the symmetric streamed full
          matvec (each chunk pair once, serving its mirror) against its
          plain pair loop and the resident symmetric KMV, repeating bit
          for bit, and its wrong variants (one pair's mirror product, the
          tail chunk's pair left out), which must fail
       b. KernelRidge(stream=2048) replaying phase 4's schedule at full
          depth, its residual history from the streamed full KMV; its
          device-memory growth must stay below A's bytes; its rounds
          take the eager loop (the streamed operator is not capturable)
       c. KernelSVM(s=32, stream=2048) replaying phase 3's schedule at
          full depth with one streamed duality gap (a check only at the
          last round: the depth cut is in checks, not iterations), and
          2048 predictions through BatchedPredictor(stream=1024); eager
          rounds too
       d. KernelRidge(approx="nystrom", landmarks=1024, uniform): the
          factor product on 512 rows against the plain build (and what a
          TF32 build reads against the same tolerance), the kernel error
          on a 2048-row subsample; its rounds captured, alpha and history
          equal to the eager loop's bit for bit, its runs timed
       e. pipelined, copy-only and compute-only times of the streamed
          KMV; the symmetric streamed full matvec's, beside the resident
          symmetric KMV and the ten-piece route it replaced, each against
          its bound; the pipe must read below copy-only + compute-only
  6. report   launch counts of phases 3-4, kernel times against their
              plain versions, bounds and library calls, timed with the
              launches queued behind a spin kernel, so the host's enqueue
              does not count, and eager beside it (KMV at r = 1, 32, 256,
              1024 and m, B = A and a copy of A, each with its regime;
              gram at 1 x 1, 32 x 32, 256 x 256 and 19 996 x 32, 1 x 1
              also through the 32 x 32 tile), the inner-phase share of an
              eager round; the fits' runs replayed as graphs (device ms a
              run and a round from events around 8 replays, host ms a
              run, capture time, graph pool bytes) and what is left of a
              replayed round beside its KMV and gram, per node
  7. LM       Qwen3-1.7B at its published widths (28 layers, d_model
              2048, 16 heads / 8 kv x 128, vocab 151 936), bf16,
              attn_impl="flash", random f32 weights from --seed:
       a. the rmsnorm and flash forward kernels against their plain
          versions at the path's shapes: the tensor-core forward (bf16,
          hd 64 and 128, ragged S and T) within its derived bf16 bound,
          the FP32-FMA forward (f32, hd != hdv); what the flash check
          reads for wrong variants (scale 5% off, a k tile skipped, k
          rows swapped in pairs within each tile: each must fail it)
       b. prefill: forward on 4 prompts of 2048 tokens; finite logits,
          113 rmsnorm and 28 tensor-core flash launches, held against the
          same forward with naive attention (bf16 and f32; the f32
          forward takes the FP32-FMA flash kernel 28 times; TF32
          attention must fail the f32 bound); time, tokens/s, memory peak
       c. 64 teacher-forced decode steps against the prefill logits
       d. ServingEngine(n_slots=4, max_seq=256) answers 8 requests (16-64
          prompt tokens, 32 new each, some arriving mid-flight), each
          held against the same request decoded alone by greedy_generate
       e. kernel times against bounds, plain versions, F.rms_norm and
          scaled_dot_product_attention (rmsnorm and F.rms_norm queued and
          eager, and the rmsnorm kernels' device time in one profiled
          prefill), the tensor-core forward beside the FP32-FMA one at
          (64, 2048, 128) and (32, 2048, 128)
  8. LM training, Qwen3-1.7B at the same widths, bf16 activations over f32
     params, attn_impl="flash", remat="full", random weights from --seed:
       a. the flash backward kernels (the tensor-core or the FP32-FMA dq
          and dkv) against their plain version on the same saved lse and
          delta at the path's shape (bf16, causal; dq, dk and dv within
          the derived bf16 bounds, repeating bit for bit) and f32, not
          causal, hd != hdv, hd 64 and ragged cases; what the check reads
          for wrong variants (delta left out, scale 5% off, a causal k
          tile skipped in dq, lse of the neighbouring row, k rows swapped
          in pairs: each must fail it); the RMSNorm Function's dx and
          dscale against autograd through its oracle
       b. loss_fn gradients at full width on 1 x 2048 tokens, through the
          kernels against the same model with naive attention (plain
          autograd): every leaf's gradient finite and non-zero, per-leaf
          relative error in f32 (the FP32-FMA kernels; TF32 attention
          must fail that bound) and bf16 (the tensor-core kernels)
       c. LM_TRAIN_STEPS steps of make_train_step on TokenPipeline batches
          of 4 x 2048 tokens in 2 microbatches, AdamW (lr 3e-5, warmup 2):
          finite and falling loss, lr on its schedule; launch counts per
          step; step time, tokens/s, device-memory peak, a profiled step
       d. the backward kernels' times against their bound, the plain
          version and the backward of scaled_dot_product_attention, the
          tensor-core dq and dkv beside the FP32-FMA ones

  9. sweeps, on phases 3-4's data (it runs after phase 6, before the LM
     phases free that data); nothing cut in width:
       a. KMV at c = F against its plain version, repeating bit for bit:
          r = 256 at c = 16 (the K-RR fleet round), r = 32 at c = 8 (the
          K-SVM fleet round), the full matvec B = A at c = 4, 8 and 16,
          each with the regime kmv_plan picks; at c = 16 the kernel with
          its last m split left out must fail; times against F launches at
          c = 1, the plain version and the bound; at c = 8 and 16 the wide
          plan kmv_plan took before beside the symmetric one
       b. solve_fleet(16 lambdas 1e-2..1e2 with 1.0, s=8 b=32 tol=1e-4)
          replaying phase 4's schedule: member lambda = 1 against phase 4
          and lambda = 100 against its own fit (1e-5), one kmv and one gram
          launch a round for the whole fleet and one kmv a check; an F = 1
          fleet equal to phase 4's fit bit for bit; the fleet cut at the
          check where its first member converged gives that member's alpha
          bit for bit
       c. solve_fleet(8 Cs with 1.0, s=32) replaying phase 3's schedule,
          held likewise against phase 3; both fleets' rounds and checks
          replayed and timed
       d. KernelRidge(s="auto", b="auto", probe=2) to the residual phase 4
          reached (its frontier, probes and winner); KernelRidge(stream=
          True): the chunk rows from the device's budget, measured link
          and chunk floor, its first residual check against phase 4's,
          its wall at most STREAM_AUTO_SLACK x the same fit's at 2048-row
          chunks
       e. reg_path over 4 lambdas (warm iterations against the fleet's
          cold ones) and cross_validate (3 folds, 4 lambdas, via the
          fleet, H = 512: a depth cut)
       f. FitResult.comm of phases 3-4, the fleets' modeled and measured
          speedups

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the ``{"kernels": [...]}`` record.  Without a CUDA
device, or without the port's sources beside this file, it exits
non-zero and prints no result.  TF32 is off throughout: the plain
versions and the kernels are compared in full f32.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and FP32 outside the
# tensor cores, the rate the kernels' f32 FMAs run at.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# bf16 dense tensor-core rate: the bound of a bf16 kernel's operations.
BF16_FLOP_PER_S = 989e12
# Host-to-device link of the streamed KMV: PCIe Gen5 x16, 128 GB/s both
# directions together in the H100 data sheet, so 64 GB/s one way (32 GT/s
# x 16 lanes, 128b/130b encoding: 63 GB/s of payload at best).
PCIE_H2D_BYTES_PER_S = 64e9

# Parity tolerances and their reasons.
TOL_KMV_F32 = 2e-4     # tests/test_kmv.py: f32 summation-order differences
TOL_GRAM_F32 = 1e-4    # tests/test_pallas_gram.py
TOL_BF16 = 2e-2        # bf16 inputs (both sides see the same bf16 values)
# s-step vs classical DCD on one schedule: each of the H = 4096 coordinate
# solves reads u^T alpha, an f32 sum over m ~ 2e4 terms of size up to
# ~1e2 (error ~1e-5), and the two methods round it differently; the
# difference compounds through the clipped updates, alpha in [0, C = 1].
TOL_SSTEP_VS_CLASSICAL = 1e-3
TOL_ORACLE = 1e-4      # facade predictions vs the dense oracle, relative
                       # to the largest decision value
# Rows per pinned chunk of the streamed phase: 64 MB of f32 at n = 8192,
# so ten chunks with a ragged tail at m = 19 996.
STREAM_CHUNK_ROWS = 2048
# Streamed vs resident metric histories on one schedule: the same f32
# full-KMV sums taken chunk by chunk in another order (~1e-6 relative).
TOL_STREAM_METRIC = 1e-4
# A fleet member against its single fit on one schedule: the reference's
# f32 iterate bound (tests/test_slabfree_parity.py).
TOL_ITERATE = 1e-5
# Phase 9d: the autotuned K-RR fit's budget (the model picks b = 1: it
# needs about the coordinate updates phase 4's b = 32 took to its check
# TUNED_CHECK, 16 384, and drawing its schedule costs the host O(H m):
# about 20 s at 2 ** 17 here), the check of phase 4 whose residual it must
# reach, and the checks of the stream=True fit (depth cuts of phase 4's
# and 5b's 16).
TUNED_MAX_ITERS = 2 ** 15
TUNED_CHECK = 4
STREAM_AUTO_CHECKS = 1
# how much slower than the same fit at 2048-row chunks the stream=True
# fit's wall may read (both pin A anew; run-to-run spread of such walls)
STREAM_AUTO_SLACK = 1.25
# Nystrom factor product Phi Phi^T, kernels against the plain build, in
# units of f32 eps x kappa(K_LL) x max|Phi Phi^T|: the gram kernel and
# its plain version sum the same f32 products in another order, so their
# entries of K (at most 1 for rbf) agree within a few eps (phase 2 reads
# ~6.5 eps at 256 x 256), and K_LL^{-1/2} amplifies a relative error in
# K_LL by up to kappa.
TOL_NYSTROM_EPS_KAPPA = 8.0
F32_EPS = 2.0 ** -23
# Phase 7 (the LM at Qwen3-1.7B width): B prompts of S tokens prefill, a
# teacher-forced decode of the first LM_DECODE_PROMPT of them, and an
# engine answering LM_REQUESTS requests of LM_NEW_TOKENS new tokens.
LM_BATCH, LM_SEQ = 4, 2048
LM_DECODE_PROMPT = 64
LM_REQUESTS, LM_NEW_TOKENS, LM_MAX_SEQ = 8, 32, 256
LM_PROFILE_STEPS = 8            # decode steps timed and profiled
TOL_RMSNORM_F32 = 1e-5          # tests/test_pallas_rmsnorm.py
TOL_FLASH_F32_R, TOL_FLASH_F32_A = 2e-4, 2e-5   # tests/test_flash_attention.py
# bf16 flash through the FP32-FMA kernels (head dims other than 64 and
# 128, hd != hdv): the kernel and flash_fwd_plain widen the same bf16
# q/k/v and compute in f32, so o differs only in its final bf16 rounding
# (at most one ulp, 2^-7 of |o|) and lse, f32 on both sides, is held to
# the f32 limits.
TOL_FLASH_BF16_R, TOL_FLASH_BF16_A = 1e-2, 1e-3
# bf16 flash through the tensor-core kernels (hd = hdv in {64, 128}): the
# derived elementwise bound of ref.flash_fwd_bf16_tolerance.  The kernel
# rounds each p (relative to the running max) to bf16 before the PV
# product, a relative error of at most u = 2^-8 per entry, so o = sum_j
# (p_j / l) v_j moves by at most u sum_j (p_j / l) |v_j|; the f32 sums
# add 2 T 2^-24 of the same terms and both sides' final rounding of o 2u
# |o|.  The bound is capped at the JAX package's bf16 bound, 3e-2
# (tests/test_flash_attention.py:49), so it is never looser; lse, from the
# f32 p on both sides, stays at the f32 limits.  The dk / dv bound of the
# tensor-core dkv kernel is the same sum over q with p and |ds| |q|
# (ref.flash_dkv_bf16_tolerance), and the tensor-core dq's the same sum
# over k with |ds| |k|, plus the f32 error of the score sums, which ds
# inherits where it is a cancellation residue of dp - delta
# (ref.flash_dq_bf16_tolerance); the FP32-FMA dq stays at one ulp.
# Relative Frobenius error of whole-model logits between two routes on
# the same weights.  bf16 (2^-8 relative) rounds the activations at every
# product, and the two routes round in different places (naive attention
# rounds the scores and probabilities to bf16, the flash kernel keeps
# them in f32; decode rounds each step's cache read and product): a
# relative error of a few 1e-3 per layer, summed along the residual
# stream of 28 layers, stays within the bf16 bound of the JAX model tests
# (tests/test_flash_attention.py, tests/test_models_smoke.py: 5e-2).  In
# f32 the routes differ only in summation order: the flash and naive
# logits read 2.97e-6 on the H100; attention with TF32 products reads far
# above TOL_LM_F32, which phase 7b checks on every run.
TOL_LM_BF16 = 5e-2
TOL_LM_F32 = 1e-5
# Phase 8 (LM training at Qwen3-1.7B width).  A step is LM_TRAIN_BATCH
# sequences of LM_SEQ tokens in LM_MICROBATCHES microbatches.
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_MICROBATCHES = 6, 4, 2
# lr 3e-5 peak after 2 warmup steps.  AdamW's sign-like early updates move
# every weight of the fresh model by lr, coherently: at peak 3e-4 the loss
# overshot at the second step (12.37, 11.99, 15.81, 10.89, 13.15, 11.19 on
# the H100), at 1e-4 at the third (12.37, 10.93, 13.62, 14.45, 10.65,
# 10.29), while one update at 5e-5 took 1.45 nats off.
LM_TRAIN_LR, LM_TRAIN_WARMUP = 3e-5, 2
# Flash backward, kernels against their plain version on the same saved lse
# and delta.  f32: 2e-4 / 2e-5, ten times tighter than the JAX gradient
# test's 2e-3 / 2e-4 (tests/test_flash_attention.py:68), which covers the
# Pallas kernels' own rounding: here both sides sum the same f32 products
# (no bf16 rounding of p) in at most another order.  bf16: one ulp of the
# single final rounding of dq, dk, dv, as for the forward's o.
TOL_FLASH_BWD_F32_R, TOL_FLASH_BWD_F32_A = 2e-4, 2e-5
# RMSNorm backward on the card (kernel forward, plain f32 backward) against
# autograd through the oracle: dx one bf16 rounding (TOL_BF16); dscale, f32
# sums over the rows in another order, relative to its largest entry.
TOL_RMSNORM_DSCALE = 1e-4
# Per-leaf relative Frobenius error of whole-model gradients, flash kernels
# against naive attention on the same weights and tokens.  f32: the two
# routes differ in summation order only; the worst of the 311 leaves read
# 2.6e-6 on the H100 (the forward logits 2.9e-6), attention with TF32
# products 6.1e-4 at the median leaf and 1.1e-3 at the worst, so the bound
# is the logits' 1e-5, and TF32 attention must read above it.  bf16: the
# JAX model tests' bound.
TOL_GRAD_F32 = 1e-5
TOL_GRAD_BF16 = 5e-2


# The libraries of the tensor-core flash kernels, whose SASS must hold
# HGMMA (wgmma) and UTMALDG (TMA loads), and a kernel each names.
WGMMA_LIBS = {"flash_fwd_wgmma": "flash_fwd_wgmma_kernel",
              "flash_bwd_wgmma": "flash_bwd_dkv_wgmma_kernel",
              "flash_bwd_dq_wgmma": "flash_bwd_dq_wgmma_kernel"}


def lm_norms(cfg) -> int:
    """RMSNorm launches in one forward or decode step: norm1 and norm2 of
    every layer, q_norm and k_norm with qk-norm, and final_norm."""
    return (4 if cfg.qk_norm else 2) * cfg.n_layers + 1


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def allclose_ratio(got, want, tol, magnitude_relative=False):
    """max |got - want| / (atol + tol |want|) — at most 1 passes.  atol is
    tol, or tol * max|want| where the tolerance is magnitude-relative
    (the polynomial kernel, ROADMAP C2)."""
    got, want = got.double(), want.double()
    atol = tol * max(1.0, float(want.abs().max())) if magnitude_relative \
        else tol
    err = (got - want).abs()
    return float((err / (atol + tol * want.abs())).max()), float(err.max())


def time_cuda(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_CYCLES_PER_MS = []


def time_queued(fn, iters: int) -> float:
    """Mean device milliseconds per call of a short kernel, with the host's
    enqueue hidden: a spin kernel (``torch.cuda._sleep``) holds the stream
    for three times the calls' measured host time while ``iters`` calls
    queue up behind it, so the events time them back to back on the card
    (at tiny shapes ``time_cuda`` times the host's Python instead)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not _CYCLES_PER_MS:              # the spin kernel's clock
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(3 * host_ms * _CYCLES_PER_MS[0]))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = FP32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gram_direct(A, B, cfg, bm, br, splits, per):
    """The gram kernel through its C entry point at a chosen output tile
    and split of the feature axis (``splits`` runs of ``per`` 32-feature
    chunks), not counted as a launch.  With ``splits`` one less than
    ``gram_splits`` gives, the partial grid and the reduce both leave the
    last split's features out: a wrong kernel for the parity check to
    catch."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels._launch import (DTYPE_CODES, check_inputs,
                                             kernel_args, raise_on_error)
    m, n = A.shape
    r = B.shape[0]
    out = torch.empty((m, r), dtype=torch.float32, device=A.device)
    ws = torch.empty(splits * (m * r + m + r), dtype=torch.float32,
                     device=A.device)
    code = build.launcher("gram")(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), ws.data_ptr(), m, r, n,
        check_inputs("gram", A, B), DTYPE_CODES[torch.float32],
        *kernel_args(cfg), bm, br, splits, per,
        torch.cuda.current_stream().cuda_stream)
    raise_on_error("gram", code)
    return out


def phase_split(kernel_phase, local_phase, rounds):
    """Mean host milliseconds of a round's kernel phase and local phase,
    synchronised after each."""
    import torch
    t_kernel = t_local = 0.0
    for k in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = kernel_phase(k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        local_phase(k, data)
        torch.cuda.synchronize()
        t_kernel += t1 - t0
        t_local += time.perf_counter() - t1
    return t_kernel / rounds * 1e3, t_local / rounds * 1e3


class DriverSpy:
    """Counts the round drivers the port's fits take, captured CUDA graphs
    (``core.loop.RoundGraphs``) or the eager loop
    (``core.loop._run_rounds_eager``), by wrapping both in ``core.loop``
    for the run's life."""

    def __init__(self):
        from repro_torch.core import loop
        self.graphs = self.eager = 0
        spy, graphs, eager = self, loop.RoundGraphs, loop._run_rounds_eager

        class Graphs(graphs):
            def __init__(self, *a, **k):
                spy.graphs += 1
                super().__init__(*a, **k)

        def run_eager(*a, **k):
            spy.eager += 1
            return eager(*a, **k)

        loop.RoundGraphs, loop._run_rounds_eager = Graphs, run_eager

    def take(self):
        """(graph drivers, eager loops) since the last take."""
        out = (self.graphs, self.eager)
        self.graphs = self.eager = 0
        return out


def bit_equal(got, want) -> tuple:
    """(equal bit for bit, max |got - want|) of two tensors or arrays."""
    import numpy as np
    import torch
    if isinstance(got, torch.Tensor):
        got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return False, float("inf")
    return bool(np.array_equal(got, want)), float(np.abs(got - want).max(
        initial=0.0))


def graph_timing(label, rf, a0, xs, c, runs=8, metric_fn=None):
    """Build ``RoundGraphs`` for one fit shape (runs of ``c`` rounds, the
    check's metric at the end of each with ``metric_fn``) and time its
    full-length runs: device ms per run from CUDA events around ``runs``
    replays, host ms per run (the copy of the schedule slice and the
    replay, no synchronise), the capture's seconds and its pool's bytes.
    Prints one line; returns the numbers."""
    import torch
    from repro_torch.core.loop import RoundGraphs
    with RoundGraphs(rf, a0, xs, c, metric_fn=metric_fn) as g:
        full = g.R // c
        g.run(0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(runs):
            g.run(i % full)
        host = (time.perf_counter() - t0) / runs * 1e3
        end.record()
        torch.cuda.synchronize()
        dev_ms = start.elapsed_time(end) / runs
        out = dict(run_ms=dev_ms, round_ms=dev_ms / c, host_ms=host,
                   capture_s=g.capture_s, warmup_s=g.warmup_s,
                   pool_bytes=g.pool_bytes, rounds=c,
                   launches=g.graph_launches[c])
    print(f"[graphs] {label}: runs of {c} rounds"
          f"{' + the check' if metric_fn else ''}: device {dev_ms:.3f} ms a "
          f"run over {runs} replays ({dev_ms / c:.4f} ms a round), host "
          f"{host:.3f} ms a run; capture {out['capture_s'] * 1e3:.1f} ms "
          f"(warm-up round {out['warmup_s'] * 1e3:.1f} ms), graph pool "
          f"{out['pool_bytes'] / 1e6:.2f} MB; kernel launches a run "
          f"{out['launches']}")
    return out


def stream_phase(c, args, failures):
    """Phase 5 (module docstring).  ``c`` holds phases 3-4's data and
    fits; returns the ``kmv_stream`` and ``kmv_stream_full`` entries of
    the kernels record."""
    import torch
    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.core import (BatchedPredictor, KernelConfig,
                                  LowRankGramOperator, StreamingGramOperator,
                                  krr_rel_residual, ksvm_predict,
                                  make_sstep_bdcd_round_fn,
                                  nystrom, pad_rounds, sstep_dcd_inner)
    from repro_torch.core.kernels import _chunk
    from repro_torch.kernels.gram import gram_cuda, gram_plain
    from repro_torch.kernels.kmv import kmv_cuda
    from repro_torch.kernels.kmv_stream import (full_launch,
                                                gather_rows_cuda,
                                                kmv_stream_cuda,
                                                kmv_stream_full_cuda,
                                                kmv_stream_full_plain,
                                                kmv_stream_full_resident,
                                                kmv_stream_plain,
                                                kmv_stream_resident)

    dev, m, n, rbf = c.dev, c.m, c.n, c.kernels["rbf"]
    CR = STREAM_CHUNK_ROWS
    f32, bf16 = torch.float32, torch.bfloat16

    # ---- a. parity ---------------------------------------------------
    t0 = time.perf_counter()
    A_h = c.A.cpu()
    A_d = {f32: c.A, bf16: c.A.to(bf16)}
    Xc_of = {(dt, cr): _chunk(A_h.to(dt), cr, pin=True)
             for dt in (f32, bf16) for cr in (CR, 6000)}
    print(f"[stream] pinned chunks of A built in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{str(dt)[6:]} {cr} rows x {Xc.shape[0]}"
                      for (dt, cr), Xc in Xc_of.items()))
    err_at = {}
    t0 = time.perf_counter()
    cases = [(cfg_name, dt, cr, bname, xname)
             for dt in (f32, bf16) for cr in (CR, 6000)
             for bname in ("r32", "r256", "piece")
             for xname in ("vec", "mat4") for cfg_name in ("rbf",)]
    cases += [(k, f32, CR, "r256", "vec") for k in ("linear", "polynomial")]
    for kname, dt, cr, bname, xname in cases:
        cfg = c.kernels[kname]
        tol = TOL_KMV_F32 if dt == f32 else TOL_BF16
        Xc = Xc_of[(dt, cr)]
        B = (A_d[dt][:cr] if bname == "piece"
             else c.B_of[bname].to(dt)).contiguous()
        X = c.Xv if xname == "vec" else c.Xm
        Xvc = _chunk(X.reshape(m, -1), cr)
        got = kmv_stream_cuda(Xc, B, Xvc, cfg, m=m)
        want = kmv_stream_plain(Xc, B, Xvc, cfg, m=m)
        resident = kmv_cuda(A_d[dt], B, X, cfg).reshape(got.shape)
        poly = kname == "polynomial"
        for ref_name, ref in (("plain", want), ("resident kmv", resident)):
            ratio, err = allclose_ratio(got, ref, tol, poly)
            err_at[(kname, str(dt), cr, bname, xname, ref_name)] = err
            if not ratio <= 1.0 or got.shape != ref.shape:
                failures.append(f"kmv_stream {kname} {dt} cr={cr} {bname} "
                                f"{xname} vs {ref_name}: max abs err "
                                f"{err:.3e} ({ratio:.2f}x tolerance)")
    # the symmetric full matvec of every check, K(A, A) X
    full_cases = [(k, dt, cr, xname) for dt in (f32, bf16)
                  for cr in (CR, 6000) for xname in ("vec", "mat4")
                  for k in ("rbf",)]
    full_cases += [(k, f32, CR, "vec") for k in ("linear", "polynomial")]
    for kname, dt, cr, xname in full_cases:
        cfg = c.kernels[kname]
        tol = TOL_KMV_F32 if dt == f32 else TOL_BF16
        X = (c.Xv if xname == "vec" else c.Xm).reshape(m, -1)
        Xvc = _chunk(X, cr)
        got = kmv_stream_full_cuda(Xc_of[(dt, cr)], Xvc, cfg, m=m)
        want = kmv_stream_full_plain(Xc_of[(dt, cr)], Xvc, cfg, m=m)
        resident = kmv_cuda(A_d[dt], A_d[dt], X, cfg)
        poly = kname == "polynomial"
        for ref_name, ref in (("plain", want), ("resident kmv", resident)):
            ratio, err = allclose_ratio(got, ref, tol, poly)
            err_at[("full", kname, str(dt), cr, xname, ref_name)] = err
            if not ratio <= 1.0 or got.shape != ref.shape:
                failures.append(f"kmv_stream_full {kname} {dt} cr={cr} "
                                f"{xname} vs {ref_name}: max abs err "
                                f"{err:.3e} ({ratio:.2f}x tolerance)")
        if not torch.equal(got, kmv_stream_full_cuda(Xc_of[(dt, cr)], Xvc,
                                                     cfg, m=m)):
            failures.append(f"kmv_stream_full {kname} {dt} cr={cr} "
                            f"{xname}: a second call gave other bits")
        if (kname, dt, cr, xname) == ("rbf", f32, CR, "vec"):
            for drop, what in ((1, "pair (0, 1) without its mirror product"),
                               (2, "pair (0, tail chunk) left out")):
                bad = full_launch(Xc_of[(dt, cr)], Xvc, cfg, m, drop=drop)
                ratio, err = allclose_ratio(bad, want, tol)
                err_at[("full-wrong", what)] = (err, ratio)
                if ratio <= 1.0:
                    failures.append(f"kmv_stream_full check passes a wrong "
                                    f"pipe ({what}: {ratio:.2f}x)")
    sel = torch.cat([c.pick[:256], c.pick[:7]])       # with repeats
    for dt in (f32, bf16):
        got = gather_rows_cuda(Xc_of[(dt, CR)], sel)
        if not torch.equal(got, A_d[dt][sel]):
            failures.append(f"gather_rows {dt}: rows differ")
    torch.cuda.synchronize()
    n_cmp = sum(k[0] != "full-wrong" for k in err_at)
    print(f"[stream] {n_cmp} kmv_stream / kmv_stream_full comparisons and 2"
          f" gathers in {time.perf_counter() - t0:.1f} s; tolerances: f32 "
          f"{TOL_KMV_F32}, bf16 {TOL_BF16}, polynomial relative to max "
          f"|output|; gather exact")
    for key in (("rbf", "torch.float32", CR, "r32", "vec", "plain"),
                ("rbf", "torch.float32", CR, "r32", "vec", "resident kmv"),
                ("rbf", "torch.float32", CR, "piece", "mat4", "plain"),
                ("rbf", "torch.float32", 6000, "r256", "vec",
                 "resident kmv"),
                ("rbf", "torch.bfloat16", CR, "r256", "mat4", "plain"),
                ("polynomial", "torch.float32", CR, "r256", "vec",
                 "plain"),
                ("full", "rbf", "torch.float32", CR, "vec", "plain"),
                ("full", "rbf", "torch.float32", CR, "vec", "resident kmv"),
                ("full", "rbf", "torch.bfloat16", 6000, "mat4", "plain"),
                ("full", "polynomial", "torch.float32", CR, "vec",
                 "plain")):
        print(f"[stream] parity {' '.join(map(str, key))}: max abs err "
              f"{err_at[key]:.3e}")
    for key, (err, ratio) in ((k, v) for k, v in err_at.items()
                              if k[0] == "full-wrong"):
        print(f"[stream] kmv_stream_full with {key[1]}: max abs err "
              f"{err:.3e} ({ratio:.1f}x tolerance; must fail)")
    del A_d[bf16]
    for key in [k for k in Xc_of if k != (f32, CR)]:
        del Xc_of[key]
    if failures:
        return None

    # ---- b-d. the streamed and Nystrom paths ------------------------------
    for fn in (kmv_cuda, gram_cuda, kmv_stream_cuda, kmv_stream_full_cuda,
               gather_rows_cuda):
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    krr_s = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                        options=SolverOptions(
                            method="sstep", s=8, b=32, stream=CR,
                            record=True, check_every=16,
                            max_iters=args.krr_iters, seed=args.seed))
    c.spy.take()
    r_ks = krr_s.fit(c.Ar.cpu(), c.yr, schedule=c.r_k.schedule)
    torch.cuda.synchronize()
    drivers = c.spy.take()
    print(f"[stream-krr] driver: {drivers[1]} eager loop, {drivers[0]} "
          f"captured (StreamingGramOperator.capturable = "
          f"{StreamingGramOperator.capturable})")
    if drivers != (0, 1):
        failures.append(f"the streamed K-RR fit took drivers {drivers}")
    growth = torch.cuda.max_memory_allocated() - base
    a_bytes = c.Ar.numel() * c.Ar.element_size()
    d_krr = float((r_ks.alpha - c.r_k.alpha).abs().max())
    h_s, h_r = r_ks.history, c.r_k.history
    d_hist = (float(abs(h_s - h_r).max() / abs(h_r).max())
              if h_s.shape == h_r.shape else float("inf"))
    print(f"[stream-krr] s=8 b=32 stream={CR}: {r_ks.iters_run} iters, "
          f"{r_ks.rounds_run} rounds, {len(h_s)} streamed residual checks,"
          f" {r_ks.wall_time_s:.2f} s (resident fit {c.r_k.wall_time_s:.2f}"
          f" s)")
    print(f"[stream-krr] max|a_stream - a_resident| = {d_krr:.3e} (bound "
          f"{TOL_SSTEP_VS_CLASSICAL}); residual history max rel diff "
          f"{d_hist:.3e} (bound {TOL_STREAM_METRIC}); last "
          f"{float(h_s[-1]):.4e}")
    print(f"[stream-krr] device memory growth during the fit: "
          f"{growth / 1e6:.1f} MB (A itself: {a_bytes / 1e6:.1f} MB)")
    if not d_krr <= TOL_SSTEP_VS_CLASSICAL:
        failures.append(f"streamed vs resident K-RR alpha {d_krr:.3e}")
    if not d_hist <= TOL_STREAM_METRIC:
        failures.append(f"streamed vs resident K-RR residuals {d_hist:.3e}")
    if not growth < a_bytes:
        failures.append(f"the streamed K-RR fit grew device memory by "
                        f"{growth} bytes, not below A's {a_bytes}")

    rounds = -(-c.r_s.iters_run // 32)
    svm_s = KernelSVM(C=1.0, kernel="rbf", device=dev,
                      options=SolverOptions(
                          method="sstep", s=32, stream=CR, record=True,
                          check_every=rounds, max_iters=args.svm_iters,
                          seed=args.seed))
    r_ss = svm_s.fit(c.A.cpu(), c.y, schedule=c.r_s.schedule)
    drivers = c.spy.take()
    print(f"[stream-ksvm] driver: {drivers[1]} eager loop, {drivers[0]} "
          f"captured")
    if drivers != (0, 1):
        failures.append(f"the streamed K-SVM fit took drivers {drivers}")
    d_svm = float((r_ss.alpha - c.r_s.alpha).abs().max())
    gap_s = float(r_ss.history[-1])
    d_gap = abs(gap_s - c.gap) / max(1.0, abs(c.gap))
    t0 = time.perf_counter()
    pred = BatchedPredictor(svm_s.op_, svm_s.alpha_ * svm_s.y_, batch=1024,
                            compact=True, stream=1024)
    f_qs = pred(c.Aq.cpu())
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    f_ref = ksvm_predict(c.A, c.y, r_ss.alpha, c.Aq[:64], svm_s.cfg)
    ratio, err = allclose_ratio(f_qs[:64], f_ref, TOL_ORACLE, True)
    print(f"[stream-ksvm] s=32 stream={CR}: {r_ss.iters_run} iters, "
          f"{r_ss.rounds_run} rounds, {r_ss.wall_time_s:.2f} s (resident "
          f"{c.r_s.wall_time_s:.2f} s)")
    print(f"[stream-ksvm] max|a_stream - a_resident| = {d_svm:.3e}; "
          f"streamed duality gap {gap_s:.6e} vs resident {c.gap:.6e} "
          f"(rel diff {d_gap:.3e})")
    print(f"[stream-ksvm] predict {f_qs.shape[0]} host queries in chunks of"
          f" 1024 on {pred.op.n_samples} support vectors: "
          f"{t_pred * 1e3:.1f} ms; vs dense oracle max abs err {err:.3e}")
    if not d_svm <= TOL_SSTEP_VS_CLASSICAL:
        failures.append(f"streamed vs resident K-SVM alpha {d_svm:.3e}")
    if not d_gap <= TOL_STREAM_METRIC:
        failures.append(f"streamed vs resident duality gap {d_gap:.3e}")
    if not (f_qs.shape == (c.q,) and bool(torch.isfinite(f_qs).all())
            and ratio <= 1.0):
        failures.append(f"streamed K-SVM predictions vs dense oracle "
                        f"{err:.3e}")

    nys = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=SolverOptions(
                          method="sstep", s=8, b=32, approx="nystrom",
                          landmarks=1024, landmark_method="uniform",
                          tol=1e-4, check_every=16, max_iters=args.krr_iters,
                          seed=args.seed))
    r_n = nys.fit(c.Ar, c.yr)
    p_n = nys.predict(c.Arq)
    torch.cuda.synchronize()
    drivers = c.spy.take()
    with mock.patch.object(LowRankGramOperator, "capturable", False):
        e_n = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                          options=nys.options).fit(c.Ar, c.yr)
    e_drivers = c.spy.take()
    print(f"[nystrom] drivers: the fit {drivers[0]} captured, {drivers[1]} "
          f"eager; its refit with the operator not capturable "
          f"{e_drivers[1]} eager, {e_drivers[0]} captured")
    if drivers != (1, 0) or e_drivers != (0, 1):
        failures.append(f"the Nystrom fits took drivers {drivers}, "
                        f"{e_drivers}")
    for label, got, want in (("alpha", r_n.alpha, e_n.alpha),
                             ("residual history", r_n.history,
                              e_n.history)):
        same, diff = bit_equal(got, want)
        print(f"[nystrom] {label}: captured vs eager "
              f"{'equal bit for bit' if same else 'DIFFER'} (max abs diff "
              f"{diff:.3e})")
        if not same:
            failures.append(f"Nystrom captured vs eager {label}: {diff:.3e}")
    # the fit's runs as the facade builds them: the linear kernel over Phi
    lin = dataclasses.replace(nys.cfg, kernel=KernelConfig("linear"))
    Phi = nys.op_.Phi
    graph_timing("K-RR Nystrom l=1024 s=8 b=32",
                 make_sstep_bdcd_round_fn(Phi, c.yr, lin, 8, op=nys.op_),
                 torch.zeros_like(c.yr), pad_rounds(r_n.schedule, 8), 16,
                 metric_fn=lambda a: krr_rel_residual(Phi, c.yr, a, lin))
    launches = {"kmv_stream": kmv_stream_cuda.launches,
                "kmv_stream_full": kmv_stream_full_cuda.launches,
                "gather_rows": gather_rows_cuda.launches,
                "gram": gram_cuda.launches, "kmv": kmv_cuda.launches}
    print(f"[stream path] launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if min(launches.values()) < 1:
        failures.append(f"a kernel of the stream/Nystrom path was never "
                        f"launched: {launches}")

    # the factor product against the same build through the plain versions
    fmap, jitter = nys.op_.fmap, 1e-6
    L = fmap.landmarks
    sidx = c.pick[:512]
    A_s = c.Ar[sidx].contiguous()

    def plain_map():
        lam, V = torch.linalg.eigh(gram_plain(L, L, rbf))
        T = (V * torch.clamp(lam, min=jitter) ** -0.5) @ V.T
        return lam, T, gram_plain(A_s, L, rbf) @ T

    lam, T_p, Phi_p = plain_map()
    # a relative error d in K_LL moves K_LL^{-1} by up to kappa * d
    kappa = float(lam.max() / torch.clamp(lam.min(), min=jitter))
    tol_phi = TOL_NYSTROM_EPS_KAPPA * F32_EPS * kappa
    Phi_k = nys.op_.Phi[sidx]
    P_p = Phi_p @ Phi_p.T
    ratio, err = allclose_ratio(Phi_k @ Phi_k.T, P_p, tol_phi, True)
    # what a build with TF32 products would read against the same check
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Phi_t = plain_map()[2]
        P_t = Phi_t @ Phi_t.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ratio_t, err_t = allclose_ratio(P_t, P_p, tol_phi, True)
    w_p = (gram_plain(c.Ar, L, rbf) @ T_p).T @ r_n.alpha
    f_ref = (gram_plain(c.Arq[:64].contiguous(), L, rbf) @ T_p) @ w_p
    ratio_f, err_f = allclose_ratio(p_n[:64], f_ref / nys.cfg.lam, tol_phi,
                                    True)
    k_err = nystrom.nystrom_kernel_error(c.Ar[:2048].contiguous(), L, rbf)
    hist = [float(v) for v in r_n.history]
    print(f"[nystrom] l=1024 uniform: {r_n.iters_run} iters, "
          f"{r_n.rounds_run} rounds, converged={r_n.converged}, "
          f"{r_n.wall_time_s:.2f} s; residual history "
          + " ".join(f"{v:.4e}" for v in hist))
    print(f"[nystrom] K_LL eigenvalues {float(lam.min()):.4e} .. "
          f"{float(lam.max()):.4e} (floor {jitter}), kappa {kappa:.1f}: "
          f"Phi Phi^T on 512 rows vs plain build max abs err {err:.3e} "
          f"({ratio:.3f} x tolerance {tol_phi:.2e} = "
          f"{TOL_NYSTROM_EPS_KAPPA:g} x f32 eps x kappa); a TF32 build "
          f"reads {err_t:.3e} ({ratio_t:.3f} x tolerance); predictions vs "
          f"plain map max abs err {err_f:.3e}")
    print(f"[nystrom] kernel error ||K - Phi Phi^T||_F / ||K||_F on 2048 "
          f"rows: {k_err:.4e}")
    if not ratio <= 1.0:
        failures.append(f"Nystrom factor product vs plain build {err:.3e}")
    if not (ratio_f <= 1.0 and p_n.shape == (c.q,)
            and bool(torch.isfinite(p_n).all())):
        failures.append(f"Nystrom predictions vs plain map {err_f:.3e}")
    if not (hist and all(v == v for v in hist) and hist[-1] < hist[0]):
        failures.append(f"Nystrom residual history does not fall: {hist}")
    if not 0.0 <= k_err < 1.0:
        failures.append(f"Nystrom kernel error {k_err}")
    if failures:
        return None

    # ---- e. pipelined, copy-only and compute-only times -------------------
    Xc = Xc_of[(f32, CR)]
    nc = Xc.shape[0]
    Xc_dev = Xc.to(dev)
    slots = torch.empty((2, CR, n), device=dev)

    def copy_only():                      # the library yardstick: the
        for i in range(nc):               # same chunks, one stream
            slots[i % 2].copy_(Xc[i], non_blocking=True)

    Xvc = _chunk(c.Xv[:, None], CR)
    x_bytes = Xc.numel() * Xc.element_size()       # copied, padded tail too
    a_bytes = m * n * Xc.element_size()            # what K(A,B)^T X must move
    copy_ms = time_cuda(copy_only, 10)
    rows = {}
    for label, B, iters in (("r32", c.B_of["r32"], 10),
                            ("r256", c.B_of["r256"], 5),
                            ("piece", c.A[:CR].contiguous(), 3)):
        r = B.shape[0]
        ms = time_cuda(lambda: kmv_stream_cuda(Xc, B, Xvc, rbf, m=m), iters)
        comp = time_cuda(lambda: kmv_stream_resident(Xc_dev, B, Xvc, rbf,
                                                     m=m), iters)
        plain = time_cuda(lambda: kmv_stream_plain(Xc, B, Xvc, rbf, m=m),
                          iters)
        flops = 2 * m * r * n + 2 * m * r + 2 * (m + r) * n + 6 * m * r
        t_link, t_ops = a_bytes / PCIE_H2D_BYTES_PER_S, flops / FP32_FLOP_PER_S
        b_ms = max(t_link, t_ops) * 1e3
        b_by = "bytes" if t_link >= t_ops else "operations"
        rows[label] = dict(ms=ms, copy=copy_ms, comp=comp, plain=plain,
                           bound=b_ms, by=b_by, r=r)
        print(f"[stream-time] kmv_stream rbf ({m}, {r}, {n}) c=1 in {nc} "
              f"chunks of {CR}: pipelined {ms:.4f} ms | copy-only "
              f"{copy_ms:.4f} ms ({x_bytes / copy_ms / 1e6:.1f} GB/s) | "
              f"compute-only {comp:.4f} ms | plain {plain:.4f} ms | bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it) | overlap: "
              f"pipelined / max(copy, compute) = "
              f"{ms / max(copy_ms, comp):.3f}")
    for k in (32, 256):                   # the rows a round gathers
        g_ms = time_cuda(lambda: gather_rows_cuda(Xc, c.pick[:k]), 20)
        print(f"[stream-time] gather_rows of {k} sampled rows "
              f"({k * n * 4 / 1e6:.2f} MB read from the mapped host "
              f"buffer): {g_ms:.4f} ms")
    t0 = time.perf_counter()
    op = StreamingGramOperator.from_dense(c.A, rbf, CR, device=dev)
    t1 = time.perf_counter()
    op.scale_rows(c.y)
    t2 = time.perf_counter()
    print(f"[stream-time] streamed representation build, A (on the card "
          f"here) to pinned chunks: {(t1 - t0) * 1e3:.1f} ms; K-SVM "
          f"scale_rows on the host into new pinned chunks: "
          f"{(t2 - t1) * 1e3:.1f} ms")
    op_svm = svm_s.op_.scale_rows(c.y)
    idx_s, valid_s = pad_rounds(r_ss.schedule, 32)
    a_s, cfg_svm = r_ss.alpha, svm_s.cfg
    sk, sl = phase_split(
        lambda k: op_svm.round_data(idx_s[k], a_s),
        lambda k, d: sstep_dcd_inner(d[0], d[1], a_s[idx_s[k]], idx_s[k],
                                     cfg_svm.nu, cfg_svm.omega, 32,
                                     valid_s[k]), min(16, len(idx_s)))
    print(f"[rounds] streamed K-SVM s=32: kernel phase {sk:.3f} ms "
          f"(gather, gram, kmv_stream), local phase {sl:.3f} ms, local "
          f"share {sl / (sk + sl):.1%}")
    del op_svm
    # the full matvec K(A, A) x of every check: the symmetric pipe, its
    # chunk copies alone (in its order, through its three slots), its
    # launches over resident chunks, the resident symmetric KMV and the
    # ten-piece route of PR 12-17 (one kmv_stream_cuda a chunk of output
    # rows, built here as a yardstick only)
    Xvc1 = _chunk(c.Xv[:, None], CR)
    order = [0] + [j for i in range(nc) for j in range(nc - 1, i, -1)]
    slots3 = torch.empty((3, CR, n), device=dev)

    def full_copy_only():
        for k, j in enumerate(order):
            slots3[k % 3].copy_(Xc[j], non_blocking=True)

    def pieces():
        return torch.cat([kmv_stream_cuda(
            Xc, Xc[j].to(dev, non_blocking=True), Xvc1, rbf, m=m)
            for j in range(nc)])[:m]

    full_s = time_cuda(lambda: op.full_matvec(c.Xv), 3, warmup=1)
    full_copy = time_cuda(full_copy_only, 3)
    full_c = time_cuda(lambda: kmv_stream_full_resident(Xc_dev, Xvc1, rbf,
                                                        m=m), 3)
    full_r = time_cuda(lambda: kmv_cuda(c.A, c.A, c.Xv, rbf), 2, warmup=1)
    full_p = time_cuda(pieces, 2, warmup=1)
    full_plain = time_cuda(lambda: kmv_stream_full_plain(Xc, Xvc1, rbf,
                                                         m=m), 2)
    # K(A, A) is symmetric: the work of its m (m + 1) / 2 distinct
    # entries (as phase 6 counts the resident B = A row), against A's
    # bytes over the link once
    pairs = m * (m + 1) // 2
    t_link = a_bytes / PCIE_H2D_BYTES_PER_S
    t_ops = (2 * pairs * n + 2 * m * m + 4 * m * n + 6 * pairs) \
        / FP32_FLOP_PER_S
    full_b = max(t_link, t_ops) * 1e3
    full_by = "bytes" if t_link >= t_ops else "operations"
    del slots3
    print(f"[stream-time] full K @ x ({m}^2 x {n}) c=1, symmetric pipe "
          f"({len(order)} chunk copies, {nc} anchors): {full_s:.2f} ms "
          f"({full_b / full_s:.1%} of its bound {full_b:.2f} ms, "
          f"{full_by}) | copy-only {full_copy:.2f} ms "
          f"({len(order) * Xc[0].numel() * 4 / full_copy / 1e6:.1f} GB/s) "
          f"+ compute-only {full_c:.2f} ms ({full_b / full_c:.1%}) = "
          f"{full_copy + full_c:.2f} ms | resident symmetric kmv "
          f"{full_r:.2f} ms ({full_b / full_r:.1%}) | ten-piece route "
          f"{full_p:.2f} ms ({full_b / full_p:.1%}) | plain pair loop "
          f"{full_plain:.2f} ms")
    print(f"[stream-time] launches on the streamed fits: kmv_stream "
          f"{launches['kmv_stream']}, kmv_stream_full "
          f"{launches['kmv_stream_full']}, gather_rows "
          f"{launches['gather_rows']}")
    if not full_s < full_copy + full_c:
        failures.append(f"the symmetric pipe does not overlap: streamed full "
                        f"KMV {full_s:.2f} ms >= copy-only {full_copy:.2f} "
                        f"+ compute-only {full_c:.2f} ms")
    del Xc_dev, slots
    r32 = rows["r32"]
    return [{"name": "kmv_stream", "route": "cuda",
            "source": "src/repro_torch/csrc/kmv_stream.cu",
            "replaces": "src/repro/kernels/kmv_stream.py:111",
            "shape": f"rbf (m, r, n, c) = ({m}, 32, {n}, 1) in {nc} pinned "
                     f"chunks of {CR}",
            "launches": launches["kmv_stream"],
            "max_abs_err": err_at[("rbf", "torch.float32", CR, "r32", "vec",
                                   "plain")],
            "ms": r32["ms"], "plain_ms": r32["plain"],
            "bound_ms": r32["bound"], "bound_by": r32["by"],
            "library_ms": None, "copy_only_ms": r32["copy"],
            "compute_only_ms": r32["comp"],
            "gather_rows_launches": launches["gather_rows"]}, {
            "name": "kmv_stream_full", "route": "cuda",
            "source": "src/repro_torch/csrc/kmv_stream.cu",
            "replaces": "src/repro/kernels/kmv_stream.py:111",
            "shape": f"rbf full matvec K(A, A) x, (m, n, c) = ({m}, {n}, 1)"
                     f" in {nc} pinned chunks of {CR}, {len(order)} chunk "
                     f"copies",
            "launches": launches["kmv_stream_full"],
            "max_abs_err": err_at[("full", "rbf", "torch.float32", CR,
                                   "vec", "plain")],
            "ms": full_s, "plain_ms": full_plain, "bound_ms": full_b,
            "bound_by": full_by, "library_ms": None,
            "copy_only_ms": full_copy, "compute_only_ms": full_c,
            "resident_kmv_ms": full_r, "ten_piece_route_ms": full_p}]



def sweep_phase(c, args, failures):
    """Phase 9 (module docstring), on phases 3-4's data and fits in ``c``:
    KMV at c = F, the K-RR and K-SVM fleets, the autotuner, a streamed fit
    with its chunk rows from the device's budget, the warm-started path
    and cross-validation.  Returns the c = F KMV entries of the kernels
    record."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.core import ExactGramOperator, pad_rounds
    from repro_torch.core.perf_model import stream_working_set_bytes
    from repro_torch.kernels.gram import gram_cuda
    from repro_torch.kernels.kmv import (WS_MAX_FLOATS, KmvPlan, kmv_cuda,
                                         kmv_plain, kmv_plan)
    from repro_torch.kernels.kmv import launch as kmv_launch
    from repro_torch.kernels._launch import check_inputs, sm_count
    from repro_torch.core.loop import FAST_RUN
    from repro_torch.tune import cross_validate, reg_path, solve_fleet
    from repro_torch.tune.fleet import fleet_metric

    dev, m, n, A, Ar = c.dev, c.m, c.n, c.A, c.Ar
    rbf = c.kernels["rbf"]
    sms = sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    t_phase = time.perf_counter()

    def counts():
        return kmv_cuda.launches, gram_cuda.launches

    def reset():
        for fn in (kmv_cuda, gram_cuda):
            fn.launches = fn.warmup_launches = 0

    # ---- 9a. KMV at c = F ---------------------------------------------
    code = check_inputs("kmv", A, A)
    kmv_at = {}
    for label, B, F in (("K-RR fleet round", c.B_of["r256"], 16),
                        ("K-SVM fleet round", c.B_of["r32"], 8),
                        ("full matvec, B = A", A, 4),
                        ("full matvec, B = A", A, 8),
                        ("full matvec, B = A", A, 16)):
        r = B.shape[0]
        X = torch.randn((m, F), generator=gen, device=dev)
        plan = kmv_plan(m, r, F, sms, B is A)
        got = kmv_cuda(A, B, X, rbf)
        want = kmv_plain(A, B, X, rbf)
        ratio, err = allclose_ratio(got, want, TOL_KMV_F32)
        same = torch.equal(got, kmv_cuda(A, B, X, rbf))
        iters = 2 if B is A else 10
        ms = time_queued(lambda: kmv_cuda(A, B, X, rbf), iters)
        one = time_queued(lambda: kmv_cuda(A, B, X[:, 0], rbf), iters)
        plain = time_queued(lambda: kmv_plain(A, B, X, rbf), 1 if B is A
                            else iters)
        pairs = m * (m + 1) // 2 if B is A else m * r
        nbytes = 4 * (m * n + (0 if B is A else r * n) + m * F + r * F)
        flops = 2 * pairs * n + 2 * m * r * F + 2 * (m + r) * n + 6 * pairs
        b_ms, b_by = bound_ms(nbytes, flops)
        row = dict(label=label, r=r, F=F, plan=plan, err=err, ms=ms,
                   one=one, plain=plain, bound=b_ms, by=b_by)
        if B is A and F >= 8:
            # the plan kmv_plan took before the symmetric workspace limit:
            # every tile, the split in runs of whole tiles
            m_tiles = -(-m // 128)
            per = -(-m_tiles // min(m_tiles, WS_MAX_FLOATS // (r * F)))
            wide = KmvPlan("wide", 128, 128, -(-m_tiles // per), per * 128)
            row["wide"] = time_queued(
                lambda: kmv_launch(A, A, X, rbf, wide, code), iters)
            wide_err = float((kmv_launch(A, A, X, rbf, wide, code)
                              - want).abs().max())
            row["wide_err"] = wide_err
        if B is A and F == 16:
            bad = kmv_launch(A, A, X, rbf,
                             plan._replace(splits=plan.splits - 1), code)
            bad_ratio, bad_err = allclose_ratio(bad, want, TOL_KMV_F32)
            print(f"[sweep] kmv c=16 B = A ({plan.regime}) with its last m "
                  f"split left out: max abs err {bad_err:.3e} "
                  f"({bad_ratio:.1f}x tolerance; must fail)")
            if bad_ratio <= 1.0:
                failures.append("the c = 16 KMV check passes a kernel with "
                                "its last split left out")
        kmv_at[(label, F)] = row
        print(f"[sweep] kmv rbf ({m}, {r}, {n}) c={F} [{plan.regime} "
              f"{plan.bm} x {plan.br}, {plan.splits} splits]: {ms:.4f} ms "
              f"against {F} x c=1 {F * one:.4f} ms (c=1 {one:.4f}) | plain "
              f"{plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / ms:.1%} of it) | max abs err {err:.3e}"
              + (f" | the wide plan of the same call {row['wide']:.4f} ms "
                 f"(max abs err {row['wide_err']:.3e})" if "wide" in row
                 else ""))
        if not ratio <= 1.0:
            failures.append(f"kmv c={F} {label}: {err:.3e} ({ratio:.2f}x "
                            f"tolerance)")
        if not same:
            failures.append(f"kmv c={F} {label}: a second call gave other "
                            f"bits")
    del X, got, want
    torch.cuda.empty_cache()

    # ---- 9b. the K-RR fleet -------------------------------------------
    lams = np.delete(np.logspace(-2, 2, 17), 1)         # 16, 1.0 among them
    i_one, i_big = int(np.argmin(abs(lams - 1.0))), len(lams) - 1
    opts_k = c.krr.options
    full_k = api._schedule("krr", opts_k, m, 32, dev)   # phase 4's draw
    if not torch.equal(full_k[:c.r_k.iters_run], c.r_k.schedule):
        failures.append("the redrawn K-RR schedule is not phase 4's")
    c.spy.take()
    reset()
    fk = solve_fleet(Ar, c.yr, lams=lams, kernel="rbf", options=opts_k,
                     schedule=full_k, device=dev)
    fk_counts = counts()
    fk_warm = (kmv_cuda.warmup_launches, gram_cuda.warmup_launches)
    drivers = c.spy.take()
    checks = fk.history.shape[0]
    want_counts = (fk.rounds_run + checks, fk.rounds_run)
    print(f"[sweep] K-RR fleet, F = {len(lams)} lambdas "
          f"{lams.min():.0e}..{lams.max():.0e}, s=8 b=32 tol="
          f"{opts_k.tol:g}: {fk.rounds_run} rounds, {checks} checks, "
          f"converged {int(fk.converged.sum())}/{len(lams)}, "
          f"{fk.wall_time_s:.2f} s against {len(lams)} x the single fit's "
          f"{c.r_k.wall_time_s:.2f} s = {len(lams) * c.r_k.wall_time_s:.2f}"
          f" s ({len(lams) * c.r_k.wall_time_s / fk.wall_time_s:.1f}x)")
    print(f"[sweep] K-RR fleet launches: kmv {fk_counts[0]}, gram "
          f"{fk_counts[1]} (one each a round for the whole fleet, one kmv "
          f"a check: {want_counts}); warm-up kmv {fk_warm[0]}, gram "
          f"{fk_warm[1]}; drivers {drivers[0]} captured, {drivers[1]} eager")
    if fk_counts != want_counts:
        failures.append(f"K-RR fleet launches {fk_counts}, not {want_counts}")
    if drivers != (1, 0):
        failures.append(f"the K-RR fleet did not run captured: {drivers}")
    r_big = KernelRidge(lam=float(lams[i_big]), kernel="rbf", device=dev,
                        options=opts_k).fit(Ar, c.yr, schedule=full_k)
    f1 = solve_fleet(Ar, c.yr, lams=[1.0], kernel="rbf", options=opts_k,
                     schedule=full_k, device=dev)
    c.spy.take()
    for label, got, want in (
            ("member lambda = 1 vs phase 4", fk.alpha[i_one], c.r_k.alpha),
            (f"member lambda = {lams[i_big]:g} vs its single fit",
             fk.alpha[i_big], r_big.alpha)):
        ratio, err = allclose_ratio(got, want, TOL_ITERATE)
        print(f"[sweep] K-RR fleet {label}: max abs err {err:.3e} (bound "
              f"{TOL_ITERATE})")
        if not ratio <= 1.0:
            failures.append(f"K-RR fleet {label}: {err:.3e}")
    for label, got, want in (("alpha", f1.alpha[0], c.r_k.alpha),
                             ("residual history", f1.history[:, 0],
                              c.r_k.history)):
        same, diff = bit_equal(got, want)
        print(f"[sweep] K-RR fleet F = 1 vs phase 4's fit: {label} "
              f"{'equal bit for bit' if same else 'DIFFERS'} (max abs diff "
              f"{diff:.3e})")
        if not same:
            failures.append(f"the F = 1 K-RR fleet's {label} differs from "
                            f"phase 4's: {diff:.3e}")
    # the frozen members: on this data every lambda's residual falls alike
    # (it is the share of coordinates not yet drawn), so a member warm
    # started at phase 4's solution converges at the first check while a
    # cold one needs about half the budget; cut at that check, the warm
    # member's alpha must be the full run's bit for bit, the cold one's
    # must have moved on
    tol_f = float(c.r_k.history[len(c.r_k.history) // 2])
    opts_f = dataclasses.replace(opts_k, tol=tol_f)
    warm = torch.stack((c.r_k.alpha, torch.zeros_like(c.r_k.alpha)))
    ff = solve_fleet(Ar, c.yr, lams=[1.0, 1.0], kernel="rbf",
                     options=opts_f, schedule=full_k, warm_start=warm,
                     device=dev)
    done_at = [int(np.argmax(ff.history[:, j] <= tol_f)) + 1
               if ff.converged[j] else None for j in range(2)]
    fc = solve_fleet(Ar, c.yr, lams=[1.0, 1.0], kernel="rbf",
                     options=opts_f, warm_start=warm, device=dev,
                     schedule=full_k[:opts_k.check_every * 8])
    c.spy.take()
    same, diff = bit_equal(fc.alpha[0], ff.alpha[0])
    moved = not bit_equal(fc.alpha[1], ff.alpha[1])[0]
    print(f"[sweep] K-RR fleet of a warm and a cold member, tol "
          f"{tol_f:.4e} (phase 4's residual at its check "
          f"{len(c.r_k.history) // 2 + 1}): done at checks {done_at} of "
          f"{ff.history.shape[0]}; the warm member's alpha cut at its check "
          f"vs the full run's {'equal bit for bit' if same else 'DIFFERS'} "
          f"(max abs diff {diff:.3e}), the cold one's "
          f"{'moved on' if moved else 'DID NOT MOVE'}")
    if not (same and moved and done_at[0] == 1
            and (done_at[1] or 0) > 1):
        failures.append(f"the frozen-member check: warm member done at "
                        f"{done_at}, bit equal {same}, cold moved {moved}")

    # ---- 9c. the K-SVM fleet ------------------------------------------
    Cs = np.array([0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0])
    opts_s = c.svm.options
    reset()
    fs = solve_fleet(A, c.y, Cs=Cs, kernel="rbf", options=opts_s,
                     schedule=c.r_s.schedule, device=dev)
    fs_counts = counts()
    drivers = c.spy.take()
    print(f"[sweep] K-SVM fleet, F = {len(Cs)} Cs {Cs.min():g}..{Cs.max():g}"
          f", s=32: {fs.rounds_run} rounds, {fs.wall_time_s:.2f} s against "
          f"{len(Cs)} x the single fit's {c.r_s.wall_time_s:.2f} s = "
          f"{len(Cs) * c.r_s.wall_time_s:.2f} s; launches kmv "
          f"{fs_counts[0]}, gram {fs_counts[1]}; drivers {drivers}")
    if fs_counts != (fs.rounds_run, fs.rounds_run):
        failures.append(f"K-SVM fleet launches {fs_counts}, not one kmv and "
                        f"one gram a round ({fs.rounds_run})")
    if drivers != (1, 0):
        failures.append(f"the K-SVM fleet did not run captured: {drivers}")
    s_one = int(np.argmin(abs(Cs - 1.0)))
    r_c25 = KernelSVM(C=0.25, kernel="rbf", device=dev,
                      options=opts_s).fit(A, c.y, schedule=c.r_s.schedule)
    f1s = solve_fleet(A, c.y, Cs=[1.0], kernel="rbf", options=opts_s,
                      schedule=c.r_s.schedule, device=dev)
    c.spy.take()
    for label, got, want in (
            ("member C = 1 vs phase 3", fs.alpha[s_one], c.r_s.alpha),
            ("member C = 0.25 vs its single fit", fs.alpha[1], r_c25.alpha)):
        ratio, err = allclose_ratio(got, want, TOL_ITERATE)
        print(f"[sweep] K-SVM fleet {label}: max abs err {err:.3e} (bound "
              f"{TOL_ITERATE})")
        if not ratio <= 1.0:
            failures.append(f"K-SVM fleet {label}: {err:.3e}")
    same, diff = bit_equal(f1s.alpha[0], c.r_s.alpha)
    print(f"[sweep] K-SVM fleet F = 1 vs phase 3's fit: alpha "
          f"{'equal bit for bit' if same else 'DIFFERS'} (max abs diff "
          f"{diff:.3e})")
    if not same:
        failures.append(f"the F = 1 K-SVM fleet differs from phase 3: "
                        f"{diff:.3e}")

    # the fleet rounds replayed: device ms a round and a check, capture
    op_k = ExactGramOperator(Ar, rbf)
    params_k = torch.tensor(lams, dtype=torch.float32, device=dev)
    rf_k = api._round_fn("krr", Ar, c.yr, c.krr.cfg, 8, None, op_k,
                         params_k)
    xs_k = pad_rounds(full_k, 8)
    a0_k = torch.zeros((len(lams), m), device=dev)
    met_k = fleet_metric("krr", op_k, Ar, c.yr, c.krr.cfg, opts_k, lams)
    g_round = graph_timing(f"K-RR fleet F={len(lams)}", rf_k, a0_k, xs_k,
                           FAST_RUN)
    g_check = graph_timing(f"K-RR fleet F={len(lams)}, each run ending in "
                           f"its check", rf_k, a0_k, xs_k,
                           opts_k.check_every, metric_fn=met_k)
    op_s = ExactGramOperator(A, rbf).scale_rows(c.y)
    rf_s = api._round_fn("ksvm", A, c.y, c.svm.cfg, 32, None, op_s,
                         torch.tensor(Cs, dtype=torch.float32, device=dev))
    g_svm = graph_timing(f"K-SVM fleet F={len(Cs)}", rf_s,
                         torch.zeros((len(Cs), m), device=dev),
                         pad_rounds(c.r_s.schedule, 32), FAST_RUN)
    c.spy.take()
    check_ms = g_check["run_ms"] - opts_k.check_every * g_round["round_ms"]
    kr = kmv_at[("K-RR fleet round", 16)]
    print(f"[sweep] K-RR fleet F=16 replayed: {g_round['round_ms']:.4f} ms a "
          f"round (its KMV c=16 {kr['ms']:.4f} ms), a check "
          f"{check_ms:.2f} ms (KMV c=16 B = A "
          f"{kmv_at[('full matvec, B = A', 16)]['ms']:.2f} ms), capture "
          f"{g_check['capture_s'] * 1e3:.1f} ms; K-SVM fleet F=8: "
          f"{g_svm['round_ms']:.4f} ms a round, capture "
          f"{g_svm['capture_s'] * 1e3:.1f} ms")
    del rf_k, op_k, rf_s, op_s, a0_k
    fleet_counts = (fk_counts[0] + fs_counts[0], fk_counts[1] + fs_counts[1])

    # ---- 9d. the autotuner and stream="auto" ----------------------------
    # phase 4 never reaches its tol (its residual is the share of
    # coordinates not yet drawn, 0.19 after its 2048 x 32 updates): the
    # tuned fit must reach what phase 4 had at TUNED_CHECK (a depth cut)
    tol_k = max(opts_k.tol, float(c.r_k.history[TUNED_CHECK - 1]))
    opts_a = SolverOptions(s="auto", b="auto", probe=2, tol=tol_k,
                           check_every=opts_k.check_every,
                           max_iters=TUNED_MAX_ITERS, seed=args.seed)
    ra = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                     options=opts_a).fit(Ar, c.yr)
    c.spy.take()
    plan = ra.plan
    top = sorted((f for f in plan.frontier if f["feasible"]),
                 key=lambda f: (f["time"], f["s"], f["b"]))[:5]
    print(f"[tune] KernelRidge(s='auto', b='auto', probe=2): budget "
          f"{plan.budget.hbm_bytes / 2 ** 30:.2f} GiB free device memory, "
          f"link {plan.budget.dma_bps / 1e9:.2f} GB/s (measured); "
          f"{len(plan.frontier)} candidates, the modeled top 5: "
          + ", ".join(f"s={f['s']} b={f['b']} {f['time']:.4f} s"
                      for f in top))
    for p in plan.probed:
        print(f"[tune] probe s={p['s']} b={p['b']}: {p['measured_s'] * 1e3:.3f}"
              f" ms device time of 2 replayed rounds (fit wall "
              f"{p['wall_s'] * 1e3:.1f} ms, its capture "
              f"{p['capture_s'] * 1e3:.1f} ms and warm-up "
              f"{p['warmup_s'] * 1e3:.1f} ms excluded)")
    print(f"[tune] winner s={ra.options.s} b={ra.options.b}: "
          f"{ra.iters_run} iters, {ra.rounds_run} rounds, converged="
          f"{ra.converged}, last residual {float(ra.history[-1]):.4e} "
          f"(tol {tol_k:.4e}: phase 4's residual at check {TUNED_CHECK}, "
          f"after {TUNED_CHECK * opts_k.check_every * 8 * 32} coordinate "
          f"updates), {ra.wall_time_s:.2f} s; modeled "
          f"{plan.modeled['time']:.4f} s")
    if not (ra.converged and float(ra.history[-1]) <= tol_k):
        failures.append(f"the autotuned K-RR fit did not reach phase 4's "
                        f"residual {tol_k:.3e}")
    # its shape replayed: where its wall goes beside the probe's rounds
    s_a, b_a = ra.options.s, ra.options.b
    op_a = ExactGramOperator(Ar, rbf)
    rf_a = api._round_fn("krr", Ar, c.yr, c.krr.cfg, s_a, None, op_a)
    xs_a = pad_rounds(api._schedule("krr", ra.options, m, b_a, dev), s_a)
    graph_timing(f"K-RR autotuned s={s_a} b={b_a}, each run ending in its "
                 f"check", rf_a, torch.zeros_like(c.yr), xs_a,
                 opts_k.check_every, runs=2,
                 metric_fn=lambda a: api._metric_fn(
                     "krr", op_a, Ar, c.yr, c.krr.cfg, ra.options)(a))
    c.spy.take()
    del op_a, rf_a, xs_a
    if not all(p["measured_s"] < p["wall_s"] for p in plan.probed):
        failures.append("a probe's measured time holds its capture")

    opts_st = dataclasses.replace(opts_k, stream=True, tol=0.0, record=True,
                                  max_iters=STREAM_AUTO_CHECKS
                                  * opts_k.check_every * 8)
    # the same fit at phase 5b's 2048-row chunks, first (it pays any cold
    # pinned allocation): the chosen chunk must not read slower (a 128-row
    # chunk, which the JAX model alone would pick, makes a check 12 403
    # one-tile pair launches)
    r2k = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=dataclasses.replace(opts_st, stream=2048)).fit(
        Ar.cpu(), c.yr, schedule=full_k[:opts_st.max_iters])
    c.spy.take()
    rst = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=opts_st).fit(
        Ar.cpu(), c.yr, schedule=full_k[:opts_st.max_iters])
    drivers = c.spy.take()
    cr = rst.options.stream
    ws = stream_working_set_bytes(cr, n, 8 * 32, slots=rst.plan.budget.slots)
    h_s, h_r = rst.history, c.r_k.history[:len(rst.history)]
    d_hist = float(abs(h_s - h_r).max() / abs(h_r).max())
    print(f"[tune] KernelRidge(stream=True): {cr} chunk rows chosen "
          f"({-(-m // cr)} chunks), link {rst.plan.budget.dma_bps / 1e9:.2f}"
          f" GB/s, working set {ws / 1e6:.1f} MB of {rst.plan.budget.slots}"
          f" slots against a budget of "
          f"{rst.plan.budget.stream_bytes / 1e9:.2f} GB; {rst.rounds_run} "
          f"rounds and {len(h_s)} checks (a depth cut of phase 5b's), "
          f"{rst.wall_time_s:.2f} s; residual history vs phase 4's max rel "
          f"diff {d_hist:.3e} (bound {TOL_STREAM_METRIC}); drivers "
          f"{drivers}")
    if not d_hist <= TOL_STREAM_METRIC:
        failures.append(f"stream=True residuals vs phase 4's {d_hist:.3e}")
    print(f"[tune] the same fit at 2048-row chunks: {r2k.wall_time_s:.3f} s "
          f"against the chosen {cr} rows' {rst.wall_time_s:.3f} s (must be "
          f"at most {STREAM_AUTO_SLACK}x it; chunk floor "
          f"{rst.plan.budget.min_chunk_rows} rows, the fewest whose chunk "
          f"pair has a 128 x 128 tile for every SM)")
    if not rst.wall_time_s <= STREAM_AUTO_SLACK * r2k.wall_time_s:
        failures.append(f"stream=True chose {cr}-row chunks: "
                        f"{rst.wall_time_s:.3f} s against 2048 rows' "
                        f"{r2k.wall_time_s:.3f} s")

    # ---- 9e. the warm-started path and cross-validation ----------------
    lams_p = [100.0, 10.0, 1.0, 0.1]
    t0 = time.perf_counter()
    path = reg_path(Ar, c.yr, lams=lams_p, kernel="rbf", options=opts_f,
                    schedule=full_k, device=dev)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    c.spy.take()
    cold = []
    for v in path.values:           # cold iterations to tol_f: the 16-lambda
        j = int(np.argmin(abs(lams - v)))     # fleet's members, which ran
        below = fk.history[:, j] <= tol_f     # every check on this schedule
        cold.append(int(np.argmax(below) + 1) * opts_k.check_every * 8
                    if below.any() else opts_k.max_iters)
    warm = [r.iters_run for r in path.results]
    print(f"[sweep] reg_path lambda {[float(v) for v in path.values]}, "
          f"tol {tol_f:.4e}: iterations warm "
          f"{warm} (total {sum(warm)}) against cold {cold} (total "
          f"{sum(cold)}), last residuals "
          + " ".join(f"{float(r.history[-1]):.2e}" for r in path.results)
          + f"; {t_path:.2f} s")
    if not sum(warm) <= sum(cold):
        failures.append(f"the warm-started path took more iterations "
                        f"({sum(warm)}) than cold fits ({sum(cold)})")
    opts_cv = dataclasses.replace(opts_k, max_iters=512)
    t0 = time.perf_counter()
    cv = cross_validate(Ar, c.yr, lams=lams_p, kernel="rbf",
                        options=opts_cv, folds=3, via="fleet",
                        seed=args.seed, device=dev)
    t_cv = time.perf_counter() - t0
    c.spy.take()
    print(f"[sweep] cross_validate 3 folds x {len(lams_p)} lambdas via the "
          f"fleet, H = {opts_cv.max_iters} (a depth cut; the width is "
          f"full): mean mse " + " ".join(f"{v:.4f}" for v in cv.mean_scores)
          + f"; best lambda {cv.best_value:g}; {t_cv:.2f} s")
    if not (cv.scores.shape == (3, len(lams_p))
            and np.isfinite(cv.scores).all()
            and cv.best_value in lams_p):
        failures.append(f"cross_validate scores {cv.scores}")

    # ---- 9f. report -----------------------------------------------------
    for label, r in (("K-SVM s-step", c.r_s), ("K-SVM classical", c.r_c),
                     ("K-RR s-step", c.r_k)):
        cm = r.comm
        print(f"[comm] {label} FitResult.comm (Hockney model, the paper's "
              f"machine): time {cm['time']:.4e} s, flops {cm['flops']:.4e}, "
              f"words {cm['words']:.4e}, msgs {cm['msgs']:.0f}")
    print(f"[comm] K-RR fleet: modeled {fk.comm['time']:.4e} s against "
          f"{fk.comm['sequential_time']:.4e} s sequential "
          f"({fk.comm['modeled_speedup']:.2f}x); measured "
          f"{len(lams) * c.r_k.wall_time_s / fk.wall_time_s:.2f}x")
    print(f"[sweep] phase 9 took {time.perf_counter() - t_phase:.1f} s")

    entries = []
    for key, what, launches in (
            (("K-RR fleet round", 16), "krr_fleet_round", fk.rounds_run),
            (("K-SVM fleet round", 8), "ksvm_fleet_round", fs.rounds_run),
            (("full matvec, B = A", 16), "fleet_check",
             fk.history.shape[0])):
        row = kmv_at[key]
        entries.append({
            "name": f"kmv_c{row['F']}_{what}", "route": "cuda",
            "source": "src/repro_torch/csrc/kmv.cu",
            "replaces": "src/repro/kernels/kmv.py:93",
            "shape": f"rbf (m, r, n, c) = ({m}, {row['r']}, {n}, "
                     f"{row['F']}) [{row['plan'].regime}]",
            "launches": launches,
            "launches_note": "kmv launches at this shape in the fleet "
                             "that runs it: its rounds, or its checks",
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain"], "bound_ms": row["bound"],
            "bound_by": row["by"], "library_ms": None,
            "ms_c1_times_F": row["one"] * row["F"],
            "ms_wide_plan": row.get("wide"),
            "ms_timing": "device time, launches queued behind a spin "
                         "kernel (time_queued)"})
    return entries, fleet_counts


def device_profile(run, calls: int):
    """Device-busy ms per call (the sum of the kernel durations that
    torch.profiler records), kernel launches per call, and the five
    kernels with the most device time, as (name, ms per call, launches
    per call), over ``calls`` calls of ``run``; (None, 0, []) where the
    profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    launches = sum(e.count for e in kernels) / calls
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return ((busy if busy > 0 else None), launches,
            [(e.key[:80], e.self_device_time_total / 1e3 / calls,
              e.count / calls) for e in top])


def kernel_device_ms(run, match: str):
    """(device ms a launch, launches) of the kernels whose name holds
    ``match`` in one call of ``run``, from torch.profiler; (None, 0) where
    the profiler records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and match in e.key]
    count = sum(e.count for e in hits)
    total = sum(e.self_device_time_total for e in hits) / 1e3
    return (total / count if count and total > 0 else None), count


def rel_fro(got, want) -> float:
    """||got - want||_F / ||want||_F in f64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def flash_err(got, want, what: str, dtype, tol=None) -> tuple:
    """(max abs err, max of err / tolerance) of a flash output against its
    plain version: ``tol``, an elementwise bound, where given (the
    tensor-core kernels' derived bf16 bound), else bf16 o at
    TOL_FLASH_BF16_*, f32 o and every lse at the f32 limits."""
    import torch
    got, want = got.double(), want.double()
    e = (got - want).abs()
    if tol is None:
        rtol, atol = ((TOL_FLASH_BF16_R, TOL_FLASH_BF16_A)
                      if what == "o" and dtype == torch.bfloat16
                      else (TOL_FLASH_F32_R, TOL_FLASH_F32_A))
        tol = atol + rtol * want.abs()
    return float(e.max()), float((e / tol.double()).max())


def swap_pairs(t):
    """Rows 2i and 2i + 1 of every (BH, len, d) head swapped: the layout
    fault a wrong shared-memory descriptor would make inside a tile."""
    n = t.shape[1] // 2 * 2
    out = t.clone()
    out[:, :n] = t[:, :n].reshape(t.shape[0], n // 2, 2, t.shape[2]).flip(
        2).reshape(t.shape[0], n, t.shape[2])
    return out


def flash_variant(q, k, v, skip):
    """A wrong causal flash forward, ``(o, lse)``, for phase 7a's check of
    its own tolerance: keys ``skip = (lo, hi)`` left out of every row at
    or past ``hi`` (a k tile skipped)."""
    import torch
    from repro_torch.kernels.ref import attention_scores
    s = attention_scores(q, k, True)
    lo, hi = skip
    rows = torch.arange(s.shape[1], device=s.device)[:, None]
    s[:, :, lo:hi] = torch.where(rows >= hi, -1e30, s[:, :, lo:hi])
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def lm_phase(dev, args, failures):
    """Phase 7 (module docstring): the LM's prefill and serving at full
    Qwen3-1.7B width.  Returns the ``rmsnorm`` and ``flash_fwd`` entries
    of the kernels record."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels._launch import DTYPE_CODES
    from repro_torch.kernels.flash_attention import (flash_fwd_cuda,
                                                     flash_fwd_plain,
                                                     flash_route)
    from repro_torch.kernels.ref import flash_fwd_bf16_tolerance
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_params)
    from repro_torch.train import Request, ServingEngine, greedy_generate
    from repro_torch.tree import leaves

    f32, bf16 = torch.float32, torch.bfloat16
    cfg = dataclasses.replace(get_config("qwen3_1p7b"), attn_impl="flash")
    B, S, H, hd = LM_BATCH, LM_SEQ, cfg.n_heads, cfg.head_dim
    D, V = cfg.d_model, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mib = 2.0 ** 20

    def counts():
        return {"rmsnorm": rmsnorm_cuda.launches,
                "flash_fwd": flash_fwd_cuda.launches,
                "flash_fwd_wgmma": flash_fwd_cuda.launches_wgmma}

    def reset():
        rmsnorm_cuda.launches = flash_fwd_cuda.launches = 0
        flash_fwd_cuda.launches_wgmma = 0

    # ---- a. parity of the kernels with their plain versions ---------------
    err_at = {}
    for n_rows, d in ((B * S, D), (B * S * H, hd), (B * S - 5, D),
                      (1001, 384)):
        x32 = torch.randn((n_rows, d), generator=gen, device=dev)
        scale = torch.randn((d,), generator=gen, device=dev)
        for dt, tol in ((f32, TOL_RMSNORM_F32), (bf16, TOL_BF16)):
            x = x32.to(dt)
            got, want = rmsnorm_cuda(x, scale), rmsnorm_plain(x, scale)
            ratio, err = allclose_ratio(got.float(), want.float(), tol)
            err_at[("rmsnorm", n_rows, d, str(dt))] = err
            if not (ratio <= 1.0 and got.dtype == dt
                    and got.shape == x.shape):
                failures.append(f"rmsnorm ({n_rows}, {d}) {dt}: max abs err "
                                f"{err:.3e} ({ratio:.2f}x tolerance)")
    # the tensor-core forward (bf16, hd = hdv in {64, 128}) at the path's
    # shape, hd 64 and ragged S and T; the FP32-FMA forward (f32, hd !=
    # hdv); each held within its route's bound
    flash_cases = [((B * H, S, S, hd, hd), bf16, True),
                   ((B * H, S, S, hd, hd), bf16, False),
                   ((16, 512, 512, 64, 64), bf16, True),
                   ((8, 100, 40, hd, hd), bf16, False),
                   ((8, 17, 17, hd, hd), bf16, True),
                   ((B * H, S, S, hd, hd), f32, True),
                   ((16, 512, 512, 64, hd), bf16, True),
                   ((8, 100, 100, hd, 32), f32, False)]
    for (BH, s_q, s_k, d_qk, d_v), dt, causal in flash_cases:
        q = torch.randn((BH, s_q, d_qk), generator=gen, device=dev).to(dt)
        k = torch.randn((BH, s_k, d_qk), generator=gen, device=dev).to(dt)
        v = torch.randn((BH, s_k, d_v), generator=gen, device=dev).to(dt)
        route = flash_route(dt, d_qk, d_v)
        before = counts()
        o, lse = flash_fwd_cuda(q, k, v, causal=causal)
        moved = {n: c - before[n] for n, c in counts().items()}
        want_moved = "flash_fwd_wgmma" if route == "wgmma" else "flash_fwd"
        if moved[want_moved] != 1 or sum(moved.values()) != 1:
            failures.append(f"flash_fwd {(BH, s_q, d_qk, d_v)} {dt}: "
                            f"launches {moved}, expected one {want_moved}")
        o_p, lse_p = flash_fwd_plain(q, k, v, causal=causal)
        tol = (flash_fwd_bf16_tolerance(q, k, v, o_p, causal)
               if route == "wgmma" else None)
        key = ("flash", BH, s_q, s_k, d_qk, d_v, str(dt)[6:], causal, route)
        for what, got, want, t in (("o", o, o_p, tol),
                                   ("lse", lse, lse_p, None)):
            err, ratio = flash_err(got, want, what, dt, t)
            err_at[key + (what,)] = (err, ratio)
            if not ratio <= 1.0:
                failures.append(f"flash_fwd {(BH, s_q, s_k, d_qk, d_v)} {dt}"
                                f" causal={causal} {what}: max abs err "
                                f"{err:.3e} ({ratio:.2f}x tolerance)")
        if key[1:] == (B * H, S, S, hd, hd, "bfloat16", True, "wgmma"):
            # the path's bf16 forward: its error as a median too, and
            # against the plain version that rounds p to bf16 as it does
            e = (o.float() - o_p.float()).abs()
            o_r, _ = flash_fwd_plain(q, k, v, causal=True, round_p=True)
            err_at["flash-path"] = (float(e.max()), float(e.median()),
                                    float(e.mean()),
                                    float((o.float() - o_r.float())
                                          .abs().max()))
            del e, o_r
        del tol
    del o, lse, o_p, lse_p, x32, x
    # What the flash check reads for wrong functions at the path's shape
    # (bf16, causal, the tensor-core route and its derived bound): the
    # kernel with the softmax scale 5% off, the plain version with the
    # second 64-key tile left out of every later q tile (a skipped k tile),
    # and the kernel fed k with rows swapped in pairs (a descriptor fault
    # inside a tile).  Each must fail the tolerance, or it would pass a
    # wrong kernel.  (A "p rounded to bf16" variant would be what this
    # kernel computes, as the TPU kernel does: it marks no fault.)
    q, k, v = (torch.randn((B * H, S, hd), generator=gen, device=dev)
               .to(bf16) for _ in range(3))
    o_p, lse_p = flash_fwd_plain(q, k, v, causal=True)
    tol = flash_fwd_bf16_tolerance(q, k, v, o_p, True)
    wrong = {"scale x 1.05": flash_fwd_cuda(q, k, v, True,
                                            1.05 * hd ** -0.5),
             "k tile 64:128 skipped": flash_variant(q, k, v, (64, 128)),
             "k rows swapped in pairs": flash_fwd_cuda(q, swap_pairs(k), v,
                                                       True)}
    for name, (o, lse) in wrong.items():
        reads = [flash_err(o, o_p, "o", bf16, tol),
                 flash_err(lse, lse_p, "lse", bf16)]
        err_at[("flash-wrong", name)] = reads
        if max(r for _, r in reads) <= 1.0:
            failures.append(f"flash check passes a wrong kernel ({name})")
    del q, k, v, o, lse, o_p, lse_p, wrong, tol
    torch.cuda.synchronize()
    print(f"[lm-parity] {len(err_at)} comparisons; tolerances: rmsnorm f32 "
          f"{TOL_RMSNORM_F32}, bf16 {TOL_BF16}; flash o f32 "
          f"{TOL_FLASH_F32_R} rel / {TOL_FLASH_F32_A} abs, bf16 FP32-FMA "
          f"route {TOL_FLASH_BF16_R} / {TOL_FLASH_BF16_A}, bf16 wgmma "
          f"route the derived bound (ref.flash_fwd_bf16_tolerance); lse "
          f"f32 limits")
    for key, err in err_at.items():
        if key == "flash-path":
            print(f"[lm-parity] tensor-core flash_fwd at {(B * H, S, hd)} "
                  f"bf16 causal, |o - o_plain| over all entries: max "
                  f"{err[0]:.3e}, median {err[1]:.3e}, mean {err[2]:.3e}; "
                  f"against the plain version with p rounded to bf16: max "
                  f"{err[3]:.3e}")
        elif key[0] == "rmsnorm":
            print(f"[lm-parity] {' '.join(map(str, key))}: max abs err "
                  f"{err:.3e}")
        elif key[0] == "flash":
            print(f"[lm-parity] {' '.join(map(str, key))}: max abs err "
                  f"{err[0]:.3e} ({err[1]:.3f}x tolerance)")
        else:
            (eo, ro), (el, rl) = err
            print(f"[lm-parity] wrong flash at {(B * H, S, hd)} bf16 causal"
                  f", {key[1]}: o {eo:.3e} ({ro:.3f}x tolerance), lse "
                  f"{el:.3e} ({rl:.3f}x tolerance)")
    if failures:
        return None

    # ---- b. prefill -------------------------------------------------------
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    # param_count leaves out the norms' scale vectors
    n_norm = cfg.n_layers * (2 * D + (2 * hd if cfg.qk_norm else 0)) + D
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {D}, {H} heads "
          f"({cfg.n_kv_heads} kv) x {hd}, d_ff {cfg.d_ff}, vocab {V}; "
          f"{n_par} f32 params ({n_par * 4 / 1e9:.2f} GB: param_count "
          f"{cfg.param_count()} + {n_norm} norm scales) drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_par != cfg.param_count() + n_norm:
        failures.append(f"{n_par} params, not param_count "
                        f"{cfg.param_count()} + {n_norm} norm scales")
    tokens = torch.randint(0, V, (B, S), generator=gen, device=dev)
    logits = forward(params, cfg, tokens)           # warm-up (cuBLAS init)
    del logits
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    logits = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_counts = counts()
    peak = torch.cuda.max_memory_allocated() - base
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        forward(params, cfg, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_best = min([t_prefill] + times)
    finite = bool(torch.isfinite(logits).all())
    print(f"[lm-prefill] forward B={B} S={S} bf16 flash: {t_prefill * 1e3:.1f}"
          f" ms (then {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; best "
          f"{B * S / t_best:.0f} tokens/s); logits {tuple(logits.shape)} "
          f"{logits.dtype}, finite={finite}; device memory peak "
          f"{peak / mib:.0f} MiB above the {base / mib:.0f} MiB allocated "
          f"before it (the params and what earlier phases hold)")
    want_prefill = {"rmsnorm": lm_norms(cfg), "flash_fwd": 0,
                    "flash_fwd_wgmma": cfg.n_layers}
    print(f"[lm-prefill] launches in the forward: {prefill_counts} "
          f"(expected {want_prefill}: the bf16 hd-{hd} path takes the "
          f"tensor-core forward)")
    if not (finite and logits.shape == (B, S, V)):
        failures.append("prefill logits not finite or misshapen")
    if prefill_counts != want_prefill:
        failures.append(f"prefill launches {prefill_counts}")
    naive = dataclasses.replace(cfg, attn_impl="naive")
    e_naive = rel_fro(logits, forward(params, naive, tokens))
    torch.cuda.synchronize()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    reset()
    l32 = forward(params, cfg32, tokens)
    torch.cuda.synchronize()
    f32_counts = counts()
    want_f32 = {"rmsnorm": lm_norms(cfg), "flash_fwd": cfg.n_layers,
                "flash_fwd_wgmma": 0}
    print(f"[lm-prefill] launches in the f32 forward: {f32_counts} "
          f"(expected {want_f32}: f32 takes the FP32-FMA forward)")
    if f32_counts != want_f32:
        failures.append(f"f32 prefill launches {f32_counts}")
    e32 = rel_fro(l32, forward(params, dataclasses.replace(
        cfg32, attn_impl="naive"), tokens))
    # the same f32 forward with attention's products in TF32 (a wrong
    # attention kernel of the kind the f32 bound must catch)
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    sdpa_flash = ops.sdpa_flash

    def tf32_attention(q, k, v, causal=True):
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return attn._sdpa(q, k, v, mask, q.dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    ops.sdpa_flash = tf32_attention
    try:
        e_tf32 = rel_fro(forward(params, cfg32, tokens), l32)
    finally:
        ops.sdpa_flash = sdpa_flash
    del l32
    print(f"[lm-prefill] flash vs naive attention, same weights and tokens,"
          f" ||a - b||_F / ||b||_F: bf16 {e_naive:.3e} (bound "
          f"{TOL_LM_BF16}), f32 {e32:.3e} (bound {TOL_LM_F32}); f32 with "
          f"TF32 attention products vs f32 flash {e_tf32:.3e}")
    if not e_naive <= TOL_LM_BF16:
        failures.append(f"bf16 prefill flash vs naive {e_naive:.3e}")
    if not e32 <= TOL_LM_F32:
        failures.append(f"f32 prefill flash vs naive {e32:.3e}")
    if not e_tf32 > TOL_LM_F32:
        failures.append(f"f32 bound {TOL_LM_F32} passes TF32 attention "
                        f"({e_tf32:.3e})")

    # ---- c. decode against prefill ----------------------------------------
    P = LM_DECODE_PROMPT
    prompt = tokens[:, :P].contiguous()
    ref = logits[:, :P].clone()
    del logits
    state = init_decode_state(cfg, B, P, device=dev)
    outs = []
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    for t in range(P):
        step_logits, state = decode_step(params, cfg, state,
                                         prompt[:, t:t + 1])
        outs.append(step_logits)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / P
    decode_counts = counts()
    got = torch.stack(outs, 1)
    e_dec = rel_fro(got, ref)
    top1 = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"[lm-decode] {P} teacher-forced decode steps (B={B}): "
          f"{t_dec * 1e3:.2f} ms a step; vs prefill logits ||a - b||_F / "
          f"||b||_F {e_dec:.3e} (bound {TOL_LM_BF16}), top-1 agreement "
          f"{top1:.4f}; launches rmsnorm {decode_counts['rmsnorm']} "
          f"(expected {P * lm_norms(cfg)}), flash_fwd "
          f"{decode_counts['flash_fwd']}")
    if not (e_dec <= TOL_LM_BF16 and bool(torch.isfinite(got).all())):
        failures.append(f"decode vs prefill {e_dec:.3e}")
    if decode_counts["rmsnorm"] != P * lm_norms(cfg):
        failures.append(f"decode launches {decode_counts}")
    del got, outs, ref, state

    # ---- d. serving -------------------------------------------------------
    lens = torch.randint(16, 65, (LM_REQUESTS,), generator=gen,
                         device=dev).tolist()
    reqs = [Request(rid=i, prompt=torch.randint(
        0, V, (n,), generator=gen, device=dev).tolist(),
        max_new_tokens=LM_NEW_TOKENS) for i, n in enumerate(lens)]
    eng = ServingEngine(params, cfg, n_slots=4, max_seq=LM_MAX_SEQ)
    arrivals = {0: reqs[:4], 8: reqs[4:6], 40: reqs[6:]}  # some mid-flight
    torch.cuda.synchronize()
    reset()
    steps = 0
    t0 = time.perf_counter()
    while steps < 2000:
        for r in arrivals.get(steps, []):
            eng.submit(r)
        if steps > max(arrivals) and not eng.pending and \
                all(s is None for s in eng.slots):
            break
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    serve_counts = counts()
    n_gen = sum(len(r.generated) for r in reqs)
    ok = all(r.done and len(r.generated) == LM_NEW_TOKENS
             and all(0 <= t < V for t in r.generated) for r in reqs)
    print(f"[lm-serve] ServingEngine(n_slots=4, max_seq={LM_MAX_SEQ}): "
          f"{LM_REQUESTS} requests, prompts {lens} tokens, "
          f"{LM_NEW_TOKENS} new each; {steps} steps in {t_serve:.2f} s, "
          f"mean decode step {t_serve / steps * 1e3:.2f} ms, {n_gen} "
          f"generated tokens, {n_gen / t_serve:.1f} generated tokens/s; "
          f"all finished: {ok}; launches rmsnorm {serve_counts['rmsnorm']} "
          f"(expected {steps * lm_norms(cfg)})")
    if not ok:
        failures.append("the engine did not answer every request")
    if serve_counts["rmsnorm"] != steps * lm_norms(cfg):
        failures.append(f"serving launches {serve_counts}")
    agree = checked = 0
    for r in reqs:
        alone, _ = greedy_generate(params, cfg, init_decode_state(
            cfg, 1, LM_MAX_SEQ, device=dev), torch.tensor(
            [r.prompt], device=dev), LM_NEW_TOKENS)
        alone = alone[0].tolist()
        # the isolated run's logits at each generated position (the same
        # batch-1 computation, teacher-forced), for its top-1/top-2 margin
        seq = torch.tensor([r.prompt + alone[:-1]], device=dev)
        st = init_decode_state(cfg, 1, LM_MAX_SEQ, device=dev)
        margins = []
        for t in range(seq.shape[1]):
            lg, st = decode_step(params, cfg, st, seq[:, t:t + 1])
            if t >= len(r.prompt) - 1:
                top2 = lg[0].topk(2).values
                margins.append(float(top2[0] - top2[1])
                               / max(1.0, abs(float(top2[0]))))
        for t, (a, b) in enumerate(zip(r.generated, alone)):
            if a != b:           # later tokens follow different contexts
                if margins[t] > TOL_LM_BF16:
                    failures.append(f"request {r.rid}: token {t} differs "
                                    f"from the isolated run ({a} vs {b}) "
                                    f"at a margin {margins[t]:.3e}")
                break
            agree += 1
        checked += len(alone)
    print(f"[lm-serve] agreement with each request decoded alone by "
          f"greedy_generate: {agree} of {checked} tokens agree up to each "
          f"request's first difference (a difference is allowed only where"
          f" the isolated top-1/top-2 logit margin is at most {TOL_LM_BF16}"
          f" of max(1, |top-1|))")

    # where the time goes: device-busy time against the unprofiled wall
    st = init_decode_state(cfg, B, LM_MAX_SEQ, device=dev)
    tok1 = tokens[:, :1].contiguous()

    def one_step():
        nonlocal st
        st = decode_step(params, cfg, st, tok1)[1]

    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_PROFILE_STEPS):
        one_step()
    torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) / LM_PROFILE_STEPS
    for label, run, calls, wall in (
            ("prefill forward", lambda: forward(params, cfg, tokens), 1,
             t_best),
            (f"decode step (B={B}, cache {LM_MAX_SEQ})", one_step,
             LM_PROFILE_STEPS, t_step)):
        busy, launches, top = device_profile(run, calls)
        if busy is None:
            print(f"[lm-profile] {label}: wall {wall * 1e3:.2f} ms; device "
                  f"time not measured (the profiler recorded none)")
            continue
        print(f"[lm-profile] {label}: wall {wall * 1e3:.2f} ms, device busy "
              f"{busy:.2f} ms (idle share {1 - busy / (wall * 1e3):.1%}) in "
              f"{launches:g} kernel launches")
        for name, ms, n in top:
            print(f"[lm-profile]   {ms:8.3f} ms  x{n:g}  {name}")
    rms_prof = kernel_device_ms(lambda: forward(params, cfg, tokens),
                                "rmsnorm")
    print(f"[lm-profile] rmsnorm kernels in one profiled prefill: "
          + ("not measured (the profiler recorded none)"
             if rms_prof[0] is None else
             f"{rms_prof[0]:.4f} ms a launch over {rms_prof[1]} launches"))
    del eng, params, tokens, st
    torch.cuda.empty_cache()
    if failures:
        return None

    # ---- e. times against bounds, plain versions and library calls -------
    x = torch.randn((B * S, D), generator=gen, device=dev).to(bf16)
    scale = torch.randn((D,), generator=gen, device=dev)
    xq = torch.randn((B * S * H, hd), generator=gen, device=dev).to(bf16)
    sq = torch.randn((hd,), generator=gen, device=dev)
    rows = {}
    for label, xx, ss in (("rows", x, scale), ("qk", xq, sq)):
        kernel = lambda: rmsnorm_cuda(xx, ss)  # noqa: E731
        s16 = ss.to(xx.dtype)
        lib_call = lambda: F.rms_norm(  # noqa: E731
            xx, (xx.shape[-1],), s16, 1e-6)
        ms, eager = time_queued(kernel, 50), time_cuda(kernel, 50)
        plain = time_queued(lambda: rmsnorm_plain(xx, ss), 20)
        lib, lib_eager = time_queued(lib_call, 50), time_cuda(lib_call, 50)
        nbytes = 2 * xx.numel() * xx.element_size() + ss.numel() * 4
        b_ms, b_by = bound_ms(nbytes, 4 * xx.numel(), BF16_FLOP_PER_S)
        rows[label] = (ms, plain, lib, b_ms, b_by, eager, lib_eager)
        print(f"[lm-time] rmsnorm {tuple(xx.shape)} bf16, queued (eager): "
              f"{ms:.4f} ({eager:.4f}) ms | plain {plain:.4f} ms | "
              f"F.rms_norm {lib:.4f} ({lib_eager:.4f}) ms | bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it)")
    del x, xq
    # the tensor-core forward (the path's) and the FP32-FMA one launched at
    # the same bf16 shapes, against the plain version and SDPA: at the
    # prefill's (64, 2048, 128) and the training microbatch's (32, ...)
    fma = build.launcher("flash_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    pairs = S * (S + 1) // 2                   # causal (row, col) pairs
    f_times = {}
    for nb in (B, B // 2):
        q4, k4, v4 = (torch.randn((nb, H, S, hd), generator=gen, device=dev)
                      .to(bf16) for _ in range(3))
        q3, k3, v3 = (t.reshape(nb * H, S, hd) for t in (q4, k4, v4))
        o3 = torch.empty_like(q3)
        lse3 = torch.empty((nb * H, S), device=dev)
        ms = time_cuda(lambda: flash_fwd_cuda(q3, k3, v3, causal=True), 50)
        ms_fma = time_cuda(lambda: fma(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o3.data_ptr(),
            lse3.data_ptr(), nb * H, S, S, hd, hd, DTYPE_CODES[bf16], 1,
            float(hd ** -0.5), stream), 10)
        plain = time_cuda(lambda: flash_fwd_plain(q3, k3, v3, causal=True),
                          5)
        lib = time_cuda(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 50)
        flops = 4 * nb * H * hd * pairs
        nbytes = 4 * nb * H * S * hd * 2 + nb * H * S * 4
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        f_times[nb * H] = (ms, ms_fma, plain, lib, b_ms, b_by)
        print(f"[lm-time] flash_fwd (BH, S, hd) = ({nb * H}, {S}, {hd}) bf16"
              f" causal: tensor-core {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s) | FP32-FMA {ms_fma:.4f} ms "
              f"({flops / ms_fma / 1e9:.1f} TFLOP/s) | plain {plain:.4f} ms | "
              f"scaled_dot_product_attention {lib:.4f} ms | bound "
              f"{b_ms:.4f} ms ({b_by} at the bf16 tensor-core rate; "
              f"tensor-core {b_ms / ms:.1%}, FP32-FMA {b_ms / ms_fma:.1%} "
              f"of it)")
        del q4, k4, v4, q3, k3, v3, o3, lse3
    print(f"[lm] phase 7 launches: prefill forward {prefill_counts}, f32 "
          f"forward {f32_counts}, {P} decode steps {decode_counts}, {steps}"
          f" engine steps {serve_counts}")
    torch.cuda.empty_cache()
    r, rq = rows["rows"], rows["qk"]
    ms, ms_fma, plain, lib, b_ms, b_by = f_times[B * H]
    shape = f"(BH, S, T, hd) = ({B * H}, {S}, {S}, {hd}) bf16 causal"
    return [
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:34",
         "shape": f"x ({B * S}, {D}) bf16, scale ({D},) f32",
         "launches": prefill_counts["rmsnorm"],
         "max_abs_err": err_at[("rmsnorm", B * S, D, str(bf16))],
         "ms": r[0], "plain_ms": r[1], "bound_ms": r[3], "bound_by": r[4],
         "library_ms": r[2], "decode_launches": decode_counts["rmsnorm"],
         "serving_launches": serve_counts["rmsnorm"],
         "ms_timing": "device time, launches queued behind a spin kernel "
                      "(time_queued); eager_ms: back to back, host "
                      "included (time_cuda); profiled_ms: torch.profiler "
                      "over one prefill",
         "eager_ms": r[5], "library_eager_ms": r[6],
         "profiled_ms": rms_prof[0], "ms_qk": rq[0], "eager_ms_qk": rq[5],
         "library_ms_qk": rq[2], "bound_ms_qk": rq[3]},
        {"name": "flash_fwd_wgmma", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_fwd_wgmma.cu",
         "replaces": "src/repro/kernels/flash_attention.py:95",
         "shape": shape, "launches": prefill_counts["flash_fwd_wgmma"],
         "max_abs_err": err_at["flash-path"][0],
         "median_abs_err": err_at["flash-path"][1],
         "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": lib, "ms_bh32": f_times[B // 2 * H][0],
         "library_ms_bh32": f_times[B // 2 * H][3]},
        {"name": "flash_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:81",
         "shape": shape + " (timed); launches from the f32 prefill",
         "launches": f32_counts["flash_fwd"],
         "max_abs_err": err_at[("flash", B * H, S, S, hd, hd, "float32",
                                True, "fma", "o")][0],
         "ms": ms_fma, "plain_ms": plain, "bound_ms": b_ms,
         "bound_by": b_by, "library_ms": lib,
         "ms_bh32": f_times[B // 2 * H][1]},
    ]


def flash_bwd_variant(q, k, v, do, lse, delta, skip):
    """The plain backward with keys ``skip = (lo, hi)`` left out of dq for
    every row at or past ``hi`` (a causal k tile the dq kernel skipped);
    dk and dv as the plain version computes them (phase 8a's wrong
    variant)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_bwd_plain
    from repro_torch.kernels.ref import attention_scores
    dq, dk, dv = flash_bwd_plain(q, k, v, do, lse, delta, causal=True)
    scale = q.shape[-1] ** -0.5
    p = torch.exp(attention_scores(q, k, True) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    lo, hi = skip
    ds[:, hi:, lo:hi] = 0.0
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype), dk, dv


def train_phase(dev, args, failures):
    """Phase 8 (module docstring): LM training at full Qwen3-1.7B width.
    Returns the flash_bwd entries (dq and dkv, tensor-core and FP32-FMA)
    of the kernels record and the training run's launch counts."""
    import dataclasses
    import statistics
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import build, ops
    from repro_torch.kernels._launch import DTYPE_CODES
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_bwd_plain,
                                                     flash_delta,
                                                     flash_fwd_cuda,
                                                     flash_route)
    from repro_torch.kernels.ref import (flash_dkv_bf16_tolerance,
                                         flash_dq_bf16_tolerance,
                                         rmsnorm_ref)
    from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm_cuda
    from repro_torch.models import attention as attn
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init, schedule
    from repro_torch.train import (TrainConfig, loss_and_grads,
                                   make_train_step)
    from repro_torch.tree import leaves_with_paths

    f32, bf16 = torch.float32, torch.bfloat16
    cfg = dataclasses.replace(get_config("qwen3_1p7b"), attn_impl="flash",
                              remat="full")
    B, S, H, hd = LM_TRAIN_BATCH, LM_SEQ, cfg.n_heads, cfg.head_dim
    BH = B // LM_MICROBATCHES * H          # one microbatch's attention
    D, V = cfg.d_model, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    gib = 2.0 ** 30

    def counts():
        return {"rmsnorm": rmsnorm_cuda.launches,
                "flash_fwd": flash_fwd_cuda.launches,
                "flash_fwd_wgmma": flash_fwd_cuda.launches_wgmma,
                "flash_bwd_dq": flash_bwd_cuda.launches_dq,
                "flash_bwd_dq_wgmma": flash_bwd_cuda.launches_dq_wgmma,
                "flash_bwd_dkv": flash_bwd_cuda.launches_dkv,
                "flash_bwd_dkv_wgmma": flash_bwd_cuda.launches_dkv_wgmma}

    def reset():
        rmsnorm_cuda.launches = flash_fwd_cuda.launches = 0
        flash_fwd_cuda.launches_wgmma = 0
        flash_bwd_cuda.launches_dq = flash_bwd_cuda.launches_dkv = 0
        flash_bwd_cuda.launches_dq_wgmma = 0
        flash_bwd_cuda.launches_dkv_wgmma = 0

    # ---- a. parity of the backward kernels with their plain version ------
    def bwd_inputs(BHx, s_q, s_k, d_qk, d_v, dt, causal):
        q = torch.randn((BHx, s_q, d_qk), generator=gen, device=dev).to(dt)
        k = torch.randn((BHx, s_k, d_qk), generator=gen, device=dev).to(dt)
        v = torch.randn((BHx, s_k, d_v), generator=gen, device=dev).to(dt)
        do = torch.randn((BHx, s_q, d_v), generator=gen, device=dev).to(dt)
        o, lse = flash_fwd_cuda(q, k, v, causal=causal)
        return q, k, v, do, lse, flash_delta(o, do)

    def bwd_err(got, want, dt, tols=(None, None, None)):
        """[(max abs err, max err / tolerance, entries that differ)] of
        dq, dk, dv; ``tols`` holds elementwise bounds where a route has
        them (the tensor-core kernels' derived bf16 bounds)."""
        rtol, atol = ((TOL_FLASH_BF16_R, TOL_FLASH_BF16_A) if dt == bf16
                      else (TOL_FLASH_BWD_F32_R, TOL_FLASH_BWD_F32_A))
        out = []
        for a, b, t in zip(got, want, tols):
            e = (a.double() - b.double()).abs()
            t = atol + rtol * b.double().abs() if t is None else t.double()
            out.append((float(e.max()), float((e / t).max()),
                        int((a != b).sum())))
        return out

    def bwd_tols(args_b, want, causal, dt):
        """The bounds on (dq, dk, dv) of the route a case takes."""
        q, k, v = args_b[:3]
        if flash_route(dt, q.shape[2], v.shape[2]) == "fma":
            return (None, None, None)
        return (flash_dq_bf16_tolerance(*args_b, want[0], causal),
                *flash_dkv_bf16_tolerance(*args_b, want[1], want[2], causal))

    err_at = {}
    # the tensor-core dq and dkv (bf16, hd = hdv in {64, 128}) at the
    # path's shape, hd 64 and ragged S and T; the FP32-FMA ones (f32, hd
    # != hdv, hd 96)
    cases = [((BH, S, S, hd, hd), bf16, True),
             ((8, 512, 512, 64, 64), bf16, True),
             ((8, 200, 136, hd, hd), bf16, False),
             ((8, 136, 200, hd, hd), bf16, True),
             ((BH, S, S, hd, hd), f32, True),
             ((8, 512, 512, hd, 64), f32, False),
             ((8, 200, 136, 64, hd), f32, False),
             ((8, 200, 200, 96, 96), bf16, True)]
    for shape, dt, causal in cases:
        args_b = bwd_inputs(*shape, dt, causal)
        route = flash_route(dt, shape[3], shape[4])
        before = counts()
        got = flash_bwd_cuda(*args_b, causal=causal)
        moved = {n: c - before[n] for n, c in counts().items()}
        tail = "_wgmma" if route == "wgmma" else ""
        dq_name, dkv_name = f"flash_bwd_dq{tail}", f"flash_bwd_dkv{tail}"
        if not (moved[dq_name] == moved[dkv_name] == 1
                and sum(moved.values()) == 2):
            failures.append(f"flash_bwd {shape} {dt}: launches {moved}, "
                            f"expected one {dq_name} and one {dkv_name}")
        want = flash_bwd_plain(*args_b, causal=causal)
        reads = bwd_err(got, want, dt, bwd_tols(args_b, want, causal, dt))
        err_at[(shape, str(dt)[6:], causal, route)] = reads
        for name, (err, ratio, _), a, ref in zip(("dq", "dk", "dv"), reads,
                                                 got, args_b[:3]):
            if not (ratio <= 1.0 and a.shape == ref.shape
                    and a.dtype == dt):
                failures.append(f"flash_bwd {shape} {dt} causal={causal} "
                                f"{name}: max abs err {err:.3e} "
                                f"({ratio:.2f}x tolerance)")
        if route == "wgmma":
            # one owner CTA an output, no atomics: the same bits again
            again = flash_bwd_cuda(*args_b, causal=causal)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                failures.append(f"flash_bwd {shape} {dt}: a second call "
                                f"gave other bits")
            del again
    del got, want, args_b
    # what the check reads for wrong functions at the path's shape (bf16,
    # causal); each must fail it, or it would pass a wrong kernel.  "k rows
    # swapped in pairs" is the fault a wrong descriptor would make inside a
    # tile of the tensor-core kernels.
    q, k, v, do, lse, delta = bwd_inputs(BH, S, S, hd, hd, bf16, True)
    want = flash_bwd_plain(q, k, v, do, lse, delta, causal=True)
    tols = bwd_tols((q, k, v, do, lse, delta), want, True, bf16)
    wrong = {
        "delta left out": flash_bwd_cuda(q, k, v, do, lse,
                                         torch.zeros_like(delta)),
        "scale x 1.05": flash_bwd_cuda(q, k, v, do, lse, delta, True,
                                       1.05 * hd ** -0.5),
        "k tile 64:128 skipped in dq": flash_bwd_variant(
            q, k, v, do, lse, delta, (64, 128)),
        "lse of the neighbouring row": flash_bwd_cuda(
            q, k, v, do, torch.roll(lse, 1, dims=1), delta),
        "k rows swapped in pairs": flash_bwd_cuda(
            q, swap_pairs(k), v, do, lse, delta)}
    for name, got in wrong.items():
        reads = bwd_err(got, want, bf16, tols)
        err_at[("wrong", name)] = reads
        if max(r for _, r, _ in reads) <= 1.0:
            failures.append(f"flash_bwd check passes a wrong kernel "
                            f"({name})")
    del wrong, got, want, tols
    # the RMSNorm Function on the card against autograd through the oracle
    for rows, d in ((B // LM_MICROBATCHES * S, D),
                    (B // LM_MICROBATCHES * S * H, hd)):
        x = torch.randn((rows, d), generator=gen, device=dev).to(bf16)
        sc = torch.randn((d,), generator=gen, device=dev)
        dy = torch.randn((rows, d), generator=gen, device=dev).to(bf16)
        grads = []
        for fn in (RMSNorm.apply, rmsnorm_ref):
            xl, sl = x.clone().requires_grad_(), sc.clone().requires_grad_()
            fn(xl, sl, 1e-6).backward(dy)
            grads.append((xl.grad, sl.grad))
        (dx, ds), (dx_r, ds_r) = grads
        r_dx, e_dx = allclose_ratio(dx.float(), dx_r.float(), TOL_BF16)
        r_ds, e_ds = allclose_ratio(ds, ds_r, TOL_RMSNORM_DSCALE, True)
        err_at[("rmsnorm-bwd", rows, d)] = (e_dx, r_dx, e_ds, r_ds)
        if not (r_dx <= 1.0 and r_ds <= 1.0 and dx.dtype == bf16):
            failures.append(f"RMSNorm backward ({rows}, {d}): dx {e_dx:.3e}"
                            f" ({r_dx:.2f}x), dscale {e_ds:.3e} "
                            f"({r_ds:.2f}x)")
    del x, dy, grads, dx, ds, dx_r, ds_r
    torch.cuda.synchronize()
    print(f"[train-parity] tolerances: flash_bwd f32 {TOL_FLASH_BWD_F32_R} "
          f"rel / {TOL_FLASH_BWD_F32_A} abs, bf16 FP32-FMA dq, dk, dv "
          f"{TOL_FLASH_BF16_R} / {TOL_FLASH_BF16_A}, tensor-core dq, dk, dv "
          f"the derived bounds (ref.flash_dq_bf16_tolerance, "
          f"ref.flash_dkv_bf16_tolerance); RMSNorm dx {TOL_BF16}, dscale "
          f"{TOL_RMSNORM_DSCALE} of its largest entry")
    for key, reads in err_at.items():
        if key[0] == "rmsnorm-bwd":
            e_dx, r_dx, e_ds, r_ds = reads
            print(f"[train-parity] RMSNorm backward ({key[1]}, {key[2]}) "
                  f"bf16: dx {e_dx:.3e} ({r_dx:.3f}x tolerance), dscale "
                  f"{e_ds:.3e} ({r_ds:.3f}x)")
            continue
        what = (f"wrong flash_bwd at {(BH, S, hd)} bf16 causal, {key[1]}"
                if key[0] == "wrong" else
                f"flash_bwd {key[0]} {key[1]} causal={key[2]} ({key[3]} "
                f"dq, dkv)")
        print(f"[train-parity] {what}: " + ", ".join(
            f"{n} {e:.3e} ({r:.3f}x tolerance, {c} entries differ)"
            for n, (e, r, c) in zip(("dq", "dk", "dv"), reads)))
    if failures:
        return None

    # ---- b. whole-model gradients at full width --------------------------
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    pipe = TokenPipeline(vocab_size=V, seq_len=S, global_batch=B,
                         seed=args.seed)
    one = {k: t[:1].to(dev) for k, t in pipe.batch(10 ** 6).items()}
    names = ["/".join(map(str, p)) for p, _ in leaves_with_paths(params)]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    naive = dataclasses.replace(cfg, attn_impl="naive")
    naive32 = dataclasses.replace(cfg32, attn_impl="naive")

    def tf32_attention(q, k, v, causal=True):
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return attn._sdpa(q, k, v, mask, q.dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def leaf_errors(grads, ref):
        return [rel_fro(g, r) for g, r in zip(grads, ref)]

    def check_leaves(grads, what):
        bad = [n for n, g in zip(names, grads)
               if g is None or not bool(torch.isfinite(g).all())
               or not bool(g.abs().max() > 0)]
        if bad:
            failures.append(f"{what}: {len(bad)} leaves without a finite, "
                            f"non-zero gradient: {bad[:6]}")

    _, g_ref = loss_and_grads(params, naive32, one)
    reset()
    loss32, g = loss_and_grads(params, cfg32, one)
    grad_counts = counts()
    check_leaves(g, "f32 flash gradients")
    e32 = leaf_errors(g, g_ref)
    del g
    sdpa_flash = ops.sdpa_flash
    ops.sdpa_flash = tf32_attention
    try:
        _, g = loss_and_grads(params, cfg32, one)
    finally:
        ops.sdpa_flash = sdpa_flash
    e_tf32 = leaf_errors(g, g_ref)
    del g, g_ref
    _, g_ref = loss_and_grads(params, naive, one)
    reset()
    loss16, g = loss_and_grads(params, cfg, one)
    grad_counts16 = counts()
    check_leaves(g, "bf16 flash gradients")
    e16 = leaf_errors(g, g_ref)
    del g, g_ref
    torch.cuda.synchronize()
    worst = {what: max(zip(e, names)) for what, e in
             (("f32", e32), ("tf32", e_tf32), ("bf16", e16))}
    print(f"[train-grad] {cfg.name} at full width, loss_fn on 1 x {S} "
          f"tokens ({time.perf_counter() - t0:.1f} s with init): f32 loss "
          f"{float(loss32):.5f}, bf16 loss {float(loss16):.5f}; launches in"
          f" one f32 backward with remat {grad_counts}, in one bf16 "
          f"{grad_counts16}")
    print(f"[train-grad] per-leaf ||g_flash - g_naive||_F / ||g_naive||_F "
          f"over {len(names)} leaves: f32 median "
          f"{statistics.median(e32):.3e}, worst {worst['f32'][0]:.3e} "
          f"({worst['f32'][1]}; bound {TOL_GRAD_F32}); f32 with TF32 "
          f"attention products: median {statistics.median(e_tf32):.3e}, "
          f"worst {worst['tf32'][0]:.3e} ({worst['tf32'][1]}); bf16 median "
          f"{statistics.median(e16):.3e}, worst {worst['bf16'][0]:.3e} "
          f"({worst['bf16'][1]}; bound {TOL_GRAD_BF16})")
    if not worst["f32"][0] <= TOL_GRAD_F32:
        failures.append(f"f32 gradients flash vs naive {worst['f32']}")
    if not worst["tf32"][0] > TOL_GRAD_F32:
        failures.append(f"f32 gradient bound {TOL_GRAD_F32} passes TF32 "
                        f"attention ({worst['tf32']})")
    if not worst["bf16"][0] <= TOL_GRAD_BF16:
        failures.append(f"bf16 gradients flash vs naive {worst['bf16']}")
    n_layers = cfg.n_layers
    # f32 takes the FP32-FMA kernels, bf16 at hd 128 the tensor-core ones
    want_grad = {"rmsnorm": lm_norms(cfg) + lm_norms(cfg) - 1,
                 "flash_fwd": 2 * n_layers, "flash_fwd_wgmma": 0,
                 "flash_bwd_dq": n_layers, "flash_bwd_dq_wgmma": 0,
                 "flash_bwd_dkv": n_layers, "flash_bwd_dkv_wgmma": 0}
    want_grad16 = dict(want_grad, flash_fwd=0, flash_fwd_wgmma=2 * n_layers,
                       flash_bwd_dq=0, flash_bwd_dq_wgmma=n_layers,
                       flash_bwd_dkv=0, flash_bwd_dkv_wgmma=n_layers)
    for got, want in ((grad_counts, want_grad),
                      (grad_counts16, want_grad16)):
        if got != want:
            failures.append(f"gradient launches {got}, expected {want}")
    del one
    if failures:
        return None

    # ---- c. training steps -----------------------------------------------
    acfg = AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=LM_TRAIN_WARMUP,
                       total_steps=LM_TRAIN_STEPS)
    step_fn = make_train_step(cfg, acfg,
                              TrainConfig(microbatches=LM_MICROBATCHES))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    per_step = {"rmsnorm": LM_MICROBATCHES * (2 * lm_norms(cfg) - 1),
                "flash_fwd": 0,
                "flash_fwd_wgmma": LM_MICROBATCHES * 2 * n_layers,
                "flash_bwd_dq": 0,
                "flash_bwd_dq_wgmma": LM_MICROBATCHES * n_layers,
                "flash_bwd_dkv": 0,
                "flash_bwd_dkv_wgmma": LM_MICROBATCHES * n_layers}
    rows, times, step_counts = [], [], []
    reset()
    for s in range(LM_TRAIN_STEPS):
        batch = pipe.batch(s)
        before = counts()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_counts.append({k: v - before[k] for k, v in counts().items()})
        rows.append({k: float(v) for k, v in m.items()})
    train_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = B * S
    t_best, t_med = min(times[1:]), statistics.median(times[1:])
    for s, (r, t, c) in enumerate(zip(rows, times, step_counts)):
        print(f"[train] step {s + 1}: loss {r['loss']:.5f}, grad_norm "
              f"{r['grad_norm']:.4f}, lr {r['lr']:.4e} (schedule "
              f"{schedule(acfg, s + 1):.4e}); {t * 1e3:.1f} ms; launches "
              f"{c}")
    print(f"[train] {LM_TRAIN_STEPS} steps of {B} x {S} tokens in "
          f"{LM_MICROBATCHES} microbatches, bf16 flash remat, AdamW lr "
          f"{LM_TRAIN_LR} warmup {LM_TRAIN_WARMUP}: step {t_med * 1e3:.1f} "
          f"ms median of steps 2-{LM_TRAIN_STEPS} (best {t_best * 1e3:.1f}, "
          f"first {times[0] * 1e3:.1f}); {tokens / t_med:.0f} training "
          f"tokens/s (best {tokens / t_best:.0f}); device memory peak "
          f"{peak / gib:.2f} GiB, {(peak - base) / gib:.2f} GiB above the "
          f"{base / gib:.2f} GiB of params and AdamW state")
    losses = [r["loss"] for r in rows]
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        failures.append(f"training loss not finite or not falling: "
                        f"{losses}")
    for s, r in enumerate(rows):
        if not (math.isfinite(r["grad_norm"]) and math.isfinite(r["lr"])
                and abs(r["lr"] - schedule(acfg, s + 1))
                <= 1e-6 * abs(schedule(acfg, s + 1))):
            failures.append(f"step {s + 1}: grad_norm {r['grad_norm']}, lr "
                            f"{r['lr']} (schedule {schedule(acfg, s + 1)})")
    for s, c in enumerate(step_counts):
        if c != per_step:
            failures.append(f"step {s + 1} launches {c}, expected "
                            f"{per_step}")

    # where the time goes: one more step under the profiler
    def one_step():
        nonlocal params, opt
        params, opt, _ = step_fn(params, opt, pipe.batch(LM_TRAIN_STEPS))

    busy, launches, top = device_profile(one_step, 1)
    if busy is None:
        print(f"[train-profile] step: wall {t_med * 1e3:.1f} ms; device time "
              f"not measured (the profiler recorded none)")
    else:
        print(f"[train-profile] step: wall {t_med * 1e3:.1f} ms (median, "
              f"unprofiled), device busy {busy:.1f} ms (idle share "
              f"{1 - busy / (t_med * 1e3):.1%}) in {launches:g} kernel "
              f"launches")
        for name, ms, n in top:
            print(f"[train-profile]   {ms:8.3f} ms  x{n:g}  {name}")
    del params, opt, step_fn
    torch.cuda.empty_cache()
    if failures:
        return None

    # ---- d. backward kernel times ----------------------------------------
    q, k, v, do, lse, delta = bwd_inputs(BH, S, S, hd, hd, bf16, True)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch = build.launcher("flash_bwd")
    launch_w = build.launcher("flash_bwd_dkv_wgmma")
    launch_qw = build.launcher("flash_bwd_dq_wgmma")
    stream = torch.cuda.current_stream().cuda_stream
    raw = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), BH, S, S, hd, hd, DTYPE_CODES[bf16], 1,
           float(hd ** -0.5))
    raw_w = raw[:6] + (dk.data_ptr(), dv.data_ptr(), BH, S, S, hd, 1,
                       float(hd ** -0.5), stream)
    raw_qw = raw[:7] + (BH, S, S, hd, 1, float(hd ** -0.5), stream)
    # every kernel through its C entry point at the path's bf16 shape:
    # the tensor-core dq and dkv the path takes, and the FP32-FMA ones
    runs = {"dq": lambda: launch(*raw, 0, stream),
            "dkv": lambda: launch(*raw, 1, stream),
            "dq_wgmma": lambda: launch_qw(*raw_qw),
            "dkv_wgmma": lambda: launch_w(*raw_w)}
    for w, run in runs.items():
        if run() != 0:
            failures.append(f"flash_bwd_{w} launch failed")
            return None
    ms = {w: time_cuda(run, 50 if w.endswith("wgmma") else 10)
          for w, run in runs.items()}
    both = time_cuda(lambda: flash_bwd_cuda(q, k, v, do, lse, delta), 10)
    plain = time_cuda(lambda: flash_bwd_plain(q, k, v, do, lse, delta), 5)
    q4, k4, v4, do4 = (t.reshape(B // LM_MICROBATCHES, H, S, hd)
                       for t in (q, k, v, do))
    leaves4 = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*leaves4, is_causal=True)

    def sdpa_fwd_bwd():
        sdpa_fwd().backward(do4)

    lib = time_cuda(sdpa_fwd_bwd, 20) - time_cuda(sdpa_fwd, 20)
    pairs = S * (S + 1) // 2                   # causal (row, col) pairs
    product = 2 * BH * pairs * hd              # one of the five products
    in_bytes = 4 * BH * S * hd * 2 + 2 * BH * S * 4
    out_bytes = {"dq": BH * S * hd * 2, "dkv": 2 * BH * S * hd * 2}
    n_products = {"dq": 3, "dkv": 4}
    bounds = {w: bound_ms(in_bytes + out_bytes[w], n_products[w] * product,
                          BF16_FLOP_PER_S) for w in ("dq", "dkv")}
    for w in ("dq", "dkv"):
        bounds[f"{w}_wgmma"] = bounds[w]
        n_products[f"{w}_wgmma"] = n_products[w]
    b_all = bound_ms(in_bytes + out_bytes["dq"] + out_bytes["dkv"],
                     5 * product, BF16_FLOP_PER_S)
    for w, label in (("dq", "FP32-FMA"), ("dkv", "FP32-FMA"),
                     ("dq_wgmma", "tensor-core"),
                     ("dkv_wgmma", "tensor-core")):
        flops = n_products[w] * product
        print(f"[train-time] flash_bwd_{w} ({label}) (BH, S, hd) = ({BH}, "
              f"{S}, {hd}) bf16 causal: {ms[w]:.4f} ms "
              f"({flops / ms[w] / 1e9:.1f} TFLOP/s in its {n_products[w]} "
              f"products) | bound "
              f"{bounds[w][0]:.4f} ms ({bounds[w][1]}; operations at the "
              f"bf16 tensor-core rate; {bounds[w][0] / ms[w]:.1%} of it)")
    print(f"[train-time] flash_bwd (tensor-core dq + dkv through the "
          f"wrapper): {both:.4f} ms | plain (dq, dk, dv) {plain:.4f} ms | "
          f"backward of scaled_dot_product_attention(is_causal=True) "
          f"{lib:.4f} ms | bound of the five products {b_all[0]:.4f} ms "
          f"({b_all[1]}); {5 * product / 1e9:.1f} GFLOP, "
          f"{(in_bytes + out_bytes['dq'] + out_bytes['dkv']) / 1e6:.1f} MB")
    print(f"[train] phase 8 launches over {LM_TRAIN_STEPS} steps: "
          f"{train_counts}; in the f32 gradient of 8b {grad_counts}")
    del q, k, v, do, lse, delta, dq, dk, dv, q4, k4, v4, do4, leaves4
    torch.cuda.empty_cache()
    path = err_at[((BH, S, S, hd, hd), "bfloat16", True, "wgmma")]
    path32 = err_at[((BH, S, S, hd, hd), "float32", True, "fma")]
    shape = f"(BH, S, T, hd) = ({BH}, {S}, {S}, {hd}) bf16 causal"
    entry = {"route": "cuda", "plain_ms": plain, "library_ms": lib}
    entries = [
        dict(entry, name="flash_bwd_dq_wgmma",
             source="src/repro_torch/csrc/flash_bwd_dq_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:220",
             shape=shape, launches=train_counts["flash_bwd_dq_wgmma"],
             max_abs_err=path[0][0], ms=ms["dq_wgmma"],
             bound_ms=bounds["dq"][0], bound_by=bounds["dq"][1]),
        dict(entry, name="flash_bwd_dq",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:220",
             shape=shape + " (timed); launches from the f32 gradient of 8b",
             launches=grad_counts["flash_bwd_dq"], max_abs_err=path32[0][0],
             ms=ms["dq"], bound_ms=bounds["dq"][0],
             bound_by=bounds["dq"][1]),
        dict(entry, name="flash_bwd_dkv_wgmma",
             source="src/repro_torch/csrc/flash_bwd_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:240",
             shape=shape, launches=train_counts["flash_bwd_dkv_wgmma"],
             max_abs_err=max(path[1][0], path[2][0]), ms=ms["dkv_wgmma"],
             bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1]),
        dict(entry, name="flash_bwd_dkv",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:240",
             shape=shape + " (timed); launches from the f32 gradient of 8b",
             launches=grad_counts["flash_bwd_dkv"],
             max_abs_err=max(path32[1][0], path32[2][0]), ms=ms["dkv"],
             bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1]),
    ]
    return entries, train_counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--svm-iters", type=int, default=4096)
    ap.add_argument("--krr-iters", type=int, default=2048)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available; this script runs only "
                    "on the card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        return fail(f"the port's sources are not at {src / 'repro_torch'}")
    sys.path.insert(0, str(src))

    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.core import (ExactGramOperator, KernelConfig,
                                  krr_predict, krr_rel_residual_op,
                                  ksvm_duality_gap, ksvm_predict,
                                  make_dcd_round_fn,
                                  make_sstep_bdcd_round_fn,
                                  make_sstep_dcd_round_fn, pad_rounds,
                                  sstep_bdcd_inner, sstep_dcd_inner)
    from repro_torch.core.loop import FAST_RUN, RoundGraphs
    from repro_torch.data.synthetic import (PAPER_DATASETS,
                                            classification_dataset,
                                            regression_dataset)
    from repro_torch.kernels import build
    from repro_torch.kernels._launch import check_inputs, sm_count
    from repro_torch.kernels.gram import gram_cuda, gram_plain, gram_splits
    from repro_torch.kernels.kmv import kmv_cuda, kmv_plain, kmv_plan
    from repro_torch.kernels.kmv import launch as kmv_launch

    # full-f32 products everywhere the plain versions meet the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures = []
    print(f"device: {torch.cuda.get_device_name(0)}  torch "
          f"{torch.__version__}  cuda {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    for entry in build.SIGNATURES:
        build.launcher(entry)
    print(f"[build] {time.perf_counter() - t0:.1f} s total")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s -> {rec['path']}")
        for line in rec["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "warning")):
                print(f"[build]   {line.strip()}")
    for lib, kernel in WGMMA_LIBS.items():
        kernels = build.sass_counts(lib)
        for name, ops in kernels.items():
            print(f"[build] SASS {lib}: {name}: HGMMA x{ops['HGMMA']}, "
                  f"UTMALDG x{ops['UTMALDG']}")
            if not (ops["HGMMA"] and ops["UTMALDG"]):
                failures.append(f"{lib}: {name} lacks HGMMA or UTMALDG")
        if not any(kernel in name for name in kernels):
            failures.append(f"{lib}: no {kernel} in its SASS")
    if failures:
        return fail("; ".join(failures))

    # ---- data at the news20-like shape ------------------------------------
    spec = PAPER_DATASETS["news20-like"]
    m, n, q = spec["m"], spec["n"], 2048
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    A_all, y_all = classification_dataset(gen, m + q, n, device=dev)
    A, y = A_all[:m].contiguous(), y_all[:m].contiguous()
    Aq, yq = A_all[m:].contiguous(), y_all[m:].contiguous()
    del A_all, y_all
    print(f"[data] K-SVM: A {tuple(A.shape)} f32 "
          f"({A.numel() * 4 / 1e6:.0f} MB), {q} held-out queries")

    # ---- 2. kernel parity -------------------------------------------------
    kernels = {"linear": KernelConfig("linear"),
               "polynomial": KernelConfig("polynomial", degree=3,
                                          coef0=1.0),
               "rbf": KernelConfig("rbf", sigma=1.0)}
    pick = torch.randperm(m, generator=gen, device=dev)
    B_of = {"r1": A[pick[:1]].contiguous(),
            "r32": A[pick[:32]].contiguous(),
            "r256": A[pick[:256]].contiguous(),
            "B=A": A, "q1024": Aq[:1024].contiguous()}
    Xv = torch.randn(m, generator=gen, device=dev)
    Xm = torch.randn((m, 4), generator=gen, device=dev)
    A16 = A.to(torch.bfloat16)
    # the classical round's 1 x 1 block, the K-SVM round's 32 x 32, the
    # K-RR round's 256 x 256 and the materialized slab's m x 32
    gram_blocks = {"1x1": (B_of["r32"][:1], B_of["r32"][1:2]),
                   "32x32": (B_of["r32"], B_of["r32"]),
                   "256x256": (B_of["r256"], B_of["r256"]),
                   "mx32": (A, B_of["r32"])}
    err_at = {}
    t0 = time.perf_counter()
    for kname, cfg in kernels.items():
        poly = kname == "polynomial"
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL_KMV_F32 if dtype == torch.float32 else TOL_BF16
            Ad = A if dtype == torch.float32 else A16
            for bname, B in B_of.items():
                Bd = Ad if bname == "B=A" else B.to(dtype)
                for xname, X in (("vec", Xv), ("mat4", Xm)):
                    got = kmv_cuda(Ad, Bd, X, cfg)
                    want = kmv_plain(Ad, Bd, X, cfg)
                    ratio, err = allclose_ratio(got, want, tol, poly)
                    err_at[("kmv", kname, str(dtype), bname, xname)] = err
                    if not ratio <= 1.0 or got.shape != want.shape:
                        failures.append(
                            f"kmv {kname} {dtype} {bname} {xname}: max "
                            f"abs err {err:.3e} ({ratio:.2f}x tolerance)")
                    # fixed-order sums, no atomics: the same bits again
                    if not torch.equal(got, kmv_cuda(Ad, Bd, X, cfg)):
                        failures.append(f"kmv {kname} {dtype} {bname} "
                                        f"{xname}: a second call gave "
                                        f"other bits")
                if dtype == torch.float32:
                    # each regime with its last m split left out of the
                    # partial grid and the reduce must fail the check
                    plan = kmv_plan(m, Bd.shape[0], 1, sm_count(0),
                                    Bd is Ad)
                    bad = kmv_launch(Ad, Bd, Xv[:, None].contiguous(), cfg,
                                     plan._replace(splits=plan.splits - 1),
                                     check_inputs("kmv", Ad, Bd))[:, 0]
                    ratio, err = allclose_ratio(bad, kmv_plain(Ad, Bd, Xv,
                                                               cfg),
                                                tol, poly)
                    err_at[("kmv-wrong", kname, bname)] = (err, ratio,
                                                           plan.regime)
                    if ratio <= 1.0:
                        failures.append(f"kmv check passes a wrong kernel "
                                        f"({kname} {bname}, {plan.regime}, "
                                        f"last split left out: "
                                        f"{ratio:.2f}x)")
            tol = TOL_GRAM_F32 if dtype == torch.float32 else TOL_BF16
            for gname, (G1, G2) in gram_blocks.items():
                G1d, G2d = G1.to(dtype), G2.to(dtype)
                got = gram_cuda(G1d, G2d, cfg)
                want = gram_plain(G1d, G2d, cfg)
                ratio, err = allclose_ratio(got, want, tol, poly)
                err_at[("gram", kname, str(dtype), gname)] = err
                if not ratio <= 1.0:
                    failures.append(f"gram {kname} {dtype} {gname}: max "
                                    f"abs err {err:.3e} ({ratio:.2f}x "
                                    f"tolerance)")
                # fixed-order sums, no atomics: the same bits again
                if not torch.equal(got, gram_cuda(G1d, G2d, cfg)):
                    failures.append(f"gram {kname} {dtype} {gname}: a "
                                    f"second call gave other bits")
                if dtype == torch.float32 and gname != "mx32":
                    # the last feature split left out of the reduce must
                    # fail the check
                    bm, br, splits, per = gram_splits(
                        G1d.shape[0], G2d.shape[0], n, sm_count(0))
                    bad = gram_direct(G1d, G2d, cfg, bm, br, splits - 1, per)
                    ratio, err = allclose_ratio(bad, want, tol, poly)
                    err_at[("gram-wrong", kname, gname)] = (err, ratio)
                    if ratio <= 1.0:
                        failures.append(f"gram check passes a wrong kernel "
                                        f"({kname} {gname}, last split "
                                        f"left out: {ratio:.2f}x)")
    torch.cuda.synchronize()
    del A16
    n_cmp = sum(k[0] not in ("gram-wrong", "kmv-wrong") for k in err_at)
    print(f"[parity] {n_cmp} comparisons in "
          f"{time.perf_counter() - t0:.1f} s; tolerances: KMV f32 "
          f"{TOL_KMV_F32}, gram f32 {TOL_GRAM_F32}, bf16 {TOL_BF16}, "
          f"polynomial relative to max |output|")
    for key in (("kmv", "rbf", "torch.float32", "r1", "vec"),
                ("kmv", "rbf", "torch.float32", "r32", "vec"),
                ("kmv", "rbf", "torch.float32", "B=A", "vec"),
                ("kmv", "polynomial", "torch.float32", "B=A", "mat4"),
                ("kmv", "rbf", "torch.bfloat16", "q1024", "mat4"),
                ("gram", "rbf", "torch.float32", "1x1"),
                ("gram", "rbf", "torch.float32", "32x32"),
                ("gram", "rbf", "torch.float32", "256x256"),
                ("gram", "linear", "torch.float32", "mx32")):
        print(f"[parity] {' '.join(key)}: max abs err {err_at[key]:.3e}")
    for key, (err, ratio, regime) in ((k, v) for k, v in err_at.items()
                                      if k[0] == "kmv-wrong"):
        print(f"[parity] kmv {key[1]} {key[2]} ({regime}) with the last m "
              f"split left out of the reduce: max abs err {err:.3e} "
              f"({ratio:.1f}x tolerance; must fail)")
    for key, (err, ratio) in ((k, v) for k, v in err_at.items()
                              if k[0] == "gram-wrong"):
        print(f"[parity] gram {key[1]} {key[2]} with the last feature split "
              f"left out of the reduce: max abs err {err:.3e} ({ratio:.1f}x "
              f"tolerance; must fail)")
    if failures:
        for f in failures:
            print(f"[parity] FAIL {f}")
        return fail(f"{len(failures)} kernel parity failures")
    print("[parity] all kernels agree with their plain versions")

    # ---- 3. K-SVM main path -----------------------------------------------
    spy = DriverSpy()
    for fn in (kmv_cuda, gram_cuda):
        fn.launches = fn.warmup_launches = 0
    svm_opts = dict(max_iters=args.svm_iters, seed=args.seed)
    svm = KernelSVM(C=1.0, kernel="rbf", device=dev, options=SolverOptions(
        method="sstep", s=32, **svm_opts))
    r_s = svm.fit(A, y)
    dcd = KernelSVM(C=1.0, kernel="rbf", device=dev, options=SolverOptions(
        method="classical", **svm_opts))
    r_c = dcd.fit(A, y, schedule=r_s.schedule)
    agree = float((r_s.alpha - r_c.alpha).abs().max())
    gap = float(ksvm_duality_gap(A, y, r_s.alpha, svm.cfg))
    t0 = time.perf_counter()
    f_q = svm.decision_function(Aq)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    acc = float((torch.sign(f_q) == yq).float().mean())
    n_sv = svm._predictor.op.n_samples
    f_ref = ksvm_predict(A, y, r_s.alpha, Aq[:64], svm.cfg)
    ratio_svm, err_svm = allclose_ratio(f_q[:64], f_ref, TOL_ORACLE, True)
    svm_counts = (kmv_cuda.launches, gram_cuda.launches)
    svm_drivers = spy.take()
    print(f"[ksvm] s-step s=32: {r_s.iters_run} iters, {r_s.rounds_run} "
          f"rounds, {r_s.wall_time_s:.2f} s | classical: "
          f"{r_c.rounds_run} rounds, {r_c.wall_time_s:.2f} s")
    print(f"[ksvm] max|a_s - a_dcd| = {agree:.3e} (bound "
          f"{TOL_SSTEP_VS_CLASSICAL}) | duality gap {gap:.6e} | "
          f"nonzero alpha {int((r_s.alpha != 0).sum())}")
    print(f"[ksvm] predict {q} queries on {n_sv} support vectors: "
          f"{t_pred * 1e3:.1f} ms, accuracy {acc:.4f}; vs dense oracle "
          f"max abs err {err_svm:.3e}")
    print(f"[ksvm] launches: kmv {svm_counts[0]}, gram {svm_counts[1]}; "
          f"drivers: {svm_drivers[0]} captured, {svm_drivers[1]} eager")
    if svm_drivers != (2, 0):
        failures.append(f"the K-SVM fits did not both run captured: "
                        f"{svm_drivers}")
    if not agree <= TOL_SSTEP_VS_CLASSICAL:
        failures.append(f"s-step vs classical {agree:.3e}")
    if not (torch.isfinite(r_s.alpha).all() and
            float(r_s.alpha.min()) >= 0.0 and
            float(r_s.alpha.max()) <= 1.0 + 1e-6):
        failures.append("K-SVM alpha outside [0, C]")
    if not (f_q.shape == (q,) and bool(torch.isfinite(f_q).all())):
        failures.append("K-SVM decision values not finite")
    if not ratio_svm <= 1.0:
        failures.append(f"K-SVM predictions vs dense oracle {err_svm:.3e}")
    if not (gap == gap and abs(gap) < float("inf")):
        failures.append("K-SVM duality gap not finite")

    # ---- 4. K-RR main path ------------------------------------------------
    R_all, t_all = regression_dataset(gen, m + q, n, device=dev)
    Ar, yr = R_all[:m].contiguous(), t_all[:m].contiguous()
    Arq, yrq = R_all[m:].contiguous(), t_all[m:].contiguous()
    del R_all, t_all
    krr = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=SolverOptions(method="sstep", s=8, b=32,
                                            tol=1e-4, check_every=16,
                                            max_iters=args.krr_iters,
                                            seed=args.seed))
    r_k = krr.fit(Ar, yr)
    t0 = time.perf_counter()
    p_q = krr.predict(Arq)
    torch.cuda.synchronize()
    t_pred_k = time.perf_counter() - t0
    p_ref = krr_predict(Ar, r_k.alpha, Arq[:64], krr.cfg)
    ratio_krr, err_krr = allclose_ratio(p_q[:64], p_ref, TOL_ORACLE, True)
    rmse = float(((p_q - yrq) ** 2).mean().sqrt())
    hist = [float(v) for v in r_k.history]
    counts = (kmv_cuda.launches, gram_cuda.launches)   # the main path's
    warmup = (kmv_cuda.warmup_launches, gram_cuda.warmup_launches)
    krr_drivers = spy.take()
    print(f"[krr] s-step s=8 b=32: {r_k.iters_run} iters, "
          f"{r_k.rounds_run} rounds, converged={r_k.converged}, "
          f"{r_k.wall_time_s:.2f} s")
    print(f"[krr] rel residual history: "
          + " ".join(f"{v:.4e}" for v in hist))
    print(f"[krr] predict {q} queries: {t_pred_k * 1e3:.1f} ms, rmse "
          f"{rmse:.4f} (target std {float(yrq.std()):.4f}); vs dense "
          f"oracle max abs err {err_krr:.3e}")
    print(f"[krr] launches: kmv {counts[0] - svm_counts[0]}, gram "
          f"{counts[1] - svm_counts[1]}; drivers: {krr_drivers[0]} "
          f"captured, {krr_drivers[1]} eager")
    if krr_drivers != (1, 0):
        failures.append(f"the K-RR fit did not run captured: {krr_drivers}")
    if not (hist and all(v == v and v < float("inf") for v in hist)
            and hist[-1] < hist[0]):
        failures.append(f"K-RR residual history does not fall: {hist}")
    if not (p_q.shape == (q,) and bool(torch.isfinite(p_q).all())):
        failures.append("K-RR predictions not finite")
    if not ratio_krr <= 1.0:
        failures.append(f"K-RR predictions vs dense oracle {err_krr:.3e}")

    print(f"[main path] launches: kmv {counts[0]}, gram {counts[1]}")
    print(f"[main path] warm-up launches, apart from those (one eager round "
          f"and check a fit before its captures): kmv {warmup[0]}, gram "
          f"{warmup[1]}")
    if counts[0] < 1 or counts[1] < 1:
        failures.append(f"a kernel was never launched on the main path "
                        f"(kmv {counts[0]}, gram {counts[1]})")
    # every round launches one KMV and one gram; a check or a prediction
    # block one KMV more: the counts are the launches the fits made
    rounds = r_s.rounds_run + r_c.rounds_run + r_k.rounds_run
    n_pred = -(-q // svm.predict_batch) + -(-q // krr.predict_batch)
    want = (rounds + len(hist) + 1 + n_pred, rounds)
    if counts != want:
        failures.append(f"main-path launch counts {counts}, not the "
                        f"{want} launches the fits make")

    # ---- 3-4b. the captured fits against the eager loop -------------------
    t0 = time.perf_counter()
    with mock.patch.object(ExactGramOperator, "capturable", False):
        e_s = KernelSVM(C=1.0, kernel="rbf", device=dev,
                        options=svm.options).fit(A, y)
        e_c = KernelSVM(C=1.0, kernel="rbf", device=dev,
                        options=dcd.options).fit(A, y, schedule=e_s.schedule)
        e_k = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                          options=krr.options).fit(Ar, yr)
    eager_drivers = spy.take()
    print(f"[graphs] the same fits with the operator not capturable: "
          f"{eager_drivers[1]} eager loops, {eager_drivers[0]} captured, "
          f"{time.perf_counter() - t0:.1f} s; fit walls eager (captured): "
          f"K-SVM s=32 {e_s.wall_time_s:.2f} s ({r_s.wall_time_s:.2f}), "
          f"classical {e_c.wall_time_s:.2f} s ({r_c.wall_time_s:.2f}), "
          f"K-RR {e_k.wall_time_s:.2f} s ({r_k.wall_time_s:.2f})")
    if eager_drivers != (0, 3):
        failures.append(f"the eager refits took {eager_drivers}")
    for label, got, want_ in (
            ("K-SVM s=32 alpha", r_s.alpha, e_s.alpha),
            ("K-SVM classical alpha", r_c.alpha, e_c.alpha),
            ("K-RR alpha", r_k.alpha, e_k.alpha),
            ("K-RR residual history", r_k.history, e_k.history)):
        same, diff = bit_equal(got, want_)
        print(f"[graphs] {label}: captured vs eager "
              f"{'equal bit for bit' if same else 'DIFFER'} (max abs "
              f"diff {diff:.3e})")
        if not same:
            failures.append(f"captured vs eager {label}: {diff:.3e}")
    # the wrong driver: every run after the first replayed without its
    # schedule slice repeats the first run's coordinates
    rf_s = make_sstep_dcd_round_fn(A, y, svm.cfg, 32,
                                   op=ExactGramOperator(A, kernels["rbf"])
                                   .scale_rows(y))
    xs_s = pad_rounds(r_s.schedule, 32)
    for refresh in (True, False):
        with RoundGraphs(rf_s, torch.zeros_like(y), xs_s,
                         min(FAST_RUN, xs_s[0].shape[0])) as g:
            for j in range(g.n_runs):
                g.run(j, refresh=refresh or j == 0)
            same, diff = bit_equal(g.state, e_s.alpha)
        spy.take()
        what = ("refreshed" if refresh else
                "stale (every run the first run's coordinates)")
        print(f"[graphs] K-SVM s=32 through RoundGraphs, schedule buffer "
              f"{what}: vs eager {'equal' if same else 'differs'} (max abs "
              f"diff {diff:.3e}){'' if refresh else '; must differ'}")
        if same != refresh:
            failures.append(f"the bit-for-bit check "
                            f"{'fails' if refresh else 'passes'} the "
                            f"{what} driver")
    if failures:
        for f in failures:
            print(f"[check] FAIL {f}")
        return fail(f"{len(failures)} main-path check(s) failed")

    # ---- 5. stream and Nystrom --------------------------------------------
    stream_entries = stream_phase(SimpleNamespace(
        dev=dev, m=m, n=n, q=q, kernels=kernels, A=A, y=y, Aq=Aq,
        B_of=B_of, pick=pick, Xv=Xv, Xm=Xm, r_s=r_s, gap=gap, Ar=Ar, yr=yr,
        Arq=Arq, r_k=r_k, spy=spy), args, failures)
    if failures:
        for f in failures:
            print(f"[stream] FAIL {f}")
        return fail(f"{len(failures)} stream/Nystrom check(s) failed")

    # ---- 6. counts, times, bounds -----------------------------------------

    rbf, lin = kernels["rbf"], kernels["linear"]
    rows = []

    def kmv_row(label, B, c, iters):
        X = Xv if c == 1 else Xm
        r = B.shape[0]
        plan = kmv_plan(m, r, c, sm_count(0), B is A)
        kernel = lambda: kmv_cuda(A, B, X, rbf)  # noqa: E731
        ms = time_queued(kernel, iters)
        eager = time_cuda(kernel, iters)
        plain = time_queued(lambda: kmv_plain(A, B, X, rbf), iters)
        # K(A, A) is symmetric: its m (m + 1) / 2 distinct entries are the
        # work the full matvec needs; B = A is read once
        pairs = m * (m + 1) // 2 if B is A else m * r
        nbytes = 4 * (m * n + (0 if B is A else r * n) + m * c + r * c)
        flops = 2 * pairs * n + 2 * m * r * c + 2 * (m + r) * n + 6 * pairs
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append(("kmv", f"{label} [{plan.regime} {plan.bm} x "
                     f"{plan.br}]", ms, plain, b_ms, b_by, None, eager))
        return ms, plain, b_ms, b_by, eager, plan.regime

    def gram_row(label, G1, G2, cfg, iters, library, kernel=None):
        r1, r2 = G1.shape[0], G2.shape[0]
        kernel = kernel or (lambda: gram_cuda(G1, G2, cfg))
        ms = time_queued(kernel, iters)
        eager = time_cuda(kernel, iters)
        plain = time_queued(lambda: gram_plain(G1, G2, cfg), iters)
        lib = (time_queued(lambda: torch.mm(G1, G2.T), iters) if library
               else None)
        nbytes = 4 * ((r1 + r2) * n + r1 * r2)
        flops = 2 * r1 * r2 * n + (2 * (r1 + r2) * n + 6 * r1 * r2
                                   if cfg.name == "rbf" else 0)
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append(("gram", label, ms, plain, b_ms, b_by, lib, eager))
        return ms, plain, b_ms, b_by, lib, eager

    k32 = kmv_row(f"rbf ({m}, 32, {n}) c=1 K-SVM round", B_of["r32"],
                  1, 20)
    k1 = kmv_row(f"rbf ({m}, 1, {n}) c=1 classical DCD round", B_of["r1"],
                 1, 20)
    k256 = kmv_row(f"rbf ({m}, 256, {n}) c=1 K-RR round", B_of["r256"],
                   1, 10)
    kmv_row(f"rbf ({m}, 1024, {n}) c=1 prediction block", B_of["q1024"],
            1, 5)
    kfull = kmv_row(f"rbf ({m}, {m}, {n}) c=1 full matvec, B = A", A, 1,
                    2)
    A_copy = A.clone()
    kmv_row(f"rbf ({m}, {m}, {n}) c=1 full matvec, B a copy of A",
            A_copy, 1, 2)
    del A_copy
    g_ms = {}
    for label, (G1, G2) in gram_blocks.items():
        what = {"1x1": "classical DCD cross block",
                "32x32": "K-SVM cross block", "256x256": "K-RR cross block",
                "mx32": "slab_free=False slab"}[label]
        shape = (G1.shape[0], G2.shape[0], n)
        iters = 10 if label == "mx32" else 50
        row = gram_row(f"rbf {shape} [{what}]", G1, G2, rbf, iters, False)
        g_ms[label] = row[0]
        if label == "256x256":
            g256 = row
        if label == "1x1":
            # the same block through the 32 x 32 tile kernel, against the
            # dot kernel that gram_splits picks for it
            _, _, splits, per = gram_splits(32, 32, n, sm_count(0))
            gram_row(f"rbf {shape} through the 32 x 32 tile", G1, G2, rbf,
                     iters, False, lambda: gram_direct(G1, G2, rbf, 32, 32,
                                                       splits, per))
        gram_row(f"linear {shape} vs torch.mm", G1, G2, lin, iters, True)
    print("[time] kmv, gram: the kernel's, plain and library times are "
          "device times of launches queued behind a spin kernel "
          "(time_queued); 'eager' times the same calls back to back "
          "(time_cuda), the wrapper's host time included; kmv's regime and "
          "tile in brackets")
    for kind, label, ms, plain, b_ms, b_by, lib, eager in rows:
        lib_s = f"{lib:.4f} ms" if lib is not None else "none"
        eager_s = f" (eager {eager:.4f} ms)" if eager is not None else ""
        print(f"[time] {kind} {label}: {ms:.4f} ms{eager_s} | plain "
              f"{plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / ms:.1%} of it) | library {lib_s}")

    # inner (local) phase share of an s-step round, synchronised per phase
    op_svm = ExactGramOperator(A, rbf).scale_rows(y)
    idx_s, valid_s = pad_rounds(r_s.schedule, 32)
    a_s = r_s.alpha
    cfg_svm = svm.cfg
    sk, sl = phase_split(
        lambda k: op_svm.round_data(idx_s[k], a_s),
        lambda k, d: sstep_dcd_inner(d[0], d[1], a_s[idx_s[k]], idx_s[k],
                                     cfg_svm.nu, cfg_svm.omega, 32,
                                     valid_s[k]), 16)
    op_krr = ExactGramOperator(Ar, rbf)
    idx_k, valid_k = pad_rounds(r_k.schedule, 8)
    a_k = r_k.alpha
    kk, kl = phase_split(
        lambda k: op_krr.round_data(idx_k[k].reshape(-1), a_k),
        lambda k, d: sstep_bdcd_inner(d[0], d[1], a_k[idx_k[k]],
                                      yr[idx_k[k]], idx_k[k].reshape(-1), m,
                                      1.0, 8, 32, valid_k[k]), 16)
    print(f"[rounds] K-SVM s=32: kernel phase {sk:.3f} ms, local phase "
          f"{sl:.3f} ms, local share {sl / (sk + sl):.1%}")
    print(f"[rounds] K-RR s=8 b=32: kernel phase {kk:.3f} ms, local phase "
          f"{kl:.3f} ms, local share {kl / (kk + kl):.1%}")

    # the same rounds replayed as CUDA graphs, as the fits run them: device
    # ms a round from events around the replays; what is left of the local
    # phase beside the rounds' KMV and gram (their queued times above),
    # spread over the round's other launches (an eager round profiled)
    op_krr_c = ExactGramOperator(Ar, rbf)
    rf_c = make_dcd_round_fn(A, y, svm.cfg, op=op_svm)
    rf_k = make_sstep_bdcd_round_fn(Ar, yr, krr.cfg, 8, op=op_krr_c)
    xs_k = pad_rounds(r_k.schedule, 8)
    gap_k = lambda a: krr_rel_residual_op(op_krr_c, yr, a,  # noqa: E731
                                          krr.cfg)
    zero = torch.zeros_like(y)
    shapes = [
        ("K-SVM s=32", rf_s, xs_s, FAST_RUN, None, k32[0] + g_ms["32x32"],
         lambda: rf_s(zero, (xs_s[0][0], xs_s[1][0]))),
        ("K-SVM classical", rf_c, r_c.schedule, FAST_RUN, None,
         k1[0] + g_ms["1x1"], lambda: rf_c(zero, r_c.schedule[0])),
        ("K-RR s=8 b=32", rf_k, xs_k, 16, None, k256[0] + g256[0],
         lambda: rf_k(zero, (xs_k[0][0], xs_k[1][0]))),
        ("K-RR s=8 b=32, each run ending in its check", rf_k, xs_k, 16,
         gap_k, None, None)]
    for label, rf, xs, c_len, metric, kernels_ms, one_round in shapes:
        gt = graph_timing(label, rf, zero, xs, c_len, metric_fn=metric)
        if one_round is None:
            continue
        busy, nodes, _ = device_profile(one_round, 1)
        local = gt["round_ms"] - kernels_ms
        per_node = (f"{local / (nodes - 2) * 1e3:.2f} us" if nodes > 2
                    else "not measured")
        print(f"[rounds] {label} replayed: {gt['round_ms']:.4f} ms a round "
              f"(eager kernel + local phase above); its KMV + gram "
              f"{kernels_ms:.4f} ms, the rest {local:.4f} ms, local share "
              f"{local / gt['round_ms']:.1%}; an eager round launches "
              f"{nodes:.0f} device operations (busy "
              f"{busy if busy is None else round(busy, 4)} ms), so "
              f"{per_node} a node beside KMV and gram")
    spy.take()

    if failures:
        for f in failures:
            print(f"[check] FAIL {f}")
        return fail(f"{len(failures)} main-path check(s) failed")

    # ---- 9. sweeps (on phases 3-4's data, before the LM frees it) ---------
    del rf_s, rf_c, rf_k, op_krr_c, gap_k, shapes, op_svm, op_krr
    torch.cuda.empty_cache()
    sweep_entries, fleet_counts = sweep_phase(SimpleNamespace(
        dev=dev, m=m, n=n, kernels=kernels, A=A, y=y, Ar=Ar, yr=yr,
        B_of=B_of, r_s=r_s, r_c=r_c, r_k=r_k, svm=svm, krr=krr, spy=spy),
        args, failures)
    print(f"[sweep] phase 9 launches (the fleets, counted from 0): kmv "
          f"{fleet_counts[0]}, gram {fleet_counts[1]}")
    if failures:
        for f in failures:
            print(f"[sweep] FAIL {f}")
        return fail(f"{len(failures)} sweep check(s) failed")

    # ---- 7. LM prefill and serving ----------------------------------------
    del A, Ar, Aq, Arq, B_of, gram_blocks, Xv, Xm, svm, krr
    del dcd
    torch.cuda.empty_cache()
    lm_entries = lm_phase(dev, args, failures)
    if failures:
        for f in failures:
            print(f"[lm] FAIL {f}")
        return fail(f"{len(failures)} LM check(s) failed")

    # ---- 8. LM training ---------------------------------------------------
    train = train_phase(dev, args, failures)
    if failures:
        for f in failures:
            print(f"[train] FAIL {f}")
        return fail(f"{len(failures)} LM training check(s) failed")
    train_entries, train_counts = train
    for entry in lm_entries:
        entry["train_launches"] = train_counts[entry["name"]]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])                            # the card's name, power limit
    record = {"kernels": [
        {"name": "kmv", "route": "cuda", "source":
            "src/repro_torch/csrc/kmv.cu",
         "replaces": "src/repro/kernels/kmv.py:93",
         "shape": f"rbf (m, r, n, c) = ({m}, 32, {n}, 1)",
         "launches": counts[0],
         "max_abs_err": err_at[("kmv", "rbf", "torch.float32", "r32",
                                "vec")],
         "ms": k32[0], "plain_ms": k32[1], "bound_ms": k32[2],
         "bound_by": k32[3], "library_ms": None,
         "ms_timing": "device time, launches queued behind a spin kernel "
                      "(time_queued); eager_ms: back to back, host "
                      "included (time_cuda)",
         "eager_ms": k32[4], "regime": k32[5],
         "ms_r1": k1[0], "eager_ms_r1": k1[4], "plain_ms_r1": k1[1],
         "bound_ms_r1": k1[2], "regime_r1": k1[5],
         "ms_full": kfull[0], "eager_ms_full": kfull[4],
         "plain_ms_full": kfull[1], "bound_ms_full": kfull[2],
         "regime_full": kfull[5]},
        {"name": "gram", "route": "cuda", "source":
            "src/repro_torch/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram.py:82",
         "shape": f"rbf (m, r, n) = (256, 256, {n})",
         "launches": counts[1],
         "max_abs_err": err_at[("gram", "rbf", "torch.float32",
                                "256x256")],
         "ms": g256[0], "plain_ms": g256[1], "bound_ms": g256[2],
         "bound_by": g256[3], "library_ms": g256[4],
         "ms_timing": "device time, launches queued behind a spin kernel "
                      "(time_queued); eager_ms: back to back, host "
                      "included (time_cuda)",
         "eager_ms": g256[5]},
        *stream_entries,
        *sweep_entries,
        *lm_entries,
        *train_entries,
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
