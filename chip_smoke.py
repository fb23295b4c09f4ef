#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the repository root, with one card:  python3 chip_smoke.py

Phases (each prints its results; any failed check makes the script exit 1):
  setup  the card's name and power limit; build the CUDA kernels (timed).
  main   the main path with every kernel's launch count set to 0 just before
         and read just after: one emulated DGEMM ``dispatch.matmul`` at
         m = k = n = 8192, and one dense CG solve ``cg_solve_dense`` of a
         Gaussian-process system (RBF kernel matrix over seeded points plus a
         noise variance on the diagonal, n = 8192), both on the ``auto`` route,
         which is the kernel route for CUDA tensors.
  gemm   the DGEMM against the reference route (bitwise) and against native
         FP64 (<= 16 u componentwise relative to |A||B|, one row at ~1e-300);
         ``gemm_hilo`` against its plain version at the main-path shape; times
         beside the bound, ``torch.matmul`` f64 and PERF.md's earlier time, and
         the device time of its four stages (residues of A, of B, the wgmma
         product, Garner; torch.profiler).
  gemv   the same at 8192 x 8192 with n in {1, 8, 16}; ``gemv_hilo`` timed at
         each n (n = 1 is the CG matvec), with its two kernels' device times.
  ragged two ragged shapes through the seam, and both kernels against their
         plain versions in every output representation (f64, digits, ds).
  cg     the same solve on the reference route: both converge, their
         compensated residual histories are bitwise equal, ||Kx - y||/||y||
         <= 1e-9, and the GEMV ran iterations + 1 times on the main path.
  stencil the 7-point Laplacian on a seeded 256^3 grid: ``dispatch.stencil7``
         kernel vs reference route (bitwise), against native FP64 (<= 8u * 7 *
         max|u| * max|c|); the fused ``stencil7`` (its Phase 1 in the kernel)
         against its plain version at 256^3 and at 37 x 29 x 51 (also scaled to
         1e-300 and 1e300), in every output representation, at two tiles; the
         kernel's time at each tile, the whole call's, its device time by kernel
         (torch.profiler), beside ``F.conv3d`` f64 and the bound (the FP64
         operations its bits need).
  jacobi the stencil's main path, with its launch counts set to 0 just before
         and read just after: ``jacobi_solve`` at 256^3, omega = 2/3, 50 sweeps;
         the stencil launched sweeps + 1 times and each reduction kernel sweeps
         + 2 times, the residual history decreases, and the reference route
         (plain stencil, tree and fold; no kernel launched) gives a
         bitwise-equal history and u.  A sweep timed by parts (CUDA events): the
         stencil call, the residual, the norm, the update.
  spmv   HPCG's operator (27-point stencil, diagonal 26, off-diagonals -1, on
         its default 104^3 local grid) in Blocked-ELL form built on the card:
         ``dispatch.spmv`` kernel vs reference route (bitwise), against native
         FP64 (<= 16u relative to sum|a| * max|x|); ``spmv_bell``'s kernel
         against its plain version there and on a ragged random matrix, in every
         output representation and at two row blocks; times beside
         ``torch.sparse`` CSR f64 and the bound, beside PERF.md's earlier time,
         and the device time of the kernel's launch by kernel (torch.profiler).
  cg_bell the SpMV's main path, launch count set to 0 just before and read just
         after: ``cg_solve_bell`` on HPCG's operator with b = A 1 (tol 1e-10);
         it converges (||Ax - b||/||b|| <= 1e-9, ||x - 1||inf <= 1e-6), the
         kernel launched iterations + 1 times, and the reference route's first
         50 iterations give a bitwise-equal history.  Then a solve of 0 and one
         of 10 iterations, each under torch.profiler and timed by the host clock
         and by CUDA events: their differences over 10 give an iteration's
         device busy time, its host and stream times, and the device's idle
         share against each (unclamped), and the busy time's split into the
         port's kernels and PyTorch's.
  reduce the compensated reductions, which every solver runs (their counts are
         set to 0 and read with the main paths'): per dot, a ``block_tree``
         (the blocked two_sum tree) and a ``carry_fold`` (the in-order fold);
         per norm also a ``norm_scale`` (its exact scale).  ``neumaier_sum``,
         ``compensated_dot`` and ``compensated_norm``, kernel route vs plain
         route (torch tree, host fold) at the main paths' lengths (256^3 norm,
         HPCG 104^3 dot, n = 8192 dot), batched, in float32 and with inf, NaN,
         signed zeros, zero lanes and denormals, and at blocks past 512
         elements; each kernel against its plain version; times of each kernel
         and of a whole norm and dot, the norm's
         device time by kernel (torch.profiler), the latency of a dependent
         float64 add (the fold's chain bound), ``torch.linalg.vector_norm`` f64
         for scale.
  attention ``dispatch.attention`` and ``attention_fused`` at yi-6b's head_dim
         128 (r = 15) in seven cases: causal prefill 32 x 512 x 512 (the serve
         phase's per-layer shape), ragged 6 x 37 x 301 with D = 80, softcap 30,
         a sliding window of 64, decode S = 1 against a ring mask at the serve
         phase's two cache lengths (32 with bkv 32, and 4096), and q
         rows and v columns at ~1e-300; an eighth at the gemmas' head_dim
         256 (the kernel's wide path, bq <= 16): decode 16 x 1 x 4096; and a
         ninth at whisper's head_dim 64: its encoder's 16 x 1500 x 1500 with
         no mask (the last key block 92 of 128 keys).  In each: the kernel route against the
         reference route (bitwise), the kernel against its plain version at
         two bq on every path of the kernel (the one-pass sweep, and where
         S = 1 the row path the wrapper picks and the sweep forced; bitwise,
         the result must depend on neither), and against
         a native-FP64 softmax attention (<= 1e-12 * max|v| per column).  Times
         of the kernel on each path, its plain version,
         ``F.scaled_dot_product_attention`` f64 and the bound, and each path's
         device time by kernel (torch.profiler), at causal prefill, the ragged
         case, both decode lengths and whisper's encoder, beside PERF.md's
         earlier times.
  serve  yi-6b at its published widths (d_model 4096, 32 heads over 4 KV
         heads, head_dim 128, d_ff 11008, vocab 64000), depth cut to 16 of 32
         layers (SERVE_LAYERS), policy ozaki2_int8, compute float32, random
         weights from a seeded generator on the card.  The main path, with every launch count set to 0 just
         before and read just after: ``ContinuousBatcher`` serves 3 requests of
         16 seeded prompt tokens and 8 new tokens through 2 slots, then
         4 decode steps of a second engine whose 2 x 4096 cache is full
         (seeded keys and values: the cost of attending over a long context),
         then one forward pass over 512 tokens, all on the ``auto`` route;
         ``attention_fused`` launched layers x calls and ``gemm_hilo``
         (7 x layers + 1) x calls times.  Then the reference route (bitwise
         forward logits and first 4 decode steps, at all 16 layers), and the
         emulated logits against the fp64 policy's (rtol 1e-3, atol 1e-4).
         Prints decode ms/step, tokens/s, ``dispatch.attention``'s share of a
         decode step (CUDA events) at both cache lengths, and peak memory.
  spectral the spectral dwarf's main paths, each with the seam kernels' counts
         set to 0 just before and read just after, on the kernel route and then
         on the reference route (bitwise): ``fft`` at n = 2^20 (Bailey twice),
         ``fft`` of 8 x 4093 (prime: one dense 8186 x 8186 GEMM through
         ``gemv_hilo``), ``fftn`` of a seeded complex128 256^3 grid (16 x 16 an
         axis, GEMMs of 32 x 32 by 32 x 1,048,576 through ``gemm_hilo``),
         ``poisson_solve_periodic`` at 256^3 (a manufactured solution),
         ``poisson_solve_checked`` (its two compensated norms on the reduction
         kernels) and ``poisson_solve_dirichlet`` on a 127^3 interior (odd
         extension to 256^3).  Each against torch.fft in complex128, in units of
         dft_error_bound(n) * max|X| (<= 2: both within one bound of the exact
         transform); the solves within kappa * 6 * dft_error_bound(256) *
         max|u|; times beside torch.fft's; launches of gemm_hilo and gemv_hilo.
  fp8    the FP8 substrate's plane products (torch._scaled_mm, use_fast_accum
         False) against exact sums, at k = 2^5 .. 2^16 and three shapes, random
         and adversarial planes: one call over the whole contraction, and the
         port's runs of FP8_CUDA_K_CHUNK in blocks of their own (0 differing
         at every k).  The DGEMM 8192^3 through ``dispatch.matmul`` on the FP8
         substrate, bitwise equal to the int8 kernel route, its error in u
         against native FP64, its time beside the int8 route and torch.matmul
         f64.  Ozaki-I's DGEMM 8192^3 (S = 8, 64 torch._int_mm products): its
         error (<= 16 u) and time.
  serve-fp8 yi-6b at its published widths, depth cut to 2 of 32 layers, under
         ozaki2_fp8, compute float32, seeded weights: one request of 16 seeded
         prompt tokens and 4 new tokens through ``ContinuousBatcher`` (the main
         path: attention_fused launched layers x steps, no gemm_hilo), its
         logits at every step bitwise equal to the same calls under
         ozaki2_int8 and within rtol 1e-3, atol 1e-4 of the fp64 policy's; ms
         per decode step, and one weight product by part.
  serve-moe deepseek-moe-16b at its published widths (d_model 2048, 16 heads
         of 128, 64 routed experts of width 1408, top-6, 2 shared, vocab
         102400), depth cut to 8 of 28 layers (SERVE_MOE_LAYERS), policy ozaki2_int8, compute float32, weights
         stored in bfloat16 (the published checkpoint's dtype) and made on the
         card from a seed.  The main path, every launch count set to 0 just
         before and read just after: ``ContinuousBatcher`` serves 3 requests
         of 16 seeded prompt tokens and 8 new tokens through 2 slots (capacity
         max(ceil(2 * 6 / 64 * 1.25), 6) = 6: no token dropped);
         ``attention_fused`` launched layers x steps and ``gemm_hilo``
         (7 x layers + 1) x steps (attention's four projections, the shared
         experts' three, the LM head; the router and the routed experts are
         float32 einsums, as in the reference).  The kernel route against the
         reference route on the first 2 decode steps: logits and routed
         experts of every layer bitwise.  The fp64 policy on the same weights
         and calls: routes compared layer by layer (each flip printed with its
         top-k margin in float32 ulps; a first flip of a slot at a margin above
         MARGIN_ULPS fails), logits within rtol 1e-3, atol 1e-4 on every step
         before the first flip.  Decode ms/step with its split (CUDA events):
         weight products (dispatch.matmul, Phase 1 included; gemm_hilo alone
         at the step's shapes), dispatch.attention, the routed experts (of it
         the float32 copies of the bfloat16 expert stacks); tokens/s; the
         weights' build time; peak memory.
  serve-ssm xlstm-350m at its published widths (d_model 1024, mLSTM and
         sLSTM alternating, 4 heads over d_inner 2048, no MLP, vocab 50304
         tied), depth cut to 16 of 24 layers (SSM_LAYERS), policy ozaki2_int8, float32 weights and compute, made on
         the card from a seed.  The main path, every launch count set to 0 just
         before and read just after: ``ContinuousBatcher`` serves 3 requests of
         16 seeded prompt tokens and 8 new tokens through 2 slots, then one
         ``Model.apply`` over 512 tokens (8 chunks of 64 in every layer); each
         call launches the kernels ``products_per_call`` reads from the layers
         (gemm_hilo 8 x 5 + 8 x 2 + 1 = 57, gemv_hilo 8 for mLSTM's 8-column
         gate projection, no attention_fused).  Decode ms/step (host clock)
         split by CUDA events into weight products and the recurrences' steps,
         the card's busy share (torch.profiler), tokens/s, the forward's ms,
         peak memory; 16 decode steps against the forward's first 16 positions
         (within SSM_DECODE_TOL x 2^-23 max|logit|); the first 2 recorded decode
         calls replayed on the kernel and reference routes (bitwise); every
         step replayed under the fp64 policy (rtol 1e-3, atol 1e-4).
  serve-hybrid jamba-1.5-large-398b at its published widths (d_model 8192, 64
         heads over 8 KV heads, d_ff 24576, Mamba d_inner 16384 with state 16,
         16 experts of width 24576, top-2, vocab 65536), depth cut to its first
         2 layers (attention with a dense SwiGLU MLP; Mamba with the MoE),
         ozaki2_int8, float32 compute, bfloat16 weights.  The same traffic and
         forward (2 Mamba chunks of 256) as serve-ssm: gemm_hilo 12 (the
         8192 x 65536 LM head in 2 column blocks, ``policy.column_blocks``) and
         attention_fused 1 a call; the forward and the first 2 decode calls
         bitwise across routes (routed experts included); the fp64 policy's
         routes under serve-moe's rule.  Step split (weight products,
         attention, routed experts and their float32 copies), busy share, peak
         memory (within the card's).
  serve-encdec whisper-medium at its published widths and depth (24 encoder
         and 24 decoder layers, d_model 1024, 16 heads of 64, d_ff 4096 GeGLU,
         vocab 51865, 1500 encoder frames), ozaki2_int8, float32 weights and
         compute.  The main path: the batcher's 3 requests (a decode step
         launches gemm_hilo 9 a layer + 1, attention_fused 1 a layer: its
         cross-attention over the never-filled cross cache is native), then
         one forward over the stub frontend's 1 x 1500 seeded frame embeddings
         and 448 seeded tokens (gemm_hilo 7 x 24 + 11 x 24 + 1, attention_fused
         24 + 2 x 24), bitwise against the reference route.  The decode step's
         parts and the forward's (weight products, attention of the encoder,
         the decoder's self- and cross-attention; CUDA events); each replayed
         step's cross-attention exactly 0 in every layer (ROADMAP queue 3, item
         16); every step against the fp64 policy (rtol 1e-3, atol 1e-4).
  serve-vlm qwen2-vl-72b at its published widths (d_model 8192, 64 heads over
         8 KV heads of 128, d_ff 29568 SwiGLU, vocab 152064 untied, M-RoPE
         sections (16, 24, 24), theta 1e6), depth cut to 2 of its 80 layers,
         bfloat16 weights, ozaki2_int8, float32 compute.  The batcher's 3 text
         requests (three equal M-RoPE streams), then one forward over 512
         seeded patch embeddings laid out as a 16 x 32 grid (t = 0, h = row, w
         = column), bitwise against the reference route, and against the same
         embeddings with three equal streams (the logits must differ).  The LM
         head's product runs in 5 column blocks (``policy.column_blocks``):
         gemm_hilo 19 and attention_fused 2 a call.  Decode against the fp64
         policy; routes bitwise on 2 replayed steps; peak memory.
  vjp    the emulated dots' gradient at yi-6b's widths: x 16 x 4096 through the
         MLP (gate and up 4096 x 11008, down 11008 x 4096, ``layers.mlp_apply``)
         and the unembedding (4096 x 64000, ``layers.unembed_apply``), float64
         activations and seeded weights, loss = sum(logits * c), under autograd.
         ozaki2_int8 on the kernel route (the main path, after a warm-up run:
         gemm_hilo 4 launches in the forward and 8 in the backward) and on the
         reference route (no launch; gradients of x and every weight bitwise
         equal); each product's dA and dB within 16 u of |g||Bᵀ| and |Aᵀ||g|
         (native FP64 from the same g); ozaki2_fp8 bitwise equal to ozaki2_int8;
         ozaki1_int8 within 16 u a product; both chains within VJP_CHAIN_TOL of
         the fp64 policy's.  Forward and backward times per policy.
  train  yi-6b's training step at its published widths (d_model 4096, 32 heads
         over 4 KV heads of 128, d_ff 11008 SwiGLU, vocab 64000), depth cut to
         2 of its 32 layers, ozaki2_int8, float32 weights and compute, remat
         on; batches of 4 x 512 from ``data.pipeline.Pipeline``, AdamW at its
         defaults with float32 moments, 1 warm-up step.  The main path, launch
         counts set to 0 just before and read just after: 3 steps of
         ``train.loop.make_train_step`` on the kernel route, each launching
         gemm_hilo 7 x 2 + 1 and attention_fused 2 in the forward, the same
         in remat's recompute, and gemm_hilo 2 x 15 in the backward.  Step ms
         (host clock) by part (forward, loss, backward, clip, update; CUDA
         events), tokens/s, peak memory.  The warm-up step against the same
         step on the reference route (loss, every gradient, the updated
         parameters and both moments bitwise; no launch); every wq, wk and wv
         gradient exactly 0 (ROADMAP queue 3, item 17), every other finite;
         its loss within TRAIN_LOSS_TOL of the fp64 policy's, and the
         relative gap of the LM head's and last MLP's gradients.
  resume checkpoints and recovery (``train.checkpoint``,
         ``train.fault_tolerance``) and the launcher (``launch.train``).  The
         main path, launch counts set to 0 just before and read just after:
         yi-6b as in the train phase (full width, 2 of 32 layers,
         ozaki2_int8, float32, remat, batches of 4 x 512) with AdamW's
         bfloat16 moments, 4 uninterrupted steps from a seeded state, then 4
         steps from the same state through ``run_with_recovery`` with a
         checkpoint every 2 steps (~7.0 GB each: float32 weights, bfloat16
         moments) and a StepFailure on the third call: one failure, one
         restore, 4 steps run, its one delay recorded, and the parameters,
         moments and step bitwise the uninterrupted run's; gemm_hilo 7 x 2 + 1
         + 7 x 2 + 2 x 15 and attention_fused 2 x 2 a step.  Each save's host
         snapshot and write (host clock), the restore with verify, their
         GB/s; the disk's free space before.  Then ``launch.train.main``
         in-process at --smoke, ozaki2_int8, 6 steps with a checkpoint every
         3, its step 6 moved aside and the command run again: it resumes from
         step 3 and writes step 6 bitwise again; its 9 steps' launches by the
         same formula at 2 layers.  The checkpoints live under ``_ckpt/``
         and are deleted at the end of the phase.
  tme    the TME model on the card: under ``telemetry_scope("counters")`` on the
         kernel route, DGEMM 8192^3 (3 calls), GEMV 8192^2 x 1, stencil7 256^3,
         HPCG 104^3 SpMV, attention at causal prefill 32 x 512 x 512 and decode
         64 x 1 x 4096, compensated_norm at 256^3 (5 calls each), each call also
         between CUDA events of the phase's own: telemetry's time within 10% of
         them per kind, the kernels' launches counted, no event pair resolved
         before the snapshot, ``telemetry_scope("off")`` recording nothing; the
         report's table for chip H100 and, per kind, the measured seam time, this
         run's kernel time and the TME prediction (beta = 1) with their ratios.
Then one JSON line describing each kernel, and the contract's last line.

Tolerances: every kernel and route comparison is bitwise (0 differing
elements; NaN equals NaN, since the reference's ds representation is NaN from
r = 16 on).  Times are CUDA-event medians after a warm-up.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
U = 2.0 ** -53
SEED = 20260613
N = 8192
# H100 SXM peaks (NVIDIA data sheet; dense): int8 tensor cores and HBM3.
INT8_OPS_PER_S = 1979e12
BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12   # FP64 outside the tensor cores
GRID = 256               # the stencil's and Jacobi's grid, GRID^3 points
JACOBI_SWEEPS = 50
HPCG_N = 104             # HPCG's default local grid (hpcg.dat: 104 104 104)
CG_REF_ITERS = 50        # CG iterations compared across routes

ATTN_D = 128             # yi-6b's head_dim
SERVE_CTX = 32           # the batcher's cache length
LONG_CTX = 4096          # yi-6b's pretraining context (arXiv:2403.04652)
LONG_STEPS = 4           # decode steps against the full LONG_CTX cache
WIDE_D = 256             # gemma-7b's and gemma3-4b's head_dim (attention's wide path)
ENC_D = 64               # whisper-medium's head_dim
ENC_FRAMES = 1500        # whisper's encoder frames (a 30-second clip); 11 x 128 + 92 keys
SERVE_MOE_ARCH = "deepseek-moe-16b"
# Depths of the earlier serving phases, cut (from 32, 28 and 24) to keep the
# whole script within its 20-minute limit on a slow host; widths are not cut.
SERVE_LAYERS = 16        # of yi-6b's 32
SERVE_MOE_LAYERS = 8     # of deepseek-moe-16b's 28
SSM_LAYERS = 16          # of xlstm-350m's 24
# A routing flip between the ozaki2_int8 and fp64 policies is a near-tie of the
# router's float32 probabilities: the first flip of a slot must come at a top-k
# margin of at most this many float32 ulps of the k-th probability.
MARGIN_ULPS = 64

# PERF.md section 6's times (ms) of each redesigned kernel before its redesign
# (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's.
EARLIER_MS = {"gemm_hilo 8192^3": 84.360,
              "gemv_hilo n=1": 1.482, "gemv_hilo n=8": 2.329, "gemv_hilo n=16": 3.130,
              "spmv_bell HPCG 104^3": 2.254,
              "attention_fused causal prefill 32 x 512 x 512": 3.923,
              f"attention_fused decode 64 x 1 x {SERVE_CTX}": 0.172,
              f"attention_fused decode 64 x 1 x {LONG_CTX}": 7.248,
              "stencil7 256^3": 2.938, "stencil7 call 256^3": 9.357,
              "jacobi sweep 256^3": 16.623, "carry_fold 256^3 norm": 0.652,
              "compensated_norm 256^3": 6.653}

VJP_ROWS = 16            # the rows of x in the vjp phase (a batch of tokens)
# The vjp phase's chain tolerance: each emulated product is within 16 u of its
# |A||B| (checked alone); through silu and the four products the gradients of x
# and of every weight are held within 1e-11 of the fp64 policy's, normwise
# (max |difference| / max |fp64 gradient|), some 10^4 u of room for the
# cancellations of sums over up to 64,000 terms.
VJP_CHAIN_TOL = 1e-11

TRAIN_ARCH = "yi-6b"
TRAIN_LAYERS = 2         # of yi-6b's 32
TRAIN_BATCH = 4          # sequences a step
TRAIN_SEQ = 512          # tokens a sequence
TRAIN_STEPS = 3          # timed steps after one warm-up step
# The first step's loss under ozaki2_int8 against the fp64 policy's from the
# same parameters and batch, relative: the weight products agree to FP64
# accuracy, and the two attention paths (emulated FP64-accurate softmax, native
# float32 softmax) differ in the last float32 bits of the activations.
# Measured 0 on an H100 (the losses' float32 bits were equal; the LM head's
# and last MLP's gradients within 1.4e-7), so 8 float32 epsilons of room.
TRAIN_LOSS_TOL = 1e-6
# The resume phase: yi-6b as in the train phase, with bfloat16 moments (the
# checkpoint's bfloat16 leaves, ROADMAP queue 3, item 19).  RESUME_STEPS
# uninterrupted steps, then the same through ``run_with_recovery`` with a
# checkpoint every RESUME_CKPT_EVERY steps and a StepFailure on call
# RESUME_FAIL_CALL; and the launcher's CLI at --smoke, run whole and then
# resumed from its step CLI_EVERY after its last checkpoint is moved aside.
RESUME_STEPS = 4
RESUME_CKPT_EVERY = 2
RESUME_FAIL_CALL = 3
CLI_STEPS = 6
CLI_EVERY = 3
CKPT_ROOT = os.path.join(ROOT, "_ckpt")   # the phase's checkpoints (listed in .gitignore)

FAILURES = []
KERNEL_MS = {}           # kernel times of this run that the tme phase reads
REDUCE_LAUNCHES = {}     # {main path: {reduction kernel: launches}}
GEMM_LAUNCHES = {}       # gemm_hilo launches on each main path
GEMV_LAUNCHES = {}       # gemv_hilo launches on each main path


def check(ok, what):
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def n_diff(a, b):
    """Count of elements whose values differ (NaN equals NaN)."""
    import torch

    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
    return int((~same).sum())


def time_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err_u(c, a, b):
    """max |c - a@b| / (|a| @ |b|) in units of u = 2^-53, native FP64 as the oracle."""
    import torch

    exact = torch.matmul(a, b)
    den = torch.matmul(a.abs(), b.abs())
    return float(((c - exact).abs() / den).max()) / U


def bound(m, k, n, r):
    """Least time (ms) for m x k x n at r moduli, and what bounds it: each (hi, lo)
    int32 input read once and the f64 output written once, against 2*m*n*k*r int8
    operations."""
    t_bytes = 8.0 * (m * k + k * n + m * n) / BYTES_PER_S
    t_ops = 2.0 * m * n * k * r / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_busy(prof, steps):
    """Device time per step from a torch.profiler run on one stream: the sum of
    the kernels' and copies' durations over `steps`, and that sum split into
    the port's kernels, by name, and PyTorch's own kernels and copies."""
    import torch

    parts = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if not t or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(?:ozaki|carry)::(\w+)", e.key)
        name = m.group(1) if m else "torch's kernels, copies and memsets"
        parts[name] = parts.get(name, 0.0) + t / 1000.0 / steps
    return sum(parts.values()), sorted(parts.items(), key=lambda kv: -kv[1])


def profiled(fn, steps):
    """device_busy of `steps` calls of fn after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    return device_busy(prof, steps)


def parts_text(parts):
    return "; ".join(f"{k} {t:.3f} ms" for k, t in parts)


@contextlib.contextmanager
def timed_calls(targets, label=None):
    """While the block runs, time every call of each ``targets[name] = (module,
    attribute)`` between CUDA events; yields {name: [(start, end), ...]}, each
    call filed under ``label(name, args)`` where a ``label`` is given."""
    import torch

    events = {name: [] for name in targets} if label is None else {}
    real = {name: getattr(mod, attr) for name, (mod, attr) in targets.items()}

    def timed(name):
        def call(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = real[name](*args, **kw)
            b.record()
            events.setdefault(name if label is None else label(name, args), []).append((a, b))
            return out
        return call

    for name, (mod, attr) in targets.items():
        setattr(mod, attr, timed(name))
    try:
        yield events
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, real[name])


def gemm_alone_ms(w):
    """gemm_hilo alone at a decode step's shape for weight w: the step's rows
    padded to 128 against w, after Phase 1 (CUDA events)."""
    import torch

    from repro_torch.core import dispatch, splitting
    from repro_torch.kernels import ozaki_gemm

    plan = dispatch.get_plan(w.shape[0])
    x = torch.randn((128, w.shape[0]), device=w.device, dtype=torch.float64)
    ah, al = splitting.split_hi_lo(splitting.scale_to_int(x, plan.payload_bits, -1)[0])
    bh, bl = splitting.split_hi_lo(splitting.scale_to_int(w.double(), plan.payload_bits, 0)[0])
    return time_ms(lambda: ozaki_gemm.gemm_hilo(ah, al, bh, bl, plan), reps=5)


def byte_bound(nbytes):
    """Least time (ms) to move nbytes at the card's memory rate."""
    return nbytes / BYTES_PER_S * 1e3


def reduce_counts(cf, reset=False):
    """The reduction kernels' launch counts, {name: count}; with ``reset`` set
    them to 0 first."""
    fns = (cf.norm_scale, cf.block_tree, cf.carry_fold)
    if reset:
        for fn in fns:
            fn.launches = 0
    return {fn.__name__: fn.launches for fn in fns}


def cg_reductions(iters):
    """A CG solve's reduction launches: ||b|| and dot(r, r) before the loop, two
    dots an iteration."""
    return {"norm_scale": 1, "block_tree": 2 * iters + 2, "carry_fold": 2 * iters + 2}


# FP64 operations that are not FMAs: one a lane a clock (FP64_OPS_PER_S counts
# an FMA as two).
FP64_PLAIN_OPS_PER_S = FP64_OPS_PER_S / 2


def stencil_bound(npts, r, per_digit=16.0):
    """Least time (ms) of the fused stencil at npts points and r moduli, and what
    bounds it: u read and the f64 output written once (16 B a point), against
    the FP64 operations its bits need, none fusable: the compensated Horner's 16
    a digit (its other 7 split an 8-bit digit, exactly: ``per_digit=23`` counts
    them too, as the plain version and the kernel issue them) and ~8 a point in
    Phase 1 and the unscale."""
    t_bytes = 16.0 * npts / BYTES_PER_S
    t_ops = npts * (per_digit * r + 8.0) / FP64_PLAIN_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def stencil_phases(dev, gen):
    """The stencil and Jacobi phases; returns the stencil7 entry of the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import compensated, dispatch
    from repro_torch.hpc import jacobi
    from repro_torch.kernels import carry_fold, ozaki_stencil, ref

    # -------------------------------------------------------------- stencil
    plan = dispatch.get_plan(8, margin_bits=4)
    check(plan.r == 15, f"stencil: plan r = {plan.r}")
    u = torch.randn((GRID,) * 3, generator=gen, device=dev, dtype=torch.float64)
    c = jacobi.laplacian_coeffs(device=dev)
    v_k = dispatch.stencil7(u, c)
    v_r = dispatch.stencil7(u, c, mode="ref")
    check(n_diff(v_k, v_r) == 0, f"stencil: {GRID}^3 kernel vs reference route, "
          f"{n_diff(v_k, v_r)} differing elements")
    want = ref.stencil7_f64(u, c)
    err = float((v_k - want).abs().max())
    lim = 8 * U * 7 * float(u.abs().max()) * float(c.abs().max())
    check(err <= lim, f"stencil: error vs native FP64 {err:.3e} <= 8u*7*max|u|*max|c| "
          f"= {lim:.3e}")
    del v_r
    tune = dispatch.get_tuning("stencil7", u.shape)
    tiles = [(int(tune["bz"]), int(tune["by"]), int(tune["bx"])), (64, 4, 32)]
    ur = torch.randn((37, 29, 51), generator=gen, device=dev, dtype=torch.float64)
    cr = torch.randn(7, generator=gen, device=dev, dtype=torch.float64)
    err_kp = 0.0
    for name, uu, cc in ((GRID, u, c), ("37x29x51", ur, cr), ("37x29x51 at 1e-300", ur * 1e-300,
                                                                cr),
                         ("37x29x51 at 1e300", ur * 1e300, cr)):
        for rep in ("f64", "digits", "ds"):
            p_out = ozaki_stencil.stencil7_ref(uu, cc, plan, rep)
            for bz, by, bx in tiles:
                k_out = ozaki_stencil.stencil7(uu, cc, plan, rep, bz=bz, by=by, bx=bx)
                d = n_diff(k_out, p_out)
                if name == GRID and rep == "f64":
                    err_kp = max(err_kp, float((k_out - p_out).abs().max()))
                check(d == 0, f"stencil: fused kernel vs plain version at {name}, {rep}, tile "
                      f"{(bz, by, bx)}, {d} differing elements")
                del k_out
            del p_out
    weight = torch.zeros((1, 1, 3, 3, 3), dtype=torch.float64, device=dev)
    for (i, j, k), ci in zip(((1, 1, 1), (0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1),
                              (1, 1, 0), (1, 1, 2)), c):
        weight[0, 0, i, j, k] = ci

    def conv():
        return F.conv3d(u[None, None], weight, padding=1)[0, 0]
    conv_err = float((conv() - want).abs().max())
    check(conv_err <= lim, f"stencil: F.conv3d computes the same function ({conv_err:.3e})")
    absmax, elog = ozaki_stencil._scales(u, c)
    kernel_ms = {}
    for (bz, by, bx) in tiles:
        kernel_ms[bz, by, bx] = time_ms(
            lambda: ozaki_stencil._launch(u, c, absmax, elog, plan, "f64", bz, by, bx), reps=10)
    bz, by, bx = tiles[0]
    t = {"ms": kernel_ms[tiles[0]],
         "plain_ms": time_ms(lambda: ozaki_stencil.stencil7_ref(u, c, plan), reps=3),
         "library_ms": time_ms(conv, reps=5),
         "wrapper_ms": time_ms(lambda: ozaki_stencil.stencil7(u, c, plan, bz=bz, by=by, bx=bx),
                               reps=10),
         "scales_ms": time_ms(lambda: ozaki_stencil._scales(u, c), reps=10)}
    s_bound, s_by = stencil_bound(u.numel(), plan.r)
    print(f"stencil: {GRID}^3 fused kernel {t['ms']:.3f} ms (tile {tiles[0]}; PERF.md's "
          f"earlier kernel {EARLIER_MS['stencil7 256^3']:.3f} ms on Phase-1 operands), bound "
          f"{s_bound:.4f} ms ({s_by}: 16 r + 8 FP64 operations a point, those the bits need; "
          f"the 23 r + 8 that the plain version and the kernel issue "
          f"{stencil_bound(u.numel(), plan.r, 23.0)[0]:.4f} ms; bytes alone "
          f"{byte_bound(16 * u.numel()):.4f} ms); by tile: "
          + "; ".join(f"{tl} {ms:.3f} ms" for tl, ms in kernel_ms.items()), flush=True)
    print(f"stencil: whole stencil7 call {t['wrapper_ms']:.3f} ms (PERF.md's earlier "
          f"{EARLIER_MS['stencil7 call 256^3']:.3f} ms), of it _scales (aminmax and log2) "
          f"{t['scales_ms']:.3f} ms; stencil7_ref {t['plain_ms']:.3f} ms; F.conv3d f64 "
          f"{t['library_ms']:.3f} ms", flush=True)
    busy, parts = profiled(lambda: ozaki_stencil.stencil7(u, c, plan, bz=bz, by=by, bx=bx), 5)
    print(f"stencil: device time of a whole stencil7 call {busy:.3f} ms (torch.profiler): "
          f"{parts_text(parts)}", flush=True)
    del v_k, want, u

    # --------------------------------------------------------------- jacobi
    f = torch.randn((GRID,) * 3, generator=gen, device=dev, dtype=torch.float64)
    counted = (ozaki_stencil.stencil7, carry_fold.norm_scale, carry_fold.block_tree,
               carry_fold.carry_fold)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_k = jacobi.jacobi_solve(f, omega=2.0 / 3.0, tol=0.0, maxiter=JACOBI_SWEEPS)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches = ozaki_stencil.stencil7.launches
    REDUCE_LAUNCHES["Jacobi"] = {fn.__name__: fn.launches for fn in counted[1:]}
    check(launches == res_k.iters + 1 == JACOBI_SWEEPS + 1,
          f"jacobi: stencil7 launched sweeps + 1 = {launches} times")
    check(all(v == JACOBI_SWEEPS + 2 for v in REDUCE_LAUNCHES["Jacobi"].values()),
          f"jacobi: norm_scale, block_tree and carry_fold launched sweeps + 2 times each "
          f"({REDUCE_LAUNCHES['Jacobi']})")
    h = res_k.history
    check(all(b < a for a, b in zip(h, h[1:])),
          f"jacobi: residual history decreases ({h[0]:.6e} -> {h[-1]:.6e})")
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    res_r = jacobi.jacobi_solve(f, omega=2.0 / 3.0, tol=0.0, maxiter=JACOBI_SWEEPS, mode="ref")
    torch.cuda.synchronize()
    t_r = time.perf_counter() - t0
    check(all(fn.launches == 0 for fn in counted),
          "jacobi: the reference route launched none of the port's kernels")
    check(res_r.history == h and n_diff(res_r.u, res_k.u) == 0,
          f"jacobi: reference route (plain stencil, tree and fold) over {JACOBI_SWEEPS} sweeps "
          f"gives a bitwise-equal history and u")
    # one sweep by parts, as jacobi_solve runs it: the stencil call, the residual,
    # the norm (with its host read), the update
    uu = res_k.u
    cj = jacobi.laplacian_coeffs(device=dev)
    r = f - dispatch.stencil7(uu, cj, plan=plan)
    w = (2.0 / 3.0) / cj[0].item()
    parts = {"stencil7 call": time_ms(lambda: dispatch.stencil7(uu, cj, plan=plan), reps=10),
             "residual f - S u": time_ms(lambda: f - uu, reps=10),
             "compensated_norm": time_ms(lambda: compensated.compensated_norm(r), reps=10),
             "update u + w r": time_ms(lambda: uu + w * r, reps=10)}
    sweep_ms = t_k * 1e3 / (JACOBI_SWEEPS + 1)
    print(f"jacobi: {GRID}^3, omega 2/3, {JACOBI_SWEEPS} sweeps; kernel route "
          f"{sweep_ms:.3f} ms/sweep (PERF.md's earlier {EARLIER_MS['jacobi sweep 256^3']:.3f}), "
          f"reference route {t_r * 1e3 / (JACOBI_SWEEPS + 1):.3f} ms/sweep (host clock, per "
          f"stencil application incl. the norm); a sweep by parts (CUDA events): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in parts.items()), flush=True)
    del r, uu, res_r, res_k, f
    return {"name": "stencil7", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ozaki_stencil.cu",
            "replaces": "src/repro/kernels/ozaki_stencil.py:98",
            "launches": launches, "max_abs_err": err_kp, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": s_bound, "bound_by": s_by,
            "library_ms": t["library_ms"]}


def hpcg_operator(n, dev):
    """HPCG's matrix in Blocked-ELL form, bw = 27, built on the card: row
    ix + n*iy + n*n*iz has 26 on the diagonal and -1 for each neighbour in the
    3 x 3 x 3 box (GenerateProblem_ref.cpp); a slot whose neighbour lies outside
    the grid points at the row itself with value 0.0."""
    import torch

    idx = torch.arange(n ** 3, device=dev)
    iz, iy, ix = idx // (n * n), (idx // n) % n, idx % n
    d = torch.tensor([(sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1)
                      for sx in (-1, 0, 1)], device=dev)
    jz, jy, jx = iz[:, None] + d[:, 0], iy[:, None] + d[:, 1], ix[:, None] + d[:, 2]
    inside = (jz >= 0) & (jz < n) & (jy >= 0) & (jy < n) & (jx >= 0) & (jx < n)
    col = torch.where(inside, jz * n * n + jy * n + jx, idx[:, None]).to(torch.int32)
    centre = (d == 0).all(dim=1)
    one = torch.ones((), dtype=torch.float64, device=dev)
    val = torch.where(inside, torch.where(centre, 26.0 * one, -one), 0.0 * one)
    return val.contiguous(), col.contiguous()


def spmv_phases(dev, gen):
    """The SpMV and sparse-CG phases; returns the spmv_bell entry of the kernels line."""
    import torch

    from repro_torch.core import dispatch
    from repro_torch.hpc import cg
    from repro_torch.kernels import carry_fold, ozaki_spmv, ref

    # ----------------------------------------------------------------- spmv
    a_val, a_col = hpcg_operator(HPCG_N, dev)
    m, bw = a_val.shape
    check(m == HPCG_N ** 3 and bw == 27 and int((a_val != 0).sum()) == (3 * HPCG_N - 2) ** 3,
          f"spmv: HPCG operator {m} x {bw}, {int((a_val != 0).sum())} nonzeros")
    plan = dispatch.get_plan(bw, margin_bits=4)
    check(plan.r == 15, f"spmv: plan r = {plan.r}")
    x = torch.randn(m, generator=gen, device=dev, dtype=torch.float64)
    y_k = dispatch.spmv(a_val, a_col, x)
    y_r = dispatch.spmv(a_val, a_col, x, mode="ref")
    check(n_diff(y_k, y_r) == 0, f"spmv: kernel vs reference route, {n_diff(y_k, y_r)} "
          f"differing elements")
    want = ref.spmv_bell_f64(a_val, a_col, x)
    denom = a_val.abs().sum(dim=1) * x.abs().max()
    err = float(((y_k - want).abs() / denom).max()) / U
    check(err <= 16, f"spmv: error vs native FP64 {err:.3f} u relative to sum|a|*max|x| "
          f"(<= 16 u)")
    del y_r
    br = int(dispatch.get_tuning("spmv_bell", a_val.shape)["br"])
    rows = (br, 64)
    ops_hpcg = ozaki_spmv._decompose_operands(a_val, a_col, x, plan)[:5]
    rm, rn, rbw = 100_003, 77_777, 13
    rv = torch.randn((rm, rbw), generator=gen, device=dev, dtype=torch.float64)
    rv *= torch.exp(torch.empty((rm, 1), device=dev, dtype=torch.float64).uniform_(
        -8, 8, generator=gen))
    rv[torch.rand((rm, rbw), generator=gen, device=dev) < 0.2] = 0.0
    rcol = torch.randint(0, rn, (rm, rbw), generator=gen, device=dev, dtype=torch.int32)
    rx = torch.randn(rn, generator=gen, device=dev, dtype=torch.float64)
    rplan = dispatch.get_plan(rbw, margin_bits=4)
    ops_ragged = ozaki_spmv._decompose_operands(rv, rcol, rx, rplan)[:5]
    err_kp = 0.0
    for name, opnds, p in (("HPCG 104^3", ops_hpcg, plan),
                           (f"{rm}x{rn}, bw {rbw}", ops_ragged, rplan)):
        for rep in ("f64", "digits", "ds"):
            for b in rows:
                k_out = ozaki_spmv._launch(*opnds, p, rep, b)
                p_out = ozaki_spmv._contract_ref(*opnds, p, rep)
                d = n_diff(k_out, p_out)
                if p is plan and rep == "f64":
                    err_kp = max(err_kp, float((k_out - p_out).abs().max()))
                check(d == 0, f"spmv: kernel vs plain version at {name}, {rep}, {b} rows a "
                      f"block, {d} differing elements")
    nz = a_val != 0
    crow = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(nz.sum(dim=1), 0)
    csr = torch.sparse_csr_tensor(crow, a_col[nz].to(torch.int64), a_val[nz], (m, m))
    lib_err = float(((csr @ x - want).abs() / denom).max()) / U
    check(lib_err <= 16, f"spmv: torch.sparse CSR computes the same function ({lib_err:.3f} u)")
    ragged_ms = time_ms(lambda: ozaki_spmv._launch(*ops_ragged, rplan, "f64", br), reps=10)
    t = {"ms": time_ms(lambda: ozaki_spmv._launch(*ops_hpcg, plan, "f64", br), reps=10),
         "plain_ms": time_ms(lambda: ozaki_spmv._contract_ref(*ops_hpcg, plan, "f64"), reps=3),
         "library_ms": time_ms(lambda: csr @ x, reps=10),
         "wrapper_ms": time_ms(lambda: ozaki_spmv.spmv_bell(a_val, a_col, x, plan, br=br), reps=5),
         "wrapper_ref_ms": time_ms(lambda: ozaki_spmv.spmv_bell_ref(a_val, a_col, x, plan),
                                   reps=3)}
    nbytes = 12 * a_val.numel() + 8 * x.numel() + 8 * m
    print(f"spmv: HPCG {HPCG_N}^3 kernel {t['ms']:.3f} ms ({br} rows a block), plain "
          f"{t['plain_ms']:.3f} ms, torch.sparse CSR f64 {t['library_ms']:.3f} ms, bound "
          f"{byte_bound(nbytes):.4f} ms ({nbytes} B); with Phase 1 and the epilogue: "
          f"spmv_bell {t['wrapper_ms']:.3f} ms, spmv_bell_ref {t['wrapper_ref_ms']:.3f} ms",
          flush=True)
    earlier = EARLIER_MS["spmv_bell HPCG 104^3"]
    print(f"spmv: spmv_bell at HPCG {HPCG_N}^3 {t['ms']:.3f} ms against PERF.md's earlier "
          f"{earlier:.3f} ms ({earlier / t['ms']:.2f}x); at {rm}x{rn}, bw {rbw}: "
          f"{ragged_ms:.3f} ms", flush=True)
    busy, parts = profiled(lambda: ozaki_spmv._launch(*ops_hpcg, plan, "f64", br), 5)
    print(f"spmv: device time of spmv_bell's _launch at HPCG {HPCG_N}^3 {busy:.3f} ms "
          f"(torch.profiler): {parts_text(parts)} (torch's: the column-bounds check)",
          flush=True)
    del ops_hpcg, ops_ragged, csr, y_k, want

    # -------------------------------------------------------------- cg_bell
    b = a_val.sum(dim=1)                      # A 1, exact: small integers
    ozaki_spmv.spmv_bell.launches = 0
    reduce_counts(carry_fold, reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_k = cg.cg_solve_bell(a_val, a_col, b, tol=1e-10, maxiter=2000)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches = ozaki_spmv.spmv_bell.launches
    REDUCE_LAUNCHES["sparse CG"] = reduce_counts(carry_fold)
    check(launches == res_k.iters + 1,
          f"cg_bell: spmv_bell launched iterations + 1 = {launches} times")
    check(REDUCE_LAUNCHES["sparse CG"] == cg_reductions(res_k.iters),
          f"cg_bell: a norm (norm_scale once) and 2 * iterations + 1 dots, each one "
          f"block_tree and one carry_fold ({REDUCE_LAUNCHES['sparse CG']})")
    rel = float(torch.linalg.vector_norm(ref.spmv_bell_f64(a_val, a_col, res_k.x) - b)
                / torch.linalg.vector_norm(b))
    xerr = float((res_k.x - 1.0).abs().max())
    check(res_k.converged and rel <= 1e-9 and xerr <= 1e-6,
          f"cg_bell: converged in {res_k.iters} iterations, ||Ax - b||/||b|| = {rel:.3e}, "
          f"||x - 1||inf = {xerr:.3e}")
    t0 = time.perf_counter()
    res_r = cg.cg_solve_bell(a_val, a_col, b, tol=1e-10, maxiter=CG_REF_ITERS, mode="ref")
    torch.cuda.synchronize()
    t_r = time.perf_counter() - t0
    n_cmp = min(CG_REF_ITERS, res_k.iters) + 1
    check(res_r.history[:n_cmp] == res_k.history[:n_cmp],
          f"cg_bell: reference route's first {n_cmp - 1} iterations give a bitwise-equal "
          f"history")
    print(f"cg_bell: HPCG {HPCG_N}^3, {res_k.iters} iterations; kernel route "
          f"{t_k * 1e3 / max(res_k.iters, 1):.3f} ms/iteration, reference route "
          f"{t_r * 1e3 / max(res_r.iters, 1):.3f} ms/iteration (host clock, per iteration "
          f"incl. the first matvec)", flush=True)
    from torch.profiler import ProfilerActivity, profile

    steps = 10
    window = {}
    for n in (0, steps):               # the set-up alone, then the set-up and `steps`
        for traced in (False, True):
            torch.cuda.synchronize()
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                a.record()
                cg.cg_solve_bell(a_val, a_col, b, tol=0.0, maxiter=n)
                z.record()
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
            if traced:
                busy, parts = device_busy(prof, 1)
                window[n] = (busy, dict(parts), host_ms, a.elapsed_time(z))
            else:
                window[n, "untraced"] = host_ms
    (b0, p0, h0, e0), (b1, p1, h1, e1) = window[0], window[steps]
    busy, host, stream = (b1 - b0) / steps, (h1 - h0) / steps, (e1 - e0) / steps
    untraced = (window[steps, "untraced"] - window[0, "untraced"]) / steps
    parts = sorted(((k, (v - p0.get(k, 0.0)) / steps) for k, v in p1.items()),
                   key=lambda kv: -kv[1])
    print(f"cg_bell: per iteration, from a {steps}-iteration solve less a 0-iteration one, "
          f"both under torch.profiler: device busy {busy:.3f} ms, host clock {host:.3f} ms, "
          f"CUDA events {stream:.3f} ms; idle share {1 - busy / host:.1%} of the host time, "
          f"{1 - busy / stream:.1%} of the stream time; busy time {parts_text(parts)}; "
          f"host clock of the same pair without the profiler {untraced:.3f} ms",
          flush=True)
    return {"name": "spmv_bell", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ozaki_spmv.cu",
            "replaces": "src/repro/kernels/ozaki_spmv.py:121",
            "launches": launches, "max_abs_err": err_kp, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": byte_bound(nbytes), "bound_by": "bytes",
            "library_ms": t["library_ms"]}


def dadd_chain(x, n, dev):
    """n dependent float64 additions of x in one CUDA thread (csrc/dadd_chain.cu),
    a (1,) tensor: a measure of the latency that bounds the fold's chains."""
    import torch

    from repro_torch.kernels import _build

    out = torch.empty(1, dtype=torch.float64, device=dev)
    err = _build.library("dadd_chain").dadd_chain(
        out.device.index, float(x), int(n), out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dadd_chain: CUDA launch failed with error {err}")
    return out


def reduce_phase(dev, gen):
    """The compensated reductions' phase; returns the norm_scale, block_tree and
    carry_fold entries of the kernels line."""
    import torch

    from repro_torch.core import compensated, dispatch
    from repro_torch.kernels import carry_fold as cf

    def operand(n, lead=(), dtype=torch.float64):
        return torch.randn(lead + (n,), generator=gen, device=dev, dtype=dtype)

    def same(a, b):
        nan = torch.isnan(a) | torch.isnan(b)
        return n_diff(a, b) + int(((torch.signbit(a) != torch.signbit(b)) & ~nan).sum())

    lengths = {"256^3 norm": GRID ** 3, "HPCG 104^3 dot": HPCG_N ** 3, f"n = {N} dot": N}
    cases = {name: (operand(n), operand(n)) for name, n in lengths.items()}
    cases["37 x 45 lanes of 9000"] = (operand(9000, (37, 45)), operand(9000, (37, 45)))
    cases["float32, 3 lanes of 70001"] = (operand(70001, (3,), torch.float32),
                                          operand(70001, (3,), torch.float32))
    x, y = (t.clone() for t in cases["37 x 45 lanes of 9000"])
    x[0, 0, 1], x[1, 1, -1], x[:, 2, 2], x[3, 3] = float("inf"), float("nan"), -0.0, 0.0
    x[4, 4] *= 1e-310                                   # denormals
    cases["inf, NaN, -0, zero lanes, denormals"] = (x, y)
    for name, (x, y) in cases.items():
        for what, fn in (("neumaier_sum", lambda m: compensated.neumaier_sum(x, mode=m)),
                         ("compensated_dot", lambda m: compensated.compensated_dot(x, y, mode=m)),
                         ("compensated_norm",
                          lambda m: compensated.compensated_norm(x, axis=-1, mode=m))):
            d = same(fn("kernel"), fn("ref"))
            check(d == 0, f"reduce: {what} kernel route vs plain route at {name} "
                  f"({tuple(x.shape)}), {d} differing elements or signs")
    x, y = cases["inf, NaN, -0, zero lanes, denormals"]
    for block in (4096, 10000):                         # pieces of 512, joined in order
        for what, fn in (("neumaier_sum", lambda m: compensated.neumaier_sum(x, block=block,
                                                                             mode=m)),
                         ("compensated_dot", lambda m: compensated.compensated_dot(
                             x, y, block=block, mode=m))):
            d = same(fn("kernel"), fn("ref"))
            check(d == 0, f"reduce: {what} kernel route vs plain route at block {block} "
                  f"({tuple(x.shape)}, special values), {d} differing elements or signs")
    x3 = cases["256^3 norm"][0].reshape(1, -1)
    xh, yh = (t.reshape(1, -1) for t in cases["HPCG 104^3 dot"])
    block3, blockh = dispatch.reduce_block(GRID ** 3), dispatch.reduce_block(HPCG_N ** 3)
    bits, flags = cf.norm_scale(x3)
    wb, wf = cf.norm_scale_ref(x3)
    check(torch.equal(bits, wb) and torch.equal(flags, wf),
          "reduce: norm_scale kernel vs plain version at the 256^3 norm")
    err = {}
    for name, args in (("256^3 norm", (x3, None, block3, bits)),
                       ("HPCG 104^3 dot", (xh, yh, blockh, None))):
        got, want = cf.block_tree(*args), cf.block_tree_ref(*args)
        d = sum(same(g, w) for g, w in zip(got, want))
        err[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(d == 0, f"reduce: block_tree kernel vs plain version at {name}, {d} differing "
              f"partials")
    sb, cb = cf.block_tree(x3, None, block3, bits)
    fold_k, fold_p = cf._fold(sb, cb), cf.carry_fold_ref(sb.t(), cb.t())
    check(same(fold_k, fold_p) == 0, f"reduce: carry_fold kernel vs plain version at the "
          f"{sb.shape[1]} partials of the 256^3 norm")
    nb = sb.shape[1]
    n3 = x3.shape[1]
    t = {"fold": time_ms(lambda: cf._fold(sb, cb), reps=20),
         "fold_plain": time_ms(lambda: cf.carry_fold_ref(sb.t(), cb.t()), reps=5),
         "tree": time_ms(lambda: cf.block_tree(x3, None, block3, bits), reps=20),
         "tree_plain": time_ms(lambda: cf.block_tree_ref(x3, None, block3, bits), reps=5),
         "scale": time_ms(lambda: cf.norm_scale(x3), reps=20),
         "scale_plain": time_ms(lambda: cf.norm_scale_ref(x3), reps=5),
         "norm": time_ms(lambda: compensated.compensated_norm(x3), reps=20),
         "norm_ref": time_ms(lambda: compensated.compensated_norm(x3, mode="ref"), reps=5),
         "dot": time_ms(lambda: compensated.compensated_dot(xh, yh), reps=20),
         "dot_ref": time_ms(lambda: compensated.compensated_dot(xh, yh, mode="ref"), reps=5),
         "vector_norm": time_ms(lambda: torch.linalg.vector_norm(x3), reps=20)}
    busy, parts = profiled(lambda: compensated.compensated_norm(x3), 10)
    # the chain bound: the latency of a dependent float64 addition, from the
    # difference of two chain lengths (launch cost cancels)
    chain = {k: time_ms(lambda k=k: dadd_chain(1.0, k * nb, dev), reps=5) for k in (1, 17)}
    dadd_ns = (chain[17] - chain[1]) / (16 * nb) * 1e6
    chain_ms = nb * dadd_ns * 1e-6
    print(f"reduce: compensated_norm at {GRID}^3 {t['norm']:.3f} ms (PERF.md's earlier "
          f"{EARLIER_MS['compensated_norm 256^3']:.3f}), plain route {t['norm_ref']:.3f} ms, "
          f"torch.linalg.vector_norm f64 {t['vector_norm']:.3f} ms (for scale only: not "
          f"compensated); device time by kernel {busy:.3f} ms (torch.profiler): "
          f"{parts_text(parts)}", flush=True)
    print(f"reduce: at the 256^3 norm: norm_scale {t['scale']:.4f} ms (plain "
          f"{t['scale_plain']:.3f}), block_tree {t['tree']:.4f} ms (plain "
          f"{t['tree_plain']:.3f}), carry_fold {t['fold']:.4f} ms over {nb} partials (PERF.md's "
          f"earlier {EARLIER_MS['carry_fold 256^3 norm']:.3f}; plain, host numpy with the copy, "
          f"{t['fold_plain']:.3f}); a dependent float64 add {dadd_ns:.3f} ns, so the chain bound "
          f"of {nb} steps is {chain_ms:.4f} ms; compensated_dot at {HPCG_N}^3 {t['dot']:.3f} ms "
          f"(plain route {t['dot_ref']:.3f}); launches on the main paths {REDUCE_LAUNCHES}",
          flush=True)

    def launches(name):
        return sum(v[name] for v in REDUCE_LAUNCHES.values())

    def entry(name, ms, plain_ms, nbytes, nops, e, chain_bound=0.0):
        t_bytes, t_ops = byte_bound(nbytes), nops / FP64_PLAIN_OPS_PER_S * 1e3
        by = max((t_bytes, "bytes"), (t_ops, "operations"), (chain_bound, "dependent chain"))
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/carry_fold.cu",
                "replaces": {"norm_scale": "src/repro/core/compensated.py:268",
                             "block_tree": "src/repro/core/compensated.py:96",
                             "carry_fold": "src/repro/core/compensated.py:111"}[name],
                "launches": launches(name), "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": by[0], "bound_by": by[1], "library_ms": None}

    # bytes: the operand read once and the partials written once; operations per
    # element: the scale (1), two_prod (17) and one combine of the tree (8), none
    # of them FMAs; the fold: nb steps of its dependent chain
    out = [entry("norm_scale", t["scale"], t["scale_plain"], 8 * n3 + 12, n3, 0.0),
           entry("block_tree", t["tree"], t["tree_plain"], 8 * n3 + 16 * nb + 8, 26 * n3,
                 err["256^3 norm"]),
           entry("carry_fold", t["fold"], t["fold_plain"], 16 * nb + 8 + 12, 8 * nb,
                 float((fold_k - fold_p.to(dev)).abs().max()), chain_ms)]
    del cases, x3, xh, yh, sb, cb
    return out


def native_attention(q, k, v, mask, softcap):
    """Softmax attention with materialised scores in native FP64 (the oracle)."""
    import torch

    s = q @ k.transpose(-1, -2) / (q.shape[-1] ** 0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    return torch.softmax(torch.where(mask != 0, s, -1e30), dim=-1) @ v


def attention_phase(dev, gen):
    """The attention phase; returns the attention_fused entry of the kernels line
    (launches filled in by the serve phase)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import dispatch
    from repro_torch.kernels import ozaki_attention as oa

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)

    def tril(b, s, t):
        return torch.tril(torch.ones((s, t), dtype=torch.int8, device=dev)).expand(b, s, t)

    i = torch.arange(512, device=dev)
    window = ((i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < 64)).to(torch.int8)

    def ring(t, pos, rows=64):                            # 2 slots x 32 heads at `pos`
        return (torch.arange(t, device=dev) <= pos).to(torch.int8)[None, None].expand(rows, 1, t)

    def decode(t):
        return [randn(64, 1, ATTN_D), randn(64, t, ATTN_D), randn(64, t, ATTN_D)]

    tiny = [randn(4, 64, ATTN_D), randn(4, 64, ATTN_D), randn(4, 64, ATTN_D)]
    tiny[0][:, 3] *= 1e-300
    tiny[2][:, :, 5] *= 1e-300
    cases = [
        ("causal prefill 32 x 512 x 512", [randn(32, 512, ATTN_D) for _ in range(3)],
         tril(32, 512, 512), 0.0),
        ("ragged 6 x 37 x 301, D 80", [randn(6, 37, 80), randn(6, 301, 80), randn(6, 301, 80)],
         (torch.rand((6, 37, 301), generator=gen, device=dev) < 0.8).to(torch.int8), 0.0),
        ("softcap 30, 8 x 256 x 256", [randn(8, 256, ATTN_D) for _ in range(3)],
         tril(8, 256, 256), 30.0),
        ("window 64, 8 x 512 x 512", [randn(8, 512, ATTN_D) for _ in range(3)],
         window.expand(8, 512, 512), 0.0),
        (f"decode 64 x 1 x {SERVE_CTX}, ring mask", decode(SERVE_CTX), ring(SERVE_CTX, 20),
         0.0),
        (f"decode 64 x 1 x {LONG_CTX}, ring mask", decode(LONG_CTX),
         ring(LONG_CTX, LONG_CTX - 2), 0.0),
        ("q rows and v columns at 1e-300", tiny, torch.ones((4, 64, 64), dtype=torch.int8,
                                                            device=dev), 0.0),
        (f"decode 16 x 1 x {LONG_CTX}, D {WIDE_D}, ring mask",       # one gemma-7b slot
         [randn(16, 1, WIDE_D), randn(16, LONG_CTX, WIDE_D), randn(16, LONG_CTX, WIDE_D)],
         ring(LONG_CTX, LONG_CTX - 2, rows=16), 0.0),
        (f"encoder 16 x {ENC_FRAMES} x {ENC_FRAMES}, D {ENC_D}, no mask",   # whisper's encoder
         [randn(16, ENC_FRAMES, ENC_D) for _ in range(3)],
         torch.ones((16, ENC_FRAMES, ENC_FRAMES), dtype=torch.int8, device=dev), 0.0),
    ]
    timed = {}
    err_kp = 0.0
    for name, (q, k, v), mask, softcap in cases:
        B, S, D = q.shape
        T = k.shape[1]
        tune = dispatch.get_tuning("attention", (B, S, D, T))
        bq = min(int(tune["bq"]), -(-S // 8) * 8)
        bkv = min(int(tune["bkv"]), -(-T // 8) * 8)
        pq, pp = dispatch.get_plan(D), dispatch.get_plan(bkv)
        check(pq.r == pp.r == 15, f"attention: {name}, plans r = {pq.r}, {pp.r}")
        y_k = dispatch.attention(q, k, v, mask=mask, softcap=softcap)
        y_r = dispatch.attention(q, k, v, mask=mask, softcap=softcap, mode="ref")
        check(n_diff(y_k, y_r) == 0, f"attention: {name}, kernel vs reference route, "
              f"{n_diff(y_k, y_r)} of {y_k.numel()} elements differ")
        plain = oa.attention_ref(q, k, v, mask, pq, pp, softcap, bkv)
        ops = oa._decompose(q, k, v, pq, pp, bkv)
        for b in sorted({bq, 8} if bq > 8 else {bq, 1}, reverse=True):
            got = oa.attention_fused(q, k, v, mask, pq, pp, softcap, bq=b, bkv=bkv)
            d = n_diff(got, plain)
            if name.startswith("causal"):
                err_kp = max(err_kp, float((got - plain).abs().max()))
            path = oa.choose_path(S)
            check(d == 0, f"attention: {name}, kernel vs plain version at bq {b} "
                  f"({path} path), {d} of {got.numel()} elements differ")
            for other in (oa.PATHS if S == 1 else ()):
                if other != path:
                    d = n_diff(oa._launch(*ops, mask, pq, pp, softcap, b, bkv, path=other),
                               plain)
                    check(d == 0, f"attention: {name}, kernel vs plain version at bq {b} "
                          f"({other} path, forced), {d} of {got.numel()} elements differ")
            del got
        del ops
        want = native_attention(q, k, v, mask, softcap)
        err = float(((y_k - want).abs().amax(dim=1) / v.abs().amax(dim=1)).max())
        check(err <= 1e-12, f"attention: {name} vs native FP64 softmax attention, {err:.3e} "
              f"<= 1e-12 * max|v| per column")
        if name.startswith("q rows"):
            col = y_k[:, :, 5].abs()
            check(bool((col > 0).all()), f"attention: the 1e-300 columns come out at "
                  f"{float(col.min()):.3e} .. {float(col.max()):.3e}")
        if name.startswith(("causal", "decode", "ragged", "encoder")):   # the timed shapes
            timed[name] = (q, k, v, mask, pq, pp, bq, bkv, want)
        del y_k, y_r, plain, want
    out = {}
    for name, (q, k, v, mask, pq, pp, bq, bkv, want) in timed.items():
        B, S, D = q.shape
        T = k.shape[1]
        ops = oa._decompose(q, k, v, pq, pp, bkv)
        if S == T and name.startswith("causal"):
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
        elif name.startswith("encoder"):
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v)
        else:
            keep = mask != 0
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        lib_err = float(((sdpa() - want).abs().amax(dim=1) / v.abs().amax(dim=1)).max())
        check(lib_err <= 1e-12, f"attention: F.scaled_dot_product_attention computes the same "
              f"function at {name} ({lib_err:.3e})")
        path = oa.choose_path(S)
        others = {p: time_ms(lambda: oa._launch(*ops, mask, pq, pp, 0.0, bq, bkv, path=p),
                             reps=5)
                  for p in (oa.PATHS if S == 1 else ()) if p != path}
        t = {"ms": time_ms(lambda: oa._launch(*ops, mask, pq, pp, 0.0, bq, bkv), reps=10),
             "plain_ms": time_ms(lambda: oa.attention_ref(q, k, v, mask, pq, pp, 0.0, bkv),
                                 reps=3),
             "library_ms": time_ms(sdpa, reps=10),
             "wrapper_ms": time_ms(lambda: oa.attention_fused(q, k, v, mask, pq, pp, bq=bq,
                                                              bkv=bkv), reps=5)}
        nbytes = 8 * B * (S * D + 2 * T * D) + 8 * B * S * D + S * T
        t_bytes, t_ops = byte_bound(nbytes), 4.0 * B * S * T * D * pq.r / INT8_OPS_PER_S * 1e3
        t["bound_ms"], t["bound_by"] = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                                            else "operations")
        print(f"attention: {name}, D {D}, r {pq.r}: kernel {t['ms']:.3f} ms (bq {bq}), plain "
              f"{t['plain_ms']:.3f} ms, F.scaled_dot_product_attention f64 "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
              f"with Phase 1: attention_fused {t['wrapper_ms']:.3f} ms", flush=True)
        for p in (path,) + tuple(others):
            busy, parts = profiled(lambda: oa._launch(*ops, mask, pq, pp, 0.0, bq, bkv, path=p),
                                   3)
            print(f"attention: {name}: {p} path device time {busy:.3f} ms (torch.profiler): "
                  f"{parts_text(parts)}", flush=True)
        earlier = EARLIER_MS.get("attention_fused " + name.split(",")[0])
        print(f"attention: {name}: the {path} path {t['ms']:.3f} ms"
              + (f" against PERF.md's earlier {earlier:.3f} ms ({earlier / t['ms']:.2f}x)"
                 if earlier else "")
              + "".join(f"; here the {p} path {ms:.3f} ms" for p, ms in others.items()),
              flush=True)
        out[name] = t
    del timed, cases
    KERNEL_MS["attention decode"] = out[f"decode 64 x 1 x {LONG_CTX}, ring mask"]["ms"]
    t = out[f"encoder 16 x {ENC_FRAMES} x {ENC_FRAMES}, D {ENC_D}, no mask"]
    print(f"attention: {smi_line()}; whisper's encoder shape: kernel {t['ms']:.3f} ms, plain "
          f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
          f"F.scaled_dot_product_attention f64 {t['library_ms']:.3f} ms", flush=True)
    t = out["causal prefill 32 x 512 x 512"]
    return {"name": "attention_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ozaki_attention.cu",
            "replaces": "src/repro/kernels/ozaki_attention.py:201", "launches": None,
            "max_abs_err": err_kp, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def serve_phase(dev):
    """The serving main path; returns the launch counts it read."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import dispatch
    from repro_torch.kernels import carry_fold, ozaki_attention, ozaki_gemm, ozaki_gemv
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine

    cfg = registry.get_config("yi-6b", policy_name="ozaki2_int8", compute_dtype="float32",
                              num_layers=SERVE_LAYERS)
    L = cfg.num_layers
    print(f"serve: {cfg.name} d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {L} of "
          f"{registry.get_config('yi-6b').num_layers} layers (depth cut for the script's time "
          f"limit); policy {cfg.policy_name}, compute {cfg.compute_dtype}", flush=True)
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve: {n_params} weights made on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, 16) for _ in range(3)]
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 512)), device=dev)

    def timed_steps(eng):
        """Host-clock times of the engine's decode steps."""
        log, real_call = [], eng._decode_call

        def call(toks, pos):
            t = time.perf_counter()
            out = real_call(toks, pos)
            torch.cuda.synchronize()
            log.append(time.perf_counter() - t)
            return out

        eng._decode_call = call
        return log

    engine = ServeEngine(model, batch_slots=2, max_seq=SERVE_CTX)
    steps = timed_steps(engine)
    batcher = ContinuousBatcher(engine)
    # a second engine whose caches hold LONG_CTX - LONG_STEPS positions already:
    # seeded keys and values, what a prompt of that length would leave (its
    # contents do not change the work of a step)
    long_engine = ServeEngine(model, batch_slots=2, max_seq=LONG_CTX)
    cache_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for layer_cache in long_engine.cache:
        for t in layer_cache["kv"].values():
            t.normal_(generator=cache_gen)
    long_steps = timed_steps(long_engine)
    for uid, p in enumerate(prompts):
        batcher.submit(Request(uid=uid, prompt=p, max_new_tokens=8))
    counts = (ozaki_gemm.gemm_hilo, ozaki_gemv.gemv_hilo, ozaki_attention.attention_fused,
              carry_fold.carry_fold)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in counts:
        k.launches = 0
    t0 = time.perf_counter()
    # dispatch.attention and dispatch.matmul (the weight products with their
    # Phase 1) timed with CUDA events inside the decode steps
    with timed_calls({"attention": (dispatch, "attention"),
                      "matmul": (dispatch, "matmul")}) as events:
        done = batcher.run_to_completion()
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        n_short = {k: len(v) for k, v in events.items()}
        toks = rng.integers(0, cfg.vocab_size, 2)
        for pos in range(LONG_CTX - LONG_STEPS, LONG_CTX):
            toks = long_engine.decode_step_all(toks, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_k, _ = model.apply({"tokens": tokens})
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counts}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    calls = len(steps) + len(long_steps) + 1
    check(launches["attention_fused"] == L * calls,
          f"serve: attention_fused launched layers x calls = {L} x {calls} = "
          f"{launches['attention_fused']} times")
    check(launches["gemm_hilo"] == (7 * L + 1) * calls,
          f"serve: gemm_hilo launched (7 x layers + 1) x calls = {7 * L + 1} x {calls} = "
          f"{launches['gemm_hilo']} times")
    check(launches["gemv_hilo"] == 0 and launches["carry_fold"] == 0,
          f"serve: no gemv_hilo or carry_fold launch ({launches})")
    ntok = sum(len(r.generated) for r in done)
    check(len(done) == 3 and ntok == 24, f"serve: 3 requests served through 2 slots, {ntok} "
          f"tokens")
    shape = tuple(logits_k.shape)
    check(bool(torch.isfinite(logits_k).all()) and shape == (1, 512, cfg.vocab_size),
          f"serve: forward logits finite, shape {shape}")
    check(len(events["attention"]) == L * (len(steps) + LONG_STEPS) and
          len(events["matmul"]) == (7 * L + 1) * (len(steps) + LONG_STEPS) and
          len(long_steps) == LONG_STEPS,
          f"serve: per decode step, one timed attention call per layer and one timed matmul "
          f"per weight, over {len(steps)} + {len(long_steps)} steps")

    def step_parts(times, evs):
        """Mean host-clock ms of the steps, and of their timed calls (CUDA events)."""
        n = len(times)
        return 1e3 * sum(times) / n, {k: sum(a.elapsed_time(b) for a, b in v) / n
                                      for k, v in evs.items()}

    step_ms, part = step_parts(steps, {k: v[:n_short[k]] for k, v in events.items()})
    long_ms, long_part = step_parts(long_steps, {k: v[n_short[k]:] for k, v in events.items()})
    rest = step_ms - part["matmul"] - part["attention"]
    # gemm_hilo alone at a decode step's shapes: the 2 slots padded to 128 rows
    # against each weight of a layer (x layers) and the LM head
    layer = model.layers[0].tree()
    weights = [layer["mixer"][n]["w"] for n in ("wq", "wk", "wv", "wo")] + \
              [layer["mlp"][n]["w"] for n in ("wi_gate", "wi_up", "wo")]
    part["gemm_hilo"] = L * sum(gemm_alone_ms(w) for w in weights) + \
        gemm_alone_ms(model.lm_head.w)
    print(f"serve: {len(steps)} decode steps ({sum(len(p) for p in prompts)} prompt steps + "
          f"batched steps) at {step_ms:.3f} ms each (mean, host clock); {ntok} tokens in "
          f"{t_serve:.3f} s = {ntok / t_serve:.3f} tokens/s; forward of 512 tokens "
          f"{1e3 * t_fwd:.1f} ms; peak memory {peak:.3f} GiB; launches {launches}", flush=True)
    print(f"serve: a decode step over {L} layers (CUDA events, mean): weight products "
          f"(dispatch.matmul) {part['matmul']:.3f} ms, of it the gemm_hilo kernel "
          f"{part['gemm_hilo']:.3f} ms (timed alone at the step's shapes) and Phase 1, "
          f"padding and the unscale {part['matmul'] - part['gemm_hilo']:.3f} ms; "
          f"dispatch.attention "
          f"{part['attention']:.3f} ms ({100 * part['attention'] / step_ms:.2f}% of the step); "
          f"the rest {rest:.3f} ms", flush=True)
    print(f"serve: {LONG_STEPS} decode steps against a {LONG_CTX}-slot cache at positions "
          f"{LONG_CTX - LONG_STEPS}..{LONG_CTX - 1}, {long_ms:.3f} ms each (mean, host clock; {[round(1e3 * t, 3) for t in long_steps]}): "
          f"weight products {long_part['matmul']:.3f} ms; dispatch.attention "
          f"{long_part['attention']:.3f} ms ({100 * long_part['attention'] / long_ms:.2f}% of "
          f"the step); the rest {long_ms - long_part['matmul'] - long_part['attention']:.3f} ms",
          flush=True)
    for r in sorted(done, key=lambda r: r.uid):
        print(f"serve: request {r.uid} -> {r.generated}", flush=True)

    # the reference route, at all L layers
    t0 = time.perf_counter()
    with dispatch.mode_scope("ref"):
        logits_r, _ = model.apply({"tokens": tokens})
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    check(n_diff(logits_k, logits_r) == 0,
          f"serve: kernel vs reference route at {L} of {L} layers, forward logits, "
          f"{n_diff(logits_k, logits_r)} of {logits_k.numel()} elements differ (reference "
          f"forward {1e3 * t_ref:.1f} ms)")
    del logits_r
    diffs = []
    caches = {m: model.init_cache(2, 32) for m in ("auto", "ref")}
    for t in range(4):
        toks = torch.as_tensor(prompts[0][t:t + 1].repeat(2)[:, None], device=dev)
        outs = {}
        for m in caches:
            with dispatch.mode_scope(m):
                outs[m], caches[m] = model.decode_step(caches[m], toks, t)
        diffs.append(n_diff(outs["auto"], outs["ref"]))
    check(diffs == [0] * 4, f"serve: kernel vs reference route at {L} of {L} layers, first 4 "
          f"decode steps, differing elements {diffs}")
    del caches

    # the fp64 policy on the same weights
    model64 = Model(dataclasses.replace(cfg, policy_name="fp64")).load(dict(model.state_dict()))
    logits_64, _ = model64.apply({"tokens": tokens})
    err = float((logits_k - logits_64).abs().max())
    ok = bool(torch.allclose(logits_k, logits_64, rtol=1e-3, atol=1e-4))
    check(ok, f"serve: emulated logits within rtol 1e-3, atol 1e-4 of the fp64 policy's "
          f"(max |diff| {err:.3e})")
    return launches


def spectral_case(name, run, oracle, bound, counts, reps):
    """One spectral main path: ``run(mode)`` with the seam kernels' counts set to
    0 just before the kernel route and read just after; the reference route
    bitwise; the error against ``oracle`` (torch.fft, complex128) in units of
    ``bound`` times its largest magnitude; times (CUDA events) of the kernel
    route and of the oracle.  Returns (launches, kernel ms)."""
    import torch

    for k in counts:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(None)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counts}
    want = run("ref")
    d = n_diff(got, want)
    check(d == 0, f"spectral: {name} kernel vs reference route, {d} of {got.numel()} "
          f"elements differ")
    del want
    exact = oracle()
    err = float((got - exact).abs().max()) / (bound * float(exact.abs().max()))
    # both transforms lie within one bound of the exact one (tests/test_torch_spectral.py)
    check(err <= 2.0, f"spectral: {name} error vs torch.fft complex128 {err:.4f} x "
          f"(bound {bound:.3e} x max|X|) <= 2")
    del got, exact
    ms = time_ms(lambda: run(None), reps=reps)
    lib_ms = time_ms(oracle, reps=5)
    print(f"spectral: {name}: kernel route {ms:.3f} ms (first call {1e3 * first:.1f} ms), "
          f"torch.fft {lib_ms:.3f} ms; launches {launches}", flush=True)
    return launches, ms


def spectral_phase(dev, gen):
    """The spectral dwarf's main paths; returns their gemm_hilo and gemv_hilo launches."""
    import torch

    from repro_torch import spectral
    from repro_torch.hpc import jacobi, poisson
    from repro_torch.kernels import carry_fold, ozaki_gemm, ozaki_gemv

    counts = (ozaki_gemm.gemm_hilo, ozaki_gemv.gemv_hilo)
    total = {"gemm_hilo": 0, "gemv_hilo": 0}

    def crandn(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev, dtype=torch.float64),
                             torch.randn(shape, generator=gen, device=dev, dtype=torch.float64))

    def add(launches, want, what):
        check(launches == want, f"spectral: {what} launched {want} ({launches})")
        for k, v in launches.items():
            total[k] += v

    x = crandn(1 << 20)
    got, _ = spectral_case(
        f"fft n = 2^20 (Bailey twice: {spectral.choose_factors(1 << 20)}, then 32 x 32)",
        lambda m: spectral.fft(x, mode=m), lambda: torch.fft.fft(x),
        spectral.dft_error_bound(1 << 20), counts, reps=5)
    add(got, {"gemm_hilo": 4, "gemv_hilo": 0}, "fft 2^20: two passes of two 64 x 64 GEMMs")
    x = crandn(8, 4093)
    got, _ = spectral_case(
        "fft of 8 x 4093 (prime: one 8186 x 8186 by 8186 x 8 dense GEMM)",
        lambda m: spectral.fft(x, mode=m), lambda: torch.fft.fft(x),
        spectral.dft_error_bound(4093), counts, reps=2)
    add(got, {"gemm_hilo": 0, "gemv_hilo": 1}, "fft 8 x 4093: one gemv_hilo")
    x = crandn(GRID, GRID, GRID)
    b256 = spectral.dft_error_bound(GRID)
    got, fftn_ms = spectral_case(
        f"fftn {GRID}^3 (each axis 16 x 16: GEMMs of 32 x 32 by 32 x {16 * GRID * GRID})",
        lambda m: spectral.fftn(x, mode=m), lambda: torch.fft.fftn(x), 3 * b256, counts, reps=3)
    add(got, {"gemm_hilo": 6, "gemv_hilo": 0}, "fftn 256^3: two GEMMs an axis")
    busy, parts = profiled(lambda: spectral.fftn(x), 1)
    print(f"spectral: device time of fftn {GRID}^3 {busy:.3f} ms (torch.profiler): "
          f"{parts_text(parts)}", flush=True)
    del x

    # Poisson: a zero-mean u drawn on the card, f = its periodic Laplacian
    shape = (GRID,) * 3
    lam = torch.from_numpy(poisson.laplacian_eigenvalues(shape)).to(dev)
    kappa = float(lam.abs().max() / lam.abs()[lam != 0].min())
    u = torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
    u -= u.mean()
    f = poisson.apply_periodic_laplacian(u)

    def torch_solve(g):
        inv = torch.where(lam != 0, 1.0 / torch.where(lam != 0, lam, 1.0), 0.0)
        return torch.fft.ifftn(torch.fft.fftn(g) * inv).real

    pbound = kappa * 3 * 2 * b256     # tests/test_torch_poisson.py's bound, relative to max|u|
    got, per_ms = spectral_case(
        f"poisson_solve_periodic {GRID}^3 (bound kappa {kappa:.1f} x 6 dft_error_bound(256))",
        lambda m: poisson.poisson_solve_periodic(f, mode=m), lambda: torch_solve(f), pbound,
        counts, reps=3)
    add(got, {"gemm_hilo": 12, "gemv_hilo": 0}, "periodic solve: fftn and ifftn")
    up = poisson.poisson_solve_periodic(f)
    e_exact = float((up - u).abs().max())
    e_torch = float((torch_solve(f) - u).abs().max())
    check(e_exact <= 1e-10, f"spectral: periodic solve max|u - u_exact| {e_exact:.3e} (the "
          f"same solve on torch.fft {e_torch:.3e}) <= 1e-10 (tests/test_poisson.py's bound)")
    del up
    cf = (carry_fold.norm_scale, carry_fold.block_tree, carry_fold.carry_fold)
    for k in cf:
        k.launches = 0
    res = poisson.poisson_solve_checked(f)
    norms = {k.__name__: k.launches for k in cf}
    res_r = poisson.poisson_solve_checked(f, mode="ref")
    check(res.residual == res_r.residual and n_diff(res.u, res_r.u) == 0 and res.residual <= 1e-12,
          f"spectral: checked solve's relative residual {res.residual:.3e} <= 1e-12, routes "
          f"bitwise ({res_r.residual:.3e})")
    check(norms == {"norm_scale": 2, "block_tree": 2, "carry_fold": 2},
          f"spectral: the checked solve's two compensated norms on the reduction kernels "
          f"({norms})")
    chk_ms = time_ms(lambda: poisson.poisson_solve_checked(f), reps=2)
    del res, res_r, f, u
    fi = torch.randn((GRID // 2 - 1,) * 3, generator=gen, device=dev, dtype=torch.float64)
    got, dir_ms = spectral_case(
        f"poisson_solve_dirichlet {GRID // 2 - 1}^3 interior (odd extension to {GRID}^3)",
        lambda m: poisson.poisson_solve_dirichlet(fi, mode=m),
        lambda: torch_solve(poisson.odd_extension(fi))[1:GRID // 2, 1:GRID // 2, 1:GRID // 2],
        pbound, counts, reps=2)
    add(got, {"gemm_hilo": 12, "gemv_hilo": 0}, "Dirichlet solve: fftn and ifftn")
    ud = poisson.poisson_solve_dirichlet(fi)
    back = float((jacobi.apply_dirichlet_laplacian(ud) - fi).abs().max())
    check(back <= 1e-9, f"spectral: Dirichlet u through apply_dirichlet_laplacian (stencil7) "
          f"returns f within {back:.3e} <= 1e-9 (tests/test_poisson.py's bound)")
    print(f"spectral: ms per solve at {GRID}^3 (CUDA events): periodic {per_ms:.3f}, checked "
          f"{chk_ms:.3f}, Dirichlet {dir_ms:.3f}; fftn {fftn_ms:.3f}", flush=True)
    del fi, ud, lam
    torch.cuda.empty_cache()
    return total


# The exactness sweep's (rows, columns, largest log2 k), k from 2^5: a decode
# step's padded rows against a weight's width, a square tile, and the DGEMM's.
FP8_SWEEP_SHAPES = ((16, 4096, 16), (1024, 1024, 16), (N, N, 12))


def fp8_phase(dev, gen):
    """FP8 exactness sweep, the DGEMM on the FP8 substrate, and Ozaki-I."""
    import torch

    from repro_torch.core import dispatch, ozaki1, ozaki2

    # ---------------------------------------------------- exactness by chunk
    # integer planes as the FP8 substrate forms them (halves in [-8, 8], the
    # Karatsuba mid plane within [-16, 16]), random and adversarial: constant odd
    # products need every bit of their sums, and runs of 16 then of +-1 add small
    # products to large partial sums
    def planes(case, rows, k, cols):
        def draw(shape, kdim, const):
            if case == "random +-8":
                t = torch.randint(-8, 9, shape, generator=gen, device=dev)
            elif case == "random +-16":
                t = torch.randint(-16, 17, shape, generator=gen, device=dev)
            elif case == "all +16":
                t = torch.full(shape, 16, device=dev)
            elif case == "all 7 x 9":
                t = torch.full(shape, const[0], device=dev)
            elif case == "all 13 x 15":
                t = torch.full(shape, const[1], device=dev)
            else:   # "16 / +-1 by 32": runs of 32 entries, 16 and random -1, 0, 1 in turn
                t = torch.randint(-1, 2, shape, generator=gen, device=dev)
                big = (torch.arange(k, device=dev) // 32) % 2 == 0
                t.index_fill_(kdim, big.nonzero().squeeze(1), 16)
            return t.to(torch.int32)
        return draw((rows, k), 1, (7, 13)), draw((k, cols), 0, (9, 15))

    def one_call(a, b):
        """One torch._scaled_mm over the whole contraction, no blocks."""
        one = torch.ones((), dtype=torch.float32, device=dev)
        return torch._scaled_mm(a.to(torch.float8_e4m3fn),
                                b.t().contiguous().to(torch.float8_e4m3fn).t(),
                                scale_a=one, scale_b=one, out_dtype=torch.float32,
                                use_fast_accum=False)

    cases = ("random +-8", "random +-16", "all +16", "all 7 x 9", "all 13 x 15",
             "16 / +-1 by 32")
    chunk = ozaki2.FP8_CUDA_K_CHUNK
    raw_exact, port_exact = set(), True
    for rows, cols, max_log2k in FP8_SWEEP_SHAPES:
        for e in range(5, max_log2k + 1):
            k = 1 << e
            raw, port = {}, {}
            for case in cases:
                pa, pb = planes(case, rows, k, cols)
                want = torch.matmul(pa.double(), pb.double())     # exact: below 2^53
                raw[case] = float((one_call(pa, pb).double() - want).abs().max())
                port[case] = float((ozaki2._dot_fp8(pa, pb).double() - want).abs().max())
                del pa, pb, want
            if not any(raw.values()):
                raw_exact.add((rows, k))
            port_exact &= not any(port.values())
            print(f"fp8: exactness at {rows} x {k} x {cols}, max |FP8 product - exact| "
                  f"(torch._scaled_mm, use_fast_accum=False): one call " +
                  ", ".join(f"{c} {v:.0f}" for c, v in raw.items()) +
                  f"; the port's runs of {chunk} " +
                  ", ".join(f"{c} {v:.0f}" for c, v in port.items()), flush=True)
    exact_ks = sorted({k for r, k in raw_exact if all((r2, k) in raw_exact
                                                      for r2, _, _ in FP8_SWEEP_SHAPES)})
    check(all((r, chunk) in raw_exact for r, _, _ in FP8_SWEEP_SHAPES),
          f"fp8: one torch._scaled_mm call exact in every case at the committed chunk "
          f"{chunk}; chunks exact in every case and shape {exact_ks}")
    check(port_exact, f"fp8: the port's FP8 plane product (runs of {chunk} in blocks of "
          f"{ozaki2._FP8_CUDA_BLOCK}) exact in every case, shape and k up to "
          f"2^{max(m for _, _, m in FP8_SWEEP_SHAPES)}")

    # ----------------------------------------------------- DGEMM on FP8
    a = torch.randn((N, N), generator=gen, device=dev, dtype=torch.float64)
    b = torch.randn((N, N), generator=gen, device=dev, dtype=torch.float64)
    a[7] *= 1e-300
    c8 = dispatch.matmul(a, b)
    cf = dispatch.matmul(a, b, substrate="fp8")
    d = n_diff(cf, c8)
    check(d == 0, f"fp8: DGEMM {N}^3 on the FP8 substrate vs the int8 kernel route, {d} "
          f"differing elements")
    err = rel_err_u(cf, a, b)
    err_tiny = rel_err_u(cf[7:8], a[7:8], b)
    check(err <= 16 and err_tiny <= 16, f"fp8: DGEMM {N}^3 on the FP8 substrate error vs "
          f"native FP64 {err:.3f} u (row at 1e-300: {err_tiny:.3f} u) <= 16 u")
    del c8, cf
    plan = dispatch.get_plan(N, substrate="fp8")
    t_fp8 = time_ms(lambda: dispatch.matmul(a, b, substrate="fp8"), reps=2)
    t_int8 = time_ms(lambda: dispatch.matmul(a, b), reps=3)
    t_f64 = time_ms(lambda: torch.matmul(a, b), reps=5)
    pa = torch.randint(-16, 17, (N, N), generator=gen, device=dev, dtype=torch.int32)
    t_one = time_ms(lambda: ozaki2._dot_fp8(pa, pa), reps=5)
    del pa
    print(f"fp8: DGEMM {N}^3 through dispatch.matmul, r = {plan.r}, {3 * plan.r} FP8 products "
          f"(CUDA events): FP8 substrate {t_fp8:.3f} ms, int8 kernel route {t_int8:.3f} ms, "
          f"torch.matmul f64 {t_f64:.3f} ms; one FP8 plane product with its operands' "
          f"conversion {t_one:.3f} ms (bound "
          f"{2.0 * N ** 3 / INT8_OPS_PER_S * 1e3:.3f} ms at 1979 T operations/s)", flush=True)

    # --------------------------------------------------------- Ozaki-I
    p1 = ozaki1.make_plan(N)
    check((p1.slice_bits, p1.num_slices, p1.num_gemms) == (7, 8, 64),
          f"fp8: Ozaki-I plan at k = {N}: b = {p1.slice_bits}, S = {p1.num_slices}, "
          f"{p1.num_gemms} int8 products (Ozaki-II: {plan.r})")
    c1 = ozaki1.emulated_matmul(a, b)
    e1 = rel_err_u(c1, a, b)
    e1_tiny = rel_err_u(c1[7:8], a[7:8], b)
    check(e1 <= 16 and e1_tiny <= 16, f"fp8: Ozaki-I DGEMM {N}^3 error vs native FP64 "
          f"{e1:.3f} u (row at 1e-300: {e1_tiny:.3f} u) <= 16 u (tests/test_ozaki1.py's bound)")
    del c1
    t1 = time_ms(lambda: ozaki1.emulated_matmul(a, b), reps=2)
    s8, s8t = ozaki1._slice_operands(
        *(torch.randint(-64, 65, (1, N, N), generator=gen, device=dev, dtype=torch.int8)
          for _ in range(2)))
    t_int_mm = time_ms(lambda: ozaki1._dot_int8(s8[0], s8t[0], N, N), reps=5)
    print(f"fp8: Ozaki-I DGEMM {N}^3, S = {p1.num_slices}, {p1.num_gemms} torch._int_mm "
          f"products (CUDA events): {t1:.3f} ms; one slice product {t_int_mm:.3f} ms; "
          f"Ozaki-II int8 kernel route {t_int8:.3f} ms", flush=True)
    del a, b, s8, s8t
    torch.cuda.empty_cache()


SERVE_FP8_PROMPT = 16
SERVE_FP8_NEW = 4
SERVE_FP8_LAYERS = 2     # of yi-6b's 32: the phase's time is its depth


def serve_fp8_phase(dev):
    """yi-6b under ozaki2_fp8; returns the attention_fused launches of its main path."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import dispatch, ozaki2
    from repro_torch.kernels import carry_fold, ozaki_attention, ozaki_gemm, ozaki_gemv
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine

    cfg = registry.get_config("yi-6b", policy_name="ozaki2_fp8", compute_dtype="float32",
                              num_layers=SERVE_FP8_LAYERS)
    L, L_full = cfg.num_layers, registry.get_config("yi-6b").num_layers
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    state = dict(model.state_dict())
    rng = np.random.default_rng(SEED + 2)
    prompt = rng.integers(0, cfg.vocab_size, SERVE_FP8_PROMPT)
    engine = ServeEngine(model, batch_slots=1, max_seq=SERVE_FP8_PROMPT + SERVE_FP8_NEW)
    steps, real_call = [], engine._decode_call

    def call(toks, pos):
        t = time.perf_counter()
        out = real_call(toks, pos)
        torch.cuda.synchronize()
        steps.append((np.array(toks), pos, out.cpu(), time.perf_counter() - t))
        return out

    engine._decode_call = call
    batcher = ContinuousBatcher(engine)
    batcher.submit(Request(uid=0, prompt=prompt, max_new_tokens=SERVE_FP8_NEW))
    counts = (ozaki_gemm.gemm_hilo, ozaki_gemv.gemv_hilo, ozaki_attention.attention_fused,
              carry_fold.carry_fold)
    for k in counts:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = batcher.run_to_completion()
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counts}
    n = len(steps)
    check(n == SERVE_FP8_PROMPT + SERVE_FP8_NEW - 1 and len(done) == 1 and
          len(done[0].generated) == SERVE_FP8_NEW,
          f"serve-fp8: one request of {SERVE_FP8_PROMPT} prompt tokens and {SERVE_FP8_NEW} new "
          f"tokens in {n} decode steps -> {done[0].generated if done else None}")
    check(launches["attention_fused"] == L * n and launches["gemm_hilo"] == 0 and
          launches["gemv_hilo"] == 0,
          f"serve-fp8: attention_fused launched layers x steps = {L} x {n} times (attention "
          f"keeps the int8 substrate), no gemm_hilo or gemv_hilo launch: every weight product "
          f"on the FP8 substrate ({launches})")
    fp8_ms = 1e3 * sum(s[3] for s in steps) / n

    # one weight product of a decode step by part (CUDA events): wq of layer 0
    w = model.layers[0].tree()["mixer"]["wq"]["w"].double()
    x = torch.randn((1, w.shape[0]), device=dev, dtype=torch.float64)
    plan = dispatch.get_plan(w.shape[0], substrate="fp8")
    ares, _ = ozaki2.decompose(x, plan, -1)
    bres, _ = ozaki2.decompose(w, plan, 0)
    cres = ozaki2.modular_matmul(ares, bres, plan)
    parts = {"whole": time_ms(lambda: dispatch.matmul(x, w, plan=plan), reps=3),
             "Phase 1 and residues of w": time_ms(lambda: ozaki2.decompose(w, plan, 0), reps=3),
             "FP8 products (split, planes, _scaled_mm, combine)":
                 time_ms(lambda: ozaki2.modular_matmul(ares, bres, plan), reps=3),
             "Garner": time_ms(lambda: ozaki2.garner_reconstruct(cres, plan), reps=3),
             "int8 kernel route": time_ms(lambda: dispatch.matmul(x, w), reps=3)}
    print(f"serve-fp8: one decode-step weight product 1 x {w.shape[0]} x {w.shape[1]} (wq), "
          f"r = {plan.r}, by part (CUDA events): " +
          "; ".join(f"{k} {v:.3f} ms" for k, v in parts.items()), flush=True)
    del w, x, ares, bres, cres

    def replay(policy_name):
        """The same decode calls, tokens and positions under another policy."""
        cfg2 = registry.get_config("yi-6b", policy_name=policy_name, compute_dtype="float32",
                                   num_layers=L)
        eng = ServeEngine(Model(cfg2).load(state), batch_slots=1, max_seq=engine.max_seq)
        outs, times = [], []
        for toks, pos, _, _ in steps:
            t = time.perf_counter()
            outs.append(eng._decode_call(toks, pos).cpu())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return outs, 1e3 * sum(times) / len(times)

    outs8, int8_ms = replay("ozaki2_int8")
    diffs = [n_diff(s[2], o) for s, o in zip(steps, outs8)]
    check(diffs == [0] * n, f"serve-fp8: logits of all {n} steps under ozaki2_fp8 vs "
          f"ozaki2_int8 (its weight products on gemm_hilo) at {L} of {L} layers, differing "
          f"elements {diffs}")
    outs64, fp64_ms = replay("fp64")
    got = torch.stack([s[2] for s in steps])
    want = torch.stack(outs64)
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=1e-3, atol=1e-4)),
          f"serve-fp8: logits of all {n} steps within rtol 1e-3, atol 1e-4 of the fp64 "
          f"policy's (max |diff| {err:.3e})")
    print(f"serve-fp8: {cfg.name}, depth cut to {L} of {L_full} layers, ozaki2_fp8, compute "
          f"float32: {n} decode steps in "
          f"{t_all:.1f} s, {fp8_ms:.3f} ms a step (mean, host clock; ozaki2_int8 "
          f"{int8_ms:.3f}, fp64 {fp64_ms:.3f}); launches {launches}", flush=True)
    del model, engine, batcher, state
    torch.cuda.empty_cache()
    return launches["attention_fused"]


@contextlib.contextmanager
def recorded_routes():
    """While the block runs, keep each MoE call's routed experts and router
    logits: yields a list of (indices (T, k), logits (T, E)), on the card."""
    from repro_torch.models import moe

    log, real = [], moe._topk_gating

    def gating(logits, m):
        out = real(logits, m)
        log.append((out[1], logits.detach().clone()))
        return out

    moe._topk_gating = gating
    try:
        yield log
    finally:
        moe._topk_gating = real


def route_margins(logits, k):
    """float32 ulps between each token's k-th and (k+1)-th router probability."""
    import torch

    p = torch.sort(torch.softmax(logits.float(), dim=-1), dim=-1, descending=True).values
    kth = p[:, k - 1]
    return (kth - p[:, k]) / (torch.nextafter(kth, torch.full_like(kth, 2.0)) - kth)


def recording_engine(model):
    """A 2-slot engine whose decode calls are kept, each as (tokens, pos, logits
    on the host, host-clock seconds): (engine, that list)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import ServeEngine

    engine = ServeEngine(model, batch_slots=2, max_seq=SERVE_CTX)
    steps, real_call = [], engine._decode_call

    def call(toks, pos):
        t = time.perf_counter()
        out = real_call(toks, pos)
        torch.cuda.synchronize()
        steps.append((np.array(toks), pos, out.cpu(), time.perf_counter() - t))
        return out

    engine._decode_call = call
    return engine, steps


def replay(model, calls, mode=None):
    """Recorded decode calls on a fresh 2-slot engine (zero states, as the
    recording's), under dispatch mode ``mode``: (logits of each on the host, the
    routed experts of each MoE call)."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, batch_slots=2, max_seq=SERVE_CTX, dispatch_mode=mode)
    with recorded_routes() as log:
        outs = [eng._decode_call(toks, pos).cpu() for toks, pos, _, _ in calls]
    return outs, [idx.cpu() for idx, _ in log]


def check_routes_bitwise(phase, model, steps, moe_layers):
    """The first 2 recorded decode calls replayed on the kernel and reference
    routes: logits and routed experts bitwise, and equal to the main path's."""
    L = model.cfg.num_layers
    t0 = time.perf_counter()
    outs_k, routes_k = replay(model, steps[:2], "auto")
    outs_r, routes_r = replay(model, steps[:2], "ref")
    t_ref = time.perf_counter() - t0
    diffs = [n_diff(a, b) for a, b in zip(outs_k, outs_r)]
    route_diffs = sum(int((a != b).sum()) for a, b in zip(routes_k, routes_r))
    check(diffs == [0, 0] and len(routes_k) == len(routes_r) == 2 * moe_layers and
          route_diffs == 0,
          f"{phase}: kernel vs reference route at {L} of {L} layers, first 2 decode steps: "
          f"differing logits {diffs}, differing routed experts {route_diffs} ({t_ref:.1f} s)")
    main_diffs = [n_diff(st[2], o) for st, o in zip(steps, outs_k)]
    check(main_diffs == [0, 0], f"{phase}: the main path's first 2 steps equal the replay's "
          f"(differing elements {main_diffs})")


def check_flips(phase, main_routes, routes64, outs, outs64, per_step, k):
    """The fp64 policy's routes against the main path's, MoE call by MoE call
    (``per_step`` a decode step): each flip printed with its top-k margin in
    float32 ulps; a slot's first flip at a margin above MARGIN_ULPS fails; the
    logits of every step before the first flip within rtol 1e-3, atol 1e-4."""
    import torch

    n = len(outs)
    flips = []                                      # (step, MoE layer, slot, margin in ulps)
    for i, ((idx, margin), idx64) in enumerate(zip(main_routes, routes64)):
        differ = (idx.sort(dim=-1).values != idx64.sort(dim=-1).values).any(dim=-1)
        flips += [(i // per_step, i % per_step, int(t), float(margin[t]))
                  for t in torch.nonzero(differ)]
    first = {}
    for f in flips:
        first.setdefault(f[2], f)
    first_step = min((f[0] for f in flips), default=n)
    least = min(float(mg.min()) for _, mg in main_routes)
    print(f"{phase}: ozaki2_int8 vs fp64 routes: {len(flips)} of {per_step * n * 2} (layer, "
          f"token) routes differ; flips (step, layer, slot, top-k margin in float32 ulps): "
          f"{flips[:12]}{' ...' if len(flips) > 12 else ''}; least margin over all routes "
          f"{least:.1f} ulps", flush=True)
    check(len(main_routes) == len(routes64) == per_step * n and
          all(f[3] <= MARGIN_ULPS for f in first.values()),
          f"{phase}: each slot's first routing flip against the fp64 policy at a top-k margin "
          f"of at most {MARGIN_ULPS} float32 ulps ({list(first.values())})")
    got = torch.stack(outs[:first_step] or outs[:1])
    want = torch.stack(outs64[:first_step] or outs64[:1])
    err = float((got - want).abs().max())
    check(first_step == 0 or bool(torch.allclose(got, want, rtol=1e-3, atol=1e-4)),
          f"{phase}: logits of the {first_step} steps before the first routing flip (of {n}) "
          f"within rtol 1e-3, atol 1e-4 of the fp64 policy's (max |diff| {err:.3e})")


def serve_moe_phase(dev):
    """deepseek-moe-16b served at its published widths and depth; returns the
    launch counts of its main path."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import dispatch
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model

    card = smi_line()
    over = {"compute_dtype": "float32", "param_dtype": "bfloat16", "num_layers": SERVE_MOE_LAYERS}
    cfg = registry.get_config(SERVE_MOE_ARCH, policy_name="ozaki2_int8", **over)
    L, m = cfg.num_layers, cfg.moe
    check(not torch.backends.cuda.matmul.allow_tf32,
          "serve-moe: TF32 off for float32 matmuls (the router and the routed experts)")
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve-moe: {card}; {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, head_dim {cfg.head_dim}, {m.num_experts} routed experts of "
          f"width {m.d_expert}, top-{m.top_k}, {m.num_shared} shared, vocab {cfg.vocab_size}, "
          f"{L} of {registry.get_config(SERVE_MOE_ARCH).num_layers} layers; param_count "
          f"{cfg.param_count()}, active_param_count {cfg.active_param_count()}, {n_params} "
          f"weights with the norms, in {cfg.param_dtype}, made on the card from a seed in "
          f"{t_build:.3f} s; policy {cfg.policy_name}, compute {cfg.compute_dtype}. Reduced: "
          f"depth (the script's time limit), bfloat16 storage (the published checkpoint's "
          f"dtype), seeded weights in place of the checkpoint; widths not cut", flush=True)
    check(products_per_call(cfg) == {"gemm_hilo": 7 * L + 1, "gemv_hilo": 0,
                                     "attention_fused": L},
          f"serve-moe: per decode step attention_fused once a layer ({L}), gemm_hilo 7 times a "
          f"layer and once for the LM head ({7 * L + 1}), no gemv_hilo "
          f"({products_per_call(cfg)})")
    run = serve_requests("serve-moe", model, dev, SEED + 3, {
        "matmul": (dispatch, "matmul"), "attention": (dispatch, "attention"),
        "routed experts": (moe, "_routed_experts")})
    n, part, steps, routes = run["n"], run["part"], run["steps"], run["routes"]
    check(len(routes) == L * n and run["calls"] == {"matmul": (7 * L + 1) * n,
                                                    "attention": L * n,
                                                    "routed experts": L * n},
          f"serve-moe: per step one routing and one routed-experts call per layer, one timed "
          f"attention call per layer and one timed matmul per weight, over {n} steps "
          f"({run['calls']}, {len(routes)} routes)")
    layer = model.layers[0].tree()
    weights = [layer["mixer"][w]["w"] for w in ("wq", "wk", "wv", "wo")] + \
              [layer["mlp"]["shared"][w]["w"] for w in ("wi_gate", "wi_up", "wo")]
    part["gemm_hilo"] = L * sum(gemm_alone_ms(w) for w in weights) + \
        gemm_alone_ms(model.lm_head.w)
    ex = layer["mlp"]["experts"]
    part["expert copies"] = L * time_ms(
        lambda: [ex[w].to(cfg.compute_torch_dtype) for w in ("wi_gate", "wi_up", "wo")], reps=3)
    rest = run["step_ms"] - part["matmul"] - part["attention"] - part["routed experts"]
    print(f"serve-moe: {card}; a decode step over {L} layers (CUDA events, mean): weight "
          f"products (dispatch.matmul, Phase 1 included) {part['matmul']:.3f} ms, of it the "
          f"gemm_hilo kernel {part['gemm_hilo']:.3f} ms (timed alone at the step's shapes); "
          f"dispatch.attention {part['attention']:.3f} ms; the routed experts (einsums in "
          f"float32) {part['routed experts']:.3f} ms, of it the float32 copies of the bfloat16 "
          f"expert stacks {part['expert copies']:.3f} ms (timed alone); the rest (router, "
          f"norms, embedding, host) {rest:.3f} ms", flush=True)
    main_routes = [(idx.cpu(), route_margins(lg, m.top_k).cpu()) for idx, lg in routes]
    launches = run["launches"]
    del routes, run

    check_routes_bitwise("serve-moe", model, steps, L)

    # the fp64 policy on the same weights and decode calls
    cfg64 = registry.get_config(SERVE_MOE_ARCH, policy_name="fp64", **over)
    t0 = time.perf_counter()
    outs64, routes64 = replay(Model(cfg64).load(dict(model.state_dict())), steps)
    t_64 = time.perf_counter() - t0
    print(f"serve-moe: fp64 replay of {n} steps {t_64:.1f} s", flush=True)
    check_flips("serve-moe", main_routes, routes64, [st[2] for st in steps], outs64, L,
                m.top_k)
    del model, outs64, steps
    return launches


def products_per_call(cfg, forward=False):
    """The seam kernels one decode step (or with ``forward`` one forward pass)
    of a model launches, read from its layers: {kernel: launches}.  Each weight
    product through the policy (``layers.dense_apply``, the tied unembedding,
    an untied LM head) is one ``gemm_hilo`` per ``policy.column_blocks`` of its
    weight, or one ``gemv_hilo`` at GEMV_MAX_B columns or fewer, and each
    attention layer one ``attention_fused``.  An encoder-decoder's decode step
    adds each decoder layer's cross-attention wq and wo (its softmax over the
    cross cache is native); its forward adds the encoder's layers and each
    decoder layer's four cross-attention products and one ``attention_fused``.
    The MoE router (float32) and routed experts (einsums), sLSTM's
    block-diagonal R and the recurrences launch none."""
    from repro_torch.configs.base import BlockCfg
    from repro_torch.core import dispatch
    from repro_torch.core.policy import column_blocks

    d, di, H = cfg.d_model, cfg.d_inner, cfg.num_heads
    q, kv = H * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    mixer = {"attn": [(d, q), (d, kv), (d, kv), (q, d)],            # wq, wk, wv, wo
             "mamba": [(d, 2 * di), (di, 2 * cfg.ssm_state_dim + 1), (di, d)],
             "mlstm": [(d, 2 * di), (di, di), (di, di), (di, di), (di, 2 * H), (di, d)],
             "slstm": [(d, 4 * di), (di, d)]}                   # w_in, down_proj
    cross = [(d, q), (d, kv), (d, kv), (q, d)] if forward else [(d, q), (q, d)]
    gated = 2 if cfg.mlp_act in ("swiglu", "geglu") else 1
    shapes, attn = [(d, cfg.vocab_size)], 0
    blocks = [cfg.block_at(i) for i in range(cfg.num_layers)]
    if cfg.family == "encdec":
        shapes += cross * cfg.num_layers
        attn += cfg.num_layers if forward else 0
        if forward:
            blocks += [BlockCfg(mixer="attn", mlp="dense")] * cfg.encoder_layers
    for blk in blocks:
        shapes += mixer[blk.mixer]
        attn += blk.mixer == "attn"
        if blk.mlp == "dense":
            shapes += [(d, cfg.d_ff)] * gated + [(cfg.d_ff, d)]
        elif blk.mlp == "moe" and cfg.moe.num_shared:
            f = cfg.moe.num_shared * cfg.moe.d_expert
            shapes += [(d, f)] * gated + [(f, d)]
    gemv = sum(n <= dispatch.GEMV_MAX_B for _, n in shapes)
    gemm = sum(len(column_blocks(k, n)) for k, n in shapes if n > dispatch.GEMV_MAX_B)
    return {"gemm_hilo": gemm, "gemv_hilo": gemv, "attention_fused": attn}


def launch_counts(reset=False):
    """The seam kernels' and carry_fold's launch counts; with ``reset`` set them
    to 0 first."""
    from repro_torch.kernels import carry_fold, ozaki_attention, ozaki_gemm, ozaki_gemv

    kernels = (ozaki_gemm.gemm_hilo, ozaki_gemv.gemv_hilo, ozaki_attention.attention_fused,
               carry_fold.carry_fold)
    if reset:
        for k in kernels:
            k.launches = 0
    return {k.__name__: k.launches for k in kernels}


def serve_requests(phase, model, dev, seed, timers, batch=None):
    """A model's serving main path: ``ContinuousBatcher`` serves 3 requests of
    16 seeded prompt tokens and 8 new tokens through 2 slots, then, given a
    ``batch``, one forward pass over it; every launch count is set to 0 just
    before and read just after.  The batcher's calls to ``timers`` are timed
    with CUDA events and its MoE routes recorded.  Checks the launches against
    ``products_per_call``, and the forward's logits bitwise against the same
    forward on the reference route; returns a dict of what the phase reads on."""
    import numpy as np
    import torch

    from repro_torch.core import dispatch
    from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, 16) for _ in range(3)]
    forward = batch is not None
    engine, steps = recording_engine(model)
    batcher = ContinuousBatcher(engine)
    for uid, p in enumerate(prompts):
        batcher.submit(Request(uid=uid, prompt=p, max_new_tokens=8))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    launch_counts(reset=True)
    t0 = time.perf_counter()
    with timed_calls(timers) as events, recorded_routes() as routes:
        done = batcher.run_to_completion()
        torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = model.apply(batch)[0] if forward else None
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n = len(steps)
    ntok = sum(len(r.generated) for r in done)
    check(len(done) == 3 and ntok == 24,
          f"{phase}: 3 requests of 16 prompt tokens and 8 new tokens served through 2 slots "
          f"in {n} decode steps, {ntok} tokens")
    per, per_fwd = products_per_call(cfg), products_per_call(cfg, forward=True)
    want = {k: v * n + per_fwd[k] * forward for k, v in per.items()}
    check(launches == {**want, "carry_fold": 0},
          f"{phase}: per decode step gemm_hilo {per['gemm_hilo']}, gemv_hilo "
          f"{per['gemv_hilo']}, attention_fused {per['attention_fused']}"
          + (f"; per forward {per_fwd}" if forward else "") + f", read from the layers; "
          f"over {n} steps + {int(forward)} forward {want}, no carry_fold ({launches})")
    rows = next(iter(batch.values())).shape[1] if forward else 0
    if forward:
        shape = tuple(logits.shape)
        check(bool(torch.isfinite(logits).all()) and shape == (1, rows, cfg.vocab_size),
              f"{phase}: forward logits over {rows} positions finite, shape {shape}")
        t0 = time.perf_counter()
        with dispatch.mode_scope("ref"):
            logits_r = model.apply(batch)[0]
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        diff = n_diff(logits, logits_r)
        check(diff == 0, f"{phase}: kernel vs reference route, {rows}-position forward logits: "
              f"{diff} of {logits.numel()} differ (reference forward {1e3 * t_ref:.1f} ms)")
        del logits_r
    check(peak < torch.cuda.get_device_properties(dev).total_memory,
          f"{phase}: peak memory {peak / 2 ** 30:.3f} GiB within the card's "
          f"{torch.cuda.get_device_properties(dev).total_memory / 2 ** 30:.3f} GiB")
    step_ms = 1e3 * sum(st[3] for st in steps) / n
    fwd = f"forward over {rows} positions {1e3 * t_fwd:.3f} ms; " if forward else ""
    print(f"{phase}: {smi_line()}; {n} decode steps at {step_ms:.3f} ms each (mean, host "
          f"clock); {ntok} tokens in {t_serve:.3f} s = {ntok / t_serve:.3f} tokens/s; {fwd}peak "
          f"memory {peak / 2 ** 30:.3f} GiB; launches {launches}", flush=True)
    for r in sorted(done, key=lambda r: r.uid):
        print(f"{phase}: request {r.uid} -> {r.generated}", flush=True)
    # the card's busy time in a decode step (torch.profiler)
    prof_engine = ServeEngine(model, batch_slots=2, max_seq=SERVE_CTX)
    busy, busy_parts = profiled(lambda: prof_engine._decode_call(steps[-1][0], steps[-1][1]), 3)
    print(f"{phase}: {smi_line()}; device busy {busy:.3f} ms of a {step_ms:.3f} ms decode step "
          f"(torch.profiler, 3 steps), idle {100 * (1 - busy / step_ms):.2f}%: "
          f"{parts_text(busy_parts)}", flush=True)
    part = {k: sum(a.elapsed_time(b) for a, b in v) / n for k, v in events.items()}
    counts = {k: len(v) for k, v in events.items()}
    return {"launches": launches, "steps": steps, "step_ms": step_ms, "part": part,
            "calls": counts, "routes": routes, "logits": logits, "n": n, "peak": peak,
            "forward_ms": 1e3 * t_fwd}


def token_batch(cfg, dev, seed, seq=512):
    """A forward's batch: (1, seq) seeded tokens on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, seq)), device=dev)}


SERVE_SSM_ARCH = "xlstm-350m"
SERVE_HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_LAYERS = 2        # jamba's first two: attention + dense MLP, Mamba + MoE
# Token-by-token decode against the forward pass of a recurrent model, in
# units of 2^-23 max|logit| (ROADMAP queue 3, item 14): the forward's chunked
# scans and its reductions over 512 rows associate otherwise than the steps.
SSM_DECODE_TOL = 64


def serve_ssm_phase(dev):
    """xlstm-350m served at its published widths and depth; returns the launch
    counts of its main path."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import dispatch
    from repro_torch.models import ssm
    from repro_torch.models.transformer import Model

    cfg = registry.get_config(SERVE_SSM_ARCH, policy_name="ozaki2_int8", compute_dtype="float32",
                              num_layers=SSM_LAYERS)
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve-ssm: {smi_line()}; {cfg.name}: d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
          f"{cfg.num_heads} heads of {cfg.d_inner // cfg.num_heads}, vocab {cfg.vocab_size} "
          f"(tied), {L} of {registry.get_config(SERVE_SSM_ARCH).num_layers} layers alternating "
          f"{[b.mixer for b in cfg.pattern]}, no MLP, chunks of {cfg.lstm_chunk}; param_count "
          f"{cfg.param_count()}, {n_params} weights with the norms, in {cfg.param_dtype}, made "
          f"on the card from a seed in {t_build:.3f} s; policy {cfg.policy_name}, compute "
          f"{cfg.compute_dtype}. Reduced: depth (the script's time limit), seeded weights in "
          f"place of the checkpoint; widths not cut", flush=True)
    tokens = token_batch(cfg, dev, SEED + 6)
    run = serve_requests("serve-ssm", model, dev, SEED + 5, {
        "matmul": (dispatch, "matmul"), "mLSTM steps": (ssm, "_mlstm_step"),
        "sLSTM steps": (ssm, "_slstm_step")}, tokens)
    n, part, steps = run["n"], run["part"], run["steps"]
    per = products_per_call(cfg)
    kinds = [cfg.block_at(i).mixer for i in range(L)]
    check(run["calls"] == {"matmul": (per["gemm_hilo"] + per["gemv_hilo"]) * n,
                           "mLSTM steps": kinds.count("mlstm") * n,
                           "sLSTM steps": kinds.count("slstm") * n},
          f"serve-ssm: per decode step one timed matmul per weight and one step per mLSTM and "
          f"sLSTM layer ({run['calls']})")
    rest = run["step_ms"] - sum(part.values())
    print(f"serve-ssm: {smi_line()}; a decode step over {L} layers (CUDA events, mean): weight "
          f"products (dispatch.matmul, Phase 1 included) {part['matmul']:.3f} ms; the "
          f"recurrences: mLSTM steps {part['mLSTM steps']:.3f} ms, sLSTM steps "
          f"{part['sLSTM steps']:.3f} ms; the rest (projections' splits and gates, norms, "
          f"embedding, host) {rest:.3f} ms", flush=True)
    # the forward's first 16 positions against token-by-token decode
    logits, tokens = run["logits"], tokens["tokens"]
    cache = model.init_cache(1, 16)
    dec = []
    for t in range(16):
        lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
        dec.append(lg[:, 0])
    dec = torch.stack(dec, dim=1)
    units = float((dec - logits[:, :16]).abs().max() / logits[:, :16].abs().max()) / 2.0 ** -23
    check(units <= SSM_DECODE_TOL,
          f"serve-ssm: 16 decode steps against the 512-token forward's first 16 positions "
          f"(chunks of {cfg.lstm_chunk}): max |diff| {units:.3f} x 2^-23 max|logit| <= "
          f"{SSM_DECODE_TOL}")
    del cache, dec
    check_routes_bitwise("serve-ssm", model, steps, 0)
    replay_fp64("serve-ssm", model, steps)
    launches = run["launches"]
    del model, run, steps, logits
    return launches


def serve_hybrid_phase(dev):
    """jamba-1.5-large-398b at its published widths, cut to its first two
    layers; returns the launch counts of its main path."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import dispatch
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model

    over = {"compute_dtype": "float32", "param_dtype": "bfloat16", "num_layers": HYBRID_LAYERS}
    cfg = registry.get_config(SERVE_HYBRID_ARCH, policy_name="ozaki2_int8", **over)
    full = registry.get_config(SERVE_HYBRID_ARCH)
    L, m = cfg.num_layers, cfg.moe
    moe_layers = sum(cfg.block_at(i).mlp == "moe" for i in range(L))
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve-hybrid: {smi_line()}; {cfg.name}: d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"d_inner {cfg.d_inner}, state {cfg.ssm_state_dim}, {m.num_experts} experts of width "
          f"{m.d_expert}, top-{m.top_k}, vocab {cfg.vocab_size}; layers "
          f"{[(b.mixer, b.mlp) for b in cfg.pattern[:L]]}; param_count {cfg.param_count()}, "
          f"active_param_count {cfg.active_param_count()}, {n_params} weights with the norms, "
          f"in {cfg.param_dtype}, made on the card from a seed in {t_build:.3f} s; policy "
          f"{cfg.policy_name}, compute {cfg.compute_dtype}, Mamba chunks of {cfg.ssm_chunk}. "
          f"Reduced: depth {L} of {full.num_layers} layers (the first two of its period of "
          f"{full.period}: the full {full.param_count()} weights fit on no single card), "
          f"bfloat16 storage, seeded weights in place of the checkpoint; widths not cut",
          flush=True)
    run = serve_requests("serve-hybrid", model, dev, SEED + 7, {
        "matmul": (dispatch, "matmul"), "attention": (dispatch, "attention"),
        "routed experts": (moe, "_routed_experts")}, token_batch(cfg, dev, SEED + 8))
    n, part, steps = run["n"], run["part"], run["steps"]
    per = products_per_call(cfg)
    check(run["calls"] == {"matmul": (per["gemm_hilo"] + per["gemv_hilo"]) * n,
                           "attention": per["attention_fused"] * n,
                           "routed experts": moe_layers * n} and
          len(run["routes"]) == moe_layers * n,
          f"serve-hybrid: per decode step one timed matmul per weight, one attention call per "
          f"attention layer, one routing and routed-experts call per MoE layer "
          f"({run['calls']}, {len(run['routes'])} routes)")
    layer = model.layers[1].tree()
    ex = layer["mlp"]["experts"]
    part["expert copies"] = moe_layers * time_ms(
        lambda: [ex[w].to(cfg.compute_torch_dtype) for w in ("wi_gate", "wi_up", "wo")], reps=3)
    rest = run["step_ms"] - part["matmul"] - part["attention"] - part["routed experts"]
    print(f"serve-hybrid: {smi_line()}; a decode step over {L} layers (CUDA events, mean): "
          f"weight products (dispatch.matmul, Phase 1 included) {part['matmul']:.3f} ms; "
          f"dispatch.attention {part['attention']:.3f} ms; the routed experts "
          f"{part['routed experts']:.3f} ms, of it the float32 copies of the bfloat16 expert "
          f"stacks {part['expert copies']:.3f} ms (timed alone); the rest (Mamba's conv and "
          f"scan step, router, norms, embedding, host) {rest:.3f} ms", flush=True)
    main_routes = [(idx.cpu(), route_margins(lg, m.top_k).cpu()) for idx, lg in run["routes"]]
    launches = run["launches"]
    del run
    check_routes_bitwise("serve-hybrid", model, steps, moe_layers)
    cfg64 = registry.get_config(SERVE_HYBRID_ARCH, policy_name="fp64", **over)
    t0 = time.perf_counter()
    outs64, routes64 = replay(Model(cfg64).load(dict(model.state_dict())), steps)
    print(f"serve-hybrid: fp64 replay of {n} steps {time.perf_counter() - t0:.1f} s",
          flush=True)
    check_flips("serve-hybrid", main_routes, routes64, [st[2] for st in steps], outs64,
                moe_layers, m.top_k)
    del model, steps, outs64
    return launches


SERVE_ENCDEC_ARCH = "whisper-medium"
ENCDEC_TEXT = 448        # whisper's text context: the forward's decoder positions
SERVE_VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 2           # of qwen2-vl-72b's 80: 4.25 G of its 72.7 G weights
VLM_GRID = (16, 32)      # an image's merged patches, rows x columns: 512 positions


def replay_fp64(phase, model, steps):
    """Every recorded decode call replayed under the fp64 policy on the same
    weights: logits within rtol 1e-3, atol 1e-4 of the main path's."""
    import torch

    from repro_torch.models.transformer import Model

    cfg64 = dataclasses.replace(model.cfg, policy_name="fp64")
    t0 = time.perf_counter()
    outs64, _ = replay(Model(cfg64).load(dict(model.state_dict())), steps)
    t_64 = time.perf_counter() - t0
    got, want = torch.stack([st[2] for st in steps]), torch.stack(outs64)
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=1e-3, atol=1e-4)),
          f"{phase}: logits of all {len(steps)} steps within rtol 1e-3, atol 1e-4 of the fp64 "
          f"policy's (max |diff| {err:.3e}; fp64 replay {t_64:.1f} s)")


def serve_encdec_phase(dev):
    """whisper-medium served at its published widths and depth; returns the
    launch counts of its main path."""
    import torch

    from repro_torch.configs import base, registry
    from repro_torch.core import dispatch
    from repro_torch.models import attention
    from repro_torch.models.transformer import Model

    cfg = registry.get_config(SERVE_ENCDEC_ARCH, policy_name="ozaki2_int8",
                              compute_dtype="float32")
    L, E = cfg.num_layers, cfg.encoder_layers
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve-encdec: {smi_line()}; {cfg.name}: {E} encoder and {L} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff} "
          f"({cfg.mlp_act}), vocab {cfg.vocab_size}, {cfg.encoder_seq} encoder frames; "
          f"param_count {cfg.param_count()}, {n_params} weights with the norms and enc_pos, in "
          f"{cfg.param_dtype}, made on the card from a seed in {t_build:.3f} s; policy "
          f"{cfg.policy_name}, compute {cfg.compute_dtype}. Reduced: seeded weights in place of "
          f"the checkpoint, the audio frontend a stub (seeded frame embeddings); nothing else "
          f"cut", flush=True)
    per, per_fwd = products_per_call(cfg), products_per_call(cfg, forward=True)
    check(per == {"gemm_hilo": 9 * L + 1, "gemv_hilo": 0, "attention_fused": L} and
          per_fwd == {"gemm_hilo": 7 * E + 11 * L + 1, "gemv_hilo": 0,
                      "attention_fused": E + 2 * L},
          f"serve-encdec: a decode step launches gemm_hilo 9 a layer (self 4, cross wq and wo, "
          f"MLP 3) and 1 for the LM head, attention_fused 1 a layer ({per}); a forward "
          f"gemm_hilo 7 an encoder layer, 11 a decoder layer and 1, attention_fused {E} + 2 x "
          f"{L} ({per_fwd})")
    batch = registry.concrete_batch(cfg, base.SHAPES[1], batch=1, seq=ENCDEC_TEXT, seed=SEED + 9,
                                    device=dev)
    del batch["labels"]
    run = serve_requests("serve-encdec", model, dev, SEED + 8, {
        "matmul": (dispatch, "matmul"), "attention": (dispatch, "attention"),
        "cross": (attention, "cross_decode_step")}, batch)
    n, part, steps = run["n"], run["part"], run["steps"]
    check(run["calls"] == {"matmul": per["gemm_hilo"] * n, "attention": L * n, "cross": L * n},
          f"serve-encdec: per decode step one timed matmul per weight, one attention and one "
          f"cross-attention call per decoder layer ({run['calls']})")
    rest = run["step_ms"] - part["matmul"] - part["attention"] - part["cross"] + \
        2 * L * part["matmul"] / per["gemm_hilo"]
    print(f"serve-encdec: {smi_line()}; a decode step over {L} decoder layers (CUDA events, "
          f"mean): weight products (dispatch.matmul, Phase 1 included) {part['matmul']:.3f} ms; "
          f"dispatch.attention (self) {part['attention']:.3f} ms; cross-attention over the "
          f"{cfg.encoder_seq}-frame zero cache {part['cross']:.3f} ms (its wq and wo products "
          f"included, ~{2 * L * part['matmul'] / per['gemm_hilo']:.3f} ms of the products' "
          f"mean); the rest (norms, MLP activation, embedding, host) {rest:.3f} ms", flush=True)
    # the forward's parts (a second forward, each call between CUDA events)
    logits = run["logits"]
    T = cfg.encoder_seq

    def kind(name, args):
        if name == "matmul":
            return "weight products"
        S, K = args[0].shape[-2], args[1].shape[-2]
        return "encoder" if S == K == T else "cross" if K == T else "decoder self"

    t0 = time.perf_counter()
    with timed_calls({"matmul": (dispatch, "matmul"), "attention": (dispatch, "attention")},
                     label=kind) as events:
        again = model.apply(batch)[0]
        torch.cuda.synchronize()
    t_fwd = 1e3 * (time.perf_counter() - t0)
    fparts = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
    calls = {k: len(v) for k, v in events.items()}
    check(n_diff(again, logits) == 0 and calls == {
        "weight products": per_fwd["gemm_hilo"], "encoder": E, "decoder self": L, "cross": L},
          f"serve-encdec: the forward again, bitwise, its calls by part {calls}")
    print(f"serve-encdec: {smi_line()}; the forward over {T} frames and {ENCDEC_TEXT} tokens "
          f"{t_fwd:.3f} ms (host clock; {run['forward_ms']:.3f} on the main path), by part "
          f"(CUDA events): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in fparts.items())
          + f"; the rest {t_fwd - sum(fparts.values()):.3f} ms", flush=True)
    del again
    # ROADMAP queue 3, item 16: the decode's cross-attention adds exactly 0
    amax, real = [], attention.cross_decode_step

    def spy(*args):
        out = real(*args)
        amax.append(out.abs().amax())
        return out

    attention.cross_decode_step = spy
    try:
        check_routes_bitwise("serve-encdec", model, steps, 0)
    finally:
        attention.cross_decode_step = real
    top = float(torch.stack(amax).max())
    check(len(amax) == 4 * L and top == 0.0,
          f"serve-encdec: each decode step's cross-attention output is exactly 0 in all {L} "
          f"layers ({len(amax)} calls over the 2 replayed steps on both routes, max |out| "
          f"{top}): the cross cache is never filled (ROADMAP queue 3, item 16)")
    replay_fp64("serve-encdec", model, steps)
    launches = run["launches"]
    del model, run, steps, logits
    return launches


def serve_vlm_phase(dev):
    """qwen2-vl-72b at its published widths, cut to its first two layers;
    returns the launch counts of its main path."""
    import torch

    from repro_torch.configs import base, registry
    from repro_torch.core import dispatch
    from repro_torch.core.policy import column_blocks
    from repro_torch.models.transformer import Model

    cfg = registry.get_config(SERVE_VLM_ARCH, policy_name="ozaki2_int8", compute_dtype="float32",
                              param_dtype="bfloat16", num_layers=VLM_LAYERS)
    full = registry.get_config(SERVE_VLM_ARCH)
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    head = column_blocks(cfg.d_model, cfg.vocab_size)
    print(f"serve-vlm: {smi_line()}; {cfg.name}: d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff} "
          f"({cfg.mlp_act}), vocab {cfg.vocab_size} (untied), M-RoPE sections "
          f"{cfg.mrope_sections}, theta {cfg.rope_theta:g}; param_count {cfg.param_count()}, "
          f"{n_params} weights with the norms, in {cfg.param_dtype}, made on the card from a "
          f"seed in {t_build:.3f} s; policy {cfg.policy_name}, compute {cfg.compute_dtype}; the "
          f"LM head's product in {len(head)} column blocks ({[b - a for a, b in head]}). "
          f"Reduced: depth {L} of {full.num_layers} layers (the full {full.param_count()} "
          f"weights fit on no single card), bfloat16 storage, seeded weights in place of the "
          f"checkpoint, the vision frontend a stub (seeded patch embeddings); widths not cut",
          flush=True)
    per = products_per_call(cfg)
    check(per == products_per_call(cfg, forward=True) == {
        "gemm_hilo": 7 * L + len(head), "gemv_hilo": 0, "attention_fused": L},
          f"serve-vlm: a call launches gemm_hilo 7 a layer and {len(head)} for the LM head's "
          f"column blocks, attention_fused 1 a layer ({per})")
    rows, cols = VLM_GRID
    batch = registry.concrete_batch(cfg, base.SHAPES[1], batch=1, seq=rows * cols,
                                    seed=SEED + 11, device=dev)
    text_positions = batch.pop("positions")
    del batch["labels"]
    i = torch.arange(rows * cols, device=dev, dtype=torch.int32)
    batch["positions"] = torch.stack([0 * i, i // cols, i % cols])[None]   # t, h, w
    run = serve_requests("serve-vlm", model, dev, SEED + 10, {
        "matmul": (dispatch, "matmul"), "attention": (dispatch, "attention")}, batch)
    n, part, steps = run["n"], run["part"], run["steps"]
    check(run["calls"] == {"matmul": per["gemm_hilo"] * n, "attention": L * n},
          f"serve-vlm: per decode step one timed matmul per weight block and one attention "
          f"call per layer ({run['calls']})")
    rest = run["step_ms"] - part["matmul"] - part["attention"]
    print(f"serve-vlm: {smi_line()}; a decode step over {L} layers (CUDA events, mean): weight "
          f"products (dispatch.matmul, Phase 1 included) {part['matmul']:.3f} ms; "
          f"dispatch.attention {part['attention']:.3f} ms; the rest (M-RoPE angles, norms, "
          f"embedding, host) {rest:.3f} ms", flush=True)
    # the same embeddings with three equal streams: M-RoPE moved the output
    text = model.apply({"embeds": batch["embeds"], "positions": text_positions})[0]
    moved = n_diff(run["logits"], text)
    check(moved > 0 and bool(torch.isfinite(text).all()),
          f"serve-vlm: the {rows} x {cols} grid's positions (t = 0, h = row, w = column) against "
          f"three equal streams over the same embeddings: {moved} of {text.numel()} logits "
          f"differ (max |diff| {float((run['logits'] - text).abs().max()):.3e})")
    del text
    check_routes_bitwise("serve-vlm", model, steps, 0)
    replay_fp64("serve-vlm", model, steps)
    launches = run["launches"]
    del model, run, steps, batch
    return launches


class RecordedPolicy:
    """A precision policy that keeps, for each of its products C = A B, the
    operands A and B, the gradient g that reaches C, and the gradients dA and
    dB it sends back (each product's own, before any accumulation)."""

    def __init__(self, name):
        from repro_torch.core.policy import Policy

        self.policy = Policy(name)
        self.products = []

    def dot(self, x, w):
        rec = {"A": x.detach(), "B": w.detach()}
        xa, wb = x.view_as(x), w.view_as(w)
        xa.register_hook(lambda g: rec.__setitem__("dA", g))
        wb.register_hook(lambda g: rec.__setitem__("dB", g))
        out = self.policy.dot(xa, wb)
        out.register_hook(lambda g: rec.__setitem__("g", g))
        self.products.append(rec)
        return out


def scheme_error(c, x, y):
    """The error of an emulated product c = x y against native FP64 from the same
    x (m, k) and y (k, n): max |c - x y| / (|x| |y|) in u, and max |c - x y| over
    the schemes' bound, u (α_i ||y_j||_1 + ||x_i||_1 β_j) + 16 u (|x| |y|)_ij.
    α_i and β_j are the largest |x| in row i and |y| in column j: Phase 1
    scales each row and column by a power of two that puts its largest
    element in [2^52, 2^53) and rounds the rest to integers there, so each
    element moves by at most u times its row's or column's largest; both
    schemes then form the exact product of the rounded operands (Ozaki-I
    accumulates its S² slice products in float64), and the 16 u term covers
    the final rounding, that accumulation and native FP64's own error.  The
    first term is what a short contraction of widely ranging values exposes:
    there |x| |y| can be far below it."""
    import torch

    err = torch.matmul(x, y)
    err.sub_(c).abs_()
    absxy = torch.matmul(x.abs(), y.abs())
    rel = float((err / absxy).max()) / U
    bound = absxy.mul_(16 * U)
    ax, ay = x.abs(), y.abs()
    bound.add_(ax.amax(dim=1, keepdim=True) * ay.sum(dim=0, keepdim=True), alpha=U)
    bound.add_(ax.sum(dim=1, keepdim=True) * ay.amax(dim=0, keepdim=True), alpha=U)
    return rel, float(err.div_(bound).max())


def product_errors(products):
    """Each product's dA = g Bᵀ and dB = Aᵀ g against ``scheme_error``."""
    return [(scheme_error(p["dA"], p["g"], p["B"].T), scheme_error(p["dB"], p["A"].T, p["g"]))
            for p in products]


def vjp_phase(dev):
    """yi-6b's weight products at full width under autograd; returns gemm_hilo's
    launches on the kernel route's timed run."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import dispatch
    from repro_torch.core.policy import Policy
    from repro_torch.kernels import ozaki_gemm, ozaki_gemv
    from repro_torch.models import layers

    cfg = registry.get_config("yi-6b")
    d, f, vocab = cfg.d_model, cfg.d_ff, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    f64 = torch.float64
    mlp = layers.mlp_init(gen, d, f, f64, act=cfg.mlp_act)
    table = layers.embed_init(gen, vocab, d, f64)["table"]
    weights = {"wi_gate": mlp["wi_gate"]["w"], "wi_up": mlp["wi_up"]["w"],
               "wo": mlp["wo"]["w"], "table": table}
    x0 = torch.randn((VJP_ROWS, d), generator=gen, device=dev, dtype=f64)
    c = torch.randn((VJP_ROWS, vocab), generator=gen, device=dev, dtype=torch.float32)
    counts = (ozaki_gemm.gemm_hilo, ozaki_gemv.gemv_hilo)
    print(f"vjp: yi-6b's MLP ({d} -> {f} gate and up, {f} -> {d} down) and unembedding "
          f"({d} x {vocab}), x {VJP_ROWS} x {d}, float64; loss = sum(logits * c)", flush=True)

    def run(name, mode=None, record=False):
        pol = RecordedPolicy(name) if record else Policy(name)
        x = x0.detach().requires_grad_(True)
        leaves = {k: v.detach().requires_grad_(True) for k, v in weights.items()}
        params = {k: {"w": leaves[k]} for k in ("wi_gate", "wi_up", "wo")}
        with dispatch.mode_scope(mode):
            for k in counts:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = layers.mlp_apply(params, x, pol, act=cfg.mlp_act)
            loss = (layers.unembed_apply({"table": leaves["table"]}, h, pol) * c).sum()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fwd = {k.__name__: k.launches for k in counts}
            loss.backward()            # the CUDA backward runs on autograd's thread
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            bwd = {k.__name__: k.launches - fwd[k.__name__] for k in counts}
        grads = {"x": x.grad, **{k: v.grad for k, v in leaves.items()}}
        return {"grads": grads, "products": pol.products if record else None,
                "fwd_ms": 1e3 * (t1 - t0),
                "bwd_ms": 1e3 * (t2 - t1), "fwd": fwd, "bwd": bwd}

    def diff(ga, gb):
        return {k: n_diff(ga[k], gb[k]) for k in ga}

    def rel(ga, gb):
        return max(float((ga[k] - gb[k]).abs().max() / gb[k].abs().max()) for k in ga)

    def show(name, r):
        print(f"vjp: {name}: forward {r['fwd_ms']:.3f} ms, backward {r['bwd_ms']:.3f} ms "
              f"(host clock, synchronised); launches forward {r['fwd']}, backward "
              f"{r['bwd']}", flush=True)

    run("ozaki2_int8")                                    # warm-up at these shapes
    k8 = run("ozaki2_int8", record=True)
    show("ozaki2_int8, kernel route", k8)
    launches = k8["fwd"]["gemm_hilo"] + k8["bwd"]["gemm_hilo"]
    check(k8["fwd"] == {"gemm_hilo": 4, "gemv_hilo": 0} and
          k8["bwd"] == {"gemm_hilo": 8, "gemv_hilo": 0},
          f"vjp: gemm_hilo launched 4 times in the forward and 8 in the backward "
          f"({k8['fwd']}, {k8['bwd']})")
    names = ["wi_up", "wi_gate", "wo", "unembed"]

    def check_products(policy, errs):
        text = ", ".join(f"{n} dA {a[0]:.3f} u ({a[1]:.4f} of the bound), dB {b[0]:.3f} u "
                         f"({b[1]:.4f})" for n, (a, b) in zip(names, errs))
        check(len(errs) == 4 and all(a[0] <= 16 for a, _ in errs),
              f"vjp: {policy}, each product's dA within 16 u of |g||Bᵀ| (contractions of "
              f"4096 to 64000; native FP64 from the same g): {text}")
        check(all(a[1] <= 1 and b[1] <= 1 for a, b in errs),
              f"vjp: {policy}, each product's dA and dB within the schemes' bound "
              f"(scheme_error; dB contracts over the {VJP_ROWS} rows of x)")

    check_products("ozaki2_int8", product_errors(k8["products"]))
    k8["products"] = None
    r8 = run("ozaki2_int8", mode="ref")
    show("ozaki2_int8, reference route", r8)
    check(r8["fwd"] == r8["bwd"] == {"gemm_hilo": 0, "gemv_hilo": 0},
          "vjp: the reference route launches no kernel, forward or backward")
    d8 = diff(k8["grads"], r8["grads"])
    check(not any(d8.values()), f"vjp: kernel vs reference route, gradients of x and every "
          f"weight bitwise equal (differing elements {d8})")
    del r8
    fp8 = run("ozaki2_fp8")
    show("ozaki2_fp8 (the FP8 substrate, reference route)", fp8)
    d8 = diff(fp8["grads"], k8["grads"])
    check(not any(d8.values()), f"vjp: ozaki2_fp8 gradients bitwise equal to ozaki2_int8's "
          f"(differing elements {d8})")
    del fp8
    o1 = run("ozaki1_int8", record=True)
    show("ozaki1_int8", o1)
    check_products("ozaki1_int8", product_errors(o1["products"]))
    o1["products"] = None
    n64 = run("fp64")
    show("fp64 (torch.matmul float64)", n64)
    for name, r in (("ozaki2_int8", k8), ("ozaki1_int8", o1)):
        e = rel(r["grads"], n64["grads"])
        check(e <= VJP_CHAIN_TOL, f"vjp: {name} chain, max |grad - fp64 policy's grad| / "
              f"max |fp64 policy's grad| = {e:.3e} <= {VJP_CHAIN_TOL:g} for x and every weight")
    return launches


@contextlib.contextmanager
def step_parts(targets):
    """While the block runs, time each call of ``targets[name] = (owner,
    attribute)`` between CUDA events and count the kernels launched inside it;
    the recomputes of checkpointed layers (``transformer.recompute_scope``,
    entered in the backward) are counted under "recompute".  Yields {name:
    [(start event, end event, {kernel: launches})]}."""
    import torch

    from repro_torch.models import transformer

    parts = {name: [] for name in list(targets) + ["recompute"]}
    real = {name: getattr(owner, attr) for name, (owner, attr) in targets.items()}

    def delta(before):
        now = launch_counts()
        return {k: now[k] - before[k] for k in now}

    def wrap(name):
        def call(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before = launch_counts()
            a.record()
            out = real[name](*args, **kw)
            b.record()
            parts[name].append((a, b, delta(before)))
            return out
        return call

    real_scope = transformer.recompute_scope

    @contextlib.contextmanager
    def counted_scope(modes):
        before = launch_counts()
        try:
            with real_scope(modes):
                yield
        finally:        # the checkpoint ends its recompute early by raising
            parts["recompute"].append((None, None, delta(before)))

    for name, (owner, attr) in targets.items():
        setattr(owner, attr, wrap(name))
    transformer.recompute_scope = counted_scope
    try:
        yield parts
    finally:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, real[name])
        transformer.recompute_scope = real_scope


def train_phase(dev):
    """yi-6b's training step at full width on the kernel route; returns the
    launches of the timed steps."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import dispatch
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = registry.get_config(TRAIN_ARCH, num_layers=TRAIN_LAYERS, policy_name="ozaki2_int8",
                              compute_dtype="float32")
    full = registry.get_config(TRAIN_ARCH)
    opt_cfg = adamw.AdamWConfig()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train: {cfg.name} d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_layers} "
          f"of {full.num_layers} layers; policy {cfg.policy_name}, {cfg.param_dtype} weights "
          f"and compute {cfg.compute_dtype}, remat {cfg.remat}; AdamW {opt_cfg}, warm-up 1 "
          f"step; batches of {TRAIN_BATCH} x {TRAIN_SEQ} from Pipeline", flush=True)
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED + 7))
    init = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    n = sum(v.numel() for v in init.values())
    lm = cfg.d_model * cfg.vocab_size
    gib = 2.0 ** 30
    print(f"train: {n} weights ({4 * n / gib:.2f} GiB float32); reckoned before the run: "
          f"weights, gradients and the two moments {16 * n / gib:.2f} GiB, Ozaki2Dot's float64 "
          f"copy of the LM head kept for its backward {8 * lm / gib:.2f} GiB (the layers' are "
          f"recomputed under remat), Phase 1 of the LM head ~8 float64 copies "
          f"{64 * lm / gib:.2f} GiB at once", flush=True)
    pipe = Pipeline(DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED), cfg,
                    device=dev)
    batches = [next(pipe) for _ in range(1 + TRAIN_STEPS)]
    pipe.close()

    def fresh(model):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(init[k])
        return loop.make_train_step(model, opt_cfg, warmup_steps=1), \
            adamw.adamw_init(dict(model.named_parameters()), opt_cfg)

    def kept(res):
        """A step's loss, gradients, moments and updated parameters, kept on
        the card (the parameters copied: the next step updates them in place)."""
        opt, metrics, grads = res
        return {"loss": float(metrics["loss"]), "grads": grads, "m": opt["m"], "v": opt["v"],
                "params": {k: p.detach().clone() for k, p in model.named_parameters()}}

    # the first step on the reference route, while the card holds least: its
    # plain products keep every modulus's plane of the LM head's 4096 x 64000
    # weight gradient at once
    step, opt = fresh(model)
    launch_counts(reset=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with dispatch.mode_scope("ref"):
        ref = kept(step(opt, batches[0]))
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    ref_launches = launch_counts()
    ref_peak = torch.cuda.max_memory_allocated() / gib
    del opt
    print(f"train: the first step on the reference route {t_ref:.3f} s (host clock), peak "
          f"memory {ref_peak:.3f} GiB; launches {ref_launches}", flush=True)
    check(not any(ref_launches.values()), "train: the reference route launched no kernel")

    # the same step on the kernel route (the warm-up), held against it
    step, opt = fresh(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = step(opt, batches[0])
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    opt = res[0]
    first = kept(res)
    del res
    diffs = {key: sum(n_diff(ref[key][k], first[key][k]) for k in first[key])
             for key in ("grads", "params", "m", "v")}
    print(f"train: warm-up step {t_warm:.3f} s (host clock), loss {first['loss']:.6f}",
          flush=True)
    check(ref["loss"] == first["loss"] and not any(diffs.values()),
          f"train: reference vs kernel route, one step from the same parameters and batch: "
          f"loss {ref['loss']!r} vs {first['loss']!r}, differing elements {diffs}")
    del ref
    L = cfg.num_layers
    g = first.pop("grads")
    zeros = [k for k in g if k.endswith(("mixer.wq.w", "mixer.wk.w", "mixer.wv.w"))]
    check(len(zeros) == 3 * L and all(not g[k].any() for k in zeros),
          f"train: every layer's wq, wk and wv gradient is exactly 0 under ozaki2_int8 "
          f"(ROADMAP queue 3, item 17; {len(zeros)} tensors)")
    others = [k for k in g if k not in zeros]
    nonzero = [k for k in others if g[k].any()]
    check(all(bool(torch.isfinite(g[k]).all()) for k in others) and nonzero,
          f"train: every other gradient is finite, {len(nonzero)} of {len(others)} non-zero "
          f"(zero: {sorted(set(others) - set(nonzero))})")
    still = {k for k, p in first["params"].items() if not (p.any() or g[k].any())}
    held = ("lm_head.w", f"layers.{L - 1}.mlp.wi_gate.w", f"layers.{L - 1}.mlp.wi_up.w",
            f"layers.{L - 1}.mlp.wo.w")
    g = {k: g[k] for k in held}
    del first["m"], first["v"]

    # the main path: TRAIN_STEPS steps on the kernel route, launch counts from 0
    targets = {"forward": (Model, "apply"), "loss": (loop, "cross_entropy_loss"),
               "backward": (torch.autograd, "grad"), "clip": (adamw, "clip_by_global_norm"),
               "update": (adamw, "adamw_update")}
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    with step_parts(targets) as parts:
        for b in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt, metrics, grads = step(opt, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            del grads
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / gib
    step_ms = 1e3 * statistics.mean(times)
    by_part = {name: statistics.mean(a.elapsed_time(b) for a, b, _ in calls)
               for name, calls in parts.items() if name != "recompute"}
    per = {name: {k: sum(c[2][k] for c in calls) // TRAIN_STEPS
                  for k in ("gemm_hilo", "attention_fused")} for name, calls in parts.items()}
    bwd_own = {k: per["backward"][k] - per["recompute"][k] for k in per["backward"]}
    print(f"train: {TRAIN_STEPS} steps at {step_ms:.3f} ms each (mean, host clock; "
          f"{[round(1e3 * t, 3) for t in times]}), {tokens / (step_ms / 1e3):.1f} tokens/s; by "
          f"part (CUDA events, mean a step): " + "; ".join(f"{k} {v:.3f} ms" for k, v in
                                                            by_part.items()) +
          f"; peak memory {peak:.3f} GiB (max_memory_allocated, the warm-up step's state "
          f"kept beside); losses {losses}", flush=True)
    print(f"train: launches a step: forward {per['forward']}, backward {per['backward']} of which "
          f"remat's recompute {per['recompute']} and the backward's own products {bwd_own}; "
          f"in all {launches}", flush=True)
    want_fwd = {"gemm_hilo": 7 * L + 1, "attention_fused": L}
    check(per["forward"] == want_fwd and per["recompute"] == {"gemm_hilo": 7 * L,
                                                              "attention_fused": L}
          and bwd_own == {"gemm_hilo": 2 * (7 * L + 1), "attention_fused": 0},
          f"train: a step launches gemm_hilo 7 x {L} + 1 and attention_fused {L} in the forward, "
          f"the same again in remat's recompute, and gemm_hilo 2 x (7 x {L} + 1) in the backward "
          f"(dA and dB of every weight product; attention's gradient is exactly 0)")
    check(launches["gemm_hilo"] == TRAIN_STEPS * (28 * L + 3) and
          launches["attention_fused"] == TRAIN_STEPS * 2 * L and launches["gemv_hilo"] == 0,
          f"train: the {TRAIN_STEPS} steps launched gemm_hilo and attention_fused on the main "
          f"path ({launches})")
    moved = {k for k, p in model.named_parameters() if not torch.equal(p, first["params"][k])}
    check(all(math.isfinite(x) for x in losses) and moved == set(first["params"]) - still,
          f"train: the {TRAIN_STEPS} steps' losses are finite ({losses}) and every parameter "
          f"moved ({len(moved)} of {len(first['params'])}) but those that are 0 with a 0 "
          f"gradient, which weight decay leaves at 0 ({sorted(still)})")

    # the fp64 policy from the same parameters and batch
    del model, step, opt, first["params"]
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(dataclasses.replace(cfg, policy_name="fp64")).load(
        {k: v.to(dev) for k, v in init.items()})
    step, opt = fresh(model)
    _, metrics, grads = step(opt, batches[0])
    loss64 = float(metrics["loss"])
    gap = abs(first["loss"] - loss64) / abs(loss64)
    rel = {k: float((grads[k] - g[k]).abs().max() / grads[k].abs().max()) for k in held}
    print(f"train: fp64 policy, first step loss {loss64!r} (ozaki2_int8 {first['loss']!r}); "
          f"relative gap of the gradients max |ozaki2_int8 - fp64| / max |fp64|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()), flush=True)
    check(gap <= TRAIN_LOSS_TOL, f"train: the first step's loss within {TRAIN_LOSS_TOL:g} of the "
          f"fp64 policy's, relative ({gap:.3e})")
    del model, step, opt, grads, g, init, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"gemm_hilo": launches["gemm_hilo"], "attention_fused": launches["attention_fused"]}


@contextlib.contextmanager
def host_timed(targets):
    """While the block runs, record the host clock's (start, end) of every
    call of ``targets[name] = (owner, attribute)``.  Yields {name: [(start,
    end)]}."""
    calls = {name: [] for name in targets}
    real = {name: getattr(owner, attr) for name, (owner, attr) in targets.items()}

    def wrap(name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kw)
            finally:
                calls[name].append((t0, time.perf_counter()))
        return call

    for name, (owner, attr) in targets.items():
        setattr(owner, attr, wrap(name))
    try:
        yield calls
    finally:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, real[name])


def bits_differ(a, b):
    """Count of elements whose bit patterns differ (dtypes must agree)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return max(a.numel(), b.numel())
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return int((a != b).sum())


def resume_phase(dev):
    """yi-6b's training resumed after an injected failure at full width, and
    the launcher's CLI resumed from its checkpoint; returns the launches of
    both main paths."""
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint, fault_tolerance, loop

    t_phase = time.perf_counter()
    cfg = registry.get_config(TRAIN_ARCH, num_layers=TRAIN_LAYERS, policy_name="ozaki2_int8",
                              compute_dtype="float32")
    opt_cfg = adamw.AdamWConfig(moment_dtype="bfloat16")
    L = cfg.num_layers
    os.makedirs(CKPT_ROOT, exist_ok=True)
    disk = shutil.disk_usage(CKPT_ROOT)
    print(f"resume: {cfg.name} at full width, {L} of {registry.get_config(TRAIN_ARCH).num_layers} "
          f"layers, {cfg.policy_name}, float32 weights and compute, remat {cfg.remat}; AdamW "
          f"with {opt_cfg.moment_dtype} moments; batches of {TRAIN_BATCH} x {TRAIN_SEQ}; "
          f"{RESUME_STEPS} steps, a checkpoint every {RESUME_CKPT_EVERY}, a StepFailure on call "
          f"{RESUME_FAIL_CALL}; disk at {CKPT_ROOT} before the phase: {disk.free / 1e9:.1f} GB "
          f"free of {disk.total / 1e9:.1f} GB (shutil.disk_usage)", flush=True)
    root = tempfile.mkdtemp(dir=CKPT_ROOT)
    pipe = Pipeline(DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED), cfg,
                    device=dev)
    try:
        batches = [next(pipe) for _ in range(RESUME_STEPS)]
    finally:
        pipe.close()
    try:
        model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED + 8))
        params = dict(model.named_parameters())
        init = checkpoint.snapshot(params)
        step = loop.make_train_step(model, opt_cfg, warmup_steps=1, total_steps=RESUME_STEPS)
        n = sum(p.numel() for p in params.values())
        nbytes = sum(p.numel() * p.element_size() for p in params.values()) + 2 * 2 * n + 4

        # the main path: the uninterrupted steps, then the recovery run
        launch_counts(reset=True)
        opt = adamw.adamw_init(params, opt_cfg)
        for b in batches:
            opt, _, _ = step(opt, b)
        torch.cuda.synchronize()
        want = {"params": {k: p.detach().clone() for k, p in params.items()}, "opt": opt}
        del opt
        loop.load_params(model, init)

        calls, delays = [0], []

        def step_fn(i, state):
            calls[0] += 1
            if calls[0] == RESUME_FAIL_CALL:
                raise fault_tolerance.StepFailure(f"injected on call {calls[0]}")
            live = loop.load_params(model, state["params"])
            new_opt, metrics, _ = step(state["opt"], batches[i])
            return {"params": live, "opt": new_opt}, metrics

        ckpt_dir = os.path.join(root, "run")
        targets = {"snapshot": (checkpoint, "snapshot"), "write": (checkpoint, "save"),
                   "save": (checkpoint.AsyncWriter, "save"),
                   "restore": (checkpoint, "restore")}
        t0 = time.perf_counter()
        with host_timed(targets) as timed:
            state, stats = fault_tolerance.run_with_recovery(
                step_fn, {"params": params, "opt": adamw.adamw_init(params, opt_cfg)},
                num_steps=RESUME_STEPS, ckpt_dir=ckpt_dir, ckpt_every=RESUME_CKPT_EVERY,
                sleep=delays.append)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = launch_counts()
        got = {"params": state["params"], "opt": state["opt"]}
        diff = {f"{part}/{k}": bits_differ(got[part][k], want[part][k])
                for part in ("params",) for k in want["params"]}
        diff.update({f"opt/{m}/{k}": bits_differ(got["opt"][m][k], want["opt"][m][k])
                     for m in ("m", "v") for k in want["opt"]["m"]})
        diff["opt/step"] = bits_differ(got["opt"]["step"], want["opt"]["step"])
        by_part = {part: sum(v for k, v in diff.items() if k.startswith(part))
                   for part in ("params", "opt/m", "opt/v", "opt/step")}
        print(f"resume: recovery run {t_run:.3f} s (host clock), stats {stats}, delays {delays}; "
              f"differing elements against {RESUME_STEPS} uninterrupted steps: {by_part}",
              flush=True)
        check(stats == {"failures": 1, "restores": 1, "steps_run": RESUME_STEPS}
              and delays == [1.0],
              f"resume: run_with_recovery took one failure and one restore and ran "
              f"{RESUME_STEPS} steps ({stats}, delays {delays})")
        check(not any(diff.values()) and int(got["opt"]["step"]) == RESUME_STEPS
              and got["opt"]["m"]["lm_head.w"].dtype == torch.bfloat16,
              f"resume: after the failure and the restore, the parameters, bfloat16 moments and "
              f"step are bitwise the uninterrupted run's ({sum(diff.values())} differing "
              f"elements of {3 * n + 1})")
        files = [os.path.join(ckpt_dir, f"step_{s:08d}", "host0000.npz")
                 for s in (RESUME_CKPT_EVERY, RESUME_STEPS)]
        sizes = [os.path.getsize(f) for f in files]
        counted = {name: len(v) for name, v in timed.items()}
        check(counted == {"snapshot": 3, "write": 2, "save": 2, "restore": 1},
              f"resume: run_with_recovery's entry snapshot, two saves (a snapshot and a write "
              f"each) and one restore ({counted})")
        gb = nbytes / 1e9
        for i, (size, f) in enumerate(zip(sizes, files)):
            (s0, _), (p0, p1), (w0, w1) = timed["save"][i], timed["snapshot"][i + 1], \
                timed["write"][i]
            print(f"resume: save of {os.path.basename(os.path.dirname(f))}: {nbytes} bytes of "
                  f"leaves ({size} on disk), from AsyncWriter.save to the end of its write (what "
                  f"wait() waits for) {w1 - s0:.3f} s ({gb / (w1 - s0):.3f} GB/s): the host "
                  f"snapshot {p1 - p0:.3f} s, the write and checksums on the thread "
                  f"{w1 - w0:.3f} s (into the page cache: no fsync)", flush=True)
        (r0, r1), (e0, e1) = timed["restore"][0], timed["snapshot"][0]
        print(f"resume: restore with verify {r1 - r0:.3f} s ({gb / (r1 - r0):.3f} GB/s; the "
              f"file was just written, so the read was warm); run_with_recovery's entry "
              f"snapshot {e1 - e0:.3f} s", flush=True)
        per_step = {"gemm_hilo": 28 * L + 3, "attention_fused": 2 * L}
        steps_run = RESUME_STEPS + stats["steps_run"]
        print(f"resume: launches {launches} over {steps_run} steps", flush=True)
        check(launches == {"gemm_hilo": steps_run * per_step["gemm_hilo"], "gemv_hilo": 0,
                           "attention_fused": steps_run * per_step["attention_fused"],
                           "carry_fold": 0},
              f"resume: the {steps_run} steps launched gemm_hilo {per_step['gemm_hilo']} and "
              f"attention_fused {per_step['attention_fused']} a step (the train phase's "
              f"formula)")
        del model, step, state, got, want, init, params, batches
        gc.collect()
        torch.cuda.empty_cache()

        # the launcher's CLI, whole and then resumed after its last checkpoint is moved aside
        cli_dir, aside = os.path.join(root, "cli"), os.path.join(root, "aside")
        argv = ["--arch", TRAIN_ARCH, "--smoke", "--policy", "ozaki2_int8", "--steps",
                str(CLI_STEPS), "--ckpt-every", str(CLI_EVERY), "--device", "cuda",
                "--ckpt-dir", cli_dir]
        last = f"step_{CLI_STEPS:08d}"
        outs = []
        launch_counts(reset=True)
        for run in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                launch_train.main(argv)
            outs.append(buf.getvalue())
            for line in outs[-1].splitlines():
                print(f"resume: cli run {run + 1}: {line}", flush=True)
            if run == 0:
                os.makedirs(aside)
                os.replace(os.path.join(cli_dir, last), os.path.join(aside, last))
        cli_launches = launch_counts()
        smoke = registry.get_config(TRAIN_ARCH, smoke=True)
        cli_steps = CLI_STEPS + (CLI_STEPS - CLI_EVERY)
        want_cli = {"gemm_hilo": cli_steps * (28 * smoke.num_layers + 3), "gemv_hilo": 0,
                    "attention_fused": cli_steps * 2 * smoke.num_layers, "carry_fold": 0}
        manifests = [json.load(open(os.path.join(d, last, checkpoint.MANIFEST)))
                     for d in (cli_dir, aside)]
        with np.load(os.path.join(cli_dir, last, "host0000.npz")) as z1, \
                np.load(os.path.join(aside, last, "host0000.npz")) as z2:
            cli_diff = [k for k in z1.files if z1[k].tobytes() != z2[k].tobytes()]
            same_keys = z1.files == z2.files
        check("resumed" not in outs[0] and f"resumed from step {CLI_EVERY}" in outs[1]
              and all(o.rstrip().endswith("done") for o in outs),
              f"resume: the CLI ran {CLI_STEPS} steps, then resumed from step {CLI_EVERY}")
        check(same_keys and not cli_diff and manifests[0] == manifests[1],
              f"resume: the CLI's resumed step {CLI_STEPS} is bitwise its uninterrupted step "
              f"{CLI_STEPS} ({len(cli_diff)} leaves differ of {len(manifests[0]['dtypes'])}; "
              f"manifests equal: {manifests[0] == manifests[1]})")
        check(cli_launches == want_cli,
              f"resume: the CLI's {cli_steps} steps launched {cli_launches} (the train phase's "
              f"formula at {smoke.num_layers} layers: {want_cli})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"resume: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: launches[k] + cli_launches[k] for k in ("gemm_hilo", "attention_fused")}


def tme_phase(dev, gen, kernel_ms):
    """The TME instrument on the card: every kind under counters telemetry on the
    kernel route, checked against the phase's own CUDA events; returns the
    launches of every kernel in it."""
    import torch

    from repro_torch.core import compensated, dispatch, tme
    from repro_torch.hpc import jacobi
    from repro_torch.kernels import (carry_fold, ozaki_attention, ozaki_gemm, ozaki_gemv,
                                     ozaki_spmv, ozaki_stencil)
    from repro_torch.obs import report, telemetry as obs

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)

    a, b, x1 = randn(N, N), randn(N, N), randn(N, 1)
    u = randn(GRID, GRID, GRID)
    c = jacobi.laplacian_coeffs(device=dev)
    a_val, a_col = hpcg_operator(HPCG_N, dev)
    xs = randn(HPCG_N ** 3)
    pq = [randn(32, 512, ATTN_D) for _ in range(3)]
    causal = torch.tril(torch.ones((512, 512), dtype=torch.int8, device=dev))
    dq, dk, dv = randn(64, 1, ATTN_D), randn(64, LONG_CTX, ATTN_D), randn(64, LONG_CTX, ATTN_D)
    ring = (torch.arange(LONG_CTX, device=dev) <= LONG_CTX - 2).to(torch.int8)[None, None] \
        .expand(64, 1, LONG_CTX)
    # (name, kind, dims, call, repetitions)
    cases = [
        ("gemm", "gemm", (N, N, N), lambda: dispatch.matmul(a, b), 3),
        ("gemv", "gemv", (N, N, 1), lambda: dispatch.matmul(a, x1), 5),
        ("stencil7", "stencil7", (GRID,) * 3, lambda: dispatch.stencil7(u, c), 5),
        ("spmv_bell", "spmv_bell", (HPCG_N ** 3, 27, HPCG_N ** 3),
         lambda: dispatch.spmv(a_val, a_col, xs), 5),
        ("attention prefill", "attention", (32, 512, ATTN_D, 512),
         lambda: dispatch.attention(*pq, mask=causal), 5),
        ("attention decode", "attention", (64, 1, ATTN_D, LONG_CTX),
         lambda: dispatch.attention(dq, dk, dv, mask=ring), 5),
        ("reduce", "reduce", (GRID ** 3,), lambda: compensated.compensated_norm(u), 5),
    ]
    for _, _, _, fn, _ in cases:                        # warm-up, outside the counts
        fn()
    kernels = (ozaki_gemm.gemm_hilo, ozaki_gemv.gemv_hilo, ozaki_stencil.stencil7,
               ozaki_spmv.spmv_bell, ozaki_attention.attention_fused, carry_fold.norm_scale,
               carry_fold.block_tree, carry_fold.carry_fold)
    for k in kernels:
        k.launches = 0
    obs.reset()
    torch.cuda.synchronize()
    events = {}
    with obs.telemetry_scope("counters"):
        for name, _, _, fn, reps in cases:
            for _ in range(reps):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                events.setdefault(name, []).append((e0, e1))
        pending = len(obs._pending)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    check(pending == sum(reps for *_, reps in cases),
          f"tme: counters mode left every CUDA event pair unresolved until the snapshot "
          f"({pending} pending)")
    snap = obs.snapshot()
    want = {"gemm_hilo": 3, "gemv_hilo": 5, "stencil7": 5, "spmv_bell": 5,
            "attention_fused": 10, "norm_scale": 5, "block_tree": 5, "carry_fold": 5}
    check(launches == want, f"tme: kernel launches {launches}")
    with obs.telemetry_scope("off"):
        dispatch.matmul(a, x1)
        compensated.compensated_norm(u)
    check(obs.snapshot()["counters"] == snap["counters"] and not obs._pending,
          "tme: telemetry_scope('off') records nothing")
    print(report.render(report.table_rows(snap), chip=snap["chip"]), flush=True)
    counters = {(ct["kind"], ct["shape_class"], ct["route"]): ct for ct in snap["counters"]}
    rows = []
    for name, kind, dims, _, reps in cases:
        ct = counters.get((kind, dispatch.shape_class(dims), "kernel"))
        own_us = 1e3 * sum(e0.elapsed_time(e1) for e0, e1 in events[name])
        tel_us = ct["us"] if ct else 0.0
        ok = ct is not None and ct["calls"] == reps and abs(tel_us - own_us) <= 0.1 * own_us
        check(ok, f"tme: {name}: telemetry {tel_us / reps:.3f} us a call against the phase's "
              f"CUDA events {own_us / reps:.3f} us ({reps} calls), within 10%")
        tme_us = ct["tme_us"] / reps if ct else float("nan")
        k_us = 1e3 * kernel_ms[name]
        rows.append((name, tel_us / reps, k_us, tme_us))
        print(f"tme: {name} {dims}: measured seam {tel_us / reps:.3f} us, kernel {k_us:.3f} us "
              f"(this run's kernel phase), TME (H100, kernel route, beta = 1) {tme_us:.3f} us; "
              f"measured / TME {tel_us / reps / tme_us:.3f}, kernel / TME "
              f"{k_us / tme_us:.3f}", flush=True)
    check(snap["chip"] == tme.DEFAULT_CHIP.name == "H100", f"tme: chip model {snap['chip']}")
    obs.reset()
    return launches


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import dispatch, splitting
    from repro_torch.hpc import cg
    from repro_torch.kernels import _build, carry_fold, ops, ozaki_gemm, ozaki_gemv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t_start = time.perf_counter()

    def stamp(phases):
        print(f"clock: {phases} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)

    def hilo(x, plan, axis):
        xi, _ = splitting.scale_to_int(x, plan.payload_bits, axis)
        return splitting.split_hi_lo(xi)

    # ---------------------------------------------------------------- setup
    card = smi_line()
    print(f"card: {card}", flush=True)
    print(f"setup: torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    reports = _build.build(_build.SOURCES + _build.PROBES)
    print(f"setup: built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        spilled = [s for s in re.findall(r"(\d+) bytes spill", text) if int(s)]
        print(f"setup: {name}: {text.count('registers')} kernel instances, "
              f"{len(spilled)} spill counts above 0 (nvcc -Xptxas -v)", flush=True)

    # ----------------------------------------------------------------- data
    a = randn(N, N)
    b = randn(N, N)
    a[7] *= 1e-300                       # a row scaled by more than 2^1023
    ell, noise = 0.2, 0.1                # RBF length scale, noise variance
    pts = torch.rand((N, 3), generator=gen, device=dev, dtype=torch.float64)
    kmat = torch.exp(-((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1) / (2 * ell * ell))
    kmat.diagonal().add_(noise)
    del pts
    y = randn(N)
    torch.cuda.synchronize()

    # ----------------------------------------------------------------- main
    ozaki_gemm.gemm_hilo.launches = 0
    ozaki_gemv.gemv_hilo.launches = 0
    reduce_counts(carry_fold, reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_main = dispatch.matmul(a, b)
    torch.cuda.synchronize()
    t_gemm = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_k = cg.cg_solve_dense(kmat, y, tol=1e-10, maxiter=1000)
    torch.cuda.synchronize()
    t_cg_k = time.perf_counter() - t0
    launches = {"gemm_hilo": ozaki_gemm.gemm_hilo.launches,
                "gemv_hilo": ozaki_gemv.gemv_hilo.launches}
    REDUCE_LAUNCHES["dense CG"] = reduce_counts(carry_fold)
    GEMM_LAUNCHES["DGEMM"] = launches["gemm_hilo"]
    GEMV_LAUNCHES["dense CG"] = launches["gemv_hilo"]
    print(f"main: dispatch.matmul {N}^3 {t_gemm * 1e3:.1f} ms (first call); "
          f"cg_solve_dense n={N}: {res_k.iters} iterations, converged={res_k.converged}; "
          f"launches {launches}", flush=True)
    check(launches["gemm_hilo"] == 1, "main: gemm_hilo launched once for the DGEMM")
    check(launches["gemv_hilo"] == res_k.iters + 1,
          f"main: gemv_hilo launched iterations + 1 = {res_k.iters + 1} times")
    check(REDUCE_LAUNCHES["dense CG"] == cg_reductions(res_k.iters),
          f"main: a norm (norm_scale once) and 2 * iterations + 1 dots, each one block_tree "
          f"and one carry_fold ({REDUCE_LAUNCHES['dense CG']})")

    # ----------------------------------------------------------------- gemm
    plan = dispatch.get_plan(N)
    check(plan.r == 16, f"gemm: plan r = {plan.r} (required_r(8192) = 16)")
    c_ref = dispatch.matmul(a, b, mode="ref")
    check(n_diff(c_main, c_ref) == 0,
          f"gemm: kernel vs reference route, {n_diff(c_main, c_ref)} differing elements")
    err = rel_err_u(c_main, a, b)
    err_tiny = rel_err_u(c_main[7:8], a[7:8], b)
    check(err <= 16 and err_tiny <= 16,
          f"gemm: error vs native FP64 {err:.3f} u (row at 1e-300: {err_tiny:.3f} u) <= 16 u")
    del c_ref
    ah, al = hilo(a, plan, -1)
    bh, bl = hilo(b, plan, 0)
    k_out = ozaki_gemm.gemm_hilo(ah, al, bh, bl, plan)
    p_out = ozaki_gemm.gemm_hilo_ref(ah, al, bh, bl, plan)
    gemm_err = float((k_out - p_out).abs().max())
    check(n_diff(k_out, p_out) == 0, f"gemm: gemm_hilo vs plain version at {N}^3, "
          f"{n_diff(k_out, p_out)} differing elements")
    del k_out, p_out
    gemm_ms = time_ms(lambda: ozaki_gemm.gemm_hilo(ah, al, bh, bl, plan), reps=5)
    gemm_plain_ms = time_ms(lambda: ozaki_gemm.gemm_hilo_ref(ah, al, bh, bl, plan), reps=3)
    gemm_lib_ms = time_ms(lambda: torch.matmul(a, b), reps=5)
    seam_k_ms = time_ms(lambda: dispatch.matmul(a, b), reps=3)
    seam_r_ms = time_ms(lambda: dispatch.matmul(a, b, mode="ref"), reps=3)
    g_bound, g_by = bound(N, N, N, plan.r)
    earlier = EARLIER_MS[f"gemm_hilo {N}^3"]
    print(f"gemm: gemm_hilo {gemm_ms:.3f} ms (PERF.md's earlier {earlier:.3f} ms, "
          f"{earlier / gemm_ms:.2f}x), bound {g_bound:.3f} ms ({g_by}), plain "
          f"{gemm_plain_ms:.3f} ms, torch.matmul f64 {gemm_lib_ms:.3f} ms; dispatch.matmul "
          f"kernel route {seam_k_ms:.3f} ms, reference route {seam_r_ms:.3f} ms", flush=True)
    busy, parts = profiled(lambda: ozaki_gemm.gemm_hilo(ah, al, bh, bl, plan), 2)
    print(f"gemm: device time of gemm_hilo at {N}^3 by stage {busy:.3f} ms (torch.profiler): "
          f"{parts_text(parts)}", flush=True)
    del ah, al, bh, bl, c_main

    # ----------------------------------------------------------------- gemv
    gemv = {}
    for n in (1, 8, 16):
        x = randn(N, n)
        yk = dispatch.matmul(a, x)
        yr = dispatch.matmul(a, x, mode="ref")
        e = rel_err_u(yk, a, x)
        check(n_diff(yk, yr) == 0 and e <= 16,
              f"gemv: {N}x{N}x{n} kernel vs reference route {n_diff(yk, yr)} differing, "
              f"error {e:.3f} u")
        xh, xl = hilo(x, plan, 0)
        ah, al = hilo(a, plan, -1)
        k_out = ozaki_gemv.gemv_hilo(ah, al, xh, xl, plan)
        p_out = ozaki_gemv.gemv_hilo_ref(ah, al, xh, xl, plan)
        check(n_diff(k_out, p_out) == 0, f"gemv: gemv_hilo vs plain version at n={n}, "
              f"{n_diff(k_out, p_out)} differing elements")
        t = {"err": float((k_out - p_out).abs().max()),
             "ms": time_ms(lambda: ozaki_gemv.gemv_hilo(ah, al, xh, xl, plan), reps=10),
             "plain_ms": time_ms(lambda: ozaki_gemv.gemv_hilo_ref(ah, al, xh, xl, plan),
                                 reps=3),
             "library_ms": time_ms(lambda: torch.matmul(a, x), reps=10),
             "seam_ms": time_ms(lambda: dispatch.matmul(a, x), reps=5),
             "seam_ref_ms": time_ms(lambda: dispatch.matmul(a, x, mode="ref"), reps=3)}
        gemv[n] = t
        earlier = EARLIER_MS[f"gemv_hilo n={n}"]
        print(f"gemv: n={n} gemv_hilo {t['ms']:.3f} ms (PERF.md's earlier {earlier:.3f} ms, "
              f"{earlier / t['ms']:.2f}x), bound {bound(N, N, n, plan.r)[0]:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms, torch.matmul f64 {t['library_ms']:.3f} ms; "
              f"dispatch.matmul kernel route {t['seam_ms']:.3f} ms, reference route "
              f"{t['seam_ref_ms']:.3f} ms", flush=True)
        busy, parts = profiled(lambda: ozaki_gemv.gemv_hilo(ah, al, xh, xl, plan), 5)
        print(f"gemv: n={n} device time by kernel {busy:.3f} ms (torch.profiler): "
              f"{parts_text(parts)}", flush=True)
        del ah, al, xh, xl, k_out, p_out
    del a, b

    # --------------------------------------------------------------- ragged
    for m, k, n in ((1000, 1537, 777), (1000, 1537, 5)):
        ra, rb = randn(m, k), randn(k, n)
        ck = dispatch.matmul(ra, rb)
        cr = dispatch.matmul(ra, rb, mode="ref")
        e = rel_err_u(ck, ra, rb)
        check(n_diff(ck, cr) == 0 and e <= 16,
              f"ragged: {m}x{k}x{n} kernel vs reference route {n_diff(ck, cr)} differing, "
              f"error {e:.3f} u")
    for m, k, n in ((1000, 1537, 777), (1000, 1537, 5), (1000, 256, 777), (1000, 256, 5)):
        ra, rb = randn(m, k), randn(k, n)
        p = dispatch.get_plan(k)
        pa, pb, _ = dispatch.pad_operands(ra, rb)
        ah, al = hilo(pa, p, -1)
        bh, bl = hilo(pb, p, 0)
        narrow = n <= dispatch.GEMV_MAX_B
        kern = ozaki_gemv.gemv_hilo if narrow else ozaki_gemm.gemm_hilo
        plain = ozaki_gemv.gemv_hilo_ref if narrow else ozaki_gemm.gemm_hilo_ref
        for rep in ("f64", "digits", "ds"):
            d = n_diff(kern(ah, al, bh, bl, p, rep), plain(ah, al, bh, bl, p, rep))
            check(d == 0, f"ragged: {kern.__name__} {rep} {m}x{k}x{n} (r={p.r}) vs plain "
                  f"version, {d} differing elements")
        f64 = ops.ozaki_gemv(ra, rb) if narrow else ops.ozaki_gemm(ra, rb)
        fin = ops.ozaki_gemv if narrow else ops.ozaki_gemm
        check(n_diff(fin(ra, rb, out_rep="digits"), f64) == 0,
              f"ragged: ops digits == f64 at {m}x{k}x{n}")
        ds = fin(ra, rb, out_rep="ds")
        if p.r <= 15:   # the reference's ds split overflows float32 from r = 16 on
            e = float(((ds - f64).abs() / torch.matmul(ra.abs(), rb.abs())).max())
            check(e <= 2.0 ** -44, f"ragged: ops ds within 2^-44 of f64 ({e:.3e}) at r={p.r}")
        else:
            print(f"ragged: ops ds at r={p.r} is NaN in {int(torch.isnan(ds).sum())} of "
                  f"{ds.numel()} elements, as in the reference", flush=True)

    # ------------------------------------------------------------------- cg
    t0 = time.perf_counter()
    res_r = cg.cg_solve_dense(kmat, y, tol=1e-10, maxiter=1000, mode="ref")
    torch.cuda.synchronize()
    t_cg_r = time.perf_counter() - t0
    rel = float(torch.linalg.vector_norm(kmat @ res_k.x - y) / torch.linalg.vector_norm(y))
    check(res_k.converged and res_r.converged,
          f"cg: both routes converge ({res_k.iters} and {res_r.iters} iterations)")
    check(res_k.history == res_r.history,
          "cg: compensated residual histories bitwise equal across routes")
    check(rel <= 1e-9, f"cg: ||Kx - y|| / ||y|| = {rel:.3e} <= 1e-9")
    print(f"cg: n={N}, {res_k.iters} iterations; kernel route "
          f"{t_cg_k * 1e3 / max(res_k.iters, 1):.3f} ms/iteration, reference route "
          f"{t_cg_r * 1e3 / max(res_r.iters, 1):.3f} ms/iteration (host clock, per "
          f"iteration incl. the first matvec)", flush=True)

    del kmat, y, res_k, res_r
    torch.cuda.empty_cache()
    stamp("setup, main, gemm, gemv, ragged, cg")
    stencil_kernel = stencil_phases(dev, gen)
    spmv_kernel = spmv_phases(dev, gen)
    reduce_kernels = reduce_phase(dev, gen)
    stamp("stencil, jacobi, spmv, cg_bell, reduce")
    torch.cuda.empty_cache()
    attention_kernel = attention_phase(dev, gen)
    stamp("attention")
    torch.cuda.empty_cache()
    serve_launches = serve_phase(dev)
    stamp("serve")
    attention_kernel["launches"] = serve_launches["attention_fused"]
    GEMM_LAUNCHES["serve"] = serve_launches["gemm_hilo"]
    torch.cuda.empty_cache()
    spectral_launches = spectral_phase(dev, gen)
    GEMM_LAUNCHES["spectral"] = spectral_launches["gemm_hilo"]
    GEMV_LAUNCHES["spectral"] = spectral_launches["gemv_hilo"]
    stamp("spectral")
    fp8_phase(dev, gen)
    stamp("fp8")
    attention_kernel["launches"] += serve_fp8_phase(dev)
    stamp("serve-fp8")
    gc.collect()       # the serve phases' engines and models sit in reference cycles
    torch.cuda.empty_cache()
    moe_launches = serve_moe_phase(dev)
    attention_kernel["launches"] += moe_launches["attention_fused"]
    GEMM_LAUNCHES["serve-moe"] = moe_launches["gemm_hilo"]
    stamp("serve-moe")
    gc.collect()       # its engine and model sit in a reference cycle too
    torch.cuda.empty_cache()
    for name, phase in (("serve-ssm", serve_ssm_phase), ("serve-hybrid", serve_hybrid_phase),
                        ("serve-encdec", serve_encdec_phase), ("serve-vlm", serve_vlm_phase)):
        counts = phase(dev)
        attention_kernel["launches"] += counts["attention_fused"]
        GEMM_LAUNCHES[name] = counts["gemm_hilo"]
        GEMV_LAUNCHES[name] = counts["gemv_hilo"]
        stamp(name)
        gc.collect()
        torch.cuda.empty_cache()
    GEMM_LAUNCHES["vjp"] = vjp_phase(dev)
    stamp("vjp")
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = train_phase(dev)
    GEMM_LAUNCHES["train"] = train_launches["gemm_hilo"]
    attention_kernel["launches"] += train_launches["attention_fused"]
    stamp("train")
    gc.collect()
    torch.cuda.empty_cache()
    resume_launches = resume_phase(dev)
    GEMM_LAUNCHES["resume"] = resume_launches["gemm_hilo"]
    attention_kernel["launches"] += resume_launches["attention_fused"]
    stamp("resume")
    gc.collect()
    torch.cuda.empty_cache()
    KERNEL_MS.update({"gemm": gemm_ms, "gemv": gemv[1]["ms"], "stencil7": stencil_kernel["ms"],
                      "spmv_bell": spmv_kernel["ms"], "attention prefill": attention_kernel["ms"],
                      "reduce": sum(k["ms"] for k in reduce_kernels)})
    tme_launches = tme_phase(dev, gen, KERNEL_MS)
    stamp("tme")
    GEMM_LAUNCHES["tme"] = tme_launches["gemm_hilo"]
    GEMV_LAUNCHES["tme"] = tme_launches["gemv_hilo"]
    for entry in (stencil_kernel, spmv_kernel, attention_kernel, *reduce_kernels):
        entry["launches"] += tme_launches[entry["name"]]

    # -------------------------------------------------------------- summary
    v_bound, v_by = bound(N, N, 1, plan.r)
    kernels = [
        {"name": "gemm_hilo", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ozaki_gemm.cu",
         "replaces": "src/repro/kernels/ozaki_gemm.py:63",
         "launches": sum(GEMM_LAUNCHES.values()), "max_abs_err": gemm_err, "ms": gemm_ms,
         "plain_ms": gemm_plain_ms, "bound_ms": g_bound, "bound_by": g_by,
         "library_ms": gemm_lib_ms},
        {"name": "gemv_hilo", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ozaki_gemv.cu",
         "replaces": "src/repro/kernels/ozaki_gemv.py:61",
         "launches": sum(GEMV_LAUNCHES.values()), "max_abs_err": gemv[1]["err"],
         "ms": gemv[1]["ms"], "plain_ms": gemv[1]["plain_ms"], "bound_ms": v_bound,
         "bound_by": v_by, "library_ms": gemv[1]["library_ms"]},
        stencil_kernel, spmv_kernel, *reduce_kernels, attention_kernel,
    ]
    print("kernels: " + ", ".join(f"{k['name']} {k['launches']} launches" for k in kernels)
          + f" on the main paths (gemm_hilo {GEMM_LAUNCHES}; gemv_hilo {GEMV_LAUNCHES})",
          flush=True)
    names = ["gemm_hilo", "gemv_hilo", "stencil7", "spmv_bell", "norm_scale", "block_tree",
             "carry_fold", "attention_fused"]
    check([k["name"] for k in kernels] == names and
          all(isinstance(k["launches"], int) and k["launches"] > 0 for k in kernels),
          f"kernels: the line lists all {len(names)} kernels, each launched on a main path")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
