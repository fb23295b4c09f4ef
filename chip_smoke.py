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
         rows and v columns at ~1e-300.  In each: the kernel route against the
         reference route (bitwise), the kernel against its plain version at
         two bq on every path of the kernel (the one-pass sweep, and where
         S = 1 the row path the wrapper picks and the sweep forced; bitwise,
         the result must depend on neither), and against
         a native-FP64 softmax attention (<= 1e-12 * max|v| per column).  Times
         of the kernel on each path, its plain version,
         ``F.scaled_dot_product_attention`` f64 and the bound, and each path's
         device time by kernel (torch.profiler), at causal prefill, the ragged
         case and both decode lengths, beside PERF.md's earlier times.
  serve  yi-6b at its published widths and all 32 layers (d_model 4096, 32
         heads over 4 KV heads, head_dim 128, d_ff 11008, vocab 64000), policy
         ozaki2_int8, compute float32, random weights from a seeded generator
         on the card.  The main path, with every launch count set to 0 just
         before and read just after: ``ContinuousBatcher`` serves 3 requests of
         16 seeded prompt tokens and 8 new tokens through 2 slots, then
         4 decode steps of a second engine whose 2 x 4096 cache is full
         (seeded keys and values: the cost of attending over a long context),
         then one forward pass over 512 tokens, all on the ``auto`` route;
         ``attention_fused`` launched layers x calls and ``gemm_hilo``
         (7 x layers + 1) x calls times.  Then the reference route (bitwise
         forward logits and first 4 decode steps, at all 32 layers), and the
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
  serve-fp8 yi-6b at its published widths and all 32 layers under ozaki2_fp8,
         compute float32, the serve phase's weights: one request of 16 seeded
         prompt tokens and 4 new tokens through ``ContinuousBatcher`` (the main
         path: attention_fused launched layers x steps, no gemm_hilo), its
         logits at every step bitwise equal to the same calls under
         ozaki2_int8 and within rtol 1e-3, atol 1e-4 of the fp64 policy's; ms
         per decode step, and one weight product by part.
Then one JSON line describing each kernel, and the contract's last line.

Tolerances: every kernel and route comparison is bitwise (0 differing
elements; NaN equals NaN, since the reference's ds representation is NaN from
r = 16 on).  Times are CUDA-event medians after a warm-up.
"""

import contextlib
import json
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

FAILURES = []
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

    def ring(t, pos):                                     # 2 slots x 32 heads at `pos`
        return (torch.arange(t, device=dev) <= pos).to(torch.int8)[None, None].expand(64, 1, t)

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
        if name.startswith(("causal", "decode", "ragged")):   # the timed shapes
            timed[name] = (q, k, v, mask, pq, pp, bq, bkv, want)
        del y_k, y_r, plain, want
    out = {}
    for name, (q, k, v, mask, pq, pp, bq, bkv, want) in timed.items():
        B, S, D = q.shape
        T = k.shape[1]
        ops = oa._decompose(q, k, v, pq, pp, bkv)
        if S == T and name.startswith("causal"):
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
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
    from repro_torch.core import dispatch, splitting
    from repro_torch.kernels import carry_fold, ozaki_attention, ozaki_gemm, ozaki_gemv
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine

    cfg = registry.get_config("yi-6b", policy_name="ozaki2_int8", compute_dtype="float32")
    L = cfg.num_layers
    print(f"serve: {cfg.name} d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {L} layers; "
          f"policy {cfg.policy_name}, compute {cfg.compute_dtype}", flush=True)
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve: {n_params} weights made on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, 16) for _ in range(3)]
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 512)), device=dev)

    # dispatch.attention and dispatch.matmul (the weight products with their
    # Phase 1) timed with CUDA events inside the decode steps
    events = {"attention": [], "matmul": []}
    real = {"attention": dispatch.attention, "matmul": dispatch.matmul}

    def timed(name):
        def call(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = real[name](*args, **kw)
            b.record()
            events[name].append((a, b))
            return out
        return call

    def patch(fns):
        dispatch.attention, dispatch.matmul = fns["attention"], fns["matmul"]

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
    patch({name: timed(name) for name in real})
    t0 = time.perf_counter()
    try:
        done = batcher.run_to_completion()
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        n_short = {k: len(v) for k, v in events.items()}
        toks = rng.integers(0, cfg.vocab_size, 2)
        for pos in range(LONG_CTX - LONG_STEPS, LONG_CTX):
            toks = long_engine.decode_step_all(toks, pos)
    finally:
        patch(real)
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

    def gemm_ms(w):
        plan = dispatch.get_plan(w.shape[0])
        x = torch.randn((128, w.shape[0]), device=dev, dtype=torch.float64)
        ah, al = splitting.split_hi_lo(splitting.scale_to_int(x, plan.payload_bits, -1)[0])
        bh, bl = splitting.split_hi_lo(splitting.scale_to_int(w.double(), plan.payload_bits,
                                                              0)[0])
        return time_ms(lambda: ozaki_gemm.gemm_hilo(ah, al, bh, bl, plan), reps=5)

    part["gemm_hilo"] = L * sum(gemm_ms(w) for w in weights) + gemm_ms(model.lm_head.w)
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
    cfg64 = registry.get_config("yi-6b", policy_name="fp64", compute_dtype="float32")
    model64 = Model(cfg64).load(dict(model.state_dict()))
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


def serve_fp8_phase(dev):
    """yi-6b under ozaki2_fp8; returns the attention_fused launches of its main path."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import dispatch, ozaki2
    from repro_torch.kernels import carry_fold, ozaki_attention, ozaki_gemm, ozaki_gemv
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine

    cfg = registry.get_config("yi-6b", policy_name="ozaki2_fp8", compute_dtype="float32")
    L = cfg.num_layers
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
        cfg2 = registry.get_config("yi-6b", policy_name=policy_name, compute_dtype="float32")
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
    print(f"serve-fp8: {cfg.name}, {L} layers, ozaki2_fp8, compute float32: {n} decode steps in "
          f"{t_all:.1f} s, {fp8_ms:.3f} ms a step (mean, host clock; ozaki2_int8 "
          f"{int8_ms:.3f}, fp64 {fp64_ms:.3f}); launches {launches}", flush=True)
    del model, engine, batcher, state
    torch.cuda.empty_cache()
    return launches["attention_fused"]


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
    stencil_kernel = stencil_phases(dev, gen)
    spmv_kernel = spmv_phases(dev, gen)
    reduce_kernels = reduce_phase(dev, gen)
    torch.cuda.empty_cache()
    attention_kernel = attention_phase(dev, gen)
    torch.cuda.empty_cache()
    serve_launches = serve_phase(dev)
    attention_kernel["launches"] = serve_launches["attention_fused"]
    GEMM_LAUNCHES["serve"] = serve_launches["gemm_hilo"]
    torch.cuda.empty_cache()
    spectral_launches = spectral_phase(dev, gen)
    GEMM_LAUNCHES["spectral"] = spectral_launches["gemm_hilo"]
    GEMV_LAUNCHES["spectral"] = spectral_launches["gemv_hilo"]
    fp8_phase(dev, gen)
    attention_kernel["launches"] += serve_fp8_phase(dev)

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
