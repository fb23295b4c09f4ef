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
         ``gemm_hilo`` against its plain version at the main-path shape; times.
  gemv   the same at 8192 x 8192 with n in {1, 8, 16}; ``gemv_hilo`` timed at
         n = 1, the CG matvec.
  ragged two ragged shapes through the seam, and both kernels against their
         plain versions in every output representation (f64, digits, ds).
  cg     the same solve on the reference route: both converge, their
         compensated residual histories are bitwise equal, ||Kx - y||/||y||
         <= 1e-9, and the GEMV ran iterations + 1 times on the main path.
Then one JSON line describing each kernel, and the contract's last line.

Tolerances: every kernel and route comparison is bitwise (0 differing
elements; NaN equals NaN, since the reference's ds representation is NaN from
r = 16 on).  Times are CUDA-event medians after a warm-up.
"""

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

FAILURES = []


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
    from repro_torch.kernels import _build, ops, ozaki_gemm, ozaki_gemv

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
    t0 = time.perf_counter()
    reports = _build.build()
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
    print(f"main: dispatch.matmul {N}^3 {t_gemm * 1e3:.1f} ms (first call); "
          f"cg_solve_dense n={N}: {res_k.iters} iterations, converged={res_k.converged}; "
          f"launches {launches}", flush=True)
    check(launches["gemm_hilo"] == 1, "main: gemm_hilo launched once for the DGEMM")
    check(launches["gemv_hilo"] == res_k.iters + 1,
          f"main: gemv_hilo launched iterations + 1 = {res_k.iters + 1} times")

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
    print(f"gemm: gemm_hilo {gemm_ms:.3f} ms, plain {gemm_plain_ms:.3f} ms, "
          f"torch.matmul f64 {gemm_lib_ms:.3f} ms; dispatch.matmul kernel route "
          f"{seam_k_ms:.3f} ms, reference route {seam_r_ms:.3f} ms", flush=True)
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
        print(f"gemv: n={n} gemv_hilo {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"torch.matmul f64 {t['library_ms']:.3f} ms; dispatch.matmul kernel route "
              f"{t['seam_ms']:.3f} ms, reference route {t['seam_ref_ms']:.3f} ms", flush=True)
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

    # -------------------------------------------------------------- summary
    g_bound, g_by = bound(N, N, N, plan.r)
    v_bound, v_by = bound(N, N, 1, plan.r)
    kernels = [
        {"name": "gemm_hilo", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ozaki_gemm.cu",
         "replaces": "src/repro/kernels/ozaki_gemm.py:63",
         "launches": launches["gemm_hilo"], "max_abs_err": gemm_err, "ms": gemm_ms,
         "plain_ms": gemm_plain_ms, "bound_ms": g_bound, "bound_by": g_by,
         "library_ms": gemm_lib_ms},
        {"name": "gemv_hilo", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ozaki_gemv.cu",
         "replaces": "src/repro/kernels/ozaki_gemv.py:61",
         "launches": launches["gemv_hilo"], "max_abs_err": gemv[1]["err"],
         "ms": gemv[1]["ms"], "plain_ms": gemv[1]["plain_ms"], "bound_ms": v_bound,
         "bound_by": v_by, "library_ms": gemv[1]["library_ms"]},
    ]
    print(f"kernels: gemm_hilo {launches['gemm_hilo']} launches, gemv_hilo "
          f"{launches['gemv_hilo']} launches on the main path", flush=True)
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
