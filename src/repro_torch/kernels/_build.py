"""Build the CUDA sources under ``csrc/`` and bind their plain C interface.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<key>.so`` inside this package
on first use, where ``<key>`` hashes the sources (the ``.cu`` and every ``.cuh``)
and the flags, so an edit rebuilds and an unchanged tree reuses the library.
``build()`` starts one ``nvcc`` per source, all at once, and waits for all of
them.  The libraries are loaded with ``ctypes``: pointers, the stream and the
launch-parameter block travel as ``c_void_p``.  A missing ``nvcc`` or a failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable

import numpy as np

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parent / "build"
SOURCES = ("ozaki_gemm", "ozaki_gemv", "ozaki_stencil", "ozaki_spmv", "carry_fold",
           "ozaki_attention")
# Measurement probes beside the kernels, built only when asked for by name.
PROBES = ("dadd_chain",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_R = 20  # ozaki::kMaxR

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
_INT64 = ctypes.c_int64
# Each source's C entry points: (name, argument types) pairs.
ENTRY_POINTS = {
    # (device, a_hi, a_lo, b_hi, b_lo, M, N, K, out_rep, out, ares, bres, cres, params,
    #  stream)
    "ozaki_gemm": (("ozaki_gemm_hilo", [_INT] + [_VOID_P] * 4 + [_INT] * 4 + [_VOID_P] * 6),),
    # (device, a_hi, a_lo, x_hi, x_lo, M, K, B, out_rep, out, xres, params, stream)
    "ozaki_gemv": (("ozaki_gemv_hilo", [_INT] + [_VOID_P] * 4 + [_INT] * 4 + [_VOID_P] * 4),),
    # (device, u, c, absmax, elog, payload_bits, X, Y, Z, bz, by, bx, out_rep, out,
    #  shift_out, params, stream)
    "ozaki_stencil": (("ozaki_stencil7", [_INT] + [_VOID_P] * 4 + [_INT] * 8 + [_VOID_P] * 4),),
    # (device, a_hi, a_lo, cols, x_hi, x_lo, M, N, bw, br, out_rep, out, xres, params,
    #  stream)
    "ozaki_spmv": (("ozaki_spmv_hilo", [_INT] + [_VOID_P] * 5 + [_INT] * 5 + [_VOID_P] * 4),),
    "carry_fold": (
        # (device, dtype_bytes, s_b, c_b, nb, lanes, scale_bits, flags, out, stream)
        ("carry_fold", [_INT] * 2 + [_VOID_P] * 2 + [_INT64] * 2 + [_VOID_P] * 4),
        # (device, dtype_bytes, kind, x, y, scale_bits, n, lanes, block, s_b, c_b, stream)
        ("carry_tree", [_INT] * 3 + [_VOID_P] * 3 + [_INT64] * 2 + [_INT] + [_VOID_P] * 3),
        # (device, dtype_bytes, x, n, lanes, bits, flags, stream)
        ("carry_norm_scale", [_INT] * 2 + [_VOID_P] + [_INT64] * 2 + [_VOID_P] * 3)),
    # (device, q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, sq, sk, sv, mask, out, qres, kres,
    #  vres, s_buf, pv_buf, stats, path, shape, params, stream)
    "ozaki_attention": (("ozaki_attention_fused", [_INT] + [_VOID_P] * 17 + [_INT]
                        + [_VOID_P] * 3),),
    # (device, x, n, out, stream): n dependent float64 additions in one thread
    "dadd_chain": (("dadd_chain", [_INT, ctypes.c_double, _INT64] + [_VOID_P] * 2),),
}


class GarnerParams(ctypes.Structure):
    """Mirror of ``ozaki::GarnerParams`` (``csrc/ozaki_common.cuh``)."""

    _fields_ = [
        ("r", ctypes.c_int),
        ("moduli", ctypes.c_int * MAX_R),
        ("inv_pref", ctypes.c_int * MAX_R),
        ("pref_mod", ctypes.c_int * (MAX_R * MAX_R)),
        ("pref_f64", ctypes.c_double * MAX_R),
        ("pref_f64_lo", ctypes.c_double * MAX_R),
        ("pref_f32", ctypes.c_float * MAX_R),
        ("pref_f32_lo", ctypes.c_float * MAX_R),
        ("pref_f64_h", ctypes.c_double * MAX_R),
        ("pref_f64_l", ctypes.c_double * MAX_R),
    ]


@functools.lru_cache(maxsize=None)
def garner_params(plan) -> GarnerParams:
    """The launch-parameter block of a plan (moduli and Garner constants);
    shared per plan, read-only."""
    from repro_torch.kernels import common  # deferred: common imports the core

    gc = plan.garner
    r = plan.r
    if r > MAX_R:
        raise ValueError(f"the kernels take at most {MAX_R} moduli, plan has {r}")
    pref_mod = np.zeros((MAX_R, MAX_R), np.int32)
    pref_mod[:r, :r] = gc.pref_mod
    ph, pl = common.ds_constants(plan)
    p = GarnerParams()
    p.r = r
    p.moduli[:r] = list(plan.moduli)
    p.inv_pref[:r] = [int(v) for v in gc.inv_pref]
    p.pref_mod[:] = [int(v) for v in pref_mod.reshape(-1)]
    p.pref_f64[:r] = [float(v) for v in gc.pref_f64]
    p.pref_f64_lo[:r] = [float(v) for v in gc.pref_f64_lo]
    p.pref_f32[:r] = [float(v) for v in ph]
    p.pref_f32_lo[:r] = [float(v) for v in pl]
    split = [common._split_const(np.float64(v), np.float64(2.0 ** 27 + 1.0))
             for v in gc.pref_f64]
    p.pref_f64_h[:r] = [float(h) for h, _ in split]
    p.pref_f64_l[:r] = [float(lo) for _, lo in split]
    return p


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, in parallel.

    Returns the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) for each source it compiled.  Raises if any build fails.
    """
    todo = {n: _library_path(n) for n in names if not _library_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    reports, failed = {}, []
    for name, (proc, tmp) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{reports[name]}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    build([name])
    lib = ctypes.CDLL(str(_library_path(name)))
    for entry, argtypes in ENTRY_POINTS[name]:
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
