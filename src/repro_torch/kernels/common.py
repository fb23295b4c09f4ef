"""Plain torch versions of the kernels' prologue and epilogue (``repro.kernels.common``).

The Hopper kernels compute, per output, the balanced residues of the exact
integer product, the balanced mixed-radix Garner digits, and one of three
output representations:
  f64    — compensated double-double Horner over the digits: the correctly
           rounded float64 of the exact integer;
  digits — the r balanced digits as int8 (r bytes per output), finished by a
           cheap torch epilogue (``digits_to_f64``);
  ds     — a double-single (f32, f32) pair with ~45-48 significant bits.
The functions here are those steps as separate torch ops, in the reference's
order.  The CUDA sources (``csrc/ozaki_common.cuh``) repeat them op for op and
are built with ``--fmad=false``, so a kernel's output is bitwise equal to its
plain version on the same device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import ozaki2
from repro_torch.core.splitting import balanced_mod, residue

OUT_REPS = ("f64", "digits", "ds")

__all__ = ["OUT_REPS", "balanced_mod", "residue", "residues_int32", "garner_digits",
           "digits_to_f64", "digits_to_ds", "stack_digits_int8", "unstack_digits",
           "represent", "raw_to_f64"]


def residues_int32(hi: torch.Tensor, lo: torch.Tensor,
                   moduli: Sequence[int]) -> List[torch.Tensor]:
    """Balanced residues of x = hi*2^26 + lo per modulus."""
    return [residue(hi, lo, m) for m in moduli]


def garner_digits(accs: Sequence[torch.Tensor], plan: ozaki2.Plan) -> List[torch.Tensor]:
    """Balanced mixed-radix digits v_j (int32) from per-modulus accumulators."""
    gc = plan.garner
    ms = plan.moduli
    carry = [torch.zeros_like(accs[0]) for _ in range(plan.r)]
    digits: List[torch.Tensor] = []
    for j in range(plan.r):
        t = balanced_mod((balanced_mod(accs[j], ms[j]) - carry[j])
                         * int(gc.inv_pref[j]), ms[j])
        digits.append(t)
        for l in range(j + 1, plan.r):
            carry[l] = balanced_mod(carry[l] + t * int(gc.pref_mod[j, l]), ms[l])
    return digits


def _split_const(c, split_c):
    """Veltkamp split of a scalar constant, in the constant's own numpy type.

    In float32 the split of the prefix products overflows from r = 16 on
    (4097 * P_15 > 2^128), as it does in the reference: the ds representation
    is then NaN there, in both packages and in the kernel alike."""
    with np.errstate(over="ignore", invalid="ignore"):
        t = split_c * c
        hi = t - (t - c)
        return hi, c - hi


def digits_to_f64(digits: Sequence[torch.Tensor], plan: ozaki2.Plan,
                  out_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Compensated double-double Horner over the digits (the reconstruction epilogue)."""
    gc = plan.garner
    npt = np.float64 if out_dtype == torch.float64 else np.float32
    split_c = npt(2.0 ** (27 if out_dtype == torch.float64 else 12) + 1.0)
    out = torch.zeros(digits[0].shape, dtype=out_dtype, device=digits[0].device)
    comp = torch.zeros_like(out)
    for j, t in enumerate(digits):
        tf = t.to(out_dtype)
        ph = npt(gc.pref_f64[j])
        ph_h, ph_l = _split_const(ph, split_c)
        p = tf * float(ph)
        # two_prod(tf, ph) inline (Veltkamp)
        c1 = float(split_c) * tf
        tf_h = c1 - (c1 - tf)
        tf_l = tf - tf_h
        e = ((tf_h * float(ph_h) - p) + tf_h * float(ph_l) + tf_l * float(ph_h)) \
            + tf_l * float(ph_l)
        e = e + tf * float(npt(gc.pref_f64_lo[j]))
        # two_sum(out, p)
        s = out + p
        v = s - out
        comp = comp + ((out - (s - v)) + (p - v)) + e
        out = s
    return out + comp


def ds_constants(plan: ozaki2.Plan) -> Tuple[np.ndarray, np.ndarray]:
    """Prefix products as exact f32 (hi, lo) pairs for the double-single epilogue."""
    ph = plan.garner.pref_f64.astype(np.float32)
    pl = (plan.garner.pref_f64 - ph.astype(np.float64)).astype(np.float32)
    return ph, pl


def digits_to_ds(digits: Sequence[torch.Tensor], plan: ozaki2.Plan
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Double-single (f32, f32) reconstruction (~45-48 significant bits)."""
    split_c = np.float32(2.0 ** 12 + 1.0)
    phs, pls = ds_constants(plan)
    hi = torch.zeros(digits[0].shape, dtype=torch.float32, device=digits[0].device)
    lo = torch.zeros_like(hi)
    for j, t in enumerate(digits):
        tf = t.to(torch.float32)
        ph, pl_ = phs[j], pls[j]
        ph_h, ph_l = _split_const(ph, split_c)
        # two_prod(tf, ph) in f32
        p = tf * float(ph)
        c1 = float(split_c) * tf
        tf_h = c1 - (c1 - tf)
        tf_l = tf - tf_h
        e = ((tf_h * float(ph_h) - p) + tf_h * float(ph_l) + tf_l * float(ph_h)) \
            + tf_l * float(ph_l)
        e = e + tf * float(pl_)
        # two_sum(hi, p)
        s = hi + p
        v = s - hi
        lo = lo + ((hi - (s - v)) + (p - v)) + e
        hi = s
    s = hi + lo
    lo = lo - (s - hi)
    return s, lo


def stack_digits_int8(digits: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([d.to(torch.int8) for d in digits], dim=0)


def unstack_digits(d8: torch.Tensor) -> List[torch.Tensor]:
    return [d8[j].to(torch.int32) for j in range(d8.shape[0])]


def represent(digits: Sequence[torch.Tensor], plan: ozaki2.Plan,
              out_rep: str) -> torch.Tensor:
    """A kernel's raw output from its Garner digits: f64 (...) | ds f32 (2, ...) |
    digits int8 (r, ...)."""
    if out_rep == "f64":
        return digits_to_f64(digits, plan)
    if out_rep == "ds":
        return torch.stack(digits_to_ds(digits, plan), dim=0)
    if out_rep == "digits":
        return stack_digits_int8(digits)
    raise ValueError(f"out_rep must be one of {OUT_REPS}, got {out_rep!r}")


def raw_to_f64(raw: torch.Tensor, plan: ozaki2.Plan, out_rep: str) -> torch.Tensor:
    """A kernel's raw output as the float64 of the scaled integer (the epilogue)."""
    if out_rep == "f64":
        return raw
    if out_rep == "ds":
        return raw[0].to(torch.float64) + raw[1].to(torch.float64)
    if out_rep == "digits":
        return digits_to_f64(unstack_digits(raw), plan)
    raise ValueError(f"out_rep must be one of {OUT_REPS}, got {out_rep!r}")
