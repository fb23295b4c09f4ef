"""Ozaki Scheme II — CRT/residue FP64 matrix-multiplication emulation (``repro.core.ozaki2``).

Pipeline (paper Phases 1–3):
  1. ``scale_to_int``  : Ã = ⌊D A⌉, B̃ = ⌊B E⌉ with exact power-of-two diagonal scaling.
  2. ``modular_matmul``: C⁽ⁱ⁾ = (Ã mod mᵢ)(B̃ mod mᵢ) mod mᵢ for r pairwise-coprime
     moduli.  INT8 substrate: the reference's int8 × int8 → int32 product is a
     float64 matmul of the residues here: every partial sum is an integer below
     k·2¹⁴ < 2⁵³, so it is exact on the CPU and on CUDA.  FP8 substrate: each
     balanced residue is split into two exact 4-bit E4M3 halves and multiplied
     with a Karatsuba 3-product schedule (``fp8_quant``); the planes' products are
     a float32 matmul on the CPU and ``torch._scaled_mm`` on the FP8 tensor
     cores on CUDA, exact because every partial sum is an integer below 2²⁴ and
     the tensor cores sum at most FP8_CUDA_K_CHUNK products at a time.
  3. ``garner_reconstruct``: balanced-digit Garner mixed-radix reconstruction,
     followed by the exact power-of-two unscale D⁻¹·E⁻¹.

This module is the unfused reference route of the dispatch seam; the Hopper
kernels in ``repro_torch.kernels`` compute the same bits (int8 substrate).  Both
substrates give the same integers mod m, so the same bits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import fp8_quant
from repro_torch.core import moduli as moduli_lib
from repro_torch.core import numerics, splitting

Substrate = str  # "int8" | "fp8"

# The reference accumulates balanced int8 residue products in int32, exact for
# k <= 2**31 / 128**2; the contraction is chunked above this.
_INT8_K_CHUNK = 1 << 17
# FP8 substrate: per-plane integer products are at most 16**2, so float32 sums
# are exact below 2**24 for k <= 2**16.
_FP8_K_CHUNK = 1 << 16
# The H100's FP8 tensor cores (``torch._scaled_mm`` with use_fast_accum=False)
# sum products in a stage narrower than float32 and move the sums to float32
# every 128 k.  Measured there: runs of 64 plane products are exact in every
# case tried, runs of 128 are not (constant odd products of 13·15 lose 32 in
# each 128; chip_smoke.py's fp8 phase, PERF.md §6).  So each run of
# FP8_CUDA_K_CHUNK products gets a block of _FP8_CUDA_BLOCK k of its own, the
# rest zeros, and the float32 sums of the blocks stay exact integers below 2**24
# (k <= _FP8_K_CHUNK).  Zeros add nothing, so the chunking changes no bit.
FP8_CUDA_K_CHUNK = 64
_FP8_CUDA_BLOCK = 128
# torch._scaled_mm takes dimensions in multiples of 16.
_FP8_MM_GRANULE = 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """Static Ozaki-II configuration (hashable)."""

    moduli: Tuple[int, ...]
    payload_bits: int            # p: |Ã| < 2**p
    substrate: Substrate = "int8"

    @property
    def r(self) -> int:
        return len(self.moduli)

    @functools.cached_property
    def garner(self) -> moduli_lib.GarnerConstants:
        return moduli_lib.garner_constants(self.moduli)

    @property
    def alpha(self) -> int:
        """Low-precision MMAs per FP64 op: r for int8, 3r for the FP8 Karatsuba split."""
        return self.r if self.substrate == "int8" else 3 * self.r


def make_plan(k: int, payload_bits: int = 53, r: Optional[int] = None,
              substrate: Substrate = "int8", margin_bits: int = 2) -> Plan:
    """Build a Plan for contractions of length k.

    If ``r`` is given, the payload is clipped to what those r moduli support at this k;
    otherwise r is the minimum for ``payload_bits``.
    """
    if r is None:
        r = moduli_lib.required_r(k, payload_bits, margin_bits)
    else:
        payload_bits = min(payload_bits,
                           moduli_lib.max_payload_bits(r, k, margin_bits))
    return Plan(moduli=moduli_lib.DEFAULT_MODULI[:r], payload_bits=payload_bits,
                substrate=substrate)


def decompose(x: torch.Tensor, plan: Plan, scale_axis: int,
              via_hilo: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residue decomposition: returns (residues int8 (r, *x.shape), shift int32).

    ``scale_axis`` is the contraction axis: rows of A scale over axis=-1, columns
    of B over axis=0.  ``via_hilo`` selects the int32 (hi, lo) path (default)
    versus the int64 oracle.
    """
    xi, shift = splitting.scale_to_int(x, plan.payload_bits, axis=scale_axis)
    if via_hilo:
        hi, lo = splitting.split_hi_lo(xi)
        res = splitting.residues_from_hilo(hi, lo, plan.moduli)
    else:
        res = splitting.residues_direct(xi, plan.moduli)
    return res, shift


def _dot_int8(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Exact integer contraction of int8 residues (last axis of a, next-to-last of b)."""
    return torch.matmul(a8.to(torch.float64), b8.to(torch.float64)).to(torch.int64)


def _chunked_modular_dot_int8(ares: torch.Tensor, bres: torch.Tensor,
                              m: int) -> torch.Tensor:
    """(Ã mod m)(B̃ mod m) mod m, chunked over the contraction like the reference."""
    k = ares.shape[-1]
    acc = None
    for s in range(0, k, _INT8_K_CHUNK):
        e = min(s + _INT8_K_CHUNK, k)
        part = splitting.balanced_mod(_dot_int8(ares[..., s:e], bres[..., s:e, :]), m)
        acc = part if acc is None else splitting.balanced_mod(acc + part, m)
    return acc.to(torch.int32)


def _fp8_blocked(x: torch.Tensor, rows: int, k_axis: int) -> torch.Tensor:
    """Integer plane x (|x| <= 16) with its contraction along ``k_axis`` as a
    float8_e4m3fn (rows, nb·_FP8_CUDA_BLOCK) matrix, rows zero-padded: run j of
    FP8_CUDA_K_CHUNK contraction entries fills the head of block j, zeros the rest."""
    xt = x if k_axis == 1 else x.t()
    r, k = xt.shape
    c = FP8_CUDA_K_CHUNK
    nb = -(-k // c)
    if nb * c != k:
        xt = F.pad(xt, (0, nb * c - k))
    out = torch.zeros((rows, nb, _FP8_CUDA_BLOCK), dtype=torch.float8_e4m3fn, device=x.device)
    out[:r, :, :c] = xt.unflatten(1, (nb, c))
    return out.flatten(1)


def _scaled_mm_2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, n) integer planes on the FP8 tensor cores, float32 out: A
    row-major, B column-major, both in the blocked layout of ``_fp8_blocked``."""
    m, n = a.shape[0], b.shape[1]
    g = _FP8_MM_GRANULE
    one = torch.ones((), dtype=torch.float32, device=a.device)
    out = torch._scaled_mm(_fp8_blocked(a, -(-m // g) * g, 1),
                           _fp8_blocked(b, -(-n // g) * g, 0).t(),
                           scale_a=one, scale_b=one, out_dtype=torch.float32,
                           use_fast_accum=False)
    return out[:m, :n]


def _dot_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact float32 contraction of integer planes (last axis of a, next-to-last of b).

    CPU: a float32 matmul.  CUDA: float8_e4m3fn operands on the FP8 tensor cores,
    each problem of a batch on its own.
    """
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    if a.ndim == 2 and b.ndim == 2:
        return _scaled_mm_2d(a, b)
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(lead + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    b3 = b.expand(lead + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    out = torch.stack([_scaled_mm_2d(x, y) for x, y in zip(a3, b3)])
    return out.reshape(lead + out.shape[-2:])


def _chunked_modular_dot_fp8(ares: torch.Tensor, bres: torch.Tensor,
                             m: int) -> torch.Tensor:
    """FP8-substrate modular product: Karatsuba over 4-bit halves.

    x·y = 256·H + 16·(Mid − H − L) + L with H = x_h·y_h, L = x_l·y_l,
    Mid = (x_h+x_l)·(y_h+y_l).  Each plane's product over a chunk of at most
    _FP8_K_CHUNK is an exact integer below 2²⁴ (on CUDA, summed from runs of
    FP8_CUDA_K_CHUNK, ``_fp8_blocked``); chunks are reduced mod m and summed mod
    m, so the chunking changes no bit.
    """
    k = ares.shape[-1]
    a_hi, a_lo = fp8_quant.fp8_split(ares)
    b_hi, b_lo = fp8_quant.fp8_split(bres)
    a_mid, b_mid = a_hi + a_lo, b_hi + b_lo
    acc = None
    for s in range(0, k, _FP8_K_CHUNK):
        e = min(s + _FP8_K_CHUNK, k)
        H, L, Mid = (_dot_fp8(x[..., s:e], y[..., s:e, :]).to(torch.int32)
                     for x, y in ((a_hi, b_hi), (a_lo, b_lo), (a_mid, b_mid)))
        part = fp8_quant.fp8_karatsuba_combine(H, Mid, L, m)
        acc = part if acc is None else splitting.balanced_mod(acc + part, m)
    return acc


def modular_matmul(ares: torch.Tensor, bres: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Stacked modular products C⁽ⁱ⁾, int32 (r, m, n), balanced representatives."""
    if plan.substrate not in ("int8", "fp8"):
        raise ValueError(f"substrate must be 'int8' or 'fp8', got {plan.substrate!r}")
    fn = (_chunked_modular_dot_int8 if plan.substrate == "int8"
          else _chunked_modular_dot_fp8)
    outs = [fn(ares[i], bres[i], m) for i, m in enumerate(plan.moduli)]
    return torch.stack(outs, dim=0)


def garner_reconstruct(cres: torch.Tensor, plan: Plan,
                       out_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Balanced-digit Garner: recover the (signed) integer value as a float.

    cres: int32 (r, ...) balanced residues of the exact integer product.  The
    accumulation runs in compensated double-double arithmetic with exact
    double-double prefix-product constants, so the result is the correctly
    rounded float of the exact integer.
    """
    gc = plan.garner
    ms = plan.moduli
    shape, dev = cres.shape[1:], cres.device
    acc = [torch.zeros(shape, dtype=torch.int32, device=dev) for _ in range(plan.r)]
    out = torch.zeros(shape, dtype=out_dtype, device=dev)
    comp = torch.zeros(shape, dtype=out_dtype, device=dev)
    for j in range(plan.r):
        t = splitting.balanced_mod(
            (cres[j].to(torch.int32) - acc[j]) * int(gc.inv_pref[j]), ms[j])
        tf = t.to(out_dtype)
        # term = t * P_j in double-double: P_j = pref_f64 + pref_f64_lo (exact).
        pref = torch.tensor(float(gc.pref_f64[j]), dtype=out_dtype, device=dev)
        pref_lo = torch.tensor(float(gc.pref_f64_lo[j]), dtype=out_dtype, device=dev)
        p_term, e_term = numerics.two_prod(tf, pref)
        e_term = e_term + tf * pref_lo
        s, e_sum = numerics.two_sum(out, p_term)
        comp = comp + (e_sum + e_term)
        out = s
        for l in range(j + 1, plan.r):
            acc[l] = splitting.balanced_mod(acc[l] + t * int(gc.pref_mod[j, l]), ms[l])
    return out + comp


def emulated_matmul(a: torch.Tensor, b: torch.Tensor, plan: Plan,
                    via_hilo: bool = True,
                    out_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """FP64-accurate C = A @ B via Ozaki Scheme II.

    a: (..., m, k), b: (..., k, n) with leading dims that broadcast, each product
    on its own (rows of a and columns of b scale per problem); float64 inputs for full
    FP64 emulation (float32 inputs work with the payload clipped to 24 bits).
    Runs on the operands' device.
    """
    a = a.to(out_dtype)
    b = b.to(out_dtype)
    ares, ashift = decompose(a, plan, scale_axis=-1, via_hilo=via_hilo)
    bres, bshift = decompose(b, plan, scale_axis=-2, via_hilo=via_hilo)
    cres = modular_matmul(ares, bres, plan)
    c_int = garner_reconstruct(cres, plan, out_dtype=out_dtype)
    return splitting.apply_unscale(c_int, ashift, bshift)
