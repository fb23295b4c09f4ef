"""Ozaki Scheme II — CRT/residue FP64 matrix-multiplication emulation (``repro.core.ozaki2``).

Pipeline (paper Phases 1–3):
  1. ``scale_to_int``  : Ã = ⌊D A⌉, B̃ = ⌊B E⌉ with exact power-of-two diagonal scaling.
  2. ``modular_matmul``: C⁽ⁱ⁾ = (Ã mod mᵢ)(B̃ mod mᵢ) mod mᵢ for r pairwise-coprime
     moduli.  The reference's int8 × int8 → int32 product is a float64 matmul of
     the residues here: every partial sum is an integer below k·2¹⁴ < 2⁵³, so it is
     exact on the CPU and on CUDA (torch has no int32 matmul on CUDA).
  3. ``garner_reconstruct``: balanced-digit Garner mixed-radix reconstruction,
     followed by the exact power-of-two unscale D⁻¹·E⁻¹.

This module is the unfused reference route of the dispatch seam; the Hopper
kernels in ``repro_torch.kernels`` compute the same bits.  Only the int8 substrate
is ported; the FP8 substrate raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import moduli as moduli_lib
from repro_torch.core import numerics, splitting

Substrate = str  # "int8" | "fp8"

# The reference accumulates balanced int8 residue products in int32, exact for
# k <= 2**31 / 128**2; the contraction is chunked above this.
_INT8_K_CHUNK = 1 << 17


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


def modular_matmul(ares: torch.Tensor, bres: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Stacked modular products C⁽ⁱ⁾, int32 (r, m, n), balanced representatives."""
    if plan.substrate != "int8":
        raise NotImplementedError(
            f"substrate {plan.substrate!r} is not ported; only 'int8' is")
    outs = [_chunked_modular_dot_int8(ares[i], bres[i], m)
            for i, m in enumerate(plan.moduli)]
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
