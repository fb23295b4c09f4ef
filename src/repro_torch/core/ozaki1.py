"""Ozaki Scheme I — mantissa-slicing FP64 emulation (``repro.core.ozaki1``).

The original error-free-transformation scheme: decompose A = Σ_p A^(p),
B = Σ_q B^(q) into S slices of b payload bits each and rebuild
C ≈ Σ_{p,q} A^(p) B^(q): Θ(S²) low-precision products against Ozaki II's Θ(r).
It is the paper's comparison baseline, with the accumulator-bound slice width
of eq. (3):

    2b + ceil(log2 k) <= w_acc   =>   b* = (w_acc - ceil(log2 k)) // 2

Slices are signed integers on the int8/int32 path (w_acc = 31).  Every slice
product is exact: a float64 matmul on the CPU (partial sums below 2³¹ < 2⁵³),
``torch._int_mm`` (int8 × int8 → int32 tensor cores) on CUDA.  Each product
times its power-of-two weight is exact too, so the reference's contraction of
``out + dot·w`` into an FMA changes no bit and the port is bitwise equal to it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import splitting


def slice_width(k: int, w_acc: int = 31, input_bits: int = 7) -> int:
    """Paper eq. (3): max safe payload bits per slice for summation length k."""
    b_star = (w_acc - math.ceil(math.log2(max(k, 2)))) // 2
    return max(1, min(b_star, input_bits))


def slice_count(payload_bits: int, b: int) -> int:
    """Slices needed to cover ``payload_bits`` of mantissa at b bits per slice."""
    return math.ceil(payload_bits / b)


@dataclasses.dataclass(frozen=True)
class Ozaki1Plan:
    slice_bits: int          # b: payload bits per slice
    num_slices: int          # S
    payload_bits: int        # total mantissa bits captured (<= 53)
    full_cross: bool = True  # keep all S² cross terms (True) or the triangle p + q < S

    @property
    def num_gemms(self) -> int:
        s = self.num_slices
        return s * s if self.full_cross else s * (s + 1) // 2


def make_plan(k: int, payload_bits: int = 53, w_acc: int = 31,
              input_bits: int = 7, full_cross: bool = True) -> Ozaki1Plan:
    b = slice_width(k, w_acc, input_bits)
    return Ozaki1Plan(slice_bits=b, num_slices=slice_count(payload_bits, b),
                      payload_bits=payload_bits, full_cross=full_cross)


def slice_decompose(x: torch.Tensor, plan: Ozaki1Plan,
                    scale_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompose to (slices int8 (S, *x.shape), shift int32).

    x ≈ 2^{-shift} * Σ_p slices[p] * 2^{(S-1-p)*b}; slice p holds b bits, balanced.
    """
    xi, shift = splitting.scale_to_int(x, plan.payload_bits, axis=scale_axis)
    b, s = plan.slice_bits, plan.num_slices
    slices = []
    rem = xi
    for p in range(s):
        w = 2.0 ** ((s - 1 - p) * b)
        sl = torch.round(rem / w)
        rem = rem - sl * w
        slices.append(sl.to(torch.int32).to(torch.int8))
    return torch.stack(slices, dim=0), shift


# torch._int_mm takes more than 16 rows, and a depth and width in multiples of 8.
_INT_MM_MIN_M = 17
_INT_MM_GRANULE = 8


def _slice_operands(asl: torch.Tensor, bsl: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slices (S, m, k) and (S, k, n) as ``_dot_int8`` takes them: on CUDA
    zero-padded to ``torch._int_mm``'s shape rules (zeros add nothing), B's
    slices column-major (its fast layout); unchanged on the CPU."""
    if asl.device.type != "cuda":
        return asl, bsl
    (m, k), n = asl.shape[-2:], bsl.shape[-1]
    g = _INT_MM_GRANULE
    pm = max(_INT_MM_MIN_M, -(-m // g) * g) - m
    pk, pn = (-k) % g, (-n) % g
    a = F.pad(asl, (0, pk, 0, pm)) if pm or pk else asl
    bt = F.pad(bsl.transpose(-1, -2), (0, pk, 0, pn)).contiguous()
    return a, bt.transpose(-1, -2)


def _dot_int8(a8: torch.Tensor, b8: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Exact product of one pair of int8 slices from ``_slice_operands``, its
    (m, n) corner in float64: ``torch._int_mm`` on CUDA, a float64 matmul on the CPU."""
    if a8.device.type != "cuda":
        return torch.matmul(a8.to(torch.float64), b8.to(torch.float64))
    return torch._int_mm(a8, b8)[:m, :n].to(torch.float64)


def emulated_matmul(a: torch.Tensor, b: torch.Tensor, plan: Optional[Ozaki1Plan] = None,
                    out_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """C = A @ B via Ozaki I slicing on the int8/int32 substrate.

    Θ(S²) int8 products accumulated in ``out_dtype`` with per-pair power-of-two
    weights, in the reference's (p, q) order.
    """
    if plan is None:
        plan = make_plan(a.shape[-1])
    a = a.to(out_dtype)
    b = b.to(out_dtype)
    asl, ashift = slice_decompose(a, plan, scale_axis=-1)
    bsl, bshift = slice_decompose(b, plan, scale_axis=0)
    asl, bsl = _slice_operands(asl, bsl)
    bbits, s = plan.slice_bits, plan.num_slices
    m, n = a.shape[0], b.shape[1]
    out = torch.zeros((m, n), dtype=out_dtype, device=a.device)
    for p in range(s):
        for q in range(s):
            if not plan.full_cross and p + q >= s:
                continue
            w = 2.0 ** ((2 * (s - 1) - p - q) * bbits)
            out = out + _dot_int8(asl[p], bsl[q], m, n).to(out_dtype) * w
    return splitting.apply_unscale(out, ashift, bshift)
