"""FP8 (E4M3) exact-integer quantisation for the Ozaki-II FP8 substrate
(``repro.core.fp8_quant``).

Modular reduction is an integer operation, so running Ozaki II on FP8 tensor
cores uses the integers that E4M3 represents exactly (every |x| <= 16, among
others): each balanced residue is split into two exact 4-bit halves, and the
product of two residues is rebuilt from three FP8 products (Karatsuba).
"""

from __future__ import annotations

from typing import Tuple

import torch


def is_exact_e4m3(x: int) -> bool:
    """True iff integer x is exactly representable in float8_e4m3fn."""
    v = torch.tensor(float(x), dtype=torch.float64)
    return float(v.to(torch.float8_e4m3fn).to(torch.float64)) == float(x)


def fp8_split(res: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split balanced int8 residues (|res| <= 128) into exact E4M3 halves.

    res = 16*hi + lo with |hi| <= 8, |lo| <= 8; hi, lo and hi + lo (|.| <= 16) are
    all exact in E4M3, which makes the Karatsuba mid-plane (x_h+x_l)(y_h+y_l)
    exact on the FP8 engine.  ``torch.round`` rounds half to even, as the
    reference's ``jnp.round``.
    """
    r32 = res.to(torch.int32)
    hi = torch.round(r32.to(torch.float32) / 16.0).to(torch.int32)
    lo = r32 - 16 * hi
    return hi, lo


def fp8_karatsuba_combine(H: torch.Tensor, Mid: torch.Tensor, L: torch.Tensor,
                          m: int) -> torch.Tensor:
    """Recombine the three Karatsuba planes mod m (balanced int32 in, balanced out).

    x·y = 256·H + 16·(Mid − H − L) + L.  Planes are reduced mod m before
    recombination, so every int32 intermediate stays below 2**17.
    """
    def bal(v):
        u = torch.remainder(v, m)
        return torch.where(u > (m - 1) // 2, u - m, u)

    Hm, Lm, Midm = bal(H), bal(L), bal(Mid)
    return bal((256 % m) * Hm + (16 % m) * (Midm - Hm - Lm) + Lm)
