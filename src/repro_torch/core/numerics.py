"""Error-free transformations and the double-single carrier (``repro.core.numerics``).

Every EFT is written as separate torch operations.  Each torch elementwise op
rounds once, on the CPU and on CUDA, so no multiply-add is ever contracted into
an FMA; fused ops such as ``addcmul`` or ``addmm(beta=...)`` are deliberately
not used, because they could round differently from the JAX reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free transformation: a + b = s + e exactly (Knuth)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """EFT valid when |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _veltkamp_split(a: torch.Tensor, bits: int) -> Pair:
    c = (2.0 ** bits + 1.0) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free product a*b = p + e (Veltkamp/Dekker splitting)."""
    p = a * b
    bits = 27 if a.dtype == torch.float64 else 12
    ah, al = _veltkamp_split(a, bits)
    bh, bl = _veltkamp_split(b, bits)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded (IEEE) square root on the tensor's device.

    torch's CPU kernel is not correctly rounded: about 0.7% of its float64
    results are one ulp off (measured on torch 2.13+cpu, AVX-512), which moves
    the compensated norms and CG's residual history off the reference's bits.
    numpy's CPU square root and CUDA's ``sqrt`` are correctly rounded.
    """
    if x.device.type == "cpu":
        return torch.as_tensor(np.sqrt(x.detach().numpy()), dtype=x.dtype)
    return torch.sqrt(x)


def ds_from_f64(x: torch.Tensor) -> Pair:
    """Split float64 into (hi, lo) float32 with hi + lo == x to f32-pair precision."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def ds_to_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return hi.to(torch.float64) + lo.to(torch.float64)


def ds_add(a: Pair, b: Pair) -> Pair:
    """Double-single addition (f32 pairs), ~45-bit accuracy."""
    s, e = two_sum(a[0], b[0])
    e = e + a[1] + b[1]
    return fast_two_sum(s, e)
