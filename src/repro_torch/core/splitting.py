"""Phase-1 integer scaling and the (hi, lo) int32 operand representation
(``repro.core.splitting``).

  * ``scale_to_int`` computes Ã = ⌊D A⌉ with a power-of-two diagonal D chosen per
    row (or per column for the right operand) so the largest entry uses the full
    payload width p.  Power-of-two scaling is exact, so D⁻¹ C̃ E⁻¹ is error-free.
  * ``split_hi_lo`` carries each scaled integer as an exact pair of int32 halves,
    x = hi·2²⁶ + lo: 8 bytes per element, the same traffic as native FP64.
  * ``residues_from_hilo`` computes balanced residues mod m with int32 arithmetic.

``ldexp`` is the reference's algorithm (``jnp.ldexp``: frexp, fold the exponent,
one multiply by an exact power of two).  ``torch.ldexp`` is not used: on CUDA it
is ``x * 2**n``, which overflows for the shifts above 1023 that rows of tiny
magnitude need.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.moduli import SPLIT_RADIX

# dtype -> (bit-int dtype, mantissa bits, exponent bias)
_IEEE = {
    torch.float32: (torch.int32, 23, 127),
    torch.float64: (torch.int64, 52, 1023),
}


def exact_pow2(e: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """2**e as ``dtype``, built from bit fields: exact over the whole range,
    denormals included; 0 below the smallest denormal, inf above the largest
    finite power."""
    it, mb, eb = _IEEE[dtype]
    e = e.to(it).clamp(-(eb + mb), eb + 1)
    normal = (e + eb).clamp(min=0) << mb
    denorm = torch.ones_like(e) << (e + (eb - 1 + mb)).clamp(min=0)
    denorm = torch.where(e < -(eb - 1 + mb), torch.zeros_like(e), denorm)
    return torch.where(e > -eb, normal, denorm).view(dtype)


def ldexp(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x * 2**n with one rounding (the algorithm of ``jnp.ldexp``)."""
    m, e = torch.frexp(x)
    e = e.to(torch.int32) + n.to(torch.int32)
    # the exponent may overflow by one and still give a finite result
    pos = e > 0
    m = torch.where(pos, m * 2, m)
    e = torch.where(pos, e - 1, e)
    y = m * exact_pow2(e, x.dtype)
    return torch.where(torch.isinf(x) | (x == 0), x, y)


def scale_to_int(x: torch.Tensor, payload_bits: int, axis: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round x (float) to integers after exact power-of-two scaling along ``axis``.

    Returns (xi, shift):
      xi    : float array holding exact integers with |xi| < 2**payload_bits
      shift : int32 per-row/col exponents with  xi ≈ x * 2**shift

    Slices along ``axis`` that are entirely zero get shift ``payload_bits - 1``
    (their exponent is taken as 0).
    """
    ax = axis % x.ndim
    absmax = x.abs().amax(dim=ax, keepdim=True)
    # exponent e with 2**e <= absmax < 2**(e+1); for absmax == 0 use e = 0.
    e = torch.floor(torch.log2(torch.where(absmax > 0, absmax, 1.0)))
    shift = (payload_bits - 1) - e.to(torch.int32)
    scaled = ldexp(x, shift.expand(x.shape))
    # Guard against the log2 boundary: ensure scaled max strictly < 2**payload_bits.
    too_big = scaled.abs().amax(dim=ax, keepdim=True) >= 2.0 ** payload_bits
    shift = shift - too_big.to(torch.int32)
    scaled = torch.where(too_big, scaled * 0.5, scaled)
    return torch.round(scaled), shift.squeeze(ax)


def split_hi_lo(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact split of an integer-valued float array into int32 (hi, lo).

    xi = hi * 2**SPLIT_BITS + lo, with |lo| <= 2**(SPLIT_BITS-1) (balanced) and
    |hi| < 2**(53-SPLIT_BITS+1).  Both halves fit int32 for |xi| < 2**53.
    """
    hi_f = torch.round(xi / SPLIT_RADIX)
    lo_f = xi - hi_f * SPLIT_RADIX
    return hi_f.to(torch.int32), lo_f.to(torch.int32)


def merge_hi_lo(hi: torch.Tensor, lo: torch.Tensor,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Inverse of split_hi_lo (float reconstruction of the exact integer)."""
    return hi.to(dtype) * float(SPLIT_RADIX) + lo.to(dtype)


def balanced_mod(v: torch.Tensor, m: int) -> torch.Tensor:
    """Balanced representative of v mod m: range [-(m//2), (m-1)//2].

    ``torch.remainder`` takes the floor, like ``jnp.remainder``."""
    u = torch.remainder(v, m)
    return torch.where(u > (m - 1) // 2, u - m, u)


def residue(hi: torch.Tensor, lo: torch.Tensor, m: int) -> torch.Tensor:
    """Balanced residue (int32) of x = hi*2^26 + lo mod m; int32-only arithmetic."""
    v = balanced_mod(hi, m) * (SPLIT_RADIX % m) + balanced_mod(lo, m)
    return balanced_mod(v, m)


def residues_from_hilo(hi: torch.Tensor, lo: torch.Tensor,
                       moduli: Sequence[int]) -> torch.Tensor:
    """Balanced residues (stacked axis 0, int8) of x = hi*2^26 + lo per modulus.

    Every balanced residue of every modulus <= 256 fits [-128, 127].
    """
    return torch.stack([residue(hi, lo, m).to(torch.int8) for m in moduli], dim=0)


def residues_direct(xi: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """Oracle path: balanced residues straight from the integer-valued float (int64)."""
    xl = xi.to(torch.int64)
    return torch.stack([balanced_mod(xl, m).to(torch.int8) for m in moduli], dim=0)


def apply_unscale(c: torch.Tensor, shift_rows: torch.Tensor,
                  shift_cols: torch.Tensor) -> torch.Tensor:
    """C = D⁻¹ C̃ E⁻¹: undo the exact power-of-two row/col scaling on the output."""
    total = -(shift_rows[..., :, None] + shift_cols[..., None, :])
    return ldexp(c, total.expand(c.shape))

