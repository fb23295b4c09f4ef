"""Pairwise-coprime moduli selection and Garner (CRT) constants for Ozaki Scheme II.

The paper (Ozaki/Uchino/Imamura 2025, as summarised in Matsuoka 2026 §2.3) requires a
set of pairwise-coprime moduli m_1 < ... < m_r with product M > 2 * max|(Ã B̃)_ij| so the
integer product is uniquely recoverable from its residues.  We use *balanced* residues
(values in [-(m-1)//2 - (m even), (m-1)//2]) so every residue of every modulus <= 256
fits a signed INT8 lane, which is what the TPU MXU int8 path (and the paper's INT8
tensor-core path) consumes.

All constants here are precomputed with exact Python integers and exported as numpy
arrays; the torch code uses them as Python scalars and the CUDA kernels receive them
as a launch-parameter block.  This module is a verbatim copy of the JAX package's
``repro.core.moduli`` (plain Python and numpy), kept here so that ``repro_torch``
never imports ``repro``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence, Tuple

import numpy as np

# 2**8 first (exactly the int8 span), then descending odd primes.  Pairwise coprime by
# construction (a power of two plus distinct odd primes).  The first 16 moduli cover
# ~123.7 bits (full 53-bit FP64 payload up to k ~ 2**13); the tail extends coverage to
# k ~ 2**32 for very long contractions.
DEFAULT_MODULI: Tuple[int, ...] = (
    256, 251, 241, 239, 233, 229, 227, 223, 211, 199, 197, 193, 191, 181, 179, 173,
    167, 163, 157, 151,
)

# Split radix for the (hi, lo) int32 representation of the 53-bit scaled integers:
# x = hi * 2**SPLIT_BITS + lo with |lo| <= 2**(SPLIT_BITS-1).  26 keeps |hi| < 2**27
# for |x| < 2**53, so both halves are comfortable int32 values (TPU has no fast int64).
SPLIT_BITS = 26
SPLIT_RADIX = 1 << SPLIT_BITS


def _egcd(a: int, b: int) -> Tuple[int, int, int]:
    if b == 0:
        return a, 1, 0
    g, x, y = _egcd(b, a % b)
    return g, y, x - (a // b) * y


def modinv(a: int, m: int) -> int:
    """Modular inverse of a (mod m); raises if gcd(a, m) != 1."""
    g, x, _ = _egcd(a % m, m)
    if g != 1:
        raise ValueError(f"{a} has no inverse mod {m}")
    return x % m


def check_pairwise_coprime(moduli: Sequence[int]) -> bool:
    for i in range(len(moduli)):
        for j in range(i + 1, len(moduli)):
            if math.gcd(moduli[i], moduli[j]) != 1:
                return False
    return True


def balanced(x: int, m: int) -> int:
    """Balanced representative of x mod m, in [-(m//2), (m-1)//2] (int convention)."""
    v = x % m
    if v > (m - 1) // 2:
        v -= m
    return v


@dataclasses.dataclass(frozen=True)
class GarnerConstants:
    """Precomputed tables for vectorised balanced-digit Garner reconstruction.

    With moduli (m_1..m_r) and prefix products P_j = m_1 * ... * m_{j-1} (P_1 = 1):
      * ``inv_pref[j]``   = P_j^{-1} mod m_j                    (paper eq. (7))
      * ``pref_mod[j,l]`` = P_j mod m_l  (used to update running partial sums)
      * ``pref_f64[j]``   = P_j rounded to float64 (reconstruction weights), and
        ``pref_f64_lo[j]`` the exact double-double tail P_j - fl(P_j), so the
        reconstruction can run in compensated double-double arithmetic and return the
        *correctly rounded* float of the exact integer.
    """

    moduli: Tuple[int, ...]
    inv_pref: np.ndarray       # (r,) int32
    pref_mod: np.ndarray       # (r, r) int32 ; pref_mod[j, l] = P_j mod m_l
    pref_f64: np.ndarray       # (r,) float64
    pref_f64_lo: np.ndarray    # (r,) float64 ; exact tails P_j - fl(P_j)
    prod: int                  # exact M = prod(moduli), python int

    @property
    def r(self) -> int:
        return len(self.moduli)


@functools.lru_cache(maxsize=None)
def garner_constants(moduli: Tuple[int, ...]) -> GarnerConstants:
    if not check_pairwise_coprime(moduli):
        raise ValueError(f"moduli not pairwise coprime: {moduli}")
    r = len(moduli)
    pref = [1] * r
    for j in range(1, r):
        pref[j] = pref[j - 1] * moduli[j - 1]
    inv_pref = np.array([modinv(pref[j], moduli[j]) for j in range(r)], dtype=np.int32)
    pref_mod = np.array(
        [[pref[j] % moduli[l] for l in range(r)] for j in range(r)], dtype=np.int32
    )
    pref_f64 = np.array([float(p) for p in pref], dtype=np.float64)
    pref_f64_lo = np.array([float(p - int(float(p))) for p in pref], dtype=np.float64)
    prod = pref[-1] * moduli[-1]
    return GarnerConstants(
        moduli=tuple(moduli), inv_pref=inv_pref, pref_mod=pref_mod,
        pref_f64=pref_f64, pref_f64_lo=pref_f64_lo, prod=prod,
    )


def capacity_bits(moduli: Sequence[int]) -> float:
    """log2 of the CRT range M = prod(moduli)."""
    return float(sum(math.log2(m) for m in moduli))


def required_r(k: int, payload_bits: int = 53, margin_bits: int = 2,
               moduli: Sequence[int] = DEFAULT_MODULI) -> int:
    """Smallest moduli count r such that prod(m_1..m_r) > 2^margin * k * 2^(2*payload).

    max |(Ã B̃)_ij| <= k * 2^(2*payload); uniqueness of the balanced representative
    needs M > 2*max; margin_bits adds headroom (default: M > 4*max).
    """
    need = 2 * payload_bits + math.ceil(math.log2(max(k, 1))) + margin_bits
    acc = 0.0
    for i, m in enumerate(moduli):
        acc += math.log2(m)
        if acc > need:
            return i + 1
    raise ValueError(
        f"moduli table exhausted: need {need} bits, have {acc:.1f} from {len(moduli)}"
    )


def max_payload_bits(r: int, k: int, margin_bits: int = 2,
                     moduli: Sequence[int] = DEFAULT_MODULI) -> int:
    """Largest per-operand integer width p supported by the first r moduli at length k."""
    cap = capacity_bits(moduli[:r])
    p = int((cap - math.ceil(math.log2(max(k, 1))) - margin_bits - 1e-9) // 2)
    return max(p, 1)
