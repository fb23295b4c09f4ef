"""Dense DFT as one GEMM on the emulation dispatch seam (``repro.spectral.dft``).

The spectral package's ground rule: its only multiplications are matrix
products routed through ``repro_torch.core.dispatch``, so every transform keeps
the Ozaki-II accuracy contract and the seam's routes (on the card, ``gemm_hilo``
for more than ``dispatch.GEMV_MAX_B`` columns, ``gemv_hilo`` otherwise).

A length-n complex DFT is one real GEMM.  With F = Fr + i·Fi, the complex
product F·X splits into the realified block form

    [Cr]   [Fr  -Fi] [Xr]
    [Ci] = [Fi   Fr]·[Xi]

so the (2n, 2n) block operator is built once per (n, direction, device),
cached, and applied to the stacked real and imaginary parts with one
``dispatch.matmul`` call.

The tables are built in float64 by the reference's numpy code, with exact
argument reduction (j·k mod n in int64), so their bits equal the reference's.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dispatch

# Transforms at or below this length run as one dense DFT GEMM; longer lengths go
# through the Bailey four-step factorisation (repro_torch.spectral.bailey).
DENSE_MAX = 64

# Hard cap on the dense fallback (taken only for a length with no factorisation,
# a prime): a (2n, 2n) operator above this is a memory bug, not a path.
DENSE_HARD_MAX = 4096

# Realified operators above this length are built on each call instead of
# cached: the composite path needs only factor-sized operators (<= DENSE_MAX),
# and the prime fallback could otherwise pin unbounded (2n, 2n) float64 arrays
# (n = 4093 alone is ~536 MB) on the device for the life of the process.
CACHE_MAX = 4 * DENSE_MAX

# Twiddle tables above this n (16n bytes each) are built on each call instead of
# cached, for the same reason.
TWIDDLE_CACHE_MAX = 1 << 16

FLOAT = torch.float64
COMPLEX = torch.complex128


def _roots_of_unity(row: np.ndarray, col: np.ndarray, n: int,
                    inverse: bool) -> np.ndarray:
    """omega_n^(±row·col) with exact int64 argument reduction mod n."""
    jk = np.mod(np.outer(row.astype(np.int64), col.astype(np.int64)), n)
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * jk.astype(np.float64) / float(n)
    return np.cos(ang) + 1j * np.sin(ang)


def dft_matrix(n: int, inverse: bool = False) -> np.ndarray:
    """Unnormalised complex DFT matrix F[j, k] = omega_n^(±jk), complex128 numpy."""
    idx = np.arange(n)
    return _roots_of_unity(idx, idx, n, inverse)


def _build_realified(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    f = dft_matrix(n, inverse)
    blk = np.block([[f.real, -f.imag], [f.imag, f.real]])
    return torch.from_numpy(blk).to(device=device, dtype=FLOAT)


@functools.lru_cache(maxsize=None)
def _realified_dft(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return _build_realified(n, inverse, device)


def realified_dft(n: int, inverse: bool = False,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """(2n, 2n) realified block operator [[Fr, -Fi], [Fi, Fr]], float64 on
    ``device`` (the CPU by default), cached per device up to ``CACHE_MAX``."""
    if n > DENSE_HARD_MAX:
        raise ValueError(
            f"dense DFT fallback refused for n={n} > {DENSE_HARD_MAX} "
            "(prime length with no four-step factorisation; pad to a "
            "composite length instead)")
    device = torch.device("cpu" if device is None else device)
    if n > CACHE_MAX:
        return _build_realified(int(n), bool(inverse), device)
    return _realified_dft(int(n), bool(inverse), device)


def _build_twiddle(n: int, n1: int, n2: int, inverse: bool,
                   device: torch.device) -> torch.Tensor:
    w = _roots_of_unity(np.arange(n1), np.arange(n2), n, inverse)
    return torch.from_numpy(w).to(device=device, dtype=COMPLEX)


@functools.lru_cache(maxsize=None)
def _twiddle(n: int, n1: int, n2: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return _build_twiddle(n, n1, n2, inverse, device)


def twiddle(n: int, n1: int, n2: int, inverse: bool = False,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """(n1, n2) four-step twiddle W[k1, j2] = omega_n^(±k1·j2), complex128 on
    ``device`` (the CPU by default), cached per device up to ``TWIDDLE_CACHE_MAX``."""
    device = torch.device("cpu" if device is None else device)
    if n > TWIDDLE_CACHE_MAX:
        return _build_twiddle(int(n), int(n1), int(n2), bool(inverse), device)
    return _twiddle(int(n), int(n1), int(n2), bool(inverse), device)


def cache_clear() -> None:
    """Drop the cached DFT operators and twiddle tables."""
    _realified_dft.cache_clear()
    _twiddle.cache_clear()


def dft_dense(x: torch.Tensor, inverse: bool = False,
              mode: Optional[str] = None) -> torch.Tensor:
    """Unnormalised DFT along axis 0 of a stacked (n, batch) complex operand.

    One realified GEMM through the dispatch seam: stack the real over the
    imaginary parts into a (2n, batch) real operand, multiply by the cached
    (2n, 2n) block operator, and rejoin the halves as the complex result.
    """
    n = x.shape[0]
    op = realified_dft(n, inverse, x.device)
    x = x.to(COMPLEX)
    xb = torch.cat([x.real, x.imag], dim=0)
    out = dispatch.matmul(op, xb, mode=mode)
    return torch.complex(out[:n], out[n:])
