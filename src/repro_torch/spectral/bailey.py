"""Bailey four-step FFT over the dispatch seam (``repro.spectral.bailey``).

For composite n = n1·n2 the DFT factors into two passes of batched small dense
DFT GEMMs around a diagonal twiddle scaling and a transpose:

    X[k2·n1 + k1] = Σ_j2 omega_n2^(j2·k2) · omega_n^(j2·k1)
                        · Σ_j1 omega_n1^(j1·k1) x[j1·n2 + j2]

  1. view x as an (n1, n2) matrix (row-major),
  2. DFT each column: one (n1, n1) GEMM over n2·batch stacked columns,
  3. scale by the twiddle table W[k1, j2] = omega_n^(±k1·j2) (elementwise, in
     float64: the one stage that is not a GEMM),
  4. transpose and DFT each row: one (n2, n2) GEMM over n1·batch columns,
  5. read the output transposed.

Both passes recurse through ``dft_stacked``, so long lengths factor down to
operators of at most DENSE_MAX and every multiplication goes through
``repro_torch.core.dispatch``.  Prime lengths fall back to the dense operator
(bounded by ``dft.DENSE_HARD_MAX``).

The twiddle product is written out in real arithmetic, (br·wr − bi·wi,
br·wi + bi·wr), each operation rounded once, on the CPU and on the card alike.
XLA-CPU computes the reference's complex product with two FMAs, so the two
packages differ there in the last bits; composite transforms are held to
``fft.dft_error_bound`` against the reference (ROADMAP queue 3, item 2).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.spectral import dft


def choose_factors(n: int) -> Optional[Tuple[int, int]]:
    """Balanced factorisation n = n1·n2 with n1 <= n2, or None if n is prime.

    n1 is the largest divisor at or below sqrt(n), which keeps both GEMM passes
    near the square.
    """
    for d in range(int(math.isqrt(n)), 1, -1):
        if n % d == 0:
            return d, n // d
    return None


def _twiddle_product(b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """b * w for complex b (n1, n2, batch) and w (n1, n2), in real arithmetic."""
    br, bi = b.real, b.imag
    wr, wi = w.real[:, :, None], w.imag[:, :, None]
    return torch.complex(br * wr - bi * wi, br * wi + bi * wr)


def dft_stacked(x: torch.Tensor, inverse: bool = False,
                mode: Optional[str] = None) -> torch.Tensor:
    """Unnormalised DFT along axis 0 of a complex (n, batch) stack.

    One dense GEMM up to ``dft.DENSE_MAX`` (and for prime n); the Bailey four
    steps with recursive factor transforms above it.
    """
    n, batch = x.shape
    if n <= 1:
        return x.to(dft.COMPLEX)
    factors = choose_factors(n) if n > dft.DENSE_MAX else None
    if factors is None:
        return dft.dft_dense(x, inverse=inverse, mode=mode)
    n1, n2 = factors

    # Steps 1 and 2: column DFTs of the (n1, n2) view, batched as one GEMM.
    b = dft_stacked(x.reshape(n1, n2 * batch), inverse=inverse, mode=mode)
    # Step 3: twiddle scaling.
    b = _twiddle_product(b.reshape(n1, n2, batch), dft.twiddle(n, n1, n2, inverse, x.device))
    # Step 4: transpose, then row DFTs as the second GEMM pass.
    c = torch.movedim(b, 1, 0).reshape(n2, n1 * batch)
    d = dft_stacked(c, inverse=inverse, mode=mode)
    # Step 5: the output is read transposed: X[k2·n1 + k1] = D[k2, k1].
    return d.reshape(n, batch)
