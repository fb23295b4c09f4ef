"""Sparse-matrix format tooling for the Blocked-ELL SpMV kernel (paper §5.4;
``repro.hpc.spmv_formats``, numpy only).

``to_blocked_ell`` converts a dense/COO matrix to the (values, columns) padded
layout; ``padding_ratio`` is Appendix D's ρ_pad — the lower bound on the TME β
for the SpMV kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def to_blocked_ell(dense: np.ndarray, bw: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (M, N) -> (values (M, bw), columns (M, bw)); raises if a row has
    more than bw nonzeros.  Padded slots point at column 0 with value 0."""
    M, N = dense.shape
    val = np.zeros((M, bw), dense.dtype)
    col = np.zeros((M, bw), np.int32)
    for i in range(M):
        nz = np.nonzero(dense[i])[0]
        if len(nz) > bw:
            raise ValueError(f"row {i} has {len(nz)} > bw={bw} nonzeros")
        val[i, :len(nz)] = dense[i, nz]
        col[i, :len(nz)] = nz
    return val, col


def laplacian_1d(n: int) -> np.ndarray:
    return (np.diag(2.0 * np.ones(n)) - np.diag(np.ones(n - 1), 1)
            - np.diag(np.ones(n - 1), -1))


def laplacian_2d(nx: int, ny: int) -> np.ndarray:
    """5-point 2-D Laplacian, (nx*ny, nx*ny) SPD."""
    n = nx * ny
    a = np.zeros((n, n))
    for i in range(nx):
        for j in range(ny):
            k = i * ny + j
            a[k, k] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nx and 0 <= jj < ny:
                    a[k, ii * ny + jj] = -1.0
    return a


def padding_ratio(val: np.ndarray) -> float:
    """Appendix D ρ_pad: stored slots / actual nonzeros (>= 1)."""
    stored = val.size
    actual = int(np.count_nonzero(val))
    return stored / max(actual, 1)
