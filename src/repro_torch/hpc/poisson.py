"""Spectral Poisson solver on periodic grids (``repro.hpc.poisson``).

Solves the second-order finite-difference Poisson problem

    Δ_h u = f,   periodic boundary conditions, zero-mean gauge,

by diagonalising the periodic discrete Laplacian in the Fourier basis: the
forward and inverse transforms are ``repro_torch.spectral`` FFTs (every
multiplication an emulated GEMM through the dispatch seam) and each mode is
divided by the exact eigenvalue

    lambda(k) = sum_axis (2 cos(2*pi*k_a / n_a) - 2) / h_a**2,

so the solve is direct: one forward transform, one diagonal scale, one inverse
transform.  The zero mode is projected out (the periodic operator has a
constant nullspace): the returned u has zero mean and solves Δ_h u = f - mean(f).
Zero-Dirichlet problems reduce to it by odd extension.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import spectral
from repro_torch.core import compensated


def laplacian_eigenvalues(shape: Sequence[int],
                          spacings: Optional[Sequence[float]] = None) -> np.ndarray:
    """Eigenvalues of the periodic FD Laplacian on a ``shape`` grid (numpy float64)."""
    if spacings is None:
        spacings = [1.0] * len(shape)
    lam = np.zeros(tuple(shape))
    for ax, (n, h) in enumerate(zip(shape, spacings)):
        k = np.arange(n)
        lam_1d = (2.0 * np.cos(2.0 * np.pi * k / n) - 2.0) / (h * h)
        bshape = [1] * len(shape)
        bshape[ax] = n
        lam = lam + lam_1d.reshape(bshape)
    return lam


@dataclasses.dataclass
class PoissonResult:
    u: torch.Tensor       # zero-mean solution
    residual: float       # ||Δ_h u - (f - mean f)|| / ||f - mean f|| (compensated norms)


def poisson_solve_periodic(f: torch.Tensor,
                           spacings: Optional[Sequence[float]] = None,
                           mode: Optional[str] = None) -> torch.Tensor:
    """Direct spectral solve of Δ_h u = f - mean(f) on a periodic grid.

    f: real float64 tensor of any rank (each axis a periodic dimension).  ``mode``
    forwards to the dispatch seam for every GEMM inside the transforms.
    """
    f = torch.as_tensor(f)
    lam = torch.from_numpy(laplacian_eigenvalues(tuple(f.shape), spacings)).to(f.device)
    fhat = spectral.fftn(f, mode=mode)
    # Zero mode: lambda = 0 exactly; project it out (zero-mean gauge).
    nz = lam != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, lam, torch.ones_like(lam)),
                      torch.zeros_like(lam))
    return spectral.ifftn(fhat * inv, mode=mode).real


def apply_periodic_laplacian(u: torch.Tensor,
                             spacings: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Δ_h u with periodic wrap: the operator the spectral solve inverts."""
    if spacings is None:
        spacings = [1.0] * u.ndim
    out = torch.zeros_like(u)
    for ax, h in enumerate(spacings):
        out = out + (torch.roll(u, 1, dims=ax) + torch.roll(u, -1, dims=ax)
                     - 2.0 * u) / (h * h)
    return out


def poisson_solve_checked(f: torch.Tensor,
                          spacings: Optional[Sequence[float]] = None,
                          mode: Optional[str] = None) -> PoissonResult:
    """Solve and report the true relative residual (compensated norms, which
    take the same ``mode``)."""
    f = torch.as_tensor(f)
    u = poisson_solve_periodic(f, spacings=spacings, mode=mode)
    rhs = f - torch.mean(f)
    res = apply_periodic_laplacian(u, spacings=spacings) - rhs
    denom = float(compensated.compensated_norm(rhs, mode=mode))
    rel = float(compensated.compensated_norm(res, mode=mode)) / max(denom, 1e-300)
    return PoissonResult(u=u, residual=rel)


def manufactured_rhs(shape: Tuple[int, ...],
                     spacings: Optional[Sequence[float]] = None,
                     seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f, u_exact) on the CPU: draw a zero-mean u from numpy's generator, apply
    the operator."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape)
    u = torch.from_numpy(u - u.mean())
    return apply_periodic_laplacian(u, spacings=spacings), u


def odd_extension(f: torch.Tensor) -> torch.Tensor:
    """Antisymmetric periodic extension: each axis n -> 2(n + 1).

    Along every axis the interior samples f_1..f_n (grid points 1..n of a
    0..n+1 Dirichlet grid) are embedded as

        [0, f_1, ..., f_n, 0, -f_n, ..., -f_1],

    which is odd about both boundary points.  The periodic FD Laplacian keeps
    this antisymmetry, so its zero-mean solution restricted to the interior
    solves the homogeneous Dirichlet problem.
    """
    f = torch.as_tensor(f)
    for ax in range(f.ndim):
        zshape = list(f.shape)
        zshape[ax] = 1
        zero = torch.zeros(zshape, dtype=f.dtype, device=f.device)
        f = torch.cat([zero, f, zero, -torch.flip(f, dims=(ax,))], dim=ax)
    return f


def poisson_solve_dirichlet(f: torch.Tensor,
                            spacings: Optional[Sequence[float]] = None,
                            mode: Optional[str] = None) -> torch.Tensor:
    """Direct spectral solve of Δ_h u = f with zero-Dirichlet boundaries.

    f holds the interior grid values (any rank); the returned u has the same
    shape and satisfies the zero-halo FD Laplacian that
    ``repro_torch.hpc.jacobi`` applies through the stencil kernel.  Internally:
    odd extension, periodic spectral solve, restriction.  The extended right-hand
    side has exactly zero mean, so the gauge loses nothing.
    """
    f = torch.as_tensor(f)
    g = odd_extension(f)
    u = poisson_solve_periodic(g, spacings=spacings, mode=mode)
    return u[tuple(slice(1, n + 1) for n in f.shape)]
