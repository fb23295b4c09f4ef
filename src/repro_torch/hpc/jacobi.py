"""Weighted-Jacobi relaxation on the 7-point Laplacian (``repro.hpc.jacobi``).

The operator application, the dominant cost of a sweep, is the emulated
7-point stencil behind the dispatch seam (``repro_torch.core.dispatch.stencil7``),
and the stopping test's compensated norms route too (kind ``reduce``), so
``mode`` / ``mode_scope`` flips every kernel of the solver between the Hopper
kernels and their bitwise-equal plain versions.  The update is elementwise.

Discretisation: the second-order finite-difference Laplacian on a regular
grid with homogeneous Dirichlet boundary conditions (the stencil's zero halo
*is* the boundary condition):

    (Δ_h u)_ijk = Σ_axis (u_{-} - 2 u + u_{+}) / h_axis²,  u = 0 outside.

``jacobi_solve`` solves Δ_h u = f by damped Jacobi:

    u ← u + ω D⁻¹ (f - Δ_h u),   D = diag(Δ_h) = -Σ_axis 2 / h_axis².

ω = 1 is classical Jacobi; ω = 2/3 is the standard multigrid smoother weighting.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.core import compensated, dispatch, ozaki2


def _coeff_list(spacings: Optional[Sequence[float]]) -> List[float]:
    if spacings is None:
        spacings = [1.0] * 3
    hx, hy, hz = (float(h) for h in spacings)
    return [-2.0 / hx**2 - 2.0 / hy**2 - 2.0 / hz**2,
            1.0 / hx**2, 1.0 / hx**2,
            1.0 / hy**2, 1.0 / hy**2,
            1.0 / hz**2, 1.0 / hz**2]


def laplacian_coeffs(spacings: Optional[Sequence[float]] = None,
                     device=None) -> torch.Tensor:
    """Stencil coefficients of the 3-D FD Laplacian in the kernel's
    [centre, -x, +x, -y, +y, -z, +z] ordering, float64 on ``device``."""
    return torch.tensor(_coeff_list(spacings), dtype=torch.float64, device=device)


def apply_dirichlet_laplacian(u: torch.Tensor,
                              spacings: Optional[Sequence[float]] = None,
                              plan: Optional[ozaki2.Plan] = None,
                              mode: Optional[str] = None) -> torch.Tensor:
    """Δ_h u with zero-Dirichlet halo, through the dispatch-routed stencil."""
    return dispatch.stencil7(u, laplacian_coeffs(spacings, device=u.device), plan=plan,
                             mode=mode)


@dataclasses.dataclass
class JacobiResult:
    u: torch.Tensor
    iters: int
    residual: float               # final relative residual ||f - Δ_h u||/||f||
    converged: bool
    history: list                 # compensated relative-residual per sweep


def jacobi_solve(f: torch.Tensor,
                 spacings: Optional[Sequence[float]] = None,
                 omega: float = 1.0,
                 tol: float = 1e-8,
                 maxiter: int = 2000,
                 x0: Optional[torch.Tensor] = None,
                 plan: Optional[ozaki2.Plan] = None,
                 mode: Optional[str] = None,
                 check_every: int = 1) -> JacobiResult:
    """Solve Δ_h u = f (zero-Dirichlet) by ω-damped Jacobi relaxation.

    Every sweep applies the 7-point operator through the dispatch seam (one
    emulated stencil per sweep, plus one for the initial residual) and relaxes
    u ← u + ω D⁻¹ r.  The residual norm (compensated) is evaluated every
    ``check_every`` sweeps; ``history`` records it for each evaluation,
    starting with the initial residual.  The plan resolves once.
    """
    if f.ndim != 3:
        raise ValueError(f"jacobi_solve expects a 3-D grid, got shape {tuple(f.shape)}")
    if plan is None:
        plan = dispatch.get_plan(8, margin_bits=4)
    coeffs = _coeff_list(spacings)
    c = torch.tensor(coeffs, dtype=torch.float64, device=f.device)
    diag = coeffs[0]
    u = torch.zeros_like(f) if x0 is None else x0

    fnorm = max(float(compensated.compensated_norm(f, mode=mode)), 1e-300)

    def residual(u):
        return f - dispatch.stencil7(u, c, plan=plan, mode=mode)

    r = residual(u)
    rel = float(compensated.compensated_norm(r, mode=mode)) / fnorm
    history: List[float] = [rel]
    if rel < tol:
        return JacobiResult(u, 0, rel, True, history)

    it = 0
    for it in range(1, maxiter + 1):
        u = u + (omega / diag) * r
        r = residual(u)
        if it % check_every == 0 or it == maxiter:
            rel = float(compensated.compensated_norm(r, mode=mode)) / fnorm
            history.append(rel)
            if rel < tol:
                return JacobiResult(u, it, rel, True, history)
    return JacobiResult(u, it, history[-1], False, history)
