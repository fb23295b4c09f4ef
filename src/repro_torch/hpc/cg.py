"""Conjugate Gradient on the emulated kernel stack (``repro.hpc.cg``).

The recipe for iterative solvers on FP64-starved hardware (paper §7.1(a)):
  * the matvec (the dominant cost) runs through the Ozaki-II GEMV at
    FP64-equivalent accuracy, routed by the dispatch seam;
  * the BLAS-1 reductions (dot products, norms) run with compensated
    accumulation (``repro_torch.core.compensated``);
  * no iterative-refinement outer loop is needed.

Alongside the compensated recurrence the solver records the same quantities
recomputed with plain working-precision dots (``history_plain``).
``cg_solve`` is generic over the matvec; ``cg_solve_bell`` and
``cg_solve_dense`` wire in the dispatch-routed Blocked-ELL SpMV and dense GEMV.
With telemetry on, every recorded residual (iteration 0 included) is also a
``solver.cg`` event, beside the seam events of the matvec and reductions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional

import torch

from repro_torch.core import compensated, dispatch, ozaki2
from repro_torch.core.numerics import sqrt
from repro_torch.obs import telemetry as obs


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iters: int
    residual: float
    converged: bool
    history: list                 # compensated relative-residual recurrence
    history_plain: list = dataclasses.field(default_factory=list)
    # same reductions in plain working precision (observability, not control)


def cg_solve(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
             maxiter: int = 500,
             dot: Callable = compensated.compensated_dot,
             norm: Callable = compensated.compensated_norm,
             record_plain: bool = True) -> CGResult:
    """Textbook CG; compensated reductions drive the recurrence and the stop
    test, a plain-dot shadow history records what uncompensated working
    precision reports for the same iterates.  ``record_plain=False`` drops the
    shadow reduction (one extra dot and host sync per iteration)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = r
    rs = dot(r, r)
    bnorm = norm(b)
    bnorm_plain = sqrt(torch.dot(b, b)) if record_plain else None

    history: List[float] = [float(sqrt(rs) / bnorm)]
    history_plain: List[float] = []
    obs.record_event("solver.cg", dims=tuple(b.shape), iter=0, rel_residual=history[0])
    if record_plain:
        history_plain.append(float(sqrt(torch.dot(r, r)) / bnorm_plain))
    it = 0
    for it in range(1, maxiter + 1):
        ap = matvec(p)
        alpha = rs / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        history.append(float(sqrt(rs_new) / bnorm))
        obs.record_event("solver.cg", dims=tuple(b.shape), iter=it,
                         rel_residual=history[-1])
        if record_plain:
            history_plain.append(float(sqrt(torch.dot(r, r)) / bnorm_plain))
        if history[-1] < tol:
            return CGResult(x, it, history[-1], True, history, history_plain)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return CGResult(x, it, history[-1], False, history, history_plain)


def _routed(mode: Optional[str], kw: dict) -> dict:
    """cg_solve's keywords with its dot and norm on ``mode``'s route (unless given)."""
    kw.setdefault("dot", functools.partial(compensated.compensated_dot, mode=mode))
    kw.setdefault("norm", functools.partial(compensated.compensated_norm, mode=mode))
    return kw


def cg_solve_bell(a_val: torch.Tensor, a_col: torch.Tensor, b: torch.Tensor,
                  plan: Optional[ozaki2.Plan] = None, out_rep: str = "f64",
                  mode: Optional[str] = None, **kw) -> CGResult:
    """CG with the Ozaki-II Blocked-ELL SpMV as the matvec, dispatch-routed
    (reference route or the ``spmv_bell`` kernel per ``mode`` / ``mode_scope``,
    ``auto`` by the tensors' device), and its compensated dots and norm on the
    same route.  The plan resolves once, not per iteration; Phase 1 of
    ``a_val`` is redone by every matvec."""
    if plan is None:
        plan = dispatch.get_plan(a_val.shape[1], margin_bits=4)

    def matvec(x):
        return dispatch.spmv(a_val, a_col, x, plan=plan, out_rep=out_rep, mode=mode)
    return cg_solve(matvec, b, **_routed(mode, kw))


def cg_solve_dense(a: torch.Tensor, b: torch.Tensor,
                   plan: Optional[ozaki2.Plan] = None,
                   mode: Optional[str] = None, **kw) -> CGResult:
    """CG on a dense SPD matrix with the emulated matvec routed through the
    dispatch seam (reference route or the ``gemv_hilo`` kernel per ``mode`` /
    ``mode_scope``, ``auto`` by the tensors' device), and its compensated dots
    and norm on the same route."""
    if plan is None:
        plan = dispatch.get_plan(a.shape[-1], margin_bits=4)

    def matvec(x):
        return dispatch.matmul(a, x[:, None], plan=plan, mode=mode)[:, 0]
    return cg_solve(matvec, b, **_routed(mode, kw))
