"""Native-float64 accuracy oracles (``repro.kernels.ref``).

The emulated products are held to these within the paper's §2.5 bound; bitwise
checks compare a kernel with its plain version instead (``gemm_hilo_ref``,
``gemv_hilo_ref``, ``stencil7_ref``, ``spmv_bell_ref``) or a route with the
reference route (``ozaki2.emulated_matmul``).
"""

from __future__ import annotations

import torch


def gemm_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))


def gemv_f64(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float64), x.to(torch.float64))


def stencil7_f64(u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """7-point stencil with zero halo; c = [centre, -x, +x, -y, +y, -z, +z]."""
    u = u.to(torch.float64)
    c = c.to(torch.float64)

    def masked(arr, ax, d):
        rolled = torch.roll(arr, d, dims=ax)
        idx = [slice(None)] * 3
        idx[ax] = 0 if d == 1 else -1
        rolled[tuple(idx)] = 0.0
        return rolled

    return (c[0] * u
            + c[1] * masked(u, 0, 1) + c[2] * masked(u, 0, -1)
            + c[3] * masked(u, 1, 1) + c[4] * masked(u, 1, -1)
            + c[5] * masked(u, 2, 1) + c[6] * masked(u, 2, -1))


def spmv_bell_f64(a_val: torch.Tensor, a_col: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Blocked-ELL SpMV oracle: y_i = sum_j a_val[i,j] * x[a_col[i,j]]."""
    gathered = x.to(torch.float64)[a_col.to(torch.int64)]
    return (a_val.to(torch.float64) * gathered).sum(dim=-1)
