"""Native-float64 accuracy oracles (``repro.kernels.ref``).

The emulated products are held to these within the paper's §2.5 bound; bitwise
checks compare a kernel with its plain version instead (``gemm_hilo_ref``,
``gemv_hilo_ref``) or a route with the reference route (``ozaki2.emulated_matmul``).
"""

from __future__ import annotations

import torch


def gemm_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))


def gemv_f64(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float64), x.to(torch.float64))
