"""Public spectral transforms (``repro.spectral.fft``), with ``numpy.fft``'s
conventions.

Every transform composes the stacked axis-0 DFT of ``bailey.dft_stacked``:
  * ``fft`` / ``ifft``    — 1-D complex transforms along any axis,
  * ``fft2`` / ``fftn``   — multi-dimensional transforms by axis composition,
  * ``rfft`` / ``irfft``  — real-input / Hermitian-output transforms.

``fft`` is unnormalised, ``ifft`` carries the 1/n factor, and
``irfft(rfft(x), n) == x``.  ``mode`` forwards to the dispatch seam (None
inherits ``dispatch.mode_scope``), so every GEMM of a transform takes one route.
Results are complex128 (float64 for ``irfft``) on the input's device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.spectral import bailey, dft


def _apply_along_axis(x: torch.Tensor, axis: int, inverse: bool,
                      mode: Optional[str]) -> torch.Tensor:
    """DFT along ``axis``: move it to the front, flatten the rest as the batch."""
    x = torch.movedim(torch.as_tensor(x), axis, 0).to(dft.COMPLEX)
    shp = x.shape
    out = bailey.dft_stacked(x.reshape(shp[0], -1), inverse=inverse, mode=mode)
    return torch.movedim(out.reshape(shp), 0, axis)


def fft(x: torch.Tensor, axis: int = -1, mode: Optional[str] = None) -> torch.Tensor:
    """Unnormalised complex DFT along ``axis`` (the ``numpy.fft.fft`` contract)."""
    return _apply_along_axis(x, axis, inverse=False, mode=mode)


def ifft(x: torch.Tensor, axis: int = -1, mode: Optional[str] = None) -> torch.Tensor:
    """Inverse DFT along ``axis`` with the 1/n normalisation."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    return _apply_along_axis(x, axis, inverse=True, mode=mode) / n


def _resolve_axes(ndim: int, axes: Optional[Sequence[int]]) -> Tuple[int, ...]:
    if axes is None:
        return tuple(range(ndim))
    return tuple(int(a) for a in axes)


def fftn(x: torch.Tensor, axes: Optional[Sequence[int]] = None,
         mode: Optional[str] = None) -> torch.Tensor:
    """N-dimensional DFT by axis composition (default: all axes)."""
    x = torch.as_tensor(x)
    for a in _resolve_axes(x.ndim, axes):
        x = fft(x, axis=a, mode=mode)
    return x


def ifftn(x: torch.Tensor, axes: Optional[Sequence[int]] = None,
          mode: Optional[str] = None) -> torch.Tensor:
    x = torch.as_tensor(x)
    for a in _resolve_axes(x.ndim, axes):
        x = ifft(x, axis=a, mode=mode)
    return x


def fft2(x: torch.Tensor, axes: Tuple[int, int] = (-2, -1),
         mode: Optional[str] = None) -> torch.Tensor:
    return fftn(x, axes=axes, mode=mode)


def ifft2(x: torch.Tensor, axes: Tuple[int, int] = (-2, -1),
          mode: Optional[str] = None) -> torch.Tensor:
    return ifftn(x, axes=axes, mode=mode)


def rfft(x: torch.Tensor, axis: int = -1, mode: Optional[str] = None) -> torch.Tensor:
    """Real-input DFT: the n//2 + 1 non-redundant coefficients along ``axis``,
    the full complex transform sliced to its Hermitian half."""
    x = torch.as_tensor(x)
    if x.is_complex():
        raise ValueError("rfft requires real input (matching numpy.fft.rfft); "
                         "use fft for complex operands")
    n = x.shape[axis]
    full = fft(x, axis=axis, mode=mode)
    return full.narrow(axis, 0, n // 2 + 1)


def irfft(x: torch.Tensor, n: Optional[int] = None, axis: int = -1,
          mode: Optional[str] = None) -> torch.Tensor:
    """Inverse of ``rfft``: Hermitian-extend the half spectrum, inverse-DFT,
    return the real part (length ``n``, default 2·(m − 1) for m coefficients)."""
    x = torch.as_tensor(x).to(dft.COMPLEX)
    ax = axis if axis >= 0 else x.ndim + axis
    m = x.shape[ax]
    if n is None:
        n = 2 * (m - 1)
    # numpy's semantics: the half spectrum is truncated or zero-padded to the
    # n//2 + 1 coefficients a length-n transform uses.
    need = n // 2 + 1
    if m > need:
        x = x.narrow(ax, 0, need)
    elif m < need:
        pad = list(x.shape)
        pad[ax] = need - m
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)], dim=ax)
    m = need
    k_mirror = n - torch.arange(m, n, device=x.device)   # n-k in [1, m-1]: in range
    tail = torch.conj(torch.index_select(x, ax, k_mirror))
    full = torch.cat([x, tail], dim=ax)
    return ifft(full, axis=ax, mode=mode).real


def dft_error_bound(n: int) -> float:
    """Forward relative-error model of the emulated transform: the seam's GEMM
    is correctly rounded, so the bound is the twiddle and stage term
    ~ u·(number of four-step levels + 1)·sqrt(n), u = 2⁻⁵³."""
    u = 2.0 ** -53
    levels = 1
    nn = n
    while nn > dft.DENSE_MAX and bailey.choose_factors(nn) is not None:
        nn = bailey.choose_factors(nn)[1]
        levels += 1
    return u * levels * (float(n) ** 0.5)
