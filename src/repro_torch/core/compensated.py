"""Compensated reductions — the paper's BLAS-1 closure (``repro.core.compensated``).

BLAS-1 (dot products, norms, CG residuals) runs on the vector units with
error-free-transformation compensation instead of Ozaki emulation.

Blocked EFT execution, as in the reference:
  1. the operand is zero-padded (exact: ``two_sum(s, 0) = (s, 0)``) and
     reshaped to ``(nblocks, block)`` with ``block`` from the dispatch tuning
     table (``dispatch.reduce_block``);
  2. within each block a pairwise ``two_sum`` tree (``log2(block)`` lane-wise
     steps over all blocks at once) gives per-block partials ``(s_b, c_b)``;
  3. a carry-propagating fold over the ``nblocks`` partials, in order, folds
     them with ``two_sum`` (the reference's ``lax.scan``), feeding the carries
     into the compensation stream;
  4. the result is ``s + c``.
Two routes (dispatch kind ``reduce``; ``mode=`` or ``dispatch.mode_scope``,
``auto`` by the operand's device): ``kernel``, the Hopper kernels of
``kernels/carry_fold.py`` (the norm's pre-pass, the tree, the fold; CUDA
tensors of float64 or float32 only), and ``ref``, the plain version: the tree
as torch ops and the fold as numpy running sums on the host
(``carry_fold_ref``).  The two are bitwise equal.
Every ``two_sum``/``two_prod`` is exact and only the compensation stream is
summed in working precision, which gives the Ogita-Rump Sum2/Dot2 bound for any
blocking.  The element-wise ``*_scan`` forms are the parity references.

``compensated_norm`` scales by exact powers of two derived from IEEE bit fields
(``Tensor.view`` to the same-width integer type), as the reference does to stay
immune to flush-to-zero arithmetic; torch does not flush denormals, but the bit
path is kept so that the bits match the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch
from repro_torch.core.numerics import fast_two_sum, sqrt, two_prod, two_sum  # noqa: F401

__all__ = ["two_sum", "two_prod", "fast_two_sum", "neumaier_sum",
           "compensated_dot", "compensated_norm", "neumaier_sum_scan",
           "compensated_dot_scan"]


# ---------------------------------------------------------------------------
# Blocked fast path
# ---------------------------------------------------------------------------

def _resolve_block(n: int, block: Optional[int]) -> int:
    if block is None:
        block = dispatch.reduce_block(n)
    return max(1, min(int(block), n))


def _pad_to_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad the last axis to a block multiple (exact for sum and dot)."""
    pad = (-x.shape[-1]) % block
    return F.pad(x, (0, pad)) if pad else x


def _block_tree(p: torch.Tensor, c: torch.Tensor):
    """Pairwise two_sum tree over the last axis (all blocks at once).  Returns
    per-block partials (s_b, c_b); every discarded rounding term lands in the
    compensation stream c_b."""
    while p.shape[-1] > 1:
        if p.shape[-1] % 2:                  # odd width: add a zero lane (exact)
            p = F.pad(p, (0, 1))
            c = F.pad(c, (0, 1))
        s, e = two_sum(p[..., 0::2], p[..., 1::2])
        c = c[..., 0::2] + c[..., 1::2] + e
        p = s
    return p[..., 0], c[..., 0]


def _block_partials(p: torch.Tensor, e: torch.Tensor, block: int):
    """Per-block partials (s_b, c_b) of p (+ pre-existing error stream e) along
    the last axis, with the block axis leading (the carry fold's input)."""
    p = _pad_to_blocks(p, block)
    e = _pad_to_blocks(e, block)
    nb = p.shape[-1] // block
    shape = tuple(p.shape[:-1]) + (nb, block)
    s_b, c_b = _block_tree(p.reshape(shape), e.reshape(shape))
    return torch.movedim(s_b, -1, 0), torch.movedim(c_b, -1, 0)


def _blocked_sum2(p: torch.Tensor, e: torch.Tensor, block: int) -> torch.Tensor:
    """Compensated sum of p (+ pre-existing error stream e) along the last axis:
    the plain version (torch tree, host fold)."""
    from repro_torch.kernels import carry_fold  # deferred: the kernels import the core

    return carry_fold.carry_fold_ref(*_block_partials(p, e, block))


def _kernel_reduce(x: torch.Tensor, y: Optional[torch.Tensor], block: int,
                   norm: bool = False) -> torch.Tensor:
    """The kernel route over the last axis of x (and y): the batch's shape."""
    from repro_torch.kernels import carry_fold  # deferred: the kernels import the core

    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    lanes = x.reshape(-1, n) if lead else x.reshape(1, n)
    other = None if y is None else y.reshape(lanes.shape)
    return carry_fold.reduce(lanes, other, block=block, norm=norm).reshape(lead)


def _normalize_axis(axis: int, ndim: int) -> int:
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for ndim {ndim}")
    return axis % ndim


# ---------------------------------------------------------------------------
# Public reductions — blocked fast path
# ---------------------------------------------------------------------------

def neumaier_sum(x: torch.Tensor, axis: int = -1, block: Optional[int] = None,
                 mode: Optional[str] = None) -> torch.Tensor:
    """Compensated (twice-working-precision) sum along ``axis`` (batched)."""
    x = torch.movedim(x, _normalize_axis(axis, x.ndim), -1)
    block = _resolve_block(x.shape[-1], block)
    if dispatch.kernel_route(None, "reduce", mode, x.device):
        return _kernel_reduce(x, None, block)
    return _blocked_sum2(x, torch.zeros_like(x), block)


def compensated_dot(x: torch.Tensor, y: torch.Tensor, axis: int = -1,
                    block: Optional[int] = None, mode: Optional[str] = None) -> torch.Tensor:
    """Ogita-Rump Dot2 inner product: ~twice-working-precision accuracy.

    Every product is split exactly with ``two_prod`` and the accumulation
    carries the ``two_sum`` rounding errors.  ``axis`` selects the reduction
    axis (batched over the rest); operands must have matching shapes.
    """
    if x.shape != y.shape:
        raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
    ax = _normalize_axis(axis, x.ndim)
    x = torch.movedim(x, ax, -1)
    y = torch.movedim(y, ax, -1)
    block = _resolve_block(x.shape[-1], block)
    if dispatch.kernel_route(None, "reduce", mode, x.device):
        return _kernel_reduce(x, y, block)
    p, e = two_prod(x, y)
    return _blocked_sum2(p, e, block)


# IEEE-754 layouts: dtype -> (bit-int dtype, mantissa bits, exponent bias,
# exponent width).
_IEEE = {
    torch.float32: (torch.int32, 23, 127, 8),
    torch.float64: (torch.int64, 52, 1023, 11),
}


def _ieee_layout(dtype):
    try:
        return _IEEE[dtype]
    except KeyError:
        raise TypeError(f"compensated_norm: unsupported dtype {dtype}") from None


def _pow2(p: torch.Tensor, dtype) -> torch.Tensor:
    """Exact power of two ``2**p`` built from bit fields (clamped to the
    normal range)."""
    it, mb, eb, _ = _ieee_layout(dtype)
    p = torch.clamp(p, 1 - eb, eb)
    return ((p + eb).to(it) << mb).view(dtype)


def _decompose(x: torch.Tensor):
    """Exact ``|x| = m * 2**e`` from IEEE bit fields: ``m`` an integer-valued
    float in ``[0, 2**(mb+1))``, ``e`` an int32 exponent."""
    it, mb, eb, ew = _ieee_layout(x.dtype)
    bits = x.contiguous().view(it)
    bits = bits & ((1 << (mb + ew)) - 1)          # clear the sign bit
    expf = (bits >> mb).to(torch.int32)
    mant = bits & ((1 << mb) - 1)
    denorm = expf == 0
    m = torch.where(denorm, mant, mant | (1 << mb)).to(x.dtype)
    e = torch.where(denorm, torch.ones_like(expf), expf) - (eb + mb)
    return m, e


def compensated_norm(x: torch.Tensor, axis: Optional[int] = None,
                     mode: Optional[str] = None) -> torch.Tensor:
    """Overflow/underflow-safe compensated 2-norm ||x||_2.

    ``axis=None`` reduces over all elements; an integer ``axis`` reduces that
    axis only.  Edge cases match ``np.linalg.norm``: all-zero → 0.0, any NaN →
    NaN, otherwise any ±inf → +inf.
    """
    if axis is None:
        x = x.reshape(-1)
        ax = 0
    else:
        ax = _normalize_axis(axis, x.ndim)
    it, mb, eb, _ = _ieee_layout(x.dtype)
    if dispatch.kernel_route(None, "reduce", mode, x.device):
        xm = torch.movedim(x, ax, -1)
        return _kernel_reduce(xm, None, _resolve_block(xm.shape[-1], None), norm=True)
    finite = torch.isfinite(x)
    has_nan = torch.isnan(x).any(dim=ax)
    has_inf = torch.isinf(x).any(dim=ax)
    xf = torch.where(finite, x, torch.zeros_like(x))
    m, e = _decompose(xf)
    # floor(log2 |x_i|) = e + (exponent of m's leading bit)
    _, mex = torch.frexp(m)
    sentinel = -(1 << 30)
    elog = torch.where(m > 0, e + mex - 1, torch.full_like(e, sentinel))
    es = elog.amax(dim=ax, keepdim=True)
    es = torch.where(es == sentinel, torch.zeros_like(es), es)   # all-zero: scale 1
    xs = m * _pow2(e - es, x.dtype)
    r = sqrt(compensated_dot(xs, xs, ax, mode="ref"))   # in [1, ~2*sqrt(n)]
    es = es.squeeze(ax)
    # r * 2**es as two exact power-of-two multiplies ...
    half = torch.div(es, 2, rounding_mode="floor")
    big = (r * _pow2(half, x.dtype)) * _pow2(es - half, x.dtype)
    # ... and a result in the denormal range stored by integer-rounding its
    # significand: t = value * 2**(eb+mb-1) < 2**(mb+1) IS its bit pattern.
    t = r * _pow2(es + (eb + mb - 1), x.dtype)
    tiny = t < 2.0 ** (mb + 1)
    k = torch.round(torch.where(tiny, t, torch.zeros_like(t))).to(it)
    nrm = torch.where(tiny, k.view(x.dtype), big)
    nrm = torch.where(has_inf, torch.full_like(nrm, float("inf")), nrm)
    return torch.where(has_nan, torch.full_like(nrm, float("nan")), nrm)


# ---------------------------------------------------------------------------
# Element-wise scan references (the parity oracle for the blocked fast path)
# ---------------------------------------------------------------------------

def neumaier_sum_scan(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Kahan-Babuska-Neumaier compensated reduction along ``axis``, one element
    at a time: the parity oracle for the blocked fast path."""
    xm = torch.movedim(x, axis, 0)
    s = torch.zeros_like(xm[0])
    c = torch.zeros_like(xm[0])
    for xi in xm:
        t = s + xi
        c = c + torch.where(s.abs() >= xi.abs(), (s - t) + xi, (xi - t) + s)
        s = t
    return s + c


def compensated_dot_scan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Element-wise Dot2 over 1-D operands: the parity reference for the blocked
    ``compensated_dot``."""
    p, e = two_prod(x, y)
    s = torch.zeros((), dtype=x.dtype, device=x.device)
    c = torch.zeros((), dtype=x.dtype, device=x.device)
    for pi, ei in zip(p, e):
        s, e2 = two_sum(s, pi)
        c = c + (e2 + ei)
    return s + c
