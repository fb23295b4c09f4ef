"""The compensated reductions on the card: the Hopper kernels ``norm_scale``,
``block_tree`` and ``carry_fold``, and their plain versions.

A reduction over the last axis of (L, n) lanes runs, on the kernel route
(``core/compensated.py`` with mode ``kernel``, or ``auto`` on CUDA tensors):

  ``norm_scale``  (2-norm only) per lane, the largest finite |x| as IEEE bits
                  and the NaN (1) and inf (2) flags, from which the norm's exact
                  power-of-two scale comes;
  ``block_tree``  per block of ``block`` elements, the pairwise two_sum tree of
                  ``compensated._block_tree`` over x, two_prod(x, y) or the
                  scaled two_prod(xs, xs): the partials (s_b, c_b), (L, nb);
  ``carry_fold``  per lane, the partials strictly in block order,
                  s, e = two_sum(s, s_b[k]) and c = c + (e + c_b[k]) from
                  s = c = +0, then s + c: the reference's ``lax.scan`` in
                  ``repro/core/compensated.py::_carry_scan``; for the norm also
                  the norm's scalar epilogue.

``csrc/carry_fold.cu`` holds the three kernels.  Each wrapper takes its plain
version for CPU tensors and launches its kernel for CUDA tensors, or raises.
The plain versions are torch ops (the tree, the pre-pass) and numpy running
sums on the host (``carry_fold_ref``); every operation rounds alike in both,
so they are bitwise equal.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

DTYPE_BYTES = {torch.float64: 8, torch.float32: 4}
# The kernels' bit types: uint64 / uint32 words, held in int64 / int32 tensors.
BITS_DTYPE = {torch.float64: torch.int64, torch.float32: torch.int32}
KINDS = {"sum": 0, "dot": 1, "norm": 2}
MAX_BLOCK = 1 << 30    # elements of a tree block (a warp reduces 512 at a time)


def _check(s_b: torch.Tensor, c_b: torch.Tensor) -> None:
    if s_b.shape != c_b.shape or s_b.ndim < 1:
        raise ValueError(f"carry_fold takes two (nblocks, ...) partials of one shape, got "
                         f"{tuple(s_b.shape)} and {tuple(c_b.shape)}")
    if s_b.dtype != c_b.dtype or s_b.device != c_b.device:
        raise ValueError(f"carry_fold: partials of {s_b.dtype} on {s_b.device} and "
                         f"{c_b.dtype} on {c_b.device}")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
        if t.dtype not in DTYPE_BYTES:
            raise TypeError(f"{name}: the kernel takes float64 or float32, got {t.dtype}")


def _device_args(t: torch.Tensor):
    dev = t.device
    return (dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# The 2-norm's pre-pass
# ---------------------------------------------------------------------------

def norm_scale_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``norm_scale``: for x (L, n), the largest finite |x| of
    each lane as IEEE bits (int64 for float64, int32 for float32; 0 for a lane
    with no finite nonzero) and its flags (int32: 1 NaN, 2 inf)."""
    it = BITS_DTYPE[x.dtype]
    sign = torch.iinfo(it).max                      # every bit but the sign
    bits = torch.where(torch.isfinite(x), x.contiguous().view(it) & sign, 0)
    mb = bits.amax(dim=-1) if x.shape[-1] else torch.zeros(x.shape[:-1], dtype=it,
                                                            device=x.device)
    flags = (torch.isnan(x).any(dim=-1).to(torch.int32)
             + 2 * torch.isinf(x).any(dim=-1).to(torch.int32))
    return mb, flags


def norm_scale(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass of ``compensated_norm`` over x (L, n): (bits, flags) of
    ``norm_scale_ref``.  CPU tensors take the plain version; CUDA tensors of
    float64 or float32 launch the kernel, or raise."""
    if x.ndim != 2:
        raise ValueError(f"norm_scale takes x (L, n), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return norm_scale_ref(x)
    _check_cuda("norm_scale", x)
    x = x.contiguous()
    L, n = x.shape
    bits = torch.empty(L, dtype=BITS_DTYPE[x.dtype], device=x.device)
    flags = torch.empty(L, dtype=torch.int32, device=x.device)
    device, stream = _device_args(x)
    err = _build.library("carry_fold").carry_norm_scale(
        device, DTYPE_BYTES[x.dtype], x.data_ptr(), n, L, bits.data_ptr(), flags.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"norm_scale: CUDA launch failed with error {err}")
    norm_scale.launches += 1
    return bits, flags


norm_scale.launches = 0  # kernel launches since the count was last set to 0


def scale_exp_ref(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """compensated_norm's scale es (int32) from ``norm_scale``'s bits: the
    exponent floor(log2 |x|) of the largest finite |x|, 0 for a zero lane."""
    from repro_torch.core.compensated import _ieee_layout  # deferred: compensated imports us

    _, mb, eb, _ = _ieee_layout(dtype)
    expf = (bits >> mb).to(torch.int32)
    mant = bits & ((1 << mb) - 1)
    _, mex = torch.frexp(mant.to(dtype))             # exact: mant < 2**mb
    es = torch.where(expf != 0, expf - eb, (1 - eb - mb) + mex - 1)
    return torch.where(bits == 0, torch.zeros_like(es), es)


# ---------------------------------------------------------------------------
# The blocked two_sum tree
# ---------------------------------------------------------------------------

def _leaves(x: torch.Tensor, y: Optional[torch.Tensor], scale_bits: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tree's leaves (p, e) as ``core/compensated.py`` forms them."""
    from repro_torch.core import compensated  # deferred: compensated imports us

    if scale_bits is not None:
        m, e = compensated._decompose(torch.where(torch.isfinite(x), x, torch.zeros_like(x)))
        es = scale_exp_ref(scale_bits, x.dtype)[:, None]
        xs = m * compensated._pow2(e - es, x.dtype)
        return compensated.two_prod(xs, xs)
    if y is not None:
        return compensated.two_prod(x, y)
    return x, torch.zeros_like(x)


def block_tree_ref(x: torch.Tensor, y: Optional[torch.Tensor], block: int,
                   scale_bits: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``block_tree``: the partials (s_b, c_b), each (L, nb),
    of x (L, n) (a sum), of two_prod(x, y) (a dot) or, given ``norm_scale``'s
    bits, of two_prod(xs, xs) for the scaled x (a 2-norm), by
    ``compensated._block_partials``."""
    from repro_torch.core import compensated  # deferred: compensated imports us

    s_b, c_b = compensated._block_partials(*_leaves(x, y, scale_bits), block)
    return s_b.t(), c_b.t()


def block_tree(x: torch.Tensor, y: Optional[torch.Tensor], block: int,
               scale_bits: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partials of ``block_tree_ref``, (L, nb) contiguous.  CPU tensors take
    the plain version; CUDA tensors of float64 or float32 launch the kernel
    (blocks of 1 .. ``MAX_BLOCK`` elements), or raise."""
    if x.ndim != 2 or (y is not None and y.shape != x.shape):
        raise ValueError(f"block_tree takes x (L, n) and y of its shape, got "
                         f"{tuple(x.shape)}, {None if y is None else tuple(y.shape)}")
    if y is not None and scale_bits is not None:
        raise ValueError("block_tree: a dot (y) or a norm (scale_bits), not both")
    if x.device.type == "cpu":
        return block_tree_ref(x, y, block, scale_bits)
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block_tree: the kernel takes blocks of 1..{MAX_BLOCK}, got {block}")
    _check_cuda("block_tree", x, *(() if y is None else (y,)))
    if y is not None and (y.dtype != x.dtype or y.device != x.device):
        raise ValueError(f"block_tree: x of {x.dtype} on {x.device}, y of {y.dtype} on "
                         f"{y.device}")
    x = x.contiguous()
    y = None if y is None else y.contiguous()
    if scale_bits is not None:
        if scale_bits.dtype != BITS_DTYPE[x.dtype] or scale_bits.shape != x.shape[:1]:
            raise ValueError("block_tree: scale_bits must be norm_scale's bits of x")
        scale_bits = scale_bits.to(x.device).contiguous()
    L, n = x.shape
    nb = -(-n // block)
    s_b = torch.empty((L, nb), dtype=x.dtype, device=x.device)
    c_b = torch.empty_like(s_b)
    kind = "norm" if scale_bits is not None else "dot" if y is not None else "sum"
    device, stream = _device_args(x)
    err = _build.library("carry_fold").carry_tree(
        device, DTYPE_BYTES[x.dtype], KINDS[kind], x.data_ptr(),
        None if y is None else y.data_ptr(),
        None if scale_bits is None else scale_bits.data_ptr(), n, L, block, s_b.data_ptr(),
        c_b.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"block_tree: CUDA launch failed with error {err}")
    block_tree.launches += 1
    return s_b, c_b


block_tree.launches = 0  # kernel launches since the count was last set to 0


# ---------------------------------------------------------------------------
# The carry fold
# ---------------------------------------------------------------------------

def carry_fold_ref(s_b: torch.Tensor, c_b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``carry_fold`` on the host; the result on s_b's device.

    Both running sums are strictly left to right, which numpy's
    ``add.accumulate`` is, so they are taken there (with the zero start
    prepended, which keeps the sign of a zero) and every two_sum error
    elementwise from them: the bits of the loop at the cost of a few passes.
    """
    _check(s_b, c_b)
    sb = s_b.detach().cpu().numpy()
    cb = c_b.detach().cpu().numpy()
    zero = np.zeros((1,) + sb.shape[1:], sb.dtype)
    with np.errstate(invalid="ignore", over="ignore"):   # inf and NaN propagate as in torch
        s = np.add.accumulate(np.concatenate([zero, sb]), axis=0)
        prev, s = s[:-1], s[1:]
        v = s - prev                                     # two_sum(prev, sb), elementwise
        e = (prev - (s - v)) + (sb - v)
        c = np.add.accumulate(np.concatenate([zero, e + cb]), axis=0)[-1]
        out = np.asarray((s[-1] if len(s) else zero[0]) + c)
    return torch.as_tensor(out, device=s_b.device)


def _fold(s_b: torch.Tensor, c_b: torch.Tensor,
          norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The CUDA kernel on (L, nb) contiguous partials: (L,), the fold of each
    lane or, given ``norm_scale``'s (bits, flags), its 2-norm."""
    L, nb = s_b.shape
    out = torch.empty(L, dtype=s_b.dtype, device=s_b.device)
    bits, flags = norm if norm is not None else (None, None)
    device, stream = _device_args(s_b)
    err = _build.library("carry_fold").carry_fold(
        device, DTYPE_BYTES[s_b.dtype], s_b.data_ptr(), c_b.data_ptr(), nb, L,
        None if bits is None else bits.data_ptr(), None if flags is None else flags.data_ptr(),
        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"carry_fold: CUDA launch failed with error {err}")
    carry_fold.launches += 1
    return out


def carry_fold(s_b: torch.Tensor, c_b: torch.Tensor) -> torch.Tensor:
    """Fold partials (nblocks, *batch) over the leading axis, in order: (*batch).

    CPU tensors take the plain version; CUDA tensors of float64 or float32
    launch the kernel, or raise.
    """
    _check(s_b, c_b)
    if s_b.device.type == "cpu":
        return carry_fold_ref(s_b, c_b)
    _check_cuda("carry_fold", s_b)
    batch = tuple(s_b.shape[1:])
    lanes = math.prod(batch)
    sb = s_b.reshape(s_b.shape[0], lanes).t().contiguous()
    cb = c_b.reshape(c_b.shape[0], lanes).t().contiguous()
    return _fold(sb, cb).reshape(batch)


carry_fold.launches = 0  # kernel launches since the count was last set to 0


# ---------------------------------------------------------------------------
# A whole reduction on the kernel route
# ---------------------------------------------------------------------------

def reduce(x: torch.Tensor, y: Optional[torch.Tensor] = None, *, block: int,
           norm: bool = False) -> torch.Tensor:
    """The compensated sum (x), dot (x, y) or, with ``norm``, 2-norm of each
    lane of CUDA x (L, n): (L,), by the three kernels (the pre-pass for the
    norm, the tree, the fold)."""
    if x.device.type != "cuda":
        raise ValueError(f"the reduction kernels take CUDA tensors, got {x.device}")
    scale = norm_scale(x) if norm else None
    s_b, c_b = block_tree(x, y, block, None if scale is None else scale[0])
    return _fold(s_b, c_b, scale)
