"""The carry fold of the compensated reductions: the Hopper kernel ``carry_fold``
and its plain version.

After the blocked two_sum tree (``core/compensated.py``) every reduction lane
holds one partial (s_b, c_b) per block.  The fold takes them strictly in block
order, s, e = two_sum(s, s_b[k]) and c = c + (e + c_b[k]) from s = c = +0, and
returns s + c: the reference's ``lax.scan`` in
``repro/core/compensated.py::_carry_scan``.  The order fixes the bits, so the
fold is one dependent chain per lane.  ``csrc/carry_fold.cu`` runs it on the
card, one thread per lane; ``carry_fold_ref`` runs it on the host with numpy.
Both round every operation alike, so they are bitwise equal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build

DTYPE_BYTES = {torch.float64: 8, torch.float32: 4}


def _check(s_b: torch.Tensor, c_b: torch.Tensor) -> None:
    if s_b.shape != c_b.shape or s_b.ndim < 1:
        raise ValueError(f"carry_fold takes two (nblocks, ...) partials of one shape, got "
                         f"{tuple(s_b.shape)} and {tuple(c_b.shape)}")
    if s_b.dtype != c_b.dtype or s_b.device != c_b.device:
        raise ValueError(f"carry_fold: partials of {s_b.dtype} on {s_b.device} and "
                         f"{c_b.dtype} on {c_b.device}")


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


def _launch(s_b: torch.Tensor, c_b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on contiguous (nblocks, lanes) partials: (lanes,)."""
    nb, lanes = s_b.shape
    dev = s_b.device
    out = torch.empty(lanes, dtype=s_b.dtype, device=dev)
    lib = _build.library("carry_fold")
    err = lib.carry_fold(dev.index if dev.index is not None else torch.cuda.current_device(),
                         DTYPE_BYTES[s_b.dtype], s_b.data_ptr(), c_b.data_ptr(), nb, lanes,
                         out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"carry_fold: CUDA launch failed with error {err}")
    return out


def carry_fold(s_b: torch.Tensor, c_b: torch.Tensor) -> torch.Tensor:
    """Fold partials (nblocks, *batch) over the leading axis, in order: (*batch).

    CPU tensors take the plain version; CUDA tensors of float64 or float32
    launch the kernel, or raise.
    """
    _check(s_b, c_b)
    if s_b.device.type == "cpu":
        return carry_fold_ref(s_b, c_b)
    if s_b.device.type != "cuda":
        raise ValueError(f"carry_fold: the kernel takes CUDA tensors, got {s_b.device}")
    if s_b.dtype not in DTYPE_BYTES:
        raise TypeError(f"carry_fold: the kernel takes float64 or float32, got {s_b.dtype}")
    batch = tuple(s_b.shape[1:])
    lanes = math.prod(batch)
    sb = s_b.reshape(s_b.shape[0], lanes).contiguous()
    cb = c_b.reshape(c_b.shape[0], lanes).contiguous()
    out = _launch(sb, cb)
    carry_fold.launches += 1
    return out.reshape(batch)


carry_fold.launches = 0  # kernel launches since the count was last set to 0
