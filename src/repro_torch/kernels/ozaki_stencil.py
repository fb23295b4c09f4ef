"""Fused Ozaki-II 7-point stencil: the Hopper kernel ``stencil7`` and its plain version.

v = S[c] u on an (X, Y, Z) grid with coefficients c ordered
[centre, -x, +x, -y, +y, -z, +z] and a zero halo (every global face).  u and c
each take one global power-of-two scale (``_global_scale_to_int``), are split
into (hi, lo) int32, and every output is rebuilt exactly from its residues over
the plan's moduli.  Replaces the TPU kernel
``repro/kernels/ozaki_stencil.py::stencil7``.  The CUDA source,
``csrc/ozaki_stencil.cu``, states the kernel's bound on the H100 and its design:
it takes u and c as float64 and does their Phase 1 itself, from the absolute
maxima and their floor(log2) that ``_scales`` computes in torch on the card.
``stencil7_ref`` is the same arithmetic as torch ops.  Every integer step is
exact and point-local, so the two are bitwise equal whatever the blocking.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import ozaki2, splitting
from repro_torch.kernels import _build, common
from repro_torch.kernels.ozaki_gemm import OUT_CODES, check_cuda, check_plan, out_shape

# Blocks of csrc/ozaki_stencil.cu: bz threads along z times by along y, each
# thread also forming at most one point of the tile's edge halo, marching along
# x over bx planes.
MAX_BLOCK_THREADS = 256
_MAX_GRID_YZ = 65535


def _global_scale_to_int(x: torch.Tensor, payload_bits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scale_to_int`` with one power-of-two shift for the whole array.

    Returns (xi, shift): integer-valued float64 with |xi| < 2**payload_bits,
    and the int32 0-d shift with xi ≈ x * 2**shift."""
    absmax = x.abs().amax()
    e = torch.floor(torch.log2(torch.where(absmax > 0, absmax, 1.0)))
    shift = (payload_bits - 1) - e.to(torch.int32)
    scaled = splitting.ldexp(x, shift.expand(x.shape))
    too_big = scaled.abs().amax() >= 2.0 ** payload_bits
    shift = shift - too_big.to(torch.int32)
    scaled = torch.where(too_big, scaled * 0.5, scaled)
    return torch.round(scaled), shift


def _roll_mask(arr: torch.Tensor, ax: int, d: int) -> torch.Tensor:
    """Shift by one along ``ax`` with a zero fill at the exposed boundary."""
    rolled = torch.roll(arr, d, dims=ax)   # a new tensor: the fill does not touch arr
    idx = [slice(None)] * arr.ndim
    idx[ax] = 0 if d == 1 else -1
    rolled[tuple(idx)] = 0
    return rolled


def _decompose(u: torch.Tensor, c: torch.Tensor, plan: ozaki2.Plan):
    """Phase 1 of the kernel and of its plain version: global scaling of u and
    c, the (hi, lo) split of u, and the (r, 7) int32 residues of c."""
    ui, su = _global_scale_to_int(u.to(torch.float64), plan.payload_bits)
    ci, sc = _global_scale_to_int(c.to(torch.float64), plan.payload_bits)
    u_hi, u_lo = splitting.split_hi_lo(ui)
    c_hi, c_lo = splitting.split_hi_lo(ci)
    c_res = torch.stack(common.residues_int32(c_hi, c_lo, plan.moduli))
    return u_hi, u_lo, c_res, su + sc


def _contract_ref(u_hi: torch.Tensor, u_lo: torch.Tensor, c_res: torch.Tensor,
                  plan: ozaki2.Plan, out_rep: str) -> torch.Tensor:
    """Plain version of the kernel proper: (hi, lo) of u and the residues of c
    to the raw output (f64 | ds | digits) of the scaled integer stencil.

    One modulus at a time: the residues of u, their six zero-filled shifts
    (the residue of a shifted point is the shifted residue, and the residue of
    the zero halo is 0), and seven int32 multiply-adds, exact in any order
    (|sum| <= 7 * 128**2).  Only the r accumulators stay alive across moduli."""
    accs = []
    for i, m in enumerate(plan.moduli):
        res = common.residue(u_hi, u_lo, m)
        ci = c_res[i]
        acc = ci[0] * res
        for d, (ax, sgn) in enumerate(((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))):
            acc = acc + ci[d + 1] * _roll_mask(res, ax, sgn)
        del res
        accs.append(common.balanced_mod(acc, m))
    return common.represent(common.garner_digits(accs, plan), plan, out_rep)


def _finish(raw: torch.Tensor, plan: ozaki2.Plan, out_rep: str,
            shift: torch.Tensor) -> torch.Tensor:
    v = common.raw_to_f64(raw, plan, out_rep)
    return splitting.ldexp(v, (-shift).expand(v.shape))


def stencil7_ref(u: torch.Tensor, c: torch.Tensor, plan: ozaki2.Plan,
                 out_rep: str = "f64") -> torch.Tensor:
    """Plain torch version of ``stencil7`` (the reference route); float64 (X, Y, Z)."""
    if out_rep not in common.OUT_REPS:
        raise ValueError(f"out_rep must be one of {common.OUT_REPS}, got {out_rep!r}")
    u_hi, u_lo, c_res, shift = _decompose(u, c, plan)
    return _finish(_contract_ref(u_hi, u_lo, c_res, plan, out_rep), plan, out_rep, shift)


def _scales(u: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The torch part of the kernel's Phase 1: the absolute maxima of u (one
    ``aminmax`` pass) and of c, and floor(log2) of each (of 1 for a zero
    maximum) as ``_global_scale_to_int`` takes it: float64 (2,) and int32 (2,),
    on u's device, with no host sync."""
    mn, mx = torch.aminmax(u)
    a = torch.stack((torch.maximum(-mn, mx), c.abs().amax()))
    return a, torch.floor(torch.log2(torch.where(a > 0, a, 1.0))).to(torch.int32)


def _check_block(X: int, Y: int, bz: int, by: int, bx: int) -> None:
    """Raise unless (bz, by, bx) is a block the kernel takes for an (X, Y, .) grid."""
    if bz < 1 or by < 1 or bx < 1 or bz * by > MAX_BLOCK_THREADS or 2 * (bz + by) > bz * by:
        raise ValueError(f"stencil7: block ({bz}, {by}) must have 1..{MAX_BLOCK_THREADS} "
                         f"threads and at least 2 (bz + by) of them, bx ({bx}) >= 1")
    if -(-X // bx) > _MAX_GRID_YZ or -(-Y // by) > _MAX_GRID_YZ:
        raise ValueError(f"stencil7: grid ({X}, {Y}, .) too large for block ({bz}, {by}, {bx})")


def _launch(u: torch.Tensor, c: torch.Tensor, absmax: torch.Tensor, elog: torch.Tensor,
            plan: ozaki2.Plan, out_rep: str, bz: int, by: int, bx: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel on float64 u and c and their ``_scales``: (the raw output,
    the int32 total shift).  For f64 the raw output is already unscaled; ds and
    digits are those of the scaled integer stencil, which ``_finish`` unscales."""
    X, Y, Z = u.shape
    _check_block(X, Y, bz, by, bx)
    shape, dtype = out_shape(out_rep, plan.r, X, Y, Z)
    dev = u.device
    out = torch.empty(shape, dtype=dtype, device=dev)
    shift = torch.zeros((), dtype=torch.int32, device=dev)
    lib = _build.library("ozaki_stencil")
    err = lib.ozaki_stencil7(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        u.data_ptr(), c.data_ptr(), absmax.data_ptr(), elog.data_ptr(), plan.payload_bits,
        X, Y, Z, bz, by, bx, OUT_CODES[out_rep], out.data_ptr(),
        None if out_rep == "f64" else shift.data_ptr(),
        ctypes.addressof(_build.garner_params(plan)), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil7: CUDA launch failed with error {err}")
    return out, shift


def stencil7(u: torch.Tensor, c: torch.Tensor, plan: ozaki2.Plan, out_rep: str = "f64",
             *, bz: int, by: int, bx: int = 64) -> torch.Tensor:
    """Emulated FP64-accurate 7-point stencil; float64 (X, Y, Z) on u's device.

    u (X, Y, Z), c (7,) ordered [centre, -x, +x, -y, +y, -z, +z], zero halo.
    CPU tensors take the plain version; CUDA tensors launch the kernel with
    blocks of bz (along z) x by (along y) threads marching over bx planes along
    x (``dispatch.stencil7`` takes them from the tuning table), or raise.  The
    result does not depend on the block.
    """
    if u.ndim != 3 or tuple(c.shape) != (7,):
        raise ValueError(f"stencil7 takes u (X, Y, Z) and c (7,), got {tuple(u.shape)} "
                         f"and {tuple(c.shape)}")
    if u.device != c.device:
        raise ValueError(f"stencil7: u on {u.device}, c on {c.device}")
    if not (u.is_floating_point() and c.is_floating_point()):
        raise TypeError(f"stencil7: u and c must be floating point, got {u.dtype}, {c.dtype}")
    if out_rep not in common.OUT_REPS:
        raise ValueError(f"out_rep must be one of {common.OUT_REPS}, got {out_rep!r}")
    if u.device.type == "cpu":
        return stencil7_ref(u, c, plan, out_rep)
    check_plan("stencil7", plan)
    u = u.to(torch.float64).contiguous()
    c = c.to(torch.float64).contiguous()
    check_cuda("stencil7", (u, c))
    absmax, elog = _scales(u, c)
    raw, shift = _launch(u, c, absmax, elog, plan, out_rep, bz, by, bx)
    stencil7.launches += 1
    return raw if out_rep == "f64" else _finish(raw, plan, out_rep, shift)


stencil7.launches = 0  # kernel launches since the count was last set to 0
