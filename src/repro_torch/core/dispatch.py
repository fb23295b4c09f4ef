"""Emulation dispatch seam (``repro.core.dispatch``): plan cache and routing.

Every emulated multiplication resolves its configuration and its execution path
here:

  1. **Plan cache** — ``get_plan`` memoises ``ozaki2.make_plan`` on
     ``(k, payload_bits, substrate, r, margin_bits)`` and primes the Garner
     constants when it fills, so repeated calls (every CG iteration) reuse them.

  2. **Router** — one entry point per kernel kind picks one of two routes.
     ``matmul`` / ``dot``: ``kernel``, the hand-written Hopper kernels behind
     ``repro_torch.kernels.ops`` (``gemm_hilo`` for right-hand sides wider than
     ``GEMV_MAX_B`` columns, ``gemv_hilo`` otherwise), with the operands
     zero-padded to the kernels' tiles; and ``ref``, the unfused
     ``ozaki2.emulated_matmul``.  Zero padding is exact (padded rows and
     columns contribute zero residues).  The kernels implement the int8
     substrate; a plan on the FP8 substrate takes the reference route on every
     device, as in the reference (its planes' products run on the FP8 tensor
     cores through ``torch._scaled_mm`` on CUDA).  ``spmv`` (Blocked-ELL, kind
     ``spmv_bell``) and ``stencil7`` route between ``ozaki_spmv.spmv_bell`` /
     ``ozaki_stencil.stencil7`` and their plain versions ``spmv_bell_ref`` /
     ``stencil7_ref``.  ``attention`` routes between the fused online-softmax
     kernel ``ozaki_attention.attention_fused`` and ``attention_ref``, the same
     scan composed from ``emulated_matmul`` per key block.  The kernels repeat
     the reference's arithmetic op for op, so on one device the two routes are
     bitwise equal.

     The compensated reductions (kind ``reduce``) route between the fused
     two_sum tree and carry fold kernels (``kernels/carry_fold.py``) and their
     plain version, the torch tree and the host fold.

  3. **Mode** — the route follows, in priority order, an explicit ``mode=``
     argument and this thread's ``mode_scope`` / ``set_mode`` override; the
     default is ``auto``.  ``auto`` takes the kernel for CUDA tensors and the
     reference route for CPU tensors (``AUTO_ROUTE``, keyed on the operands'
     device).  ``kernel`` with CPU tensors raises: the kernels exist only on
     the card.

  4. **Tuning table** — ``get_tuning(kind, shape)`` resolves per-(kind,
     shape-class) parameters from ``TUNE_TABLE``: the kernels' padding granules
     for gemm/gemv, the CUDA blocks of spmv_bell and stencil7, attention's q
     and key blocks, and the block size of the compensated reductions
     (``reduce_block``).

  5. **Telemetry** — with recording on (``repro_torch.obs.telemetry``), every
     entry point records its kind, shape class, the route taken, the plan, its
     measured time and the TME prediction of the same op (``attention`` with a
     ``prefill`` (S > 1) or ``decode`` (S = 1) label), and the plan and tuning
     caches count their hits and misses.  ``dot`` records nothing of its own:
     it is one ``matmul``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import ozaki2
from repro_torch.obs import telemetry as obs

MODES = ("auto", "ref", "kernel")
KINDS = ("gemm", "gemv", "spmv_bell", "stencil7", "attention")
# The compensated reductions (core/compensated.py) route too, and take their
# block size from the tuning table; they need no plan.
TUNE_KINDS = KINDS + ("reduce",)

AUTO_ROUTE = {
    "gemm": {"cuda": "kernel", "default": "ref"},
    "gemv": {"cuda": "kernel", "default": "ref"},
    "spmv_bell": {"cuda": "kernel", "default": "ref"},
    "stencil7": {"cuda": "kernel", "default": "ref"},
    "attention": {"cuda": "kernel", "default": "ref"},
    "reduce": {"cuda": "kernel", "default": "ref"},
}

# RHS widths at or below this route to the batched-GEMV kernel instead of
# padding N up to a GEMM tile.
GEMV_MAX_B = 16

# attention's bq and bkv round up to multiples of this (the reference's sublane).
SUBLANE = 8

_tls = threading.local()


# ---------------------------------------------------------------------------
# Mode resolution
# ---------------------------------------------------------------------------

def _validate_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"dispatch mode must be one of {MODES}, got {mode!r}")
    return mode


def get_mode() -> str:
    """Effective dispatch mode: this thread's override, else ``auto``."""
    override = getattr(_tls, "mode", None)
    return "auto" if override is None else override


def set_mode(mode: Optional[str]) -> None:
    """Set (or with None, clear) this thread's dispatch-mode override."""
    _tls.mode = None if mode is None else _validate_mode(mode)


@contextlib.contextmanager
def mode_scope(mode: Optional[str]):
    """Temporarily force a dispatch mode (None = inherit the ambient mode)."""
    prev = getattr(_tls, "mode", None)
    set_mode(mode if mode is not None else prev)
    try:
        yield
    finally:
        _tls.mode = prev


# ---------------------------------------------------------------------------
# Plan / Garner-constant cache
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cached_plan(k: int, payload_bits: int, substrate: str, r: Optional[int],
                 margin_bits: int) -> ozaki2.Plan:
    plan = ozaki2.make_plan(k, payload_bits, r=r, substrate=substrate,
                            margin_bits=margin_bits)
    plan.garner  # noqa: B018 — prime the Garner constants at cache-fill time
    return plan


def get_plan(k: int, payload_bits: int = 53, substrate: str = "int8",
             r: Optional[int] = None, margin_bits: int = 2) -> ozaki2.Plan:
    """Cache-resolved Plan for contractions of length k (Garner pre-primed)."""
    if obs.enabled():
        before = _cached_plan.cache_info().misses
        plan = _cached_plan(int(k), int(payload_bits), substrate, r, margin_bits)
        obs.record_cache("plan", _cached_plan.cache_info().misses == before)
        return plan
    return _cached_plan(int(k), int(payload_bits), substrate, r, margin_bits)


def plan_cache_info():
    """lru_cache statistics for the plan cache."""
    return _cached_plan.cache_info()


def clear_plan_cache() -> None:
    """Drop every memoised Plan."""
    _cached_plan.cache_clear()


# ---------------------------------------------------------------------------
# Tuning table: (kind, shape-class) -> parameters
# ---------------------------------------------------------------------------

# "*" is the per-kind wildcard; specific shape classes (``shape_class``)
# override it.  gemm/gemv entries are the padding granules of the Hopper
# kernels (csrc/ozaki_gemm.cu: 128-row tiles, N in halves of its 256-column
# tile, K in 64; csrc/ozaki_gemv.cu: 8 rows per warp, 32-deep K steps).  spmv_bell's br is
# the rows (threads) per block of csrc/ozaki_spmv.cu; stencil7's block is bz
# threads along z by by along y marching over bx planes along x
# (csrc/ozaki_stencil.cu).  Neither changes a bit of the result.  attention's bq is the q rows of a tile of
# csrc/ozaki_attention.cu (two 16-row MMA tiles at 32; at most 16 above
# head_dim 128, where two do not fit a block's shared memory; the reference's
# 128 is a TPU VMEM tile) and does not change the result; its bkv, the key
# block, is part of the function (it sets plan_pv and p's scaling blocks) and
# stays the reference's 128.
TUNE_TABLE: Dict[Tuple[str, str], Dict[str, Any]] = {
    ("gemm", "*"): {"bm": 128, "bn": 128, "bk": 64},
    ("gemv", "*"): {"bm": 8, "bk": 32},
    ("spmv_bell", "*"): {"br": 128},
    ("stencil7", "*"): {"bz": 32, "by": 8, "bx": 64},
    ("attention", "*"): {"bq": 32, "bkv": 128},
    ("reduce", "*"): {"block": 512},
    # Kept from the reference's table (measured there on a CPU): >=64k-element
    # reductions take the shorter 256-lane block.
    ("reduce", "65536"): {"block": 256},
    ("reduce", "131072"): {"block": 256},
}

# Legality granules per kind (bm, bn, bk): tuned values round up to these.
_GRANULE = {"gemm": (128, 128, 64), "gemv": (8, 1, 32)}


def _next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def shape_class(dims: Sequence[int]) -> str:
    """Bucket a shape into its tuning class: each dim rounded up to the next
    power of two, joined with "x" (e.g. (100, 64, 24) -> "128x64x32")."""
    return "x".join(str(_next_pow2(d)) for d in dims)


@functools.lru_cache(maxsize=None)
def _cached_tuning(kind: str, cls: str) -> Dict[str, Any]:
    merged: Dict[str, Any] = {}
    for layer in (TUNE_TABLE.get((kind, "*")), TUNE_TABLE.get((kind, cls))):
        if layer:
            merged.update(layer)
    return merged


def get_tuning(kind: str, dims: Sequence[int]) -> Dict[str, Any]:
    """Tuning parameters for ``kind`` at this shape class (memoised; read-only)."""
    if kind not in TUNE_KINDS:
        raise ValueError(f"tuning kind must be one of {TUNE_KINDS}, got {kind!r}")
    if obs.enabled():
        before = _cached_tuning.cache_info().misses
        tuning = _cached_tuning(kind, shape_class(dims))
        obs.record_cache("tune", _cached_tuning.cache_info().misses == before)
        return tuning
    return _cached_tuning(kind, shape_class(dims))


def reduce_block(n: int) -> int:
    """Block size for the blocked-EFT reductions over length-n operands."""
    return max(1, int(get_tuning("reduce", (n,)).get("block", 512)))


# ---------------------------------------------------------------------------
# Shape normalisation
# ---------------------------------------------------------------------------

def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _matmul_kind(n: int) -> str:
    """gemm vs gemv: a narrow RHS routes to the batched-GEMV kernel."""
    return "gemv" if n <= GEMV_MAX_B else "gemm"


def choose_blocks(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """Padding blocks (bm, bn, bk) for an (m, k) x (k, n) product.

    The tuned values for the kind (gemm or gemv, by RHS width) round up to the
    kernel's granules, so K is always a multiple of 32.  A gemv does not pad
    its RHS width: bn is n.
    """
    kind = _matmul_kind(n)
    gm, gn, gk = _GRANULE[kind]
    tune = get_tuning(kind, (m, k, n))
    bm = _round_up(max(int(tune.get("bm", gm)), 1), gm)
    bk = _round_up(max(int(tune.get("bk", gk)), 1), gk)
    bn = n if kind == "gemv" else _round_up(max(int(tune.get("bn", gn)), 1), gn)
    return bm, bn, bk


def _pad_axis(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad  # F.pad lists the last axis first
    return F.pad(x, widths)


def pad_operands(a: torch.Tensor, b: torch.Tensor,
                 blocks: Optional[Tuple[int, int, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int, int]]:
    """Zero-pad (m,k)x(k,n) operands to block multiples.  Exact: padded rows and
    columns are all zero and contribute zero residues, so the product over the
    real region is unchanged bit for bit."""
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = blocks if blocks is not None else choose_blocks(m, k, n)
    a = _pad_axis(_pad_axis(a, 0, bm), 1, bk)
    b = _pad_axis(_pad_axis(b, 0, bk), 1, bn)
    return a, b, (bm, bn, bk)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _validate_kind(kind: str) -> str:
    if kind not in TUNE_KINDS:
        raise ValueError(f"dispatch kind must be one of {TUNE_KINDS}, got {kind!r}")
    return kind


def kernel_supported(plan: Optional[ozaki2.Plan], kind: str = "gemm") -> bool:
    """The Ozaki kernels implement the int8 residue substrate (the FP8 substrate
    takes the reference route on every device); the reduction kernels
    (``reduce``) take no plan."""
    _validate_kind(kind)
    if kind == "reduce":
        return True
    return plan is not None and plan.substrate == "int8"


def choose_route(plan: Optional[ozaki2.Plan], kind: str = "gemm",
                 mode: Optional[str] = None,
                 device: Optional[torch.device] = None) -> str:
    """Resolve a concrete route ('ref' | 'kernel') for this plan/kind/mode.

    ``auto`` looks up ``AUTO_ROUTE`` by the operands' device type (CPU when
    ``device`` is None).
    """
    _validate_kind(kind)
    mode = _validate_mode(mode) if mode is not None else get_mode()
    if mode == "ref" or not kernel_supported(plan, kind):
        return "ref"
    if mode == "kernel":
        return "kernel"
    table = AUTO_ROUTE[kind]
    dev_type = torch.device(device).type if device is not None else "cpu"
    return table.get(dev_type, table["default"])


def kernel_route(plan: Optional[ozaki2.Plan], kind: str, mode: Optional[str],
                 device: torch.device) -> bool:
    """Whether this call takes the kernel route; the kernels take CUDA tensors only."""
    if choose_route(plan, kind, mode, device=device) != "kernel":
        return False
    if device.type != "cuda":
        raise ValueError(f"the kernel route needs CUDA tensors, got {device}")
    return True


def _kernel_matmul(a: torch.Tensor, b: torch.Tensor, plan: ozaki2.Plan) -> torch.Tensor:
    from repro_torch.kernels import ops  # deferred: kernels import core, not vice versa

    # ops pads the (hi, lo) operands to these blocks and slices the result back.
    bm, bn, bk = choose_blocks(a.shape[0], a.shape[1], b.shape[1])
    if _matmul_kind(b.shape[1]) == "gemv":
        return ops.ozaki_gemv(a, b, plan=plan, bm=bm, bk=bk)
    return ops.ozaki_gemm(a, b, plan=plan, bm=bm, bn=bn, bk=bk)


def matmul(a: torch.Tensor, b: torch.Tensor, plan: Optional[ozaki2.Plan] = None,
           payload_bits: int = 53, substrate: str = "int8",
           mode: Optional[str] = None) -> torch.Tensor:
    """Emulated FP64-accurate C = A @ B through the dispatch seam.

    a: (m, k), b: (k, n) on one device; returns float64 (m, n) on that device,
    whatever the route.  ``substrate`` ("int8" | "fp8") picks the cached plan's
    substrate when ``plan`` is None; both give the same bits.  Callers needing
    the kernels' digits/ds output representations use ``repro_torch.kernels.ops``
    directly.
    """
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes (m, k) x (k, n), got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} vs {b.device}")
    if plan is None:
        plan = get_plan(a.shape[1], payload_bits, substrate)
    kind = _matmul_kind(b.shape[1])
    kernel = kernel_route(plan, kind, mode, a.device)
    rec = obs.op_start(kind, (a.shape[0], a.shape[1], b.shape[1]),
                       "kernel" if kernel else "ref", plan, a, b)
    if kernel:
        out = _kernel_matmul(a, b, plan)
    else:
        out = ozaki2.emulated_matmul(a, b, plan, out_dtype=torch.float64)
    return obs.op_end(rec, out)


def dot(x: torch.Tensor, w: torch.Tensor, plan: Optional[ozaki2.Plan] = None,
        payload_bits: int = 53, substrate: str = "int8",
        mode: Optional[str] = None) -> torch.Tensor:
    """(..., k) x (k, n) emulated dot — the shape contract of ``Policy.dot``."""
    lead = tuple(x.shape[:-1])
    out = matmul(x.reshape(-1, x.shape[-1]), w, plan=plan,
                 payload_bits=payload_bits, substrate=substrate, mode=mode)
    return out.reshape(lead + (w.shape[-1],))


def spmv(a_val: torch.Tensor, a_col: torch.Tensor, x: torch.Tensor,
         plan: Optional[ozaki2.Plan] = None, out_rep: str = "f64",
         br: Optional[int] = None, mode: Optional[str] = None) -> torch.Tensor:
    """Emulated Blocked-ELL SpMV y = A x through the dispatch seam.

    a_val: (M, bw) padded per-row values, a_col: (M, bw) column indices, x: (N,);
    returns float64 (M,) on x's device.  The plan resolves from the cache
    (k = bw, the SpMV margin), the route follows ``choose_route(plan,
    "spmv_bell", mode)``; ``br`` (rows per CUDA block) comes from the tuning
    table unless given, and does not change the result.
    """
    from repro_torch.kernels import ozaki_spmv as _spmv  # deferred: kernels import core

    if plan is None:
        plan = get_plan(a_val.shape[1], margin_bits=4)
    kernel = kernel_route(plan, "spmv_bell", mode, x.device)
    rec = obs.op_start("spmv_bell", (a_val.shape[0], a_val.shape[1], x.shape[0]),
                       "kernel" if kernel else "ref", plan, a_val, a_col, x)
    if kernel:
        if br is None:
            br = int(get_tuning("spmv_bell", a_val.shape)["br"])
        out = _spmv.spmv_bell(a_val, a_col, x, plan, out_rep=out_rep, br=br)
    else:
        out = _spmv.spmv_bell_ref(a_val, a_col, x, plan, out_rep=out_rep)
    return obs.op_end(rec, out)


def stencil7(u: torch.Tensor, c: torch.Tensor, plan: Optional[ozaki2.Plan] = None,
             out_rep: str = "f64", bz: Optional[int] = None,
             mode: Optional[str] = None) -> torch.Tensor:
    """Emulated 7-point stencil v = S[c] u through the dispatch seam.

    u: (X, Y, Z) grid, c: (7,) coefficients ordered [centre, -x, +x, -y, +y,
    -z, +z]; boundary points see a zero halo.  Returns float64 (X, Y, Z) on u's
    device.  The route follows ``choose_route(plan, "stencil7", mode)``.  The
    CUDA block (``bz`` threads along z, as the reference's z-slab, by ``by``
    along y, marching over ``bx`` planes along x) comes from the tuning table
    unless ``bz`` is given, and does not change the result.
    """
    from repro_torch.kernels import ozaki_stencil as _stencil  # deferred

    if plan is None:
        plan = get_plan(8, margin_bits=4)
    kernel = kernel_route(plan, "stencil7", mode, u.device)
    rec = obs.op_start("stencil7", u.shape, "kernel" if kernel else "ref", plan, u, c)
    if kernel:
        tune = get_tuning("stencil7", u.shape)
        bz = int(tune["bz"]) if bz is None else bz
        out = _stencil.stencil7(u, c, plan, out_rep=out_rep, bz=bz, by=int(tune["by"]),
                                bx=int(tune["bx"]))
    else:
        out = _stencil.stencil7_ref(u, c, plan, out_rep=out_rep)
    return obs.op_end(rec, out)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None, softcap: float = 0.0,
              plan_qk: Optional[ozaki2.Plan] = None, plan_pv: Optional[ozaki2.Plan] = None,
              payload_bits: int = 53, substrate: str = "int8",
              mode: Optional[str] = None) -> torch.Tensor:
    """Fused emulated attention out = softmax(mask(QKᵀ/√D + softcap)) V.

    q: (..., S, D) queries, k/v: (..., T, D) keys/values on one device; the
    leading dims (batch, heads, ...) are flattened into independent problems.
    ``mask`` is None (attend to all), a shared (S, T) array, or batched
    (..., S, T); nonzero/True = attend.  ``softcap`` > 0 applies the tanh logit
    cap between scaling and masking.  Returns float64 (..., S, D).

    The route follows ``choose_route(plan_qk, "attention", mode)``: the fused
    kernel (all problems in one launch) or ``attention_ref``, bitwise equal on
    one device.  ``plan_qk`` covers the length-D score contraction,
    ``plan_pv`` the length-bkv probability-value contraction; both resolve
    from the plan cache when omitted.  bq and bkv come from the tuning table,
    rounded to ``SUBLANE`` and capped at S and T rounded up (bq also at the
    kernel's largest tile for D).  Telemetry labels the op ``prefill`` (S > 1)
    or ``decode`` (S = 1).
    """
    from repro_torch.kernels import ozaki_attention as _attn  # deferred: kernels import core

    lead = tuple(q.shape[:-2])
    S, D = q.shape[-2:]
    T = k.shape[-2]
    B = 1
    for d in lead:
        B *= int(d)
    tune = get_tuning("attention", (B, S, D, T))
    bq = min(_round_up(int(tune["bq"]), SUBLANE), _round_up(S, SUBLANE), _attn.max_bq(D))
    bkv = min(_round_up(int(tune["bkv"]), SUBLANE), _round_up(T, SUBLANE))
    if plan_qk is None:
        plan_qk = get_plan(D, payload_bits, substrate)
    if plan_pv is None:
        plan_pv = get_plan(bkv, payload_bits, substrate)
    kernel = kernel_route(plan_qk, "attention", mode, q.device)
    rec = obs.op_start("attention", (B, S, D, T), "kernel" if kernel else "ref", plan_qk,
                       q, k, v, label="decode" if S == 1 else "prefill")
    if mask is None:
        mask = torch.ones((S, T), dtype=torch.int8, device=q.device)
    mask = (mask != 0).to(torch.int8)
    mask = mask.expand(B, S, T) if mask.ndim == 2 else mask.reshape(B, S, T)
    f64 = torch.float64
    qf = q.to(f64).reshape(B, S, D)
    kf = k.to(f64).reshape(B, T, D)
    vf = v.to(f64).reshape(B, T, D)
    if kernel:
        def route(qf, kf, vf):
            return _attn.attention_fused(qf, kf, vf, mask, plan_qk, plan_pv, softcap, bq=bq,
                                         bkv=bkv)
    else:
        def route(qf, kf, vf):
            return _attn.attention_ref(qf, kf, vf, mask, plan_qk, plan_pv, softcap, bkv)
    out = _ZeroGradAttention.apply(qf, kf, vf, route)
    return obs.op_end(rec, out.reshape(lead + (S, D)))


class _ZeroGradAttention(torch.autograd.Function):
    """Emulated attention with the reference's gradient: exactly zero for q, k
    and v on both routes (ROADMAP queue 3, item 17).  The reference has no
    custom VJP here, and its Phase 1 rounds the operands to integers, so
    ``jax.grad`` through it gives zeros; the kernel route has no autograd graph
    and the reference route's integer casts cut it, so this function states
    the zeros.  The native attention paths keep their true gradients."""

    @staticmethod
    def forward(ctx, qf, kf, vf, route):
        ctx.metas = [(t.shape, t.dtype, t.device) for t in (qf, kf, vf)]
        return route(qf, kf, vf)

    @staticmethod
    def backward(ctx, g):
        zeros = [torch.zeros(shape, dtype=dt, device=dev) for shape, dt, dev in ctx.metas]
        return (*zeros, None)
