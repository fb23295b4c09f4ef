"""The Tensor–Memory Equilibrium (TME) model (``repro.core.tme``; the paper's §4).

Classical Roofline (Williams et al.) extended with three emulation parameters:
    α — low-precision MMAs per FP64-equivalent op (≈ r for Ozaki II; 3r on FP8; S² for
        Ozaki I),
    β — bandwidth multiplier (1 for fully fused on-chip decomposition; r unfused),
    γ — per-output reconstruction latency (Garner, O(r²) small int ops).

    T_nat = max(W / P_fp64, Q / B_mem)                            (paper eq. 8)
    T_emu = max(αW / P_low, βQ / B_mem) + γ·n_out                 (paper eq. 9)

This module reproduces the paper's Tables 2–5 and prices every op of the dispatch
seam (``predict_op_time``), which ``repro_torch.obs.telemetry`` compares with
what it measures.  The chip is an argument; the default is ``H100``, the card the
port runs on.  Route names are the port's: ``"kernel"`` is the fused route
(β = 1), ``"ref"`` the unfused reference route (β = r).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Table 2 — architectural parameters (TFLOPS / TOPS dense, TB/s)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    fp64_vector: float          # TFLOPS
    fp64_tensor: Optional[float]  # TFLOPS (None if absent / emulated-only)
    fp8: float                  # TFLOPS dense
    int8: float                 # TOPS dense
    bf16: float                 # TFLOPS dense
    hbm_tbps: float             # TB/s
    hbm_gb: float
    ici_gbps: float = 0.0       # per-link interconnect GB/s

    @property
    def native_ridge(self) -> float:
        """Memory ridge point (FLOPs/Byte) of the native FP64 vector pipe.

        Units: TFLOPS / (TB/s) — the 1e12 factors cancel, leaving FLOPs/Byte
        directly (e.g. H100: 34 / 3.35 ≈ 10.1 F/B, the paper's Table 2 row).
        """
        return self.fp64_vector / self.hbm_tbps

    def fp64_matrix_native(self) -> float:
        return self.fp64_tensor if self.fp64_tensor is not None else self.fp64_vector


H100 = ChipSpec("H100", fp64_vector=34, fp64_tensor=67, fp8=1979, int8=1979,
                bf16=989, hbm_tbps=3.35, hbm_gb=80)
B200 = ChipSpec("B200", fp64_vector=40, fp64_tensor=40, fp8=4500, int8=155,
                bf16=2250, hbm_tbps=8.0, hbm_gb=192)
B300 = ChipSpec("B300", fp64_vector=1.3, fp64_tensor=1.2, fp8=5000, int8=165,
                bf16=2500, hbm_tbps=8.0, hbm_gb=288)
R200 = ChipSpec("R200", fp64_vector=33, fp64_tensor=None, fp8=4000, int8=250,
                bf16=2000, hbm_tbps=22.0, hbm_gb=288)
# The reference package's compile target, kept as data so that a caller can
# price an op for it explicitly; nothing here defaults to it.
TPU_V5E = ChipSpec("TPUv5e", fp64_vector=0.4, fp64_tensor=None, fp8=394, int8=394,
                   bf16=197, hbm_tbps=0.819, hbm_gb=16, ici_gbps=50.0)

CHIPS: Dict[str, ChipSpec] = {c.name: c for c in (H100, B200, B300, R200, TPU_V5E)}

# The chip every prediction is made for unless the caller passes another.
DEFAULT_CHIP = H100

# Route names: the fused kernel route keeps residues on the chip (β = 1); any
# other route materialises the r residue planes (β = r).
FUSED_ROUTE = "kernel"


# ---------------------------------------------------------------------------
# Emulation parameters (Def. 1) and the two time equations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EmulationParams:
    alpha: float               # low-precision MMAs per FP64 op
    beta: float = 1.0          # bandwidth multiplier (1 = fused)
    gamma: float = 0.0         # s per output element (Garner)
    substrate: str = "fp8"     # which P_low to use: "fp8" | "int8" | "bf16"

    @staticmethod
    def ozaki2(r: int = 10, substrate: str = "fp8", fused: bool = True,
               fp8_planes: bool = False) -> "EmulationParams":
        """Paper defaults: α = r; §2.4's (3r+1) plane count if fp8_planes."""
        alpha = (3 * r + 1) if fp8_planes else r
        return EmulationParams(alpha=alpha, beta=1.0 if fused else float(r),
                               substrate=substrate)


def p_low(spec: ChipSpec, substrate: str) -> float:
    return {"fp8": spec.fp8, "int8": spec.int8, "bf16": spec.bf16}[substrate]


def native_time(W: float, Q: float, spec: ChipSpec, matrix: bool = False) -> float:
    """Paper eq. (8).  W in FLOPs, Q in bytes; returns seconds."""
    p = (spec.fp64_matrix_native() if matrix else spec.fp64_vector) * 1e12
    return max(W / p, Q / (spec.hbm_tbps * 1e12))


def emulated_time(W: float, Q: float, n_out: float, spec: ChipSpec,
                  params: EmulationParams) -> float:
    """Paper eq. (9)."""
    p = p_low(spec, params.substrate) * 1e12
    return max(params.alpha * W / p, params.beta * Q / (spec.hbm_tbps * 1e12)) \
        + params.gamma * n_out


def native_perf(oi: float, spec: ChipSpec, matrix: bool = False) -> float:
    """Attainable native FP64 TFLOPS at operational intensity ``oi``."""
    p = spec.fp64_matrix_native() if matrix else spec.fp64_vector
    return min(oi * spec.hbm_tbps, p)


def emulated_perf(oi: float, spec: ChipSpec, params: EmulationParams) -> float:
    """Attainable emulated-FP64 TFLOPS at ``oi`` (γ amortised; paper Fig. 1 curve)."""
    ceiling = p_low(spec, params.substrate) / params.alpha
    return min(oi * spec.hbm_tbps / params.beta, ceiling)


def speedup(oi: float, spec: ChipSpec, params: EmulationParams,
            matrix: bool = False) -> float:
    return emulated_perf(oi, spec, params) / native_perf(oi, spec, matrix)


def crossover_oi(spec: ChipSpec, params: EmulationParams) -> float:
    """OI above which emulation beats native FP64 (paper §4.3 Case A boundary)."""
    # native compute roof == memory roof at native ridge; emulation wins when
    # OI * B > P_fp64 (with β=1):
    return params.beta * spec.fp64_vector / spec.hbm_tbps


def emulation_ridge(spec: ChipSpec, params: EmulationParams) -> float:
    """OI at which the emulated curve leaves the memory roof (its own ridge)."""
    return p_low(spec, params.substrate) / params.alpha / spec.hbm_tbps


# ---------------------------------------------------------------------------
# Per-op cost model for the dispatch seam (the telemetry prediction side)
# ---------------------------------------------------------------------------


def op_costs(kind: str, dims: Tuple[int, ...]) -> Tuple[float, float, float]:
    """(W FLOPs, Q HBM bytes, n_out) of one FP64-equivalent dispatched op.

    ``dims`` per kind: gemm/gemv (m, k, n); spmv_bell (M, bw, N); stencil7
    (X, Y, Z); reduce (n,); attention (B, S, D, T).  Q assumes 8-byte working
    floats (the op being *emulated* is FP64 even when the operands arrive in
    f32 — the model's native side, paper eq. (8)'s Q).  For reduce, Q charges
    the two-stream Dot2 case (the CG solver); one-stream sums overstate Q by
    2x, within the model's tolerance.
    """
    if kind in ("gemm", "gemv"):
        m, k, n = (float(d) for d in dims)
        return 2.0 * m * k * n, 8.0 * (m * k + k * n + m * n), m * n
    if kind == "spmv_bell":
        M, bw = float(dims[0]), float(dims[1])
        N = float(dims[2]) if len(dims) > 2 else M
        # values + int32 colidx + x gather (~1x cached) + y
        return 2.0 * M * bw, 8.0 * M * bw + 4.0 * M * bw + 8.0 * N + 8.0 * M, M
    if kind == "stencil7":
        npts = float(dims[0]) * float(dims[1]) * float(dims[2])
        return 14.0 * npts, 16.0 * npts, npts
    if kind == "reduce":
        n = float(dims[0])
        return 2.0 * n, 16.0 * n, 1.0
    if kind == "attention":
        # (B, S, D, T) — B independent rows of S queries against T keys at
        # head dim D; a bare 3-tuple (S, D, T) means B = 1.  W counts the
        # QK^T + PV products (2·2·S·T·D each row); Q is the fused-path f64
        # traffic: q + out (S·D each) and k + v (T·D each); n_out counts the
        # Garner reconstructions (S·T scores + S·D outputs per row).
        if len(dims) == 3:
            dims = (1,) + tuple(dims)
        B, S, D, T = (float(d) for d in dims)
        return (4.0 * B * S * T * D,
                8.0 * B * (2.0 * S * D + 2.0 * T * D),
                B * S * (T + D))
    raise ValueError(f"op_costs: unknown kind {kind!r}")


# Compensated BLAS-1: ~5 vector-pipe flops per plain flop (two_prod + the
# two_sum tree), β = 1 (one streaming pass), no Garner term — §7.1(a)'s
# "healthy vector pipe" path, charged against the bf16 rate as its proxy.
REDUCE_EFT_ALPHA = 5.0


def predict_op_time(kind: str, dims: Tuple[int, ...], r: int = 10,
                    alpha: Optional[float] = None, substrate: str = "int8",
                    route: str = "ref",
                    spec: Optional[ChipSpec] = None) -> float:
    """TME-predicted seconds for one dispatched op (paper eq. (9) pointed at the
    seam's own kernels — what the telemetry compares measured time against).

    ``route`` sets β: the fused ``kernel`` route keeps residues on the chip
    (β = 1); the unfused ``ref`` route materialises r residue planes (β = r).
    γ is the ``garner_gamma`` model at this r.  The reduce kind has no
    emulation at all: α is the EFT flop multiplier, β = 1, γ = 0.  ``spec``
    defaults to ``DEFAULT_CHIP``.
    """
    if spec is None:
        spec = DEFAULT_CHIP
    if kind == "attention":
        return attention_emulated_time(dims, r=r, alpha=alpha,
                                       substrate=substrate, route=route,
                                       spec=spec)
    W, Q, n_out = op_costs(kind, dims)
    if kind == "reduce":
        params = EmulationParams(alpha=REDUCE_EFT_ALPHA, beta=1.0,
                                 gamma=0.0, substrate="bf16")
        return emulated_time(W, Q, 0.0, spec, params)
    if alpha is None:
        alpha = float(r) if substrate == "int8" else 3.0 * r
    beta = 1.0 if route == FUSED_ROUTE else float(r)
    params = EmulationParams(alpha=float(alpha), beta=beta,
                             gamma=garner_gamma(spec, r), substrate=substrate)
    return emulated_time(W, Q, n_out, spec, params)


def attention_emulated_time(dims: Tuple[int, ...], r: int = 10,
                            alpha: Optional[float] = None,
                            substrate: str = "int8", route: str = "ref",
                            spec: Optional[ChipSpec] = None) -> float:
    """TME-predicted seconds for the fused attention kind, per route.

    The ``kernel`` route is the online-softmax scan: scores and probabilities
    never leave registers and shared memory, so it is priced like the other
    fused kernels (β = 1 over the q/k/v/out traffic, γ per reconstruction).
    The ``ref`` route composes emulated GEMMs per key block and *materialises*
    the S and P matrices (2·8·B·S·T bytes); that extra traffic is charged on
    top of the residue-plane β = r multiplier (added as q_scores/r so the β
    factor restores it to one full f64 pass each way).
    """
    if spec is None:
        spec = DEFAULT_CHIP
    if len(dims) == 3:
        dims = (1,) + tuple(dims)
    B, S, D, T = (float(d) for d in dims)
    W, Q, n_out = op_costs("attention", dims)
    if alpha is None:
        alpha = float(r) if substrate == "int8" else 3.0 * r
    gamma = garner_gamma(spec, r)
    if route == FUSED_ROUTE:
        params = EmulationParams(alpha=float(alpha), beta=1.0, gamma=gamma,
                                 substrate=substrate)
        return emulated_time(W, Q, n_out, spec, params)
    q_scores = 2.0 * 8.0 * B * S * T
    params = EmulationParams(alpha=float(alpha), beta=float(r), gamma=gamma,
                             substrate=substrate)
    return emulated_time(W, Q + q_scores / float(r), n_out, spec, params)


# ---------------------------------------------------------------------------
# Workloads (Table 3 rows) and table generators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    oi: float                  # FLOPs / byte of HBM traffic
    matrix: bool               # True → native path uses the FP64 *tensor* rate


WORKLOADS: Tuple[Workload, ...] = (
    Workload("dense_gemm", 100.0, True),
    Workload("bgemv_b8", 4.0, False),
    Workload("bgemv_b2", 1.5, False),
    Workload("stencil_7pt", 0.5, False),
    Workload("spmv", 0.2, False),
)


def table3_speedups(r: int = 10) -> List[dict]:
    """Projected Ozaki II/FP8-over-native speedups (paper Table 3)."""
    rows = []
    params = EmulationParams.ozaki2(r=r, substrate="fp8")
    for w in WORKLOADS:
        row = {"workload": w.name, "oi": w.oi}
        for chip in ("H100", "B200", "B300", "R200"):
            row[chip] = speedup(w.oi, CHIPS[chip], params, matrix=w.matrix)
        rows.append(row)
    return rows


def table4_h100_baseline(r: int = 10) -> List[dict]:
    """Absolute FP64-equivalent TFLOPS and H100-relative scaling (paper Table 4)."""
    rows = []
    params = EmulationParams.ozaki2(r=r, substrate="fp8")
    h100_native = {w.name: native_perf(w.oi, H100, w.matrix) for w in WORKLOADS}
    for w in WORKLOADS:
        for path in ("native", "ozaki2"):
            row = {"workload": w.name, "path": path}
            for chip in ("H100", "B200", "B300", "R200"):
                spec = CHIPS[chip]
                perf = (native_perf(w.oi, spec, w.matrix) if path == "native"
                        else emulated_perf(w.oi, spec, params))
                row[chip] = perf
                row[f"{chip}_vs_h100"] = perf / h100_native[w.name]
            rows.append(row)
    return rows


def table5_substrates(r: int = 10) -> List[dict]:
    """INT8 vs FP8 emulation ceilings (paper Table 5)."""
    rows = []
    for chip in ("H100", "B200", "B300", "R200"):
        spec = CHIPS[chip]
        int8_ceil = spec.int8 / r
        fp8_ceil = spec.fp8 / r
        rows.append({
            "chip": chip, "p_int8": spec.int8, "p_fp8": spec.fp8,
            "ozaki_int8_ceiling": int8_ceil, "ozaki_fp8_ceiling": fp8_ceil,
            "fp8_advantage": fp8_ceil / int8_ceil,
        })
    return rows


def moduli_sensitivity(chip: str = "B300") -> List[dict]:
    """§2.4 sensitivity: the ceiling P_fp8/r at r = 10, 11, 12 (and with 3r+1)."""
    spec = CHIPS[chip]
    rows = []
    for r in (10, 11, 12):
        rows.append({
            "r": r,
            "ceiling_r": spec.fp8 / r,
            "ceiling_3r1": spec.fp8 / (3 * r + 1),
        })
    return rows


# ---------------------------------------------------------------------------
# Bailey four-step FFT stages (companion FFT analysis; Part 2 gamma-roof)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FFTStage:
    """One stage of the four-step FFT in TME terms.

    W is real FLOPs (a complex MAC through the realified GEMM costs 8), Q is
    HBM bytes, n_out the per-stage Garner reconstruction count (the gamma
    multiplier: each GEMM pass reconstructs 2n real outputs per batch element).
    """
    name: str
    W: float
    Q: float
    n_out: float

    def emulated_s(self, spec: ChipSpec, params: EmulationParams) -> float:
        return emulated_time(self.W, self.Q, self.n_out, spec, params)


def bailey_fft_stages(n: int, batch: int = 1,
                      working_bytes: int = 16) -> List[FFTStage]:
    """Per-stage (W, Q, n_out) of the four-step FFT over a length-n batch.

    Mirrors the recursion of ``repro_torch.spectral.bailey.dft_stacked`` using
    the same ``choose_factors``/``DENSE_MAX`` the executed transform uses, so
    the model cannot desynchronise from it: each recursion level contributes a
    twiddle scaling and a transpose (pure data movement), and every leaf is a
    dense DFT GEMM ``gemm_n{f}`` — the emulated part, charging 8f MACs-worth
    of real FLOPs per element and a gamma term on its 2n real outputs per
    batch element.  ``working_bytes`` is per complex element (16 for
    FP64-equivalent working precision).
    """
    # Deferred: spectral sits above core in the layering; this is the one
    # place the model reaches up, to stay pinned to the executed factors.
    from repro_torch.spectral.bailey import choose_factors
    from repro_torch.spectral.dft import DENSE_MAX

    pass_q = 2.0 * working_bytes * n * batch          # stream in + out
    factors = choose_factors(n) if n > DENSE_MAX else None
    if factors is None:                               # dense leaf (or prime)
        return [FFTStage(f"gemm_n{n}", 8.0 * n * n * batch, pass_q,
                         2.0 * n * batch)]
    n1, n2 = factors
    stages = list(bailey_fft_stages(n1, n2 * batch, working_bytes))
    stages.append(FFTStage(f"twiddle_n{n}", 6.0 * n * batch,
                           pass_q + working_bytes * n, 0.0))
    stages.append(FFTStage(f"transpose_n{n}", 0.0, pass_q, 0.0))
    stages.extend(bailey_fft_stages(n2, n1 * batch, working_bytes))
    return stages


def garner_gamma(spec: ChipSpec, r: int = 10) -> float:
    """Crude per-output Garner latency model: the O(r²) mixed-radix small-int
    ops charged against the chip's int8 pipe (paper Def. 1's gamma).  Callers
    that measured a real reconstruction rate should pass their own gamma; this
    default exists so the gamma term is non-zero under the paper's defaults."""
    return float(r * r) / (p_low(spec, "int8") * 1e12)


def fft_emulated_time(n: int, spec: ChipSpec, params: EmulationParams,
                      batch: int = 1) -> float:
    """Sum of paper eq. (9) over the four-step stages (gamma terms included)."""
    return sum(s.emulated_s(spec, params) for s in bailey_fft_stages(n, batch))


def fft_native_time(n: int, spec: ChipSpec, batch: int = 1,
                    working_bytes: int = 16) -> float:
    """Native-FP64 radix-2 FFT through paper eq. (8): W = 5 n log2 n."""
    W = 5.0 * n * math.log2(n) * batch
    Q = 2.0 * working_bytes * n * batch
    return native_time(W, Q, spec)


def table_fft(r: int = 10, batch: int = 4096,
              sizes: Tuple[int, ...] = (1 << 10, 1 << 14, 1 << 18)) -> List[dict]:
    """Projected emulated-over-native FFT speedups with the per-stage gamma
    split (the companion paper's gamma-roof view of the spectral dwarf).

    gamma defaults to the ``garner_gamma`` model per chip (so the
    reconstruction term is visible, not silently zero)."""
    rows = []
    base = EmulationParams.ozaki2(r=r, substrate="fp8")
    for n in sizes:
        for chip in ("H100", "B200", "B300", "R200"):
            spec = CHIPS[chip]
            params = dataclasses.replace(base, gamma=garner_gamma(spec, r))
            stages = bailey_fft_stages(n, batch)
            emu = sum(s.emulated_s(spec, params) for s in stages)
            gamma_s = sum(params.gamma * s.n_out for s in stages)
            rows.append({
                "n": n, "chip": chip,
                "native_s": fft_native_time(n, spec, batch),
                "emulated_s": emu,
                "speedup": fft_native_time(n, spec, batch) / emu if emu else 0.0,
                "gamma_fraction": gamma_s / emu if emu else 0.0,
            })
    return rows


# ---------------------------------------------------------------------------
# Three-term roofline (compute, memory, collective)
# ---------------------------------------------------------------------------

# One H100 SXM (NVIDIA data sheet, dense): bf16 tensor-core peak, HBM3 rate,
# and NVLink 4 at 450 GB/s each way (900 GB/s both ways together).
PEAK_BF16_FLOPS = H100.bf16 * 1e12
HBM_BW = H100.hbm_tbps * 1e12
ICI_BW = 450e9  # NVLink, per direction


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def fraction_of_roofline(self) -> float:
        """Useful-compute fraction if the kernel ran exactly at its bound."""
        return self.compute_s / self.bound_s if self.bound_s > 0 else 0.0


def roofline_terms(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
                   chips: int, peak_flops: float = PEAK_BF16_FLOPS,
                   hbm_bw: float = HBM_BW, link_bw: float = ICI_BW) -> RooflineTerms:
    """The three terms, in seconds (totals across ``chips`` cards)."""
    return RooflineTerms(
        compute_s=hlo_flops / (chips * peak_flops),
        memory_s=hlo_bytes / (chips * hbm_bw),
        collective_s=collective_bytes / (chips * link_bw),
    )
