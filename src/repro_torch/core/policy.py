"""Precision policies (``repro.core.policy``): how a model's weight matmuls compute.

Every weight matmul in ``repro_torch.models`` goes through ``Policy.dot``;
flipping the policy swaps the arithmetic between the native paths and the Ozaki
emulation with no model-code changes.

Policies:
  bf16        — bf16 operands, float32 accumulation.
  fp32        — float32 operands and accumulation.
  fp64        — native float64 (the oracle).
  ozaki2_int8 — Ozaki Scheme II on int8 residue products (``dispatch.matmul``).
  ozaki2_fp8  — Ozaki Scheme II on the FP8 substrate (``dispatch.matmul`` with
                substrate="fp8": the reference route on every device).
  ozaki1_int8 — Ozaki Scheme I mantissa slicing (S² int8 products, ``ozaki1``).

Emulated paths carry a custom VJP (``Ozaki2Dot``, ``Ozaki1Dot``): the gradient of
an FP64-accurate matmul is the FP64-accurate matmul of the gradients, dA = g·Bᵀ
and dB = Aᵀ·g under the same emulated arithmetic.

PyTorch runs a CUDA backward on a worker thread of its own, where this thread's
``dispatch.mode_scope`` and ``telemetry_scope`` are not seen; so the forward keeps
its effective dispatch mode and telemetry mode in the autograd context, and the
backward's products run under them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dispatch, ozaki1, ozaki2
from repro_torch.obs import telemetry as obs

POLICIES = ("bf16", "fp32", "fp64", "ozaki2_int8", "ozaki2_fp8", "ozaki1_int8")

# An emulated forward product whose weight has more elements than this runs
# over blocks of the weight's columns, one after another: Phase 1 holds about
# eight float64-sized copies of its operand at once, ~80 GB for qwen2-vl-72b's
# 8192 x 152064 LM head.  Each column of the result depends only on its own
# column (B scales per column; the plan and A's Phase 1 depend on k, not n),
# so the blocks give the whole product's bits.
DOT_MAX_W = 1 << 28


def column_blocks(k: int, n: int):
    """The column ranges [(j0, j1), ...] over which ``Policy.dot`` runs the
    emulated forward product of a k x n weight: one block up to DOT_MAX_W
    elements, else blocks of the most multiples of 128 columns that fit."""
    if k * n <= DOT_MAX_W:
        return [(0, n)]
    step = max(128, DOT_MAX_W // k // 128 * 128)
    return [(j, min(j + step, n)) for j in range(0, n, step)]


class Ozaki2Dot(torch.autograd.Function):
    """C = A @ B through ``dispatch.matmul`` with the plan given, differentiable.

    a: (m, k), b: (k, n), float64.  The backward re-plans for the new
    contraction lengths (dA contracts over n = g.shape[-1], dB over m =
    a.shape[0], the flattened rows) on the forward's substrate and payload, and
    runs both products under the forward's dispatch and telemetry modes.
    """

    @staticmethod
    def forward(ctx, a, b, plan: ozaki2.Plan):
        ctx.save_for_backward(a, b)
        ctx.plan = plan
        ctx.modes = (dispatch.get_mode(), obs.get_mode())
        return dispatch.matmul(a, b, plan=plan)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        plan = ctx.plan
        mode, telemetry_mode = ctx.modes
        da = db = None
        with dispatch.mode_scope(mode), obs.telemetry_scope(telemetry_mode):
            if ctx.needs_input_grad[0]:
                plan_da = dispatch.get_plan(g.shape[-1], plan.payload_bits,
                                            substrate=plan.substrate)
                da = dispatch.matmul(g, b.T, plan=plan_da)
            if ctx.needs_input_grad[1]:
                plan_db = dispatch.get_plan(a.shape[0], plan.payload_bits,
                                            substrate=plan.substrate)
                db = dispatch.matmul(a.T, g, plan=plan_db)
        return da, db, None


class Ozaki1Dot(torch.autograd.Function):
    """C = A @ B through ``ozaki1.emulated_matmul`` (float64), differentiable:
    dA = g·Bᵀ and dB = Aᵀ·g by the same scheme."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return ozaki1.emulated_matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = ozaki1.emulated_matmul(g, b.T) if ctx.needs_input_grad[0] else None
        db = ozaki1.emulated_matmul(a.T, g) if ctx.needs_input_grad[1] else None
        return da, db


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dispatches matmuls to a numeric path.  Hashable."""

    name: str = "bf16"
    payload_bits: int = 53

    def __post_init__(self):
        if self.name not in POLICIES:
            raise ValueError(f"unknown policy {self.name!r}; choose from {POLICIES}")

    @property
    def is_emulated(self) -> bool:
        return self.name.startswith("ozaki")

    def dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """y[..., n] = x[..., k] @ w[k, n] under this policy, in x's dtype.

        bf16 rounds the operands to bfloat16 and accumulates in float32 (as the
        reference's ``preferred_element_type``); fp32 and fp64 multiply in
        those types; ozaki2_int8 and ozaki2_fp8 run ``Ozaki2Dot`` (the seam's
        matmul) in float64 on the flattened leading dims with the cached plan
        for k on their substrate; ozaki1_int8 runs ``Ozaki1Dot``
        (``ozaki1.emulated_matmul``) in float64 on the flattened leading dims.
        Every path has a gradient.  Where no gradient is recorded, an emulated
        product runs over ``column_blocks`` of w, each converted to float64 on
        its own (the same bits as one product; with a gradient dA = g·Bᵀ
        contracts over all n at once, so the product stays whole).
        """
        if self.name == "bf16":
            bf = torch.bfloat16
            return torch.matmul(x.to(bf).float(), w.to(bf).float()).to(x.dtype)
        if self.name == "fp32":
            return torch.matmul(x.float(), w.float()).to(x.dtype)
        if self.name == "fp64":
            return torch.matmul(x.double(), w.double()).to(x.dtype)
        lead = tuple(x.shape[:-1])
        x2 = x.double().reshape(-1, x.shape[-1])
        grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
        blocks = [(0, w.shape[-1])] if grad else column_blocks(*w.shape)
        if self.name in ("ozaki2_int8", "ozaki2_fp8"):
            plan = dispatch.get_plan(x.shape[-1], self.payload_bits,
                                     substrate=self.name.split("_")[1])
            outs = [Ozaki2Dot.apply(x2, w[:, j0:j1].double(), plan) for j0, j1 in blocks]
        elif self.name == "ozaki1_int8":
            outs = [Ozaki1Dot.apply(x2, w[:, j0:j1].double()) for j0, j1 in blocks]
        else:
            raise AssertionError(self.name)
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        return out.reshape(lead + (w.shape[-1],)).to(x.dtype)

    def matmul_flops_multiplier(self) -> int:
        """TME α for this policy (1 for native paths) — used by the roofline tooling."""
        if self.name in ("bf16", "fp32", "fp64"):
            return 1
        if self.name == "ozaki2_int8":
            return 16          # r at k~4096, p=53
        if self.name == "ozaki2_fp8":
            return 48          # 3r
        if self.name == "ozaki1_int8":
            return 64          # S² at S=8
        raise AssertionError(self.name)


DEFAULT_POLICY = Policy("bf16")
