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

The reference gives the emulated dots a custom VJP; the port has no training path
yet, so an emulated ``dot`` is forward-only and raises where a gradient would be
needed (the VJP comes with the training slice, ROADMAP slice 10).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dispatch, ozaki1

POLICIES = ("bf16", "fp32", "fp64", "ozaki2_int8", "ozaki2_fp8", "ozaki1_int8")


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
        those types; ozaki2_int8 and ozaki2_fp8 run ``dispatch.dot`` (the seam's
        matmul over flattened leading dims) in float64 with the cached plan for k
        on their substrate; ozaki1_int8 runs ``ozaki1.emulated_matmul`` in
        float64 on the flattened leading dims.  An emulated dot raises
        ``NotImplementedError`` where autograd would need its gradient.
        """
        if self.name == "bf16":
            bf = torch.bfloat16
            return torch.matmul(x.to(bf).float(), w.to(bf).float()).to(x.dtype)
        if self.name == "fp32":
            return torch.matmul(x.float(), w.float()).to(x.dtype)
        if self.name == "fp64":
            return torch.matmul(x.double(), w.double()).to(x.dtype)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise NotImplementedError(
                f"the gradient of an emulated dot ({self.name!r}) is not ported yet "
                f"(ROADMAP slice 10: training)")
        if self.name in ("ozaki2_int8", "ozaki2_fp8"):
            plan = dispatch.get_plan(x.shape[-1], self.payload_bits,
                                     substrate=self.name.split("_")[1])
            return dispatch.dot(x.double(), w.double(), plan=plan).to(x.dtype)
        if self.name == "ozaki1_int8":
            out = ozaki1.emulated_matmul(x.double().reshape(-1, x.shape[-1]), w.double())
            return out.reshape(tuple(x.shape[:-1]) + (w.shape[-1],)).to(x.dtype)
        raise AssertionError(self.name)

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
