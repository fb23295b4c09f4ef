"""AdamW with optional bfloat16 moments (``repro.optim.adamw``).

Parameters, gradients and moments are dicts of tensors keyed by the model's
``state_dict`` names; the state is ``{"m": {...}, "v": {...}, "step": int32
0-dim tensor}``.  The update follows the reference's float32 arithmetic
operation for operation (Python constants enter as float32, each elementwise
op rounds once), so from the same state it gives the reference's bits, with
two exceptions measured on the CPU (ROADMAP queue 3, item 18): the bias
corrections' float32 ``pow`` at some steps, and ``global_norm``'s float32 sums,
whose order differs.  Square roots on CPU tensors go through
``core.numerics.sqrt``, which is correctly rounded (queue 3, item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.core import numerics

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"      # "bfloat16" halves the moments' memory
    grad_clip_norm: float = 1.0


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig = AdamWConfig()) -> Dict:
    """Zero moments in ``cfg.moment_dtype`` and step 0, on the parameters' device."""
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every tensor's float32 sum of squares (float32)."""
    sums = [torch.sum(torch.square(x.float())) for x in tensors.values()]
    return numerics.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """(grads scaled by min(1, max_norm / max(norm, 1e-12)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 state: Dict, cfg: AdamWConfig = AdamWConfig(),
                 lr_scale=1.0) -> Tuple[Tensors, Dict]:
    """One AdamW step: (new parameters in their dtypes, new state).  Nothing
    is changed in place."""
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    lr = cfg.lr * lr_scale
    newp, newm, newv = {}, {}, {}
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g32 = grads[k].float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (numerics.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        newp[k] = (p.float() - lr * delta).to(p.dtype)
        newm[k] = m32.to(m.dtype)
        newv[k] = v32.to(v.dtype)
    return newp, {"m": newm, "v": newv, "step": step}
