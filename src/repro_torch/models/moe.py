"""Mixture-of-Experts MLP (``repro.models.moe``): deepseek-style fine-grained
routing with shared experts, in the reference's dense-dispatch form.

Top-k routing builds a (tokens, experts, capacity) dispatch tensor; the routed
experts are batched products over the expert axis, in the compute dtype
(``torch.einsum``: the reference's are XLA einsums, outside any Pallas kernel).
The shared experts are a dense MLP through the model's precision policy, so
under an emulated policy they run on the seam's GEMM.  Tokens past an expert's
capacity are dropped, as in the reference.

The reference marks the expert axis for sharding (``annotate.ann``), a hint
that does nothing on one device; expert parallelism across cards comes with
the distributed part of ROADMAP slice 10.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoECfg
from repro_torch.core.policy import Policy
from repro_torch.models import layers

ROUTER_POLICY = Policy("fp32")


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """The router (float32, d x E), the routed experts stacked on a leading
    expert axis, and the shared experts as one MLP of width num_shared x d_expert."""
    m = cfg.moe
    d, dt = cfg.d_model, cfg.param_torch_dtype
    scale = 1.0 / math.sqrt(d)
    wo_scale = scale / math.sqrt(m.d_expert / d)
    params = {
        "router": {"w": layers._uniform(gen, (d, m.num_experts), -scale, scale,
                                        torch.float32)},
        "experts": {
            "wi_gate": layers._uniform(gen, (m.num_experts, d, m.d_expert), -scale, scale, dt),
            "wi_up": layers._uniform(gen, (m.num_experts, d, m.d_expert), -scale, scale, dt),
            "wo": layers._uniform(gen, (m.num_experts, m.d_expert, d), -wo_scale, wo_scale, dt),
        },
    }
    if m.num_shared > 0:
        params["shared"] = layers.mlp_init(gen, d, m.num_shared * m.d_expert, dt,
                                           act=cfg.mlp_act)
    return params


def _topk_gating(logits: torch.Tensor, m: MoECfg
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T, k), indices (T, k), aux loss).

    The top k by a stable descending sort: equal probabilities come lowest
    index first, as ``jax.lax.top_k`` gives them (``torch.topk`` promises no
    order among ties).
    """
    lf = logits.float()
    probs = torch.softmax(lf, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = top[:, :m.top_k], order[:, :m.top_k]
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    # load-balancing aux loss (Switch-style) + router z-loss
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(idx[:, 0], m.num_experts).float(), dim=0)
    aux = m.num_experts * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(lf, dim=-1) ** 2)
    return weights, idx, aux + m.router_zloss * z


def _routed_experts(experts: Dict, dispatch: torch.Tensor, combine: torch.Tensor,
                    xt: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """Gather tokens into expert slots, run every expert's SwiGLU, scatter back
    weighted: (T, d) -> (T, d), all in the compute dtype ``cd``."""
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(cd), xt)
    gate = torch.einsum("ecd,edf->ecf", expert_in, experts["wi_gate"].to(cd))
    up = torch.einsum("ecd,edf->ecf", expert_in, experts["wi_up"].to(cd))
    h = F.silu(gate) * up
    eo = torch.einsum("ecf,efd->ecd", h, experts["wo"].to(cd))
    return torch.einsum("tec,ecd->td", combine.to(cd), eo)


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              policy: Policy) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)

    logits = layers.dense_apply(params["router"], xt.float(), ROUTER_POLICY)
    weights, idx, aux = _topk_gating(logits, m)

    capacity = int(math.ceil(T * m.top_k / m.num_experts * m.capacity_factor))
    capacity = max(capacity, m.top_k)

    # dispatch (T, E, C): token t -> slot c of expert e (capacity-truncated).
    # Slot positions run over the flattened (T*k) assignment order, so choices
    # of different ranks never share a slot; the counts are exact in float32.
    onehot = F.one_hot(idx, m.num_experts).float()                  # (T, k, E)
    flat = onehot.reshape(-1, m.num_experts)                         # (T*k, E)
    running = torch.cumsum(flat, dim=0) - flat                       # earlier count
    pos_tk = torch.einsum("ne,ne->n", running, flat).reshape(onehot.shape[:2])
    keep = (pos_tk < capacity).float()                               # (T, k)
    # a one-hot that is all zeros past the capacity, as jax.nn.one_hot's
    slot_oh = (pos_tk.long()[..., None]
               == torch.arange(capacity, device=x.device)).float()    # (T, k, C)
    sel = onehot * keep[:, :, None]                                  # (T, k, E)
    dispatch = torch.einsum("tke,tkc->tec", sel, slot_oh)
    combine = torch.einsum("tke,tk,tkc->tec", sel, weights, slot_oh)

    out = _routed_experts(params["experts"], dispatch, combine, xt, cfg.compute_torch_dtype)
    if m.num_shared > 0:
        out = out + layers.mlp_apply(params["shared"], xt, policy, cfg.mlp_act)
    return out.reshape(B, S, d), aux
