"""Gradient compression: int8 quantisation with error feedback
(``repro.distributed.compression``).

Each gradient (plus the residual carried from the last step) is scaled by
max|x| / 127, rounded half to even to int8 and scaled back: the tensor a
reduce-scatter of int8 would carry, at a quarter of float32's bytes.  The
quantisation residual is kept and added to the next step's gradient (EF-SGD,
Karimireddy et al. 2019).  On one device nothing crosses a wire; the function
is the compression's arithmetic, bitwise the reference's.  Gradients are dicts
of tensors keyed by ``state_dict`` names.  The reference scales each leaf of
its parameter tree, and a leaf stacks the same block of every pattern period
(``transformer.Model.stacked_groups``): ``groups`` names the tensors that share
one scale, and each tensor not named scales alone.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_state(grads: Mapping[str, torch.Tensor]) -> Tensors:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def _groups(names: Iterable[str], groups: Optional[Iterable[Sequence[str]]]) -> List[List[str]]:
    """``groups`` (those of its names present) and every other name alone."""
    names = list(names)
    present = set(names)
    out = [[k for k in grp if k in present] for grp in (groups or ())]
    out = [grp for grp in out if grp]
    seen = {k for grp in out for k in grp}
    return out + [[k] for k in names if k not in seen]


def compress_decompress(grads: Mapping[str, torch.Tensor],
                        ef_state: Optional[Mapping[str, torch.Tensor]] = None,
                        groups: Optional[Iterable[Sequence[str]]] = None
                        ) -> Tuple[Tensors, Tensors]:
    """(the gradients as seen after the wire, in their dtypes; the new
    float32 error-feedback state), one int8 scale per group of ``groups``."""
    if ef_state is None:
        ef_state = init_state(grads)
    newg, newe = {}, {}
    for grp in _groups(grads, groups):
        g32 = {k: grads[k].float() + ef_state[k] for k in grp}
        flat = torch.cat([x.reshape(-1) for x in g32.values()]) if len(grp) > 1 else g32[grp[0]]
        q, s = _quantize(flat)
        deq = _dequantize(q, s)
        for k, part in zip(grp, torch.split(deq.reshape(-1), [g32[k].numel() for k in grp])):
            part = part.reshape(g32[k].shape)
            newg[k] = part.to(grads[k].dtype)
            newe[k] = g32[k] - part
    return {k: newg[k] for k in grads}, {k: newe[k] for k in grads}


def compression_ratio(grads: Mapping[str, torch.Tensor],
                      groups: Optional[Iterable[Sequence[str]]] = None) -> float:
    """Wire-bytes ratio float32 -> int8 plus a float32 scale per group."""
    total = sum(g.numel() * 4 for g in grads.values())
    wire = sum(g.numel() * 1 for g in grads.values()) + 4 * len(_groups(grads, groups))
    return total / wire
