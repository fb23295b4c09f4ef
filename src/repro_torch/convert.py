"""Carry state between ``repro`` and ``repro_torch``.

The system has no weights: its state is the emulation plan and the operands.
``plan_from_fields`` builds this package's ``Plan`` from the fields of a
``repro`` plan (moduli, payload bits, substrate), so both packages compute on
the same plan; ``from_numpy`` / ``to_numpy`` move operands and results as
numpy arrays (a single array, or a list, tuple or dict of them).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import ozaki2


def plan_from_fields(moduli: Sequence[int], payload_bits: int,
                     substrate: str = "int8") -> ozaki2.Plan:
    return ozaki2.Plan(moduli=tuple(int(m) for m in moduli),
                       payload_bits=int(payload_bits), substrate=substrate)


def resolve_device(device="cuda") -> torch.device:
    """A torch device that exists: asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return dev


def from_numpy(arrays, device="cuda"):
    """numpy array(s) -> tensor(s) on ``device`` (default: the card)."""
    dev = resolve_device(device)
    if isinstance(arrays, dict):
        return {k: from_numpy(v, dev) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(from_numpy(v, dev) for v in arrays)
    return torch.from_numpy(np.ascontiguousarray(arrays)).to(dev)


def to_numpy(tensors):
    """tensor(s) -> numpy array(s) on the host."""
    if isinstance(tensors, dict):
        return {k: to_numpy(v) for k, v in tensors.items()}
    if isinstance(tensors, (list, tuple)):
        return type(tensors)(to_numpy(v) for v in tensors)
    return tensors.detach().cpu().numpy()
