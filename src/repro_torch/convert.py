"""Carry state between ``repro`` and ``repro_torch``.

``plan_from_fields`` builds this package's ``Plan`` from the fields of a
``repro`` plan (moduli, payload bits, substrate), so both packages compute on
the same plan; ``from_numpy`` / ``to_numpy`` move operands and results as
numpy arrays (a single array, or a list, tuple or dict of them);
``params_from_jax`` turns ``repro``'s model parameters into the flat state that
``models.transformer.Model.load`` takes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

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


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            _flatten(val, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = np.array(val)   # a writable copy


def params_from_jax(tree: Mapping, device="cuda") -> Dict[str, torch.Tensor]:
    """``repro``'s ``Model.init`` parameter tree (leaves as numpy arrays) -> the
    flat state of this package's ``Model`` (``Model.load``), on ``device``.

    ``repro`` stacks the layers of each pattern period on a leading axis
    (``"stack"`` -> ``"b{j}"``, period i, block j is layer i * period + j) and
    keeps the remainder as ``"tail{j}"`` (layer num_periods * period + j); the
    port names every layer ``layers.{index}``.
    """
    state: Dict[str, np.ndarray] = {}
    stack = tree.get("stack", {})
    period = len(stack) or 1
    periods = 0
    for j in range(len(stack)):
        flat: Dict[str, np.ndarray] = {}
        _flatten(stack[f"b{j}"], "", flat)
        for name, arr in flat.items():
            periods = arr.shape[0]
            for i in range(periods):
                state[f"layers.{i * period + j}.{name}"] = arr[i]
    tails = sorted((k for k in tree if k.startswith("tail")), key=lambda k: int(k[4:]))
    for k in tails:
        _flatten(tree[k], f"layers.{periods * period + int(k[4:])}.", state)
    for key, val in tree.items():
        if key != "stack" and key not in tails:
            _flatten({key: val}, "", state)
    return from_numpy(state, device)
