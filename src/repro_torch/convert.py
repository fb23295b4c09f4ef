"""Carry state between ``repro`` and ``repro_torch``.

``plan_from_fields`` builds this package's ``Plan`` from the fields of a
``repro`` plan (moduli, payload bits, substrate), so both packages compute on
the same plan; ``from_numpy`` / ``to_numpy`` move operands and results as
numpy arrays (a single array, or a list, tuple or dict of them);
``params_from_jax`` turns ``repro``'s model parameters into the flat state that
``models.transformer.Model.load`` takes, and ``opt_state_from_jax`` its AdamW
state into ``optim.adamw``'s.
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
    """numpy array(s) -> tensor(s) on ``device`` (default: the card).  JAX's
    bfloat16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not
    take) come across bit for bit."""
    dev = resolve_device(device)
    if isinstance(arrays, dict):
        return {k: from_numpy(v, dev) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(from_numpy(v, dev) for v in arrays)
    arr = np.ascontiguousarray(arrays)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


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
    port names every layer ``layers.{index}``.  An encoder-decoder's encoder
    layers are stacked on one leading axis (``"encoder"``); the port names them
    ``encoder.{index}``.  Every leaf unstacks alike: an MoE layer's router (d,
    E), its stacked experts ((E, d, f), (E, f, d)) and its shared experts come
    out as that layer's ``mlp.router.w``, ``mlp.experts.*`` and
    ``mlp.shared.*``; a decoder layer's cross-attention as ``cross.*`` and
    ``norm_cross.*``.
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
    encoder: Dict[str, np.ndarray] = {}
    _flatten(tree.get("encoder", {}), "", encoder)
    for name, arr in encoder.items():
        for i in range(arr.shape[0]):
            state[f"encoder.{i}.{name}"] = arr[i]
    for key, val in tree.items():
        if key not in ("stack", "encoder") and key not in tails:
            _flatten({key: val}, "", state)
    return from_numpy(state, device)


def opt_state_from_jax(state: Mapping, device="cuda") -> Dict:
    """``repro``'s ``adamw_init`` / ``adamw_update`` state (leaves as numpy
    arrays) -> ``optim.adamw``'s, on ``device``: the moments ``m`` and ``v``
    unstacked and named as ``params_from_jax`` names the parameters (bfloat16
    moments bit for bit), ``step`` an int32 0-dim tensor."""
    dev = resolve_device(device)
    return {"m": params_from_jax(state["m"], dev), "v": params_from_jax(state["v"], dev),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=dev)}
