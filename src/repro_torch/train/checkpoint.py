"""Sharded, async, atomic checkpointing with an integrity manifest
(``repro.train.checkpoint``).

Layout (one directory per step), the reference's:
    ckpt_dir/step_000123/
        host0000.npz        the flattened leaves this host owns
        MANIFEST.json       leaf -> file map, adler32 checksums, dtypes, the
                            tree's key structure, the data step, ``extra`` —
                            written LAST (the commit point)
A step directory without a MANIFEST is ignored (a crash during the write), so
a restart always finds the latest *complete* checkpoint.  ``AsyncWriter``
writes on a background thread after copying the tree to the host.

A tree is a nested dict whose leaves are tensors (or numpy arrays), such as
``{"params": {state_dict name: tensor}, "opt": {"m": ..., "v": ..., "step":
...}}``; a leaf's key joins its dict keys with "/", and leaves are written in
sorted key order, as JAX flattens a dict.  numpy has no bfloat16: a bfloat16
leaf is written as its raw 2-byte words (numpy's ``|V2``, which is also how
the reference's ``np.savez`` writes one), with the manifest dtype "bfloat16",
so its bytes and checksum are the reference's, and it is read back through
the manifest's dtype bit for bit.  The reference cannot restore such a leaf
(ROADMAP queue 3, item 19).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Any
MANIFEST = "MANIFEST.json"
_WORDS = np.dtype("V2")          # a bfloat16 leaf's raw 2-byte words


def _paths(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) over a nested dict, keys sorted at each level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _structure(tree: Tree):
    return {k: _structure(v) if isinstance(v, Mapping) else None for k, v in tree.items()}


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host (a view where it already is one);
    bfloat16 as its raw words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_WORDS)
        return t.numpy()
    arr = np.asarray(leaf)
    return arr.view(_WORDS) if arr.dtype.name == "bfloat16" else arr


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _WORDS else str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _checksum(arr: np.ndarray) -> int:
    """adler32 of the leaf's bytes in C order (the reference's
    ``adler32(v.tobytes())``, without the copy)."""
    return zlib.adler32(arr.reshape(-1).view(np.uint8))


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _paths(tree)}


def _unflatten(like: Tree, flat: Mapping[str, Any], prefix: str = "") -> Tree:
    return {k: _unflatten(v, flat, f"{prefix}{k}/") if isinstance(v, Mapping)
            else flat[f"{prefix}{k}"] for k, v in like.items()}


def snapshot(tree: Tree) -> Tree:
    """A copy of the tree on the host, taken now: every tensor copied to CPU
    memory of its own (a blocking copy after the card is synchronised, never a
    view that a later in-place update overwrites), numpy leaves copied."""
    for dev in {v.device for _, v in _paths(tree) if isinstance(v, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def copy(v):
        if isinstance(v, Mapping):
            return {k: copy(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", copy=True)
        return np.array(v)
    return copy(tree)


def copy_like(tree: Tree, like: Tree) -> Tree:
    """A copy of ``tree``'s tensors on the devices and in the dtypes of
    ``like``'s leaves (whose values are not read)."""
    flat = dict(_paths(tree))
    return _unflatten(like, {k: torch.as_tensor(flat[k]).to(device=v.device, dtype=v.dtype,
                                                             copy=True)
                             for k, v in _paths(like)})


def save(ckpt_dir: str, step: int, tree: Tree, host_id: int = 0,
         extra: Optional[Dict] = None) -> str:
    """Synchronous sharded save with atomic manifest commit."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    flat = _flatten(tree)
    fname = f"host{host_id:04d}.npz"
    tmp_name = os.path.join(d, f".tmp_host{host_id:04d}.npz")  # savez appends
    with open(tmp_name, "wb") as f:                            # .npz unless it
        np.savez(f, **flat)                                    # is given a file
    os.replace(tmp_name, os.path.join(d, fname))
    manifest = {
        "step": step,
        "files": {fname: sorted(flat)},
        "checksums": {k: _checksum(v) for k, v in flat.items()},
        "treedef": _structure(tree),
        "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
        "extra": extra or {},
    }
    tmp = os.path.join(d, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(d, MANIFEST))   # commit point
    return d


def _complete_steps(ckpt_dir: str):
    return sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                  if n.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, n, MANIFEST)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like: Tree, step: Optional[int] = None,
            host_id: int = 0, verify: bool = True) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``like``: each leaf a tensor on the
    device and in the dtype of ``like``'s leaf (whose values are not read).
    Returns (tree, manifest extra).  Raises if the checkpoint's keys differ
    from ``like``'s or, with ``verify``, if a leaf's checksum does not match;
    each leaf is read once."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    leaves = dict(_paths(like))
    out = {}
    with np.load(os.path.join(d, f"host{host_id:04d}.npz")) as data:
        if set(data.files) != set(leaves):
            raise ValueError(f"checkpoint/model structure mismatch in {d}: "
                             f"{sorted(set(data.files) ^ set(leaves))}")
        for k, leaf in leaves.items():
            arr = data[k]
            if verify and _checksum(arr) != manifest["checksums"][k]:
                raise IOError(f"checksum mismatch for leaf {k} in {d}")
            out[k] = _to_tensor(arr, manifest["dtypes"][k]).to(device=leaf.device,
                                                               dtype=leaf.dtype)
    return _unflatten(like, out), manifest.get("extra", {})


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Retain only the newest ``keep`` complete checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    for s in _complete_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


class AsyncWriter:
    """Background checkpoint writer: ``save()`` copies the tree to the host
    and returns, the file is written on a thread, ``wait()`` joins it and
    raises any error the write met."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, ckpt_dir: str, step: int, tree: Tree, **kw) -> None:
        self.wait()
        host_tree = snapshot(tree)   # before the thread: the next step updates in place

        def _run():
            try:
                save(ckpt_dir, step, host_tree, **kw)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
