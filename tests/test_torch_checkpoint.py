"""repro_torch's checkpoints (``train.checkpoint``) on the CPU: the counterparts
of the reference's checkpoint tests (``tests/test_substrate.py``), the
asynchronous writer's host snapshot, and parity with ``repro``'s checkpoints.

Parity: the same numpy tree through both packages' ``save`` gives the same npz
members, dtypes, checksums, files, step and extra (the manifest's ``treedef``
is not compared: the reference's is a JAX ``PyTreeDef`` string), and each
package restores the other's float32/int32 checkpoint bitwise.  A bfloat16
leaf is written by both as its raw words (``|V2``) with the same checksum; the
reference cannot restore it and the port restores it bit for bit (ROADMAP
queue 3, item 19).
"""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.train import checkpoint as jcheckpoint  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

CFG = registry.get_config("yi-6b", smoke=True)


def _bits(t):
    """A tensor's bit patterns, as a numpy array of unsigned integers."""
    t = t.detach().contiguous()
    if t.dtype.is_floating_point:
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.numpy()


def _assert_bitwise(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_bitwise(got[k], want[k])
    else:
        assert isinstance(got, torch.Tensor) and not got.requires_grad
        assert got.dtype == want.dtype and got.shape == want.shape and got.device == want.device
        np.testing.assert_array_equal(_bits(got), _bits(want.detach()))


def _train_state():
    """A smoke model's parameters and AdamW state with bfloat16 moments (m and
    v filled with seeded values), as the launcher checkpoints them."""
    model = Model(CFG).init(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    opt = adamw.adamw_init(params, adamw.AdamWConfig(moment_dtype="bfloat16"))
    gen = torch.Generator().manual_seed(1)
    for moments in (opt["m"], opt["v"]):
        for k, v in moments.items():
            moments[k] = torch.randn(v.shape, generator=gen).to(torch.bfloat16)
    opt["step"] = torch.tensor(5, dtype=torch.int32)
    return {"params": params, "opt": opt}


def _tensors(tree):
    """A numpy tree as CPU tensors, bfloat16 bit for bit, 0-d kept 0-d."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v.detach())
            for k, v in tree.items()}


# --- the reference's cases -------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = _train_state()
    d = str(tmp_path / "ck")
    checkpoint.save(d, 7, state, extra={"next_step": 8})
    restored, extra = checkpoint.restore(d, like=_zeros_like(state))
    assert extra["next_step"] == 8
    _assert_bitwise(restored, state)


def test_checkpoint_latest_ignores_incomplete(tmp_path):
    params = _train_state()["params"]
    d = str(tmp_path / "ck")
    checkpoint.save(d, 1, params)
    checkpoint.save(d, 5, params)
    # a crash mid-write of step 9: a directory without MANIFEST
    os.makedirs(os.path.join(d, "step_00000009"))
    assert checkpoint.latest_step(d) == 5
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), like=params)


def test_checkpoint_detects_corruption(tmp_path):
    params = {"w": torch.arange(10.0)}
    d = str(tmp_path / "ck")
    path = checkpoint.save(d, 0, params)
    f = os.path.join(path, "host0000.npz")
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(Exception):
        checkpoint.restore(d, like=params)


def test_checkpoint_checksum_mismatch_raises_unless_not_verified(tmp_path):
    params = {"w": torch.arange(10.0), "b": {"c": torch.ones(3, dtype=torch.int32)}}
    d = str(tmp_path / "ck")
    path = checkpoint.save(d, 0, params)
    mf = os.path.join(path, checkpoint.MANIFEST)
    manifest = json.load(open(mf))
    manifest["checksums"]["b/c"] ^= 1
    json.dump(manifest, open(mf, "w"))
    with pytest.raises(IOError, match="checksum mismatch for leaf b/c"):
        checkpoint.restore(d, like=params)
    restored, _ = checkpoint.restore(d, like=params, verify=False)
    _assert_bitwise(restored, params)


def test_checkpoint_structure_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    checkpoint.save(d, 0, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(d, like={"w": torch.zeros(3), "b": torch.zeros(1)})


def test_checkpoint_cleanup(tmp_path):
    params = {"w": torch.zeros(3)}
    d = str(tmp_path / "ck")
    for s in range(6):
        checkpoint.save(d, s, params)
    checkpoint.cleanup(d, keep=2)
    assert checkpoint.latest_step(d) == 5
    assert len([n for n in os.listdir(d) if n.startswith("step_")]) == 2


def test_restore_takes_device_and_dtype_of_like(tmp_path):
    d = str(tmp_path / "ck")
    checkpoint.save(d, 0, {"w": torch.arange(4, dtype=torch.float32)})
    restored, _ = checkpoint.restore(d, like={"w": torch.zeros(4, dtype=torch.float64)})
    assert restored["w"].dtype == torch.float64
    assert restored["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


# --- the asynchronous writer -------------------------------------------------------

def test_async_writer(tmp_path):
    params = {"w": torch.arange(5.0)}
    d = str(tmp_path / "ck")
    w = checkpoint.AsyncWriter()
    try:
        w.save(d, 3, params)
    finally:
        w.wait()
    restored, _ = checkpoint.restore(d, like=params)
    _assert_bitwise(restored, params)


def test_async_writer_snapshots_before_its_thread_writes(tmp_path, monkeypatch):
    """The train step updates its tensors in place right after ``save``
    returns: the file holds the values at the call, not later ones."""
    release = threading.Event()
    real_save = checkpoint.save

    def gated_save(*args, **kw):
        assert release.wait(timeout=60)
        return real_save(*args, **kw)

    monkeypatch.setattr(checkpoint, "save", gated_save)
    state = _train_state()
    want = checkpoint.snapshot(state)
    d = str(tmp_path / "ck")
    w = checkpoint.AsyncWriter()
    try:
        w.save(d, 1, state)
        with torch.no_grad():                 # the next step, before the write
            for p in state["params"].values():
                p.add_(1.0)
            state["opt"]["step"] += 1
        release.set()
    finally:
        release.set()
        w.wait()
    restored, _ = checkpoint.restore(d, like=state)
    _assert_bitwise(restored, want)


def test_snapshot_is_a_copy():
    t = torch.arange(3.0)
    snap = checkpoint.snapshot({"a": {"t": t}, "n": np.arange(2)})
    t.add_(1.0)
    assert snap["a"]["t"].tolist() == [0.0, 1.0, 2.0]
    assert snap["a"]["t"].data_ptr() != t.data_ptr()
    back = checkpoint.copy_like(snap, {"a": {"t": torch.zeros(3, dtype=torch.float64)},
                                       "n": torch.zeros(2, dtype=torch.int64)})
    assert back["a"]["t"].dtype == torch.float64 and back["n"].tolist() == [0, 1]


def test_async_writer_raises_a_failed_write_at_the_next_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    w = checkpoint.AsyncWriter()
    try:
        w.save(str(blocker), 1, {"w": torch.zeros(2)})
        with pytest.raises(OSError):
            w.wait()
    finally:
        w.wait()                              # the error was raised once


# --- parity with repro -------------------------------------------------------------

def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "emb": {"table": rng.standard_normal((5, 2)).astype(np.float32)}},
            "opt": {"m": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
                    "count": rng.integers(-9, 9, (4,)).astype(np.int32),
                    "step": np.asarray(7, np.int32)}}


def _read(d, step):
    path = os.path.join(d, f"step_{step:08d}")
    manifest = json.load(open(os.path.join(path, checkpoint.MANIFEST)))
    with np.load(os.path.join(path, "host0000.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


def test_save_matches_reference_layout(tmp_path):
    tree = _numpy_tree()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jcheckpoint.save(jdir, 3, jax.tree.map(jnp.asarray, tree), extra={"next_step": 3})
    checkpoint.save(tdir, 3, tree, extra={"next_step": 3})
    jman, jarr = _read(jdir, 3)
    tman, tarr = _read(tdir, 3)
    assert list(tarr) == list(jarr)           # the npz members, in order
    for key in ("dtypes", "checksums", "files", "step", "extra"):
        assert tman[key] == jman[key], key
    for k in jarr:
        assert tarr[k].dtype == jarr[k].dtype and tarr[k].tobytes() == jarr[k].tobytes(), k
    assert tman["dtypes"]["opt/step"] == "int32" and tarr["opt/step"].shape == ()


def test_each_package_restores_the_others_checkpoint(tmp_path):
    tree = _numpy_tree(1)
    jtree = jax.tree.map(jnp.asarray, tree)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jcheckpoint.save(jdir, 2, jtree)
    ttree = _tensors(tree)
    checkpoint.save(tdir, 2, ttree)
    got, _ = checkpoint.restore(jdir, like=_zeros_like(ttree))
    _assert_bitwise(got, ttree)
    jgot, _ = jcheckpoint.restore(tdir, like=jtree)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jgot)[0], jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and np.asarray(a).tobytes() == np.asarray(b).tobytes(), path


def test_bfloat16_leaf_restores_in_the_port_and_not_in_the_reference(tmp_path):
    """Item 19: both write a bfloat16 leaf as |V2 with the manifest dtype
    "bfloat16" and the same checksum; repro's restore raises, the port's
    restores the bits, from either package's checkpoint."""
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2 ** 16, (2, 3), dtype=np.uint16)
    tree = {"a": words.view(ml_dtypes.bfloat16),
            "b": {"c": rng.standard_normal(4).astype(np.float32), "step": np.asarray(3, np.int32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jcheckpoint.save(jdir, 1, jtree)
    ttree = _tensors(tree)
    assert ttree["a"].dtype == torch.bfloat16
    checkpoint.save(tdir, 1, ttree)
    jman, jarr = _read(jdir, 1)
    tman, tarr = _read(tdir, 1)
    assert tman["dtypes"] == jman["dtypes"] and tman["dtypes"]["a"] == "bfloat16"
    assert tman["checksums"] == jman["checksums"]
    assert tarr["a"].dtype == jarr["a"].dtype == np.dtype("V2")
    assert tarr["a"].tobytes() == jarr["a"].tobytes() == words.tobytes()
    with pytest.raises(TypeError):
        jcheckpoint.restore(jdir, like=jtree)
    for d in (jdir, tdir):
        got, _ = checkpoint.restore(d, like=_zeros_like(ttree))
        _assert_bitwise(got, ttree)
        assert np.array_equal(_bits(got["a"]).view(np.uint16), words)


def test_bfloat16_numpy_leaf_saves_as_the_reference_does(tmp_path):
    """A numpy bfloat16 leaf (ml_dtypes) through the port's save gives the
    reference's bytes, dtype and checksum."""
    words = np.arange(6, dtype=np.uint16).reshape(2, 3) * 4099
    tree = {"a": words.view(ml_dtypes.bfloat16), "z": np.zeros((), np.float32)}
    jcheckpoint.save(str(tmp_path / "j"), 0, jax.tree.map(jnp.asarray, tree))
    checkpoint.save(str(tmp_path / "t"), 0, tree)
    jman, jarr = _read(str(tmp_path / "j"), 0)
    tman, tarr = _read(str(tmp_path / "t"), 0)
    assert (tman["dtypes"], tman["checksums"]) == (jman["dtypes"], jman["checksums"])
    assert tarr["a"].tobytes() == jarr["a"].tobytes()
