"""repro_torch's training launcher (``launch.train``), called in-process on the
CPU at yi-6b-smoke (2 layers, a batch of 2 x 16, 4 steps).

A launch whose last checkpoint is moved aside resumes from the one before and
writes that step again bit for bit, under ``fp64`` and ``ozaki2_int8``.  A
checkpoint holds the parameters and the optimizer state only, as the
reference's does, so a resumed ``--compress-grads`` run starts a fresh
error-feedback state: it equals a loop that resets that state at the resume
step, and differs from the uninterrupted run (ROADMAP queue 3, item 20).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint, loop  # noqa: E402

STEPS, EVERY, BATCH, SEQ = 4, 2, 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run this file's steps on one intra-op thread, restored after.  The
    smoke model's many small ops thrash when the suite's workers share the
    cores on many threads each (an ozaki2_int8 smoke step took 24 s with four
    such processes on 8 cores, 0.9 s on one thread each); every comparison
    here is between runs made in this same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _launch(ckpt_dir, policy, *extra):
    train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--policy", policy,
                "--steps", str(STEPS), "--ckpt-every", str(EVERY), "--batch", str(BATCH),
                "--seq", str(SEQ), "--ckpt-dir", str(ckpt_dir), *extra])


def _logged_steps(out):
    return [int(line.split()[1]) for line in out.splitlines() if line.startswith("step ")]


def _launch_twice(tmp_path, capsys, policy, *extra):
    """Launch, move the last checkpoint aside, launch again; returns the two
    directories that hold step STEPS (the resumed run's, the moved one's)."""
    d, aside = tmp_path / "ck", tmp_path / "aside"
    _launch(d, policy, *extra)
    out = capsys.readouterr().out
    assert "resumed" not in out and out.rstrip().endswith("done")
    assert _logged_steps(out) == list(range(STEPS))
    assert checkpoint.latest_step(str(d)) == STEPS
    aside.mkdir()
    os.replace(d / f"step_{STEPS:08d}", aside / f"step_{STEPS:08d}")
    _launch(d, policy, *extra)
    out = capsys.readouterr().out
    assert f"resumed from step {STEPS - EVERY}" in out and out.rstrip().endswith("done")
    assert _logged_steps(out) == list(range(STEPS - EVERY, STEPS))
    return d, aside


def _same_bits(d1, d2):
    """Whether two step directories hold the same leaves, byte for byte."""
    step = f"step_{STEPS:08d}"
    m1, m2 = (json.load(open(d / step / checkpoint.MANIFEST)) for d in (d1, d2))
    with np.load(d1 / step / "host0000.npz") as z1, np.load(d2 / step / "host0000.npz") as z2:
        return m1 == m2 and z1.files == z2.files and all(
            z1[k].dtype == z2[k].dtype and z1[k].tobytes() == z2[k].tobytes() for k in z1.files)


@pytest.mark.parametrize("policy", ["fp64", "ozaki2_int8"])
def test_resumed_launch_writes_the_uninterrupted_step_bitwise(tmp_path, capsys, policy):
    d, aside = _launch_twice(tmp_path, capsys, policy)
    assert _same_bits(d, aside)
    manifest = json.load(open(d / f"step_{STEPS:08d}" / checkpoint.MANIFEST))
    assert manifest["extra"] == {"next_step": STEPS}
    assert {k.split("/")[0] for k in manifest["dtypes"]} == {"params", "opt"}
    assert manifest["dtypes"]["opt/step"] == "int32"


def _hand_run(reset_at=None):
    """The launcher's compressed run written out by hand, with the
    error-feedback state reset at step ``reset_at``; returns its state."""
    cfg = registry.get_config("yi-6b", smoke=True, policy_name="fp64")
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=3e-4)
    opt = adamw.adamw_init(dict(model.named_parameters()), opt_cfg)
    step = loop.make_train_step(model, opt_cfg, warmup_steps=max(STEPS // 10, 1),
                                total_steps=STEPS, compress_grads=True)
    ef = None
    for i in range(STEPS):
        if i == reset_at:
            ef = None
        batch = synth_batch(DataConfig(global_batch=BATCH, seq_len=SEQ), cfg, i, device="cpu")
        opt, _, _, ef = step(opt, batch, ef)
    return {"params": dict(model.named_parameters()), "opt": opt}


def _equal(got, want):
    got, want = dict(checkpoint._paths(got)), dict(checkpoint._paths(want))
    return set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and
        checkpoint._to_numpy(got[k]).tobytes() == checkpoint._to_numpy(want[k]).tobytes()
        for k in want)


def test_resumed_compressed_launch_starts_a_fresh_error_feedback_state(tmp_path, capsys):
    d, aside = _launch_twice(tmp_path, capsys, "fp64", "--compress-grads")
    fresh, whole = _hand_run(reset_at=STEPS - EVERY), _hand_run()
    resumed, _ = checkpoint.restore(str(d), like=fresh)
    uninterrupted, _ = checkpoint.restore(str(aside), like=fresh)
    assert _equal(resumed, fresh)
    assert _equal(uninterrupted, whole)
    assert not _equal(resumed, uninterrupted)
    assert not _same_bits(d, aside)


def test_launch_without_a_card_raises_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
