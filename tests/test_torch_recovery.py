"""repro_torch's fault tolerance (``train.fault_tolerance``) on the CPU: the
counterparts of the reference's cases (``tests/test_substrate.py``), parity
with ``repro``'s monitor, detector, restart policy and recovery loop, and a
real training run resumed bitwise after injected failures.

Clocks and sleeps are injected (``now``, ``sleep``): nothing here sleeps or
reads the wall clock.  The bitwise resume runs the port's train step on
yi-6b-smoke (2 layers, float32 compute, bfloat16 moments, a batch of 2 x 16,
4 steps) under ``fp64`` and ``ozaki2_int8``; a run through
``run_with_recovery`` that fails once before its first checkpoint and once
after it ends on the uninterrupted run's parameters, moments and step, bit
for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import fault_tolerance as jft  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint, fault_tolerance, loop  # noqa: E402

STEPS = 4


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


def _bits(t):
    t = t.detach().contiguous()
    if t.dtype.is_floating_point:
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.numpy()


def _differing(got, want):
    """{key: count of elements whose bits differ} over two trees' leaves."""
    got, want = dict(checkpoint._paths(got)), dict(checkpoint._paths(want))
    assert set(got) == set(want)
    return {k: int((_bits(got[k]) != _bits(want[k])).sum()) for k in want
            if got[k].dtype != want[k].dtype or (_bits(got[k]) != _bits(want[k])).any()}


# --- the reference's cases ---------------------------------------------------------

def test_heartbeat_monitor():
    hb = fault_tolerance.HeartbeatMonitor(num_hosts=3, timeout_s=10)
    hb.beat(0, now=100.0)
    hb.beat(1, now=100.0)
    hb.beat(2, now=95.0)
    assert hb.dead_hosts(now=106.0) == [2]


def test_straggler_detector_flags_slow_host():
    det = fault_tolerance.StragglerDetector(num_hosts=8, patience=3)
    rng = np.random.default_rng(0)
    flagged = []
    for step in range(20):
        times = 1.0 + 0.01 * rng.standard_normal(8)
        times[5] = 3.0  # host 5 is 3x slower
        flagged = det.observe(times)
    assert flagged == [5]


def test_run_with_recovery_survives_failures(tmp_path):
    """Steps fail twice; training resumes from checkpoints and completes."""
    calls = {"n": 0}

    def step_fn(step, state):
        calls["n"] += 1
        if calls["n"] in (7, 15):       # two injected failures
            raise fault_tolerance.StepFailure("simulated node loss")
        return {"x": state["x"] + 1.0}, {}

    state, stats = fault_tolerance.run_with_recovery(
        step_fn, {"x": torch.zeros((), dtype=torch.float64)}, num_steps=20,
        ckpt_dir=str(tmp_path / "ck"), ckpt_every=5, sleep=lambda s: None)
    assert stats["failures"] == 2
    assert stats["restores"] >= 2
    assert float(state["x"]) == 20.0    # exactly num_steps effective updates


# --- parity with repro -------------------------------------------------------------

def test_heartbeat_matches_reference():
    beats = [(0, 10.0), (1, 12.5), (2, 3.0), (0, 40.0), (3, 41.0)]
    mon = fault_tolerance.HeartbeatMonitor(num_hosts=5, timeout_s=20.0)
    jmon = jft.HeartbeatMonitor(num_hosts=5, timeout_s=20.0)
    for h, t in beats:
        mon.beat(h, now=t)
        jmon.beat(h, now=t)
        for now in (t, t + 19.5, t + 20.0, t + 20.5, 1e6):
            assert mon.dead_hosts(now=now) == jmon.dead_hosts(now=now)


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(7)
    det = fault_tolerance.StragglerDetector(num_hosts=8, patience=3, z_thresh=2.5)
    jdet = jft.StragglerDetector(num_hosts=8, patience=3, z_thresh=2.5)
    flagged = []
    for step in range(40):
        times = 1.0 + 0.05 * rng.standard_normal(8)
        if 10 <= step < 30:
            times[3] *= 1.8              # host 3 slows down, then recovers
        got, want = det.observe(times), jdet.observe(times)
        assert got == want, step
        assert det._ewma.tobytes() == jdet._ewma.tobytes(), step
        assert np.array_equal(det._flags, jdet._flags), step
        flagged.append(got)
    assert [3] in flagged


def test_restart_policy_matches_reference():
    pol = fault_tolerance.RestartPolicy(max_restarts=6, backoff_s=0.5, backoff_mult=3.0)
    jpol = jft.RestartPolicy(max_restarts=6, backoff_s=0.5, backoff_mult=3.0)
    delays = [pol.next_delay() for _ in range(8)]
    assert delays == [jpol.next_delay() for _ in range(8)]
    assert delays[-2:] == [None, None] and pol.restarts == 6


@pytest.mark.parametrize("failures", [(2, 6, 7), (1, 4, 9, 10), ()])
def test_run_with_recovery_matches_reference(tmp_path, failures):
    """The same failure schedule (one before the first checkpoint where the
    schedule has one) gives the same stats, delays and final state."""
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(3).astype(np.float32)
    runs = {}
    for name, ft, wrap, scale in (
            ("port", fault_tolerance, lambda x: torch.from_numpy(x.copy()),
             lambda x, s: x * 1.5 + torch.tensor(s, dtype=torch.float32)),
            ("repro", jft, jnp.asarray, lambda x, s: x * 1.5 + jnp.float32(s))):
        calls, delays = [0], []

        def step_fn(step, state, ft=ft, scale=scale):
            calls[0] += 1
            if calls[0] in failures:
                raise ft.StepFailure("injected")
            return {"x": scale(state["x"], step), "n": state["n"] + 1}, {}

        state, stats = ft.run_with_recovery(
            step_fn, {"x": wrap(x0), "n": wrap(np.asarray(0, np.int32))}, num_steps=8,
            ckpt_dir=str(tmp_path / name), ckpt_every=3, sleep=delays.append)
        runs[name] = (stats, delays, np.asarray(state["x"]), int(state["n"]))
    (stats, delays, x, n), (jstats, jdelays, jx, jn) = runs["port"], runs["repro"]
    assert stats == jstats and delays == jdelays and n == jn == 8
    assert x.dtype == jx.dtype == np.float32 and x.tobytes() == jx.tobytes()
    assert stats["failures"] == len(failures)


def test_in_place_step_restarts_from_the_true_initial_state(tmp_path):
    """A step that updates the state in place and then fails, before any
    checkpoint, restarts from the values the run began with."""
    calls = [0]

    def step_fn(step, state):
        calls[0] += 1
        state["x"].add_(1.0)             # the update lands before the failure
        if calls[0] in (1, 3):
            raise fault_tolerance.StepFailure("after the in-place update")
        return state, {}

    x = torch.zeros(2, dtype=torch.float64)
    state, stats = fault_tolerance.run_with_recovery(
        step_fn, {"x": x}, num_steps=4, ckpt_dir=str(tmp_path / "ck"), ckpt_every=4,
        sleep=lambda s: None)
    assert stats == {"failures": 2, "restores": 0, "steps_run": 5}
    assert state["x"].tolist() == [4.0, 4.0]


def test_run_resumes_from_an_existing_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    checkpoint.save(d, 3, {"x": torch.full((2,), 3.0)}, extra={"next_step": 3})
    seen = []

    def step_fn(step, state):
        seen.append(step)
        return {"x": state["x"] + 1.0}, {}

    state, stats = fault_tolerance.run_with_recovery(
        step_fn, {"x": torch.zeros(2)}, num_steps=5, ckpt_dir=d, ckpt_every=10,
        sleep=lambda s: None)
    assert seen == [3, 4] and stats == {"failures": 0, "restores": 1, "steps_run": 2}
    assert state["x"].tolist() == [5.0, 5.0] and checkpoint.latest_step(d) == 5


def test_run_with_recovery_gives_up_after_its_budget(tmp_path):
    def step_fn(step, state):
        raise fault_tolerance.StepFailure("always")

    delays = []
    with pytest.raises(fault_tolerance.StepFailure):
        fault_tolerance.run_with_recovery(
            step_fn, {"x": torch.zeros(1)}, num_steps=2, ckpt_dir=str(tmp_path / "ck"),
            policy=fault_tolerance.RestartPolicy(max_restarts=2), sleep=delays.append)
    assert delays == [1.0, 2.0]


# --- a real training run, resumed bitwise ---------------------------------------------

@pytest.mark.parametrize("policy", ["fp64", "ozaki2_int8"])
def test_training_resumed_after_failures_is_bitwise_the_uninterrupted_run(tmp_path, policy):
    cfg = registry.get_config("yi-6b", smoke=True, policy_name=policy, compute_dtype="float32")
    assert cfg.num_layers == 2
    opt_cfg = adamw.AdamWConfig(moment_dtype="bfloat16")
    model = Model(cfg).init(torch.Generator().manual_seed(5))
    init = checkpoint.snapshot(dict(model.named_parameters()))
    step = loop.make_train_step(model, opt_cfg, warmup_steps=1, total_steps=STEPS)
    data = DataConfig(global_batch=2, seq_len=16, seed=1)
    batches = [synth_batch(data, cfg, i, device="cpu") for i in range(STEPS)]

    opt = adamw.adamw_init(dict(model.named_parameters()), opt_cfg)
    for b in batches:
        opt, _, _ = step(opt, b)
    want = {"params": checkpoint.snapshot(dict(model.named_parameters())),
            "opt": checkpoint.snapshot(opt)}

    params = loop.load_params(model, init)
    calls = [0]

    def step_fn(i, state):
        calls[0] += 1
        if calls[0] in (2, 5):           # before the first checkpoint, and after it
            raise fault_tolerance.StepFailure("injected")
        live = loop.load_params(model, state["params"])
        new_opt, metrics, _ = step(state["opt"], batches[i])
        return {"params": live, "opt": new_opt}, metrics

    delays = []
    state, stats = fault_tolerance.run_with_recovery(
        step_fn, {"params": params, "opt": adamw.adamw_init(params, opt_cfg)},
        num_steps=STEPS, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2, sleep=delays.append)
    assert stats == {"failures": 2, "restores": 1, "steps_run": 5} and delays == [1.0, 2.0]
    assert int(state["opt"]["step"]) == STEPS
    assert _differing(state, want) == {}
    assert state["opt"]["m"]["lm_head.w"].dtype == torch.bfloat16
    restored, extra = checkpoint.restore(str(tmp_path / "ck"), like=state)
    assert extra == {"next_step": STEPS} and _differing(restored, want) == {}
