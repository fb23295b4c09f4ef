"""Fault tolerance for training: heartbeats, straggler detection, restart
policy and the recovery loop (``repro.train.fault_tolerance``).

  * HeartbeatMonitor — per-host liveness with a timeout; a host silent for
    more than ``timeout_s`` is declared dead.
  * StragglerDetector — per-step wall-time EWMA and a robust z-score across
    hosts; a host above ``z_thresh`` for ``patience`` consecutive steps is
    flagged.
  * RestartPolicy — an exponential-backoff restart budget.
  * run_with_recovery — wraps a step function, checkpoints periodically and,
    on a ``StepFailure``, restores the latest complete checkpoint and goes on.

The monitor and the detector compute in numpy float64, as the reference's do.
Clocks and sleeps are arguments (``now``, ``sleep``) so that callers and tests
can drive them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.train import checkpoint


@dataclasses.dataclass
class HeartbeatMonitor:
    num_hosts: int
    timeout_s: float = 60.0
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host_id: int, now: Optional[float] = None) -> None:
        self._last[host_id] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h in range(self.num_hosts)
                if now - self._last.get(h, -1e18) > self.timeout_s]

    @property
    def healthy(self) -> bool:
        return not self.dead_hosts()


@dataclasses.dataclass
class StragglerDetector:
    num_hosts: int
    alpha: float = 0.1            # EWMA smoothing
    z_thresh: float = 3.0
    patience: int = 5
    _ewma: Optional[np.ndarray] = None
    _flags: Optional[np.ndarray] = None

    def observe(self, step_times: np.ndarray) -> List[int]:
        """step_times: (num_hosts,) wall seconds for this step.  Returns the
        hosts flagged as stragglers (>= patience consecutive hits)."""
        if self._ewma is None:
            self._ewma = step_times.astype(np.float64).copy()
            self._flags = np.zeros(self.num_hosts, np.int32)
            return []
        self._ewma = (1 - self.alpha) * self._ewma + self.alpha * step_times
        # robust z-score (median/MAD) so the straggler can't inflate the spread
        med = np.median(self._ewma)
        mad = np.median(np.abs(self._ewma - med)) * 1.4826 + 1e-6 * med + 1e-12
        z = (self._ewma - med) / mad
        hit = z > self.z_thresh
        self._flags = np.where(hit, self._flags + 1, 0)
        return [int(h) for h in np.nonzero(self._flags >= self.patience)[0]]


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    restarts: int = 0

    def next_delay(self) -> Optional[float]:
        if self.restarts >= self.max_restarts:
            return None
        d = self.backoff_s * (self.backoff_mult ** self.restarts)
        self.restarts += 1
        return d


class StepFailure(RuntimeError):
    """Raised by a step function to signal a recoverable worker failure."""


def run_with_recovery(step_fn: Callable[[int, Any], Tuple[Any, Dict]],
                      init_state: Any, num_steps: int, ckpt_dir: str,
                      ckpt_every: int = 10,
                      policy: Optional[RestartPolicy] = None,
                      sleep: Callable[[float], None] = time.sleep
                      ) -> Tuple[Any, Dict]:
    """Run ``state, metrics = step_fn(step, state)`` for ``num_steps`` with
    checkpoint/restart recovery; the state is a checkpoint tree.  Returns
    (final state, stats).

    ``step_fn`` may update the state's tensors in place (the train step
    updates the parameters in place), so ``init_state`` need not hold the
    initial values once a step has run: a host copy taken at entry is what a
    failure before the first checkpoint restarts from.  A restored or
    restarted state holds new tensors on ``init_state``'s devices, which
    ``step_fn`` takes as its input state.
    """
    policy = policy or RestartPolicy()
    writer = checkpoint.AsyncWriter()
    stats = {"failures": 0, "restores": 0, "steps_run": 0}
    initial = checkpoint.snapshot(init_state)

    state = init_state
    step = 0
    start = checkpoint.latest_step(ckpt_dir)
    if start is not None:
        state, extra = checkpoint.restore(ckpt_dir, like=init_state)
        step = int(extra.get("next_step", start + 1))
        stats["restores"] += 1

    try:
        while step < num_steps:
            try:
                state, _ = step_fn(step, state)
                stats["steps_run"] += 1
                step += 1
                if step % ckpt_every == 0 or step == num_steps:
                    writer.save(ckpt_dir, step, state, extra={"next_step": step})
            except StepFailure:
                stats["failures"] += 1
                delay = policy.next_delay()
                if delay is None:
                    raise
                sleep(delay)
                writer.wait()
                last = checkpoint.latest_step(ckpt_dir)
                if last is not None:
                    state, extra = checkpoint.restore(ckpt_dir, like=init_state)
                    step = int(extra.get("next_step", last))
                    stats["restores"] += 1
                else:
                    state, step = checkpoint.copy_like(initial, init_state), 0
    finally:
        writer.wait()
    return state, stats
