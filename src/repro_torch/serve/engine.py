"""Serving engine (``repro.serve.engine``): prefill + decode with continuous batching.

``ServeEngine`` wraps a ``Model`` with:
  * ``prefill_slot`` — feeds a prompt token by token through decode steps,
    which fills the slot's KV cache with the decode path's own semantics;
  * ``decode_step_all`` — one batched single-token step over every slot;
  * ``ContinuousBatcher`` — slot-based request scheduler: finished sequences
    release their cache slot to queued requests between steps.

Under an emulated precision policy (``policy_name="ozaki2_int8"``) every weight
matmul goes through ``dispatch.matmul`` and the score path of every step through
``dispatch.attention``; the engine's ``dispatch_mode`` pins both routes
(``auto`` | ``ref`` | ``kernel``) for everything it runs.

With telemetry on (``repro_torch.obs.telemetry``), the engine records per-step
serving events: ``serve.prefill`` (host-clock μs and tokens/s per prompt),
``serve.decode`` (host-clock μs and tokens/s per batched step; both end in a
copy of the next tokens to the host, which waits for the card) and
``serve.queue`` (queue depth and active slots per scheduler step), beside the
seam events of the model's own products and attention.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.models.transformer import Model
from repro_torch.obs import telemetry as obs


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray             # (P,) int
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ServeEngine:
    def __init__(self, model: Model, batch_slots: int, max_seq: int,
                 dispatch_mode: Optional[str] = None):
        """``dispatch_mode`` pins the emulation route (auto | ref | kernel) for
        every step this engine runs; None inherits the thread's mode."""
        self.model = model
        self.slots = batch_slots
        self.max_seq = max_seq
        self.dispatch_mode = dispatch_mode
        self.cache = model.init_cache(batch_slots, max_seq)
        self.pos = np.zeros(batch_slots, np.int32)

    def _decode_call(self, tokens: np.ndarray, pos: int) -> torch.Tensor:
        toks = torch.as_tensor(tokens.reshape(-1, 1), dtype=torch.long, device=self.model.device)
        with dispatch.mode_scope(self.dispatch_mode):
            logits, self.cache = self.model.decode_step(self.cache, toks, pos)
        return logits

    def prefill_slot(self, slot: int, prompt: np.ndarray) -> int:
        """Feed a prompt through decode steps to fill the cache slot; returns
        the first generated token."""
        t0 = time.perf_counter() if obs.enabled() else None
        last = 0
        for t, tok in enumerate(prompt):
            tokens = np.zeros((self.slots,), np.int64)
            tokens[slot] = tok
            logits = self._decode_call(tokens, t)
            last = int(torch.argmax(logits[slot, 0]))
        self.pos[slot] = len(prompt)
        if t0 is not None:
            dt = time.perf_counter() - t0
            obs.record_event("serve.prefill", us=dt * 1e6, route=self.dispatch_mode or "",
                             tokens=len(prompt), slot=slot,
                             tokens_per_s=len(prompt) / max(dt, 1e-9))
        return last

    def decode_step_all(self, tokens: np.ndarray, pos: int) -> np.ndarray:
        t0 = time.perf_counter() if obs.enabled() else None
        logits = self._decode_call(tokens, pos)
        out = torch.argmax(logits[:, 0], dim=-1).cpu().numpy().astype(np.int32)
        if t0 is not None:
            dt = time.perf_counter() - t0
            obs.record_event("serve.decode", us=dt * 1e6, route=self.dispatch_mode or "",
                             batch=self.slots, tokens_per_s=self.slots / max(dt, 1e-9))
        return out


@dataclasses.dataclass
class ContinuousBatcher:
    """Slot scheduler: admits queued requests into freed slots each step."""
    engine: ServeEngine
    queue: List[Request] = dataclasses.field(default_factory=list)
    active: Dict[int, Request] = dataclasses.field(default_factory=dict)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.engine.slots):
            if slot not in self.active and self.queue:
                req = self.queue.pop(0)
                req.generated.append(self.engine.prefill_slot(slot, req.prompt))
                self.active[slot] = req

    def step(self) -> List[Request]:
        """One engine step; returns requests that finished this step."""
        obs.record_event("serve.queue", queued=len(self.queue), active=len(self.active))
        self._admit()
        if not self.active:
            return []
        tokens = np.zeros(self.engine.slots, np.int64)
        pos = 0
        for slot, req in self.active.items():
            tokens[slot] = req.generated[-1]
            pos = max(pos, int(self.engine.pos[slot]))
        nxt = self.engine.decode_step_all(tokens, pos)
        finished = []
        for slot, req in list(self.active.items()):
            req.generated.append(int(nxt[slot]))
            self.engine.pos[slot] += 1
            if req.done:
                finished.append(req)
                del self.active[slot]      # slot released -> next admit() reuses it
        return finished

    def run_to_completion(self, max_steps: int = 1000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.queue and not self.active:
                break
            done.extend(self.step())
        return done
