"""Deterministic, shard-aware, step-resumable synthetic token pipeline
(``repro.data.pipeline``).

Each data-parallel host makes only its shard of the global batch from a
counter-based numpy generator keyed by (seed, step, host), so a batch is fixed
by its step: a restart needs no data state beyond the step counter, and a
background thread can make the next batches while the card computes.  The
numpy draws are the reference's, in its order, so the tokens and labels are
its bits, and the bfloat16 embeddings round as JAX rounds them.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import _bfloat16


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _host_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    # counter-based: (seed, step, host) fully determines the batch
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def synth_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int,
                device="cuda") -> Dict[str, torch.Tensor]:
    """This host's batch at ``step``, on ``device`` (default: the card): Markov
    tokens (next = (prev * a + noise) % V) and their labels, int32 (B, S); an
    encoder-decoder's bfloat16 ``enc_embeds`` (B, encoder_seq, d); for the
    vision frontend bfloat16 ``embeds`` (B, S, d) and int32 ``positions``
    (B, 3, S) in place of the tokens."""
    dev = convert.resolve_device(device)
    rng = _host_rng(cfg, step)
    B, S, V = cfg.host_batch, cfg.seq_len, model_cfg.vocab_size
    a = 6364136223846793005 % V or 1
    x = np.empty((B, S + 1), np.int64)
    x[:, 0] = rng.integers(0, V, B)
    noise = rng.integers(0, max(V // 64, 2), (B, S))
    for t in range(S):
        x[:, t + 1] = (x[:, t] * a + noise[:, t]) % V
    batch = {"tokens": convert.from_numpy(x[:, :-1].astype(np.int32), dev),
             "labels": convert.from_numpy(x[:, 1:].astype(np.int32), dev)}
    if model_cfg.family == "encdec":
        batch["enc_embeds"] = _bfloat16(
            rng.standard_normal((B, model_cfg.encoder_seq, model_cfg.d_model)), dev)
    if model_cfg.frontend == "vision":
        batch.pop("tokens")
        batch["embeds"] = _bfloat16(rng.standard_normal((B, S, model_cfg.d_model)), dev)
        batch["positions"] = convert.from_numpy(
            np.broadcast_to(np.arange(S, dtype=np.int32), (B, 3, S)), dev)
    return batch


class Pipeline:
    """Step-indexed iterator over ``synth_batch`` with background prefetch
    (double buffering), on ``device`` (default: the card)."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig, start_step: int = 0,
                 prefetch: int = 2, device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = convert.resolve_device(device)
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, self.model_cfg, step, self.device)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
