"""Seam telemetry (``repro.obs.telemetry``): measured-vs-TME records of the seam.

The TME model (``repro_torch.core.tme``, eqs. 8–9) predicts emulated-FP64 time
from (α, β, γ), and every emulated multiplication of the port routes through
one seam (``repro_torch.core.dispatch``).  This module records what actually
happens there, so "measured vs TME-predicted" is collected on every run that
asks for it.

What is recorded per dispatched op (``op_start``/``op_end`` around the route's
execution): kind, shape class, the route taken (``kernel`` | ``ref``), the
plan's r and payload_bits, the measured time, the FLOPs and bytes of the
FP64-equivalent op, and the TME-predicted time of the same op on ``tme.H100``
(``tme.DEFAULT_CHIP``).  The measured time is one of two things:

  * **CUDA tensors** — the elapsed time between two CUDA events recorded on the
    current stream, one by ``op_start`` and one by ``op_end``: the device's
    span of the op, including any idle gaps while the host enqueued it.  The
    pair is resolved lazily, when a snapshot is taken or when ``PENDING_CAP``
    pairs are pending (then the oldest half is waited for), so recording adds
    no host synchronisation to the path it watches.
  * **CPU tensors** — the host clock (``time.perf_counter``) between the two
    calls; CPU ops are synchronous.

Plan and tuning cache hits and misses are counted separately (``record_cache``),
and free-form events (solver residuals, serving steps) ride the same stream
through ``record_event``.

Storage is two-tier, selected by ``set_mode`` or ``telemetry_scope`` (this
thread's setting; there is no environment variable):

  * **counters** — per-(kind, shape class, route) aggregates: call count,
    total/min/max μs, total FLOPs and bytes, total TME-predicted μs.
  * **trace** — the counters plus a ring of the ``TRACE_CAP`` most recent
    events.

Two invariants the instrumented call sites rely on:

  * **Safe under compile and capture** — ``op_start`` returns None and
    ``record_event`` does nothing while ``torch.compile`` traces or the current
    CUDA stream is capturing a graph: neither may see an event or a clock.
  * **Off costs one lookup** — with the mode off, ``op_start`` and
    ``record_event`` read one thread-local attribute and return; no event, no
    allocation, no lock.

The mode is this thread's: PyTorch runs a CUDA backward on a worker thread of
its own, so code that records there (``core.policy``'s emulated dots) carries
the forward's mode over in ``telemetry_scope``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import tme

MODES = ("off", "counters", "trace")

# Ring-buffer capacity in trace mode (most recent events win).
TRACE_CAP = 4096
# CUDA event pairs held unresolved before the oldest half is waited for.
PENDING_CAP = 4096

_tls = threading.local()
_lock = threading.Lock()

# (kind, shape_class, route) -> mutable aggregate dict.
_counters: Dict[Tuple[str, str, str], Dict[str, float]] = {}
# cache name ("plan" | "tune") -> [hits, misses]
_caches: Dict[str, List[int]] = {}
_trace: deque = deque(maxlen=TRACE_CAP)
# Events in the order they ended: (event, start, end, trace) with CUDA events
# still to be resolved, or (event, None, None, trace) for one that is complete
# but queued behind them (so the trace keeps its order); ``trace`` is whether
# the recording thread was in trace mode.
_pending: deque = deque()


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One recorded event.  Dispatch ops fill every field; free-form events
    (``record_event``) carry their payload in ``extra`` and may leave the
    plan/cost fields at zero."""
    kind: str
    shape_class: str
    route: str
    r: int
    payload_bits: int
    us: float                  # measured time: CUDA events, or the host clock
    flops: float               # W of the FP64-equivalent op
    bytes: float               # Q of the FP64-equivalent op
    tme_us: float              # TME-predicted time for the same op
    label: str = ""
    extra: Tuple[Tuple[str, Any], ...] = ()


# ---------------------------------------------------------------------------
# Mode resolution (mirrors dispatch.mode_scope)
# ---------------------------------------------------------------------------

def _validate_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"telemetry mode must be one of {MODES}, got {mode!r}")
    return mode


def get_mode() -> str:
    """Effective telemetry mode: this thread's override, else ``off``."""
    override = getattr(_tls, "mode", None)
    return "off" if override is None else override


def set_mode(mode: Optional[str]) -> None:
    """Set (or with None, clear) this thread's telemetry-mode override."""
    _tls.mode = None if mode is None else _validate_mode(mode)


@contextlib.contextmanager
def telemetry_scope(mode: Optional[str]):
    """Temporarily force a telemetry mode (None = inherit the ambient mode)."""
    prev = getattr(_tls, "mode", None)
    set_mode(mode if mode is not None else prev)
    try:
        yield
    finally:
        _tls.mode = prev


def enabled() -> bool:
    """Whether any recording is active.  This is the per-call fast path the
    instrumented seams check first: one lookup, no allocation."""
    return getattr(_tls, "mode", None) not in (None, "off")


def tracing() -> bool:
    """Whether the per-event trace ring is filling (mode == "trace")."""
    return get_mode() == "trace"


def _compiling_or_capturing() -> bool:
    """Whether torch.compile is tracing or a CUDA graph is being captured."""
    if torch.compiler.is_compiling():
        return True
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

def reset() -> None:
    """Drop all counters, cache tallies, pending events and the trace ring."""
    with _lock:
        _counters.clear()
        _caches.clear()
        _trace.clear()
        _pending.clear()


def _shape_class(dims: Sequence[int]) -> str:
    if not dims:
        return ""
    # Deferred: dispatch imports this module at load time, not vice versa.
    from repro_torch.core.dispatch import shape_class
    return shape_class(dims)


def _record_locked(ev: OpEvent, trace: bool) -> None:
    key = (ev.kind, ev.shape_class, ev.route)
    agg = _counters.get(key)
    if agg is None:
        agg = _counters[key] = {
            "calls": 0, "us": 0.0, "us_min": float("inf"), "us_max": 0.0,
            "flops": 0.0, "bytes": 0.0, "tme_us": 0.0,
        }
    agg["calls"] += 1
    agg["us"] += ev.us
    agg["us_min"] = min(agg["us_min"], ev.us)
    agg["us_max"] = max(agg["us_max"], ev.us)
    agg["flops"] += ev.flops
    agg["bytes"] += ev.bytes
    agg["tme_us"] += ev.tme_us
    if trace:
        _trace.append(ev)


def _resolve_locked(count: int) -> None:
    """Record the ``count`` oldest pending events, waiting for their CUDA
    events where they have not completed."""
    for _ in range(min(count, len(_pending))):
        ev, start, end, trace = _pending.popleft()
        if start is not None:
            end.synchronize()
            ev = dataclasses.replace(ev, us=start.elapsed_time(end) * 1e3)
        _record_locked(ev, trace)


def _submit(ev: OpEvent, start=None, end=None) -> None:
    trace = get_mode() == "trace"
    with _lock:
        if start is None and not _pending:
            _record_locked(ev, trace)
            return
        _pending.append((ev, start, end, trace))
        if len(_pending) >= PENDING_CAP:
            _resolve_locked(PENDING_CAP // 2)


def flush() -> None:
    """Resolve every pending CUDA event pair into the counters (waits for the
    device to reach the last of them).  The snapshots call this."""
    with _lock:
        _resolve_locked(len(_pending))


def _device(operands) -> Optional[torch.device]:
    for v in operands:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def op_start(kind: str, dims: Sequence[int], route: str, plan=None,
             *operands, label: str = ""):
    """Begin recording one dispatched op; returns an opaque token for
    ``op_end``, or None when recording is off, torch.compile is tracing, or a
    CUDA graph is capturing.  On CUDA operands the token holds a CUDA event
    recorded on the current stream; otherwise the host clock."""
    if not enabled() or _compiling_or_capturing():
        return None
    dev = _device(operands)
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        t0 = None
    else:
        start, t0 = None, time.perf_counter()
    return (kind, tuple(int(d) for d in dims), route, plan, label, dev, start, t0)


def op_end(token, out):
    """Finish the op begun by ``op_start``: take its end time (a CUDA event on
    the current stream, or the host clock), compute the FLOPs, bytes and TME
    prediction, record, and return ``out`` (so call sites can ``return
    op_end(tok, out)``)."""
    if token is None:
        return out
    kind, dims, route, plan, label, dev, start, t0 = token
    end = None
    if start is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(dev))
        us = 0.0
    else:
        us = (time.perf_counter() - t0) * 1e6
    W, Q, _ = tme.op_costs(kind, dims)
    if plan is not None:
        r, pb = plan.r, plan.payload_bits
        tme_us = tme.predict_op_time(kind, dims, r=r, alpha=float(plan.alpha),
                                     substrate=plan.substrate, route=route) * 1e6
    else:
        r, pb = 0, 0
        tme_us = tme.predict_op_time(kind, dims, route=route) * 1e6
    _submit(OpEvent(kind, _shape_class(dims), route, r, pb, us, W, Q, tme_us,
                    label=label), start, end)
    return out


def record_event(kind: str, *, us: float = 0.0, dims: Sequence[int] = (),
                 route: str = "", label: str = "", **extra) -> None:
    """Record a free-form event (solver residuals, serving latencies, queue
    depths).  No TME prediction; nothing is recorded while torch.compile
    traces or a CUDA graph captures."""
    if not enabled() or _compiling_or_capturing():
        return
    _submit(OpEvent(kind, _shape_class(dims), route, 0, 0, float(us),
                    0.0, 0.0, 0.0, label=label,
                    extra=tuple(sorted(extra.items()))))


def record_cache(name: str, hit: bool) -> None:
    """Count a plan/tuning cache lookup (only called when recording is on)."""
    with _lock:
        tally = _caches.setdefault(name, [0, 0])
        tally[0 if hit else 1] += 1


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def counters_snapshot() -> Dict[Tuple[str, str, str], Dict[str, float]]:
    """Copy of the aggregate counters, keyed (kind, shape_class, route)."""
    flush()
    with _lock:
        return {k: dict(v) for k, v in _counters.items()}


def cache_snapshot() -> Dict[str, Tuple[int, int]]:
    """Cache tallies: name -> (hits, misses)."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _caches.items()}


def trace_snapshot() -> List[OpEvent]:
    """Copy of the ring buffer (oldest first; trace mode only fills it)."""
    flush()
    with _lock:
        return list(_trace)


def snapshot() -> Dict[str, Any]:
    """JSON-serialisable snapshot of everything recorded so far."""
    counters = [
        {"kind": k, "shape_class": cls, "route": route, **agg}
        for (k, cls, route), agg in sorted(counters_snapshot().items())
    ]
    return {
        "mode": get_mode(),
        "chip": tme.DEFAULT_CHIP.name,
        "counters": counters,
        "caches": {name: {"hits": h, "misses": m}
                   for name, (h, m) in sorted(cache_snapshot().items())},
        "trace": [dataclasses.asdict(ev) for ev in trace_snapshot()],
    }


def write_json(path: str) -> str:
    """Dump ``snapshot()`` to ``path``."""
    with open(path, "w") as fh:
        json.dump(snapshot(), fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def probe(fn):
    """Run ``fn`` once under trace telemetry and return ``(result, event)``
    where ``event`` is the last dispatched-op event it produced (None if it
    recorded none)."""
    with telemetry_scope("trace"):
        before = len(trace_snapshot())
        out = fn()
        new = trace_snapshot()[before:]
    for ev in reversed(new):
        if ev.route:
            return out, ev
    return out, None
