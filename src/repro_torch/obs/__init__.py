"""Observability (``repro.obs``): seam telemetry, measured against the TME model.

``repro_torch.obs.telemetry`` records per-op events at the dispatch seam, the
compensated reductions, the iterative solvers and the serving engine;
``repro_torch.obs.report`` turns the counters into the measured-vs-TME-predicted
table (``python -m repro_torch.obs.report``).  Controlled by
``telemetry_scope(...)`` or ``set_mode`` (off | counters | trace).
"""

from repro_torch.obs.telemetry import (  # noqa: F401
    MODES,
    PENDING_CAP,
    TRACE_CAP,
    OpEvent,
    cache_snapshot,
    counters_snapshot,
    enabled,
    flush,
    get_mode,
    op_end,
    op_start,
    probe,
    record_cache,
    record_event,
    reset,
    set_mode,
    snapshot,
    telemetry_scope,
    trace_snapshot,
    tracing,
    write_json,
)
