"""The port's seam telemetry (``repro_torch.obs``) on the CPU.

Mode rules (no environment variable), the recording tiers, the labels, the
cache tallies, the solver and serving events, the report, the compile and
capture guards, the lazy resolution of CUDA event pairs (with stand-in
events), and the counters of one op sequence against ``repro.obs``'s.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compensated as jcomp  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core import ozaki2 as jozaki2  # noqa: E402
from repro.core import tme as jtme  # noqa: E402
from repro.obs import telemetry as jobs  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import compensated, dispatch, ozaki2, tme  # noqa: E402
from repro_torch.hpc import cg, jacobi  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs import telemetry as obs  # noqa: E402
from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine  # noqa: E402


@pytest.fixture(autouse=True)
def clean_telemetry():
    """Every test starts with empty stores and no override on this thread."""
    obs.set_mode(None)
    obs.reset()
    yield
    obs.set_mode(None)
    obs.reset()


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape))


def _ops(rng):
    """One call of every seam kind, on the CPU's (reference) route."""
    a, b = _t(rng, 32, 32), _t(rng, 32, 32)
    dispatch.matmul(a, b)
    dispatch.matmul(a, _t(rng, 32, 4))
    c = torch.tensor([6.0, -1, -1, -1, -1, -1, -1], dtype=torch.float64)
    dispatch.stencil7(_t(rng, 8, 8, 8), c)
    plan = ozaki2.make_plan(4, payload_bits=24, margin_bits=4)
    col = torch.from_numpy(rng.integers(0, 32, (32, 4)).astype(np.int32))
    dispatch.spmv(_t(rng, 32, 4), col, _t(rng, 32), plan=plan)
    dispatch.attention(_t(rng, 16, 8), _t(rng, 16, 8), _t(rng, 16, 8))
    dispatch.attention(_t(rng, 2, 1, 8), _t(rng, 2, 16, 8), _t(rng, 2, 16, 8))
    compensated.neumaier_sum(_t(rng, 300))
    compensated.compensated_dot(_t(rng, 300), _t(rng, 300))
    compensated.compensated_norm(_t(rng, 6, 50), axis=1)


# --- mode resolution ---------------------------------------------------------

def test_mode_rules_read_no_environment(monkeypatch):
    monkeypatch.setenv("REPRO_TELEMETRY", "trace")
    monkeypatch.setenv("REPRO_TORCH_TELEMETRY", "trace")
    assert obs.get_mode() == "off" and not obs.enabled() and not obs.tracing()
    obs.set_mode("counters")
    assert obs.get_mode() == "counters" and obs.enabled() and not obs.tracing()
    with obs.telemetry_scope("trace"):
        assert obs.tracing()
        with obs.telemetry_scope(None):          # None inherits
            assert obs.get_mode() == "trace"
        with obs.telemetry_scope("off"):
            assert not obs.enabled()
        assert obs.get_mode() == "trace"
    assert obs.get_mode() == "counters"
    obs.set_mode(None)
    assert obs.get_mode() == "off"
    with pytest.raises(ValueError, match="telemetry mode"):
        obs.set_mode("loud")
    with pytest.raises(ValueError, match="telemetry mode"):
        with obs.telemetry_scope("loud"):
            pass
    assert obs.get_mode() == "off"
    src = open(obs.__file__).read()
    assert "os.environ" not in src and "REPRO_" not in src


def test_mode_is_per_thread():
    seen = {}
    with obs.telemetry_scope("trace"):
        th = threading.Thread(target=lambda: seen.setdefault("mode", obs.get_mode()))
        th.start()
        th.join(timeout=30)
    assert not th.is_alive() and seen["mode"] == "off"


# --- recording tiers ---------------------------------------------------------

def test_off_records_nothing():
    _ops(np.random.default_rng(0))
    assert obs.counters_snapshot() == {} and obs.cache_snapshot() == {}
    assert obs.trace_snapshot() == []
    assert obs.op_start("gemm", (1, 2, 3), "ref") is None
    out = object()
    assert obs.op_end(None, out) is out


def test_counters_aggregate_without_trace():
    with obs.telemetry_scope("counters"):
        _ops(np.random.default_rng(0))
        _ops(np.random.default_rng(0))
    snap = obs.counters_snapshot()
    assert obs.trace_snapshot() == []
    assert {k for k, _, _ in snap} == {"gemm", "gemv", "stencil7", "spmv_bell", "attention",
                                       "reduce"}
    assert all(route == "ref" for _, _, route in snap)
    gemm = snap[("gemm", "32x32x32", "ref")]
    assert gemm["calls"] == 2 and gemm["flops"] == 2 * 2.0 * 32 ** 3
    assert gemm["bytes"] == 2 * 8.0 * 3 * 32 * 32
    plan = dispatch.get_plan(32)
    want = tme.predict_op_time("gemm", (32, 32, 32), r=plan.r, alpha=float(plan.alpha),
                               substrate="int8", route="ref") * 1e6
    assert gemm["tme_us"] == 2 * want
    assert 0 < gemm["us_min"] <= gemm["us_max"] and gemm["us"] >= gemm["us_max"]
    assert snap[("reduce", "512", "ref")]["calls"] == 4       # sum and dot, twice
    assert snap[("reduce", "64", "ref")]["calls"] == 2        # the norm's rows


def test_trace_fills_ring_with_plan_fields_and_probe():
    rng = np.random.default_rng(1)
    with obs.telemetry_scope("trace"):
        dispatch.matmul(_t(rng, 16, 24), _t(rng, 24, 40))
    (ev,) = obs.trace_snapshot()
    plan = dispatch.get_plan(24)
    assert (ev.kind, ev.shape_class, ev.route, ev.r, ev.payload_bits) == \
        ("gemm", "16x32x64", "ref", plan.r, 53)
    assert ev.us > 0 and ev.tme_us > 0 and ev.flops == 2.0 * 16 * 24 * 40
    out, pev = obs.probe(lambda: dispatch.matmul(_t(rng, 8, 8), _t(rng, 8, 2)))
    assert tuple(out.shape) == (8, 2) and pev.kind == "gemv" and pev.route == "ref"
    assert obs.probe(lambda: 3) == (3, None)
    assert obs.get_mode() == "off"


def test_labels_prefill_decode_and_reductions():
    rng = np.random.default_rng(2)
    with obs.telemetry_scope("trace"):
        dispatch.attention(_t(rng, 3, 5, 8), _t(rng, 3, 7, 8), _t(rng, 3, 7, 8))
        dispatch.attention(_t(rng, 3, 1, 8), _t(rng, 3, 7, 8), _t(rng, 3, 7, 8))
        compensated.neumaier_sum(_t(rng, 40))
        compensated.compensated_dot(_t(rng, 40), _t(rng, 40))
        compensated.compensated_norm(_t(rng, 40))
    evs = obs.trace_snapshot()
    assert [(e.kind, e.label) for e in evs] == [
        ("attention", "prefill"), ("attention", "decode"),
        ("reduce", "sum2"), ("reduce", "dot2"), ("reduce", "nrm2")]
    assert evs[0].shape_class == "4x8x8x8" and evs[1].shape_class == "4x1x8x8"
    assert all(e.route == "ref" and e.r == 0 for e in evs[2:])


def test_reset_clears_everything():
    with obs.telemetry_scope("trace"):
        _ops(np.random.default_rng(0))
    assert obs.counters_snapshot() and obs.trace_snapshot() and obs.cache_snapshot()
    obs.reset()
    assert obs.counters_snapshot() == {} and obs.trace_snapshot() == []
    assert obs.cache_snapshot() == {}


def test_plan_and_tune_cache_tallies():
    dispatch.clear_plan_cache()
    with obs.telemetry_scope("counters"):
        dispatch.get_plan(4093)
        dispatch.get_plan(4093)
        dispatch.get_plan(4093)
        dispatch.get_tuning("stencil7", (3, 5, 999))
        dispatch.get_tuning("stencil7", (3, 5, 999))
    caches = obs.cache_snapshot()
    assert caches["plan"] == (2, 1)
    assert caches["tune"][0] >= 1 and sum(caches["tune"]) == 2
    dispatch.get_plan(4093)                              # off: not counted
    assert obs.cache_snapshot()["plan"] == (2, 1)


# --- solvers and serving -----------------------------------------------------

def test_cg_residual_events_equal_history():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((24, 24))
    a = torch.from_numpy(m @ m.T + 24 * np.eye(24))
    b = _t(rng, 24)
    with obs.telemetry_scope("trace"):
        res = cg.cg_solve_dense(a, b, tol=1e-12, maxiter=50)
    evs = [e for e in obs.trace_snapshot() if e.kind == "solver.cg"]
    extra = [dict(e.extra) for e in evs]
    assert [x["iter"] for x in extra] == list(range(res.iters + 1))
    assert [x["rel_residual"] for x in extra] == res.history
    assert all(e.shape_class == "32" for e in evs)
    kinds = {e.kind for e in obs.trace_snapshot()}
    assert {"gemv", "reduce"} <= kinds


def test_jacobi_residual_events_equal_history():
    rng = np.random.default_rng(4)
    f = _t(rng, 6, 5, 4)
    with obs.telemetry_scope("trace"):
        res = jacobi.jacobi_solve(f, omega=2.0 / 3.0, tol=1e-30, maxiter=6, check_every=2)
    extra = [dict(e.extra) for e in obs.trace_snapshot() if e.kind == "solver.jacobi"]
    assert [x["iter"] for x in extra] == [0, 2, 4, 6]
    assert [x["rel_residual"] for x in extra] == res.history
    stencils = [e for e in obs.trace_snapshot() if e.kind == "stencil7"]
    assert len(stencils) == 7 and stencils[0].shape_class == "8x8x4"


def test_serve_engine_step_events():
    cfg = registry.get_config("yi-6b", smoke=True, policy_name="ozaki2_int8",
                              compute_dtype="float32")
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    batcher = ContinuousBatcher(ServeEngine(model, batch_slots=2, max_seq=8,
                                            dispatch_mode="ref"))
    rng = np.random.default_rng(5)
    for uid in range(3):
        batcher.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, 3),
                               max_new_tokens=2))
    with obs.telemetry_scope("trace"):
        done = batcher.run_to_completion()
    assert len(done) == 3
    evs = obs.trace_snapshot()
    prefill = [e for e in evs if e.kind == "serve.prefill"]
    decode = [e for e in evs if e.kind == "serve.decode"]
    queue = [dict(e.extra) for e in evs if e.kind == "serve.queue"]
    assert len(prefill) == 3 and all(dict(e.extra)["tokens"] == 3 for e in prefill)
    assert len(decode) == len(queue) and all(e.route == "ref" and e.us > 0 for e in decode)
    assert queue[0] == {"queued": 3, "active": 0}
    assert all(dict(e.extra)["batch"] == 2 for e in decode)
    labels = {e.label for e in evs if e.kind == "attention"}
    assert labels == {"decode"}
    assert {e.kind for e in evs} >= {"gemm", "attention"}


# --- the report -------------------------------------------------------------

def test_report_rows_and_render():
    with obs.telemetry_scope("counters"):
        _ops(np.random.default_rng(0))
        obs.record_event("solver.cg", dims=(8,), iter=0, rel_residual=1.0)
    rows = report.table_rows()
    assert [(r["kind"], r["route"]) for r in rows] == sorted((r["kind"], r["route"])
                                                             for r in rows)
    by_kind = {r["kind"]: r for r in rows}
    assert by_kind["attention"]["calls"] == 2 and by_kind["reduce"]["calls"] == 3
    assert by_kind["solver.cg"]["ratio"] == 0.0 and by_kind["solver.cg"]["tme_us"] == 0.0
    g = by_kind["gemm"]
    assert g["ratio"] == pytest.approx(g["mean_us"] / g["tme_us"])
    text = report.render(rows, chip="H100")
    assert text.splitlines()[0] == "measured vs TME-predicted (chip model: H100)"
    assert len(text.splitlines()) == 2 + len(rows)
    assert set(report.COLUMNS) <= set(rows[0])


def test_report_main_on_the_cpu_and_a_snapshot(tmp_path, capsys):
    assert report.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "chip model: H100" in out
    for kind in ("gemm", "gemv", "stencil7", "spmv_bell", "attention", "reduce"):
        assert kind in out
    path = obs.write_json(str(tmp_path / "telemetry.json"))
    snap = json.loads(open(path).read())
    assert snap["chip"] == "H100" and snap["mode"] == "off" and len(snap["trace"]) == 6
    assert report.main([path, "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert {r["route"] for r in rows} == {"ref"} and len(rows) == 6


def test_report_sweep_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        report.main([])


# --- compile and capture guards, lazy CUDA resolution ------------------------

def test_compile_guard(monkeypatch):
    rng = np.random.default_rng(6)
    a, b = _t(rng, 8, 8), _t(rng, 8, 8)
    want = dispatch.matmul(a, b)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with obs.telemetry_scope("trace"):
        assert obs.op_start("gemm", (8, 8, 8), "ref", None, a) is None
        got = dispatch.matmul(a, b)
        obs.record_event("solver.cg", iter=0)
    assert torch.equal(got, want)
    assert obs.counters_snapshot() == {} and obs.trace_snapshot() == []


def test_capture_guard(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    rng = np.random.default_rng(7)
    with obs.telemetry_scope("counters"):
        compensated.compensated_norm(_t(rng, 64))
        obs.record_event("serve.queue", queued=0, active=0)
    assert obs.counters_snapshot() == {}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with obs.telemetry_scope("counters"):
        compensated.compensated_norm(_t(rng, 64))
    assert obs.counters_snapshot()[("reduce", "64", "ref")]["calls"] == 1


class _Event:
    """Stands in for a CUDA event pair's end: its elapsed time is fixed."""

    def __init__(self, ms, log):
        self.ms, self.log = ms, log

    def synchronize(self):
        self.log.append(self.ms)

    def elapsed_time(self, end):
        return end.ms


def _ev(kind, us=0.0):
    return obs.OpEvent(kind, "", "kernel", 0, 0, us, 0.0, 0.0, 0.0)


def test_pending_pairs_resolve_lazily_and_in_order(monkeypatch):
    monkeypatch.setattr(obs, "PENDING_CAP", 8)
    waited = []
    with obs.telemetry_scope("trace"):
        obs._submit(_ev("a"), _Event(0, waited), _Event(0.5, waited))
        obs._submit(_ev("b", us=7.0))               # complete, queued behind "a"
        assert waited == [] and len(obs._pending) == 2
        for i in range(6):
            obs._submit(_ev(f"c{i}"), _Event(0, waited), _Event(0.001 * (i + 1), waited))
        # the eighth entry reached the cap: the oldest half (4) was waited for
        assert waited == [0.5, 0.001, 0.002] and len(obs._pending) == 4
        trace = obs.trace_snapshot()                # resolves the rest
    assert [e.kind for e in trace] == ["a", "b"] + [f"c{i}" for i in range(6)]
    assert [e.us for e in trace[:3]] == [500.0, 7.0, 1.0]
    assert len(obs._pending) == 0 and obs.counters_snapshot()[("a", "", "kernel")]["calls"] == 1


# --- against repro.obs -------------------------------------------------------

def _jops(rng):
    """The same op sequence as ``_ops`` through repro (its CPU route, xla)."""
    def t(*shape):
        return jnp.asarray(rng.standard_normal(shape))

    a, b = t(32, 32), t(32, 32)
    jdispatch.matmul(a, b)
    jdispatch.matmul(a, t(32, 4))
    c = jnp.asarray([6.0, -1, -1, -1, -1, -1, -1])
    jdispatch.stencil7(t(8, 8, 8), c)
    plan = jozaki2.make_plan(4, payload_bits=24, margin_bits=4)
    col = jnp.asarray(rng.integers(0, 32, (32, 4)).astype(np.int32))
    jdispatch.spmv(t(32, 4), col, t(32), plan=plan)
    jdispatch.attention(t(16, 8), t(16, 8), t(16, 8))
    jdispatch.attention(t(2, 1, 8), t(2, 16, 8), t(2, 16, 8))
    jcomp.neumaier_sum(t(300))
    jcomp.compensated_dot(t(300), t(300))
    jcomp.compensated_norm(t(6, 50), axis=1)


def test_counters_equal_reference_for_one_op_sequence(monkeypatch):
    monkeypatch.setenv(jtme.CHIP_VAR, "H100")
    monkeypatch.delenv(jobs.ENV_VAR, raising=False)
    jobs.reset()
    try:
        with jobs.telemetry_scope("counters"):
            _jops(np.random.default_rng(8))
        want = jobs.counters_snapshot()
    finally:
        jobs.reset()
    with obs.telemetry_scope("counters"):
        _ops(np.random.default_rng(8))
    got = obs.counters_snapshot()
    route = {"xla": "ref", "pallas": "kernel"}
    assert set(got) == {(k, cls, route[r]) for k, cls, r in want}
    for (k, cls, r), agg in want.items():
        mine = got[(k, cls, route[r])]
        for field in ("calls", "flops", "bytes", "tme_us"):
            assert mine[field] == agg[field], (k, cls, field)
