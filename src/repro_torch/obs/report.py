"""Measured-vs-TME report (``repro.obs.report``): the paper's instrument pointed
at the port's own seam.

Aggregates the telemetry counters (live, or a ``telemetry.write_json``
snapshot) into one row per (kind, route): calls, mean measured μs, mean
TME-predicted μs (``tme.DEFAULT_CHIP``, the H100), and the model-error ratio
measured/TME.

CLI::

    python -m repro_torch.obs.report                  # built-in sweep on the card
    python -m repro_torch.obs.report --device cpu     # the same sweep on the CPU
    python -m repro_torch.obs.report telemetry.json   # report a saved snapshot

The sweep runs on the card unless ``--device cpu`` is given, and raises when
the device is missing: a time taken on the CPU is never reported as the card's.
On the card it drives every kind on both routes; on the CPU only the
reference route exists.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs import telemetry

COLUMNS = ("kind", "route", "calls", "mean_us", "tme_us", "ratio")


def _counter_list(snap: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
    if snap is None:
        snap = telemetry.snapshot()
    return snap.get("counters", [])


def table_rows(snap: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
    """One row per (kind, route), aggregated over shape classes.

    ``ratio`` is total-measured / total-TME-predicted μs (0.0 when the kind
    has no prediction — solver/serving events).  Rows sort by kind, route.
    """
    agg: Dict[tuple, Dict[str, float]] = {}
    for c in _counter_list(snap):
        key = (c["kind"], c["route"])
        a = agg.setdefault(key, {"calls": 0, "us": 0.0, "tme_us": 0.0})
        a["calls"] += int(c["calls"])
        a["us"] += float(c["us"])
        a["tme_us"] += float(c["tme_us"])
    rows = []
    for (kind, route), a in sorted(agg.items()):
        calls = max(a["calls"], 1)
        rows.append({
            "kind": kind, "route": route, "calls": a["calls"],
            "mean_us": a["us"] / calls,
            "tme_us": a["tme_us"] / calls,
            "ratio": a["us"] / a["tme_us"] if a["tme_us"] > 0 else 0.0,
        })
    return rows


def render(rows: List[Dict[str, Any]], chip: str = "") -> str:
    """Fixed-width text table of ``table_rows`` output."""
    head = f"measured vs TME-predicted (chip model: {chip})" if chip else \
        "measured vs TME-predicted"
    lines = [head,
             f"{'kind':<14} {'route':<8} {'calls':>6} {'mean_us':>12} "
             f"{'tme_us':>12} {'ratio':>10}"]
    for r in rows:
        ratio = f"{r['ratio']:.1f}x" if r["ratio"] else "-"
        tme_us = f"{r['tme_us']:.3f}" if r["tme_us"] else "-"
        lines.append(f"{r['kind']:<14} {r['route'] or '-':<8} "
                     f"{r['calls']:>6d} {r['mean_us']:>12.2f} "
                     f"{tme_us:>12} {ratio:>10}")
    return "\n".join(lines)


def _builtin_sweep(device: torch.device) -> None:
    """Small workload touching every dispatch kind and the reductions, at the
    reference package's sweep sizes, on every route ``device`` has."""
    import numpy as np

    from repro_torch.core import compensated, dispatch, ozaki2

    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=device)

    a, b = t(64, 64), t(64, 64)
    v = t(64, 4)
    u = t(8, 8, 8)
    c = torch.tensor([6.0, -1, -1, -1, -1, -1, -1], dtype=torch.float64, device=device)
    plan_r7 = ozaki2.make_plan(4, payload_bits=24, margin_bits=4)
    val = t(32, 4)
    col = torch.as_tensor(rng.integers(0, 32, (32, 4)).astype(np.int32), device=device)
    x = t(32)
    q, kq, vq = t(16, 8), t(16, 8), t(16, 8)
    causal = torch.tril(torch.ones((16, 16), dtype=torch.int8, device=device))
    routes = ("ref", "kernel") if device.type == "cuda" else ("ref",)
    for mode in routes:
        dispatch.matmul(a, b, mode=mode)
        dispatch.matmul(a, v, mode=mode)
        dispatch.stencil7(u, c, mode=mode)
        dispatch.spmv(val, col, x, plan=plan_r7, mode=mode)
        dispatch.attention(q, kq, vq, mask=causal, mode=mode)
        compensated.compensated_dot(t(4096), t(4096), mode=mode)


def sweep(device: str = "cuda") -> Dict[str, Any]:
    """Run the built-in sweep under trace telemetry on ``device`` and return
    its snapshot.  Raises when ``device`` is ``cuda`` and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the sweep runs on the card and no CUDA device is available "
                           "(pass --device cpu for the CPU)")
    telemetry.reset()
    with telemetry.telemetry_scope("trace"):
        _builtin_sweep(dev)
    return telemetry.snapshot()


def main(argv=None) -> int:
    """CLI entry: report a saved snapshot, or sweep-and-report (see module)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("snapshot", nargs="?", default=None,
                        help="telemetry snapshot JSON (from telemetry.write_json); "
                             "omitted = run a small built-in sweep and report it")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the built-in sweep runs (default: the card)")
    parser.add_argument("--json", action="store_true",
                        help="emit the table as JSON rows instead of text")
    args = parser.parse_args(argv)

    if args.snapshot is not None:
        with open(args.snapshot) as fh:
            snap = json.load(fh)
    else:
        snap = sweep(args.device)

    rows = table_rows(snap)
    if args.json:
        json.dump(rows, sys.stdout, indent=2)
        print()
    else:
        print(render(rows, chip=snap.get("chip", "")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
