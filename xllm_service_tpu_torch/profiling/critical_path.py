"""Request critical-path attribution over span trees (copy of
``xllm_service_tpu/profiling/critical_path.py``).

:func:`critical_path` splits the window from a request's arrival at its
owning frontend to its first streamed token into exclusive stage waits
(admission, schedule, handoff, dispatch wait, prefill, failover, first
delta) that sum to the window by construction: an event sweep charges
every millisecond to exactly one stage. :func:`aggregate_critical_paths`
rolls per-request splits into a stage table.

The functions are pure over span dicts (``Span.to_dict`` and
``merge_fleet_spans`` output), so one engine's trace, a fleet-merged trace
and an aggregate take the same code. An engine's own trace has no
``frontend.request`` root, so its split is None; the master's fleet view
decomposes the merged tree.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

#: Exclusive TTFT stages, in causal order. Every sweep segment lands in
#: exactly one of these, so ``sum(stages_ms.values()) == ttft window``.
CRITICAL_STAGES = (
    "admission_wait",   # arrival -> first scheduler span starts
    "schedule",         # scheduler.schedule/template/tokenize/route/bind
    "handoff",          # relay hop: non-owner frontend.request forwarding
    "dispatch_wait",    # scheduled but no engine span covering yet
    "prefill",          # engine.prefill
    "failover",         # scheduler.failover re-routing
    "first_delta",      # prefill done -> first token observed at owner
)

#: Span points that claim sweep coverage, mapped to their stage.
#: frontend.request spans are NOT intervals — the owner-side one covers
#: the whole window and would swallow every gap; the relay hop is
#: instead charged as the gap from the root's start to the owner span's
#: start (see the sweep's gap rules).
_STAGE_OF = {
    "scheduler.schedule": "schedule",
    "scheduler.template": "schedule",
    "scheduler.tokenize": "schedule",
    "scheduler.route": "schedule",
    "scheduler.bind": "schedule",
    "scheduler.failover": "failover",
    "engine.prefill": "prefill",
}

#: Priority when intervals overlap: the most specific (latest-starting
#: wins first; ties break by this stage precedence, most specific last).
_STAGE_RANK = {stage: i for i, stage in enumerate(CRITICAL_STAGES)}


def _num(v: Any) -> Optional[float]:
    try:
        if v is None:
            return None
        return float(v)
    except (TypeError, ValueError):
        return None


def critical_path(spans: Iterable[dict]) -> Optional[dict]:
    """Decompose one trace's TTFT window into exclusive stage waits.

    Returns ``None`` when the trace has no root ``frontend.request``
    span or no TTFT observation (request never produced a first token).
    """
    spans = [s for s in spans if isinstance(s, dict)]
    if not spans:
        return None
    ids = {s.get("span_id") for s in spans if s.get("span_id")}
    fronts = [s for s in spans if s.get("point") == "frontend.request"]
    roots = [s for s in fronts
             if s.get("parent_span_id") not in ids and
             _num(s.get("start_ms")) is not None]
    if not roots:
        return None
    root = min(roots, key=lambda s: _num(s.get("start_ms")))

    # TTFT is observed on the owner-side frontend span (on a relayed
    # request that is a child hop, not the root).
    ttft_spans = [s for s in fronts
                  if _num((s.get("attrs") or {}).get("ttft_ms")) is not None
                  and _num(s.get("start_ms")) is not None]
    if not ttft_spans:
        return None
    ttft_src = min(ttft_spans, key=lambda s: _num(s.get("start_ms")))
    t0 = _num(root.get("start_ms"))
    t1 = _num(ttft_src.get("start_ms")) + \
        _num((ttft_src.get("attrs") or {}).get("ttft_ms"))
    if t1 <= t0:
        return None
    # A relayed request's TTFT is observed by the owner-side frontend
    # span, a child hop of the accepting frontend's relay root; the
    # forwarding leg is the window from the root's start to that span's.
    relayed = ttft_src is not root
    owner_start = _num(ttft_src.get("start_ms"))

    # Build clipped (start, end, stage) intervals from covering spans.
    intervals: list[tuple[float, float, str]] = []
    for s in spans:
        stage = _STAGE_OF.get(s.get("point"))
        if stage is None:
            continue
        a = _num(s.get("start_ms"))
        b = _num(s.get("end_ms"))
        if a is None:
            continue
        if b is None:
            b = t1   # still-open span covers to the end of the window
        a, b = max(a, t0), min(b, t1)
        if b > a:
            intervals.append((a, b, stage))

    # Event sweep: charge each segment to the latest-starting covering
    # interval (the most nested span wins), gaps to the causal filler.
    # owner_start is a gap-rule boundary (not an interval edge), so it
    # must split sweep segments too.
    points = sorted({t0, t1, *((owner_start,) if relayed else ()),
                     *[a for a, _, _ in intervals],
                     *[b for _, b, _ in intervals]})
    first_sched = min((a for a, _, st in intervals
                       if st in ("schedule", "failover")), default=None)
    first_prefill = min((a for a, _, st in intervals if st == "prefill"),
                        default=None)
    stages_ms = {stage: 0.0 for stage in CRITICAL_STAGES}
    segments: list[dict] = []
    for a, b in zip(points, points[1:]):
        if b <= t0 or a >= t1:
            continue
        covering = [(ia, _STAGE_RANK[st], st) for ia, ib, st in intervals
                    if ia <= a and ib >= b]
        if covering:
            stage = max(covering)[2]
        elif relayed and a < owner_start:
            stage = "handoff"
        elif first_sched is not None and a < first_sched:
            stage = "admission_wait"
        elif first_prefill is None or a < first_prefill:
            stage = "dispatch_wait"
        else:
            stage = "first_delta"
        stages_ms[stage] += b - a
        if segments and segments[-1]["stage"] == stage:
            segments[-1]["end_ms"] = b
        elif len(segments) < 64:
            segments.append({"stage": stage, "start_ms": a, "end_ms": b})

    ttft_ms = t1 - t0
    # Failover attempts live on the owner-side span (the scheduler sets
    # them there); on a relayed request the root is the relay hop.
    attrs = {**(root.get("attrs") or {}), **{
        k: v for k, v in (ttft_src.get("attrs") or {}).items()
        if v is not None}}
    return {
        "trace_id": root.get("trace_id"),
        "request_id": root.get("request_id"),
        "window_start_ms": t0,
        "ttft_ms": round(ttft_ms, 3),
        "relayed": relayed,
        "failover_attempts": int(_num(attrs.get("failover_attempts")) or 0),
        "stages_ms": {k: round(v, 3) for k, v in stages_ms.items()},
        "stage_share": {
            k: round(v / ttft_ms, 4) if ttft_ms else 0.0
            for k, v in stages_ms.items()},
        "segments": [
            {"stage": s["stage"],
             "start_ms": round(s["start_ms"] - t0, 3),
             "duration_ms": round(s["end_ms"] - s["start_ms"], 3)}
            for s in segments],
    }


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def aggregate_critical_paths(paths: Iterable[Optional[dict]]) -> dict:
    """Fleet stage table for ``/admin/hotpath``: per-stage mean/p50/p90
    milliseconds and mean TTFT share over recent decomposed requests."""
    rows = [p for p in paths if p]
    out: dict[str, Any] = {"requests": len(rows), "stages": {}}
    if not rows:
        return out
    ttfts = sorted(p["ttft_ms"] for p in rows)
    out["ttft_ms"] = {
        "mean": round(sum(ttfts) / len(ttfts), 3),
        "p50": round(_quantile(ttfts, 0.50), 3),
        "p90": round(_quantile(ttfts, 0.90), 3),
    }
    for stage in CRITICAL_STAGES:
        vals = sorted(p["stages_ms"].get(stage, 0.0) for p in rows)
        shares = [p["stage_share"].get(stage, 0.0) for p in rows]
        out["stages"][stage] = {
            "mean_ms": round(sum(vals) / len(vals), 3),
            "p50_ms": round(_quantile(vals, 0.50), 3),
            "p90_ms": round(_quantile(vals, 0.90), 3),
            "mean_share": round(sum(shares) / len(shares), 4),
        }
    return out
