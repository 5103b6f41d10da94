"""The port's engine-side tracing (``common/tracing.py``,
``profiling/critical_path.py``) against the reference's, with span ids,
trace ids and clocks injected into both: ``TraceContext`` dicts and
headers, ``is_sampled`` at every rate, ``SpanStore`` capacity and its
pending/promote buffer under tail sampling, and the ``/admin/trace``
(with ``critical_path``) and ``/admin/trace/recent`` payloads for the same
recorded spans; ``span_tree``, ``merge_fleet_spans`` and
``aggregate_critical_paths`` on the same dicts."""

import importlib
import itertools
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from xllm_service_tpu.common import tracing as ref
from xllm_service_tpu_torch.common import tracing as port

# The modules (each package re-exports its function under the same name).
ref_cp = importlib.import_module("xllm_service_tpu.profiling.critical_path")
port_cp = importlib.import_module(
    "xllm_service_tpu_torch.profiling.critical_path")

MODS = (port, ref)


@pytest.fixture
def injected(monkeypatch):
    """Deterministic ids and clock for both modules: the n-th span of each
    gets the same ids and times. ``now[0]`` moves the clock."""
    now = [1_000_000.0]
    for mod in MODS:
        spans = itertools.count()
        traces = itertools.count()
        monkeypatch.setattr(mod, "_new_span_id",
                            lambda c=spans: f"{next(c):016x}")
        monkeypatch.setattr(mod, "_new_trace_id",
                            lambda c=traces: f"{next(c):032x}")
        monkeypatch.setattr(mod, "_now_ms", lambda: now[0])
    return now


@pytest.mark.parametrize("d", [
    {"trace_id": "t" * 32, "span_id": "s" * 16}, {"trace_id": "t"},
    {"trace_id": "", "span_id": "x"}, None, "x", [1], {"trace_id": 5,
                                                       "span_id": 6}])
def test_trace_context_dicts_and_headers(d):
    got, want = port.TraceContext.from_dict(d), ref.TraceContext.from_dict(d)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_dict() == want.to_dict()
        assert got.to_headers() == want.to_headers()
        back = port.TraceContext.from_headers(want.to_headers())
        assert back == got
    for headers in ({port.TRACE_ID_HEADER: "a", port.PARENT_SPAN_HEADER: "b"},
                    {port.TRACE_ID_HEADER: "a"}, None, 3):
        g = port.TraceContext.from_headers(headers)
        w = ref.TraceContext.from_headers(headers)
        assert (g and g.to_dict()) == (w and w.to_dict())
    assert (port.TRACE_ID_HEADER, port.PARENT_SPAN_HEADER) == \
        (ref.TRACE_ID_HEADER, ref.PARENT_SPAN_HEADER)


@settings(max_examples=300, deadline=None)
@given(st.text(max_size=40), st.floats(-0.5, 1.5))
def test_is_sampled_is_the_references(trace_id, rate):
    got, want = port.Tracer(), ref.Tracer()
    got.configure(sample_rate=rate)
    want.configure(sample_rate=rate)
    assert got.sample_rate == want.sample_rate
    assert got.is_sampled(trace_id) == want.is_sampled(trace_id)


def _record(tracer_mod, tracer, script):
    """Record a script of spans: (point, parent index or None, request id,
    start, end, attrs); returns the span objects."""
    out = []
    for point, parent, rid, start, end, attrs in script:
        ctx = out[parent].context() if parent is not None else None
        tracer_mod._now_ms = lambda t=start: t
        sp = tracer.start_span(point, ctx=ctx, request_id=rid,
                               instance="e:1", **attrs)
        sp.event("tick", n=1)
        out.append(sp)
    for sp, (_, _, _, _, end, _) in zip(out, script):
        if end is not None:
            tracer_mod._now_ms = lambda t=end: t
            sp.end("OK" if end % 2 else None)
    return out


SCRIPT = [
    ("frontend.request", None, "r1", 0.0, 90.0, {"ttft_ms": 40.0}),
    ("scheduler.schedule", 0, "r1", 1.0, 5.0, {}),
    ("engine.prefill", 0, "r1", 8.0, 30.0, {"prompt_tokens": 70}),
    ("engine.decode", 0, "r1", 30.0, 85.0, {}),
    ("kv_transfer.offer", 2, "r1", 20.0, 29.0, {"path": "stream"}),
    ("frontend.request", None, "r2", 100.0, 130.0, {}),
    ("engine.prefill", 5, "r2", 101.0, None, {}),
]


@pytest.mark.parametrize("capacity", [2048, 5, 3])
def test_query_payloads_are_the_references(injected, capacity):
    tracers = {mod: mod.Tracer(capacity) for mod in MODS}
    for mod, tr in tracers.items():
        _record(mod, tr, SCRIPT)
        mod._now_ms = lambda: 500.0
    for rid in ("r1", "r2", "nope"):
        got = tracers[port].query_trace(request_id=rid)
        want = tracers[ref].query_trace(request_id=rid)
        assert got == want
    tid = tracers[ref].store.trace_id_for_request("r1")
    assert tracers[port].query_trace(trace_id=tid) == \
        tracers[ref].query_trace(trace_id=tid)
    assert tracers[port].query_trace() == tracers[ref].query_trace()
    if capacity == 2048:
        status, payload = tracers[port].query_trace(request_id="r1")
        assert status == 200 and payload["critical_path"]["ttft_ms"] == 40.0
        assert [s["point"] for s in payload["tree"][0]["children"]] == [
            "scheduler.schedule", "engine.prefill", "engine.decode"]
    for limit, sort in ((20, "recent"), (1, "slowest"), (0, "x")):
        assert tracers[port].query_recent(limit, sort) == \
            tracers[ref].query_recent(limit, sort)


def test_tail_sampling_pending_and_promote(injected):
    """At sample rate 0 spans park pending (queryable by trace); a kept
    trace moves into the ring and records its later spans directly; a
    dropped one is gone; the pending buffer is bounded by whole traces."""
    tracers = {mod: mod.Tracer(64) for mod in MODS}
    views = {}
    for mod, tr in tracers.items():
        tr.configure(sample_rate=0.0)
        spans = _record(mod, tr, SCRIPT)
        t1, t2 = spans[0].trace_id, spans[5].trace_id
        before = (tr.query_trace(trace_id=t1), tr.query_recent())
        tr.keep_trace(t1)
        late = tr.start_span("engine.decode", ctx=spans[0].context(),
                             request_id="r1")
        late.end()
        tr.drop_trace(t2)
        after = (tr.query_trace(trace_id=t1), tr.query_trace(trace_id=t2),
                 tr.query_recent())
        # A bounded buffer: 40 more sampled-out traces of one span each.
        for i in range(40):
            tr.start_span("engine.prefill", request_id=f"x{i}").end()
        views[mod] = (before, after, tr.query_trace(request_id="x0"),
                      tr.query_trace(request_id="x39"),
                      len(tr.store._pending))
    assert views[port] == views[ref]
    before, after, x0, x39, n_pending = views[port]
    assert before[0][0] == 200 and before[1]["traces"] == []
    assert after[0][1]["num_spans"] == 6 and after[1][0] == 404
    assert x0[0] == 404 and x39[0] == 200 and n_pending == 16


def test_disabled_and_context_free_spans_are_noops(injected):
    for mod in MODS:
        tr = mod.Tracer()
        assert tr.start_span("engine.prefill", require_ctx=True) is \
            mod.NOOP_SPAN
        tr.configure(enabled=False)
        assert not tr.start_span("engine.prefill")
    sp = port.TRACER.start_span("engine.decode", require_ctx=True)
    assert sp is port.NOOP_SPAN and sp.context() is None
    assert sp.set(a=1) is sp and sp.duration_ms() == 0.0


def test_active_stack_is_per_thread(injected):
    """A span entered on one thread is that thread's active span only:
    events and faults land on it, never on another thread's."""
    tr = port.Tracer()
    seen = {}

    def other():
        seen["other"] = port.current_span()
        port.add_event("lost")   # no active span on this thread: a no-op

    with tr.span("kv_transfer.pull", request_id="r") as sp:
        t = threading.Thread(target=other)
        t.start()
        t.join()
        port.add_event("fault", point="kv_transfer.pull")
        assert port.current_span() is sp
        assert port.current_context() == sp.context()
    assert seen["other"] is None and port.current_span() is None
    assert [e["name"] for e in sp.events] == ["fault"]
    with pytest.raises(ValueError):
        with tr.span("kv_transfer.pull", request_id="r2") as sp2:
            raise ValueError("boom")
    assert sp2.status.startswith("ERROR: ValueError")


SPAN_DICTS = st.lists(st.fixed_dictionaries({
    "point": st.sampled_from(["frontend.request", "scheduler.schedule",
                              "scheduler.route", "engine.prefill",
                              "engine.decode", "scheduler.failover"]),
    "span_id": st.sampled_from([f"s{i}" for i in range(8)]),
    "parent_span_id": st.sampled_from([""] + [f"s{i}" for i in range(8)]),
    "trace_id": st.just("t"),
    "request_id": st.sampled_from(["", "r"]),
    "start_ms": st.floats(0, 100),
    "end_ms": st.one_of(st.none(), st.floats(0, 200)),
    "attrs": st.one_of(st.just({}), st.fixed_dictionaries(
        {"ttft_ms": st.floats(0, 100)}), st.fixed_dictionaries(
        {"failover_attempts": st.integers(0, 3)})),
}), max_size=8)


@settings(max_examples=300, deadline=None)
@given(SPAN_DICTS, SPAN_DICTS)
def test_span_dict_functions_are_the_references(a, b):
    assert port.span_tree(a) == ref.span_tree(a)
    assert port.merge_fleet_spans([a, b]) == ref.merge_fleet_spans([a, b])
    assert port_cp.critical_path(a) == ref_cp.critical_path(a)
    paths = [ref_cp.critical_path(x) for x in (a, b)]
    assert port_cp.aggregate_critical_paths(paths) == \
        ref_cp.aggregate_critical_paths(paths)
    assert port_cp.CRITICAL_STAGES == ref_cp.CRITICAL_STAGES


@pytest.mark.parametrize("query,status", [
    ({}, 404), ({"request_id": "nope"}, 404), ({"limit": "x"}, 400),
    ({"limit": "3", "sort": "slowest"}, 200)])
def test_admin_routes_answer_as_the_references(injected, query, status):
    tr = port.Tracer()
    _record(port, tr, SCRIPT)
    if "limit" in query:
        got = port.admin_trace_recent(query, tr)
    else:
        got = port.admin_trace(query, tr)
    assert got[0] == status
