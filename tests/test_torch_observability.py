"""The port's observability pieces against the reference's on the same
operations: ``Counter``, ``Gauge`` and ``Histogram`` (labeled and plain)
render byte for byte the same after hypothesis operation scripts, and
after ``evict_series``; the registry's exposition; a seeded
``FaultPlane`` fires on the same calls; ``FlightRecorder`` bundles match
(spans, providers, a failing provider; the reference's bundle also
carries the master's hot-path percentiles, which an engine process does
not record, and the capture time); ``parse_folded`` and
``summarize_stacks`` agree on the same folded text; the sampling profiler
charges the port's threads to its roles."""

import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from xllm_service_tpu.common import faults as ref_faults
from xllm_service_tpu.common import flightrecorder as ref_fr
from xllm_service_tpu.common import metrics as ref_metrics
from xllm_service_tpu.common import tracing as ref_tracing
from xllm_service_tpu.profiling import sampler as ref_sampler
from xllm_service_tpu_torch.common import faults, flightrecorder, metrics
from xllm_service_tpu_torch.common import tracing
from xllm_service_tpu_torch.profiling import sampler

LABEL = st.sampled_from(["a", "b", 'q"x', "back\\slash", "new\nline", "7"])
VALUE = st.floats(-1e6, 1e6, allow_nan=False)
OPS = st.lists(st.tuples(
    st.sampled_from(["inc", "set", "observe", "evict"]), LABEL, LABEL,
    VALUE), max_size=30)


def _apply(mod, ops):
    c = mod.Counter("c_total", "a counter", labelnames=("peer", "x"))
    g = mod.Gauge("g", "a gauge", labelnames=("master",))
    plain = mod.Gauge("plain", "")
    h = mod.Histogram("h_ms", "a histogram", buckets=(1, 10, 100),
                      labelnames=("i",))
    for op, l1, l2, v in ops:
        if op == "inc":
            c.labels(peer=l1, x=l2).inc(abs(v))
            plain.inc(v)
        elif op == "set":
            g.labels(master=l1).set(v)
            plain.set(v)
        elif op == "observe":
            h.labels(i=l1).observe(v)
        else:
            mod.evict_series(c, peer=l1, x=l2)
            mod.evict_series(g, master=l1)
            mod.evict_series(h, i=l1)
    return (c.render(), g.render(), plain.render(), h.render(), c.value(),
            g.value(), h.count(), h.mean())


@settings(max_examples=200, deadline=None)
@given(OPS)
def test_instruments_render_as_the_references(ops):
    assert _apply(metrics, ops) == _apply(ref_metrics, ops)


def test_registry_and_label_errors_match():
    for mod in (metrics, ref_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("x_total", "help").inc(3)
        reg.gauge("y", "", labelnames=("a",)).labels(a="1").set(2)
        reg.histogram("z_ms", "z", buckets=(5,)).observe(7)
        assert reg.counter("x_total") is reg.counter("x_total")
        with pytest.raises(TypeError):
            reg.gauge("x_total")
        with pytest.raises(TypeError):
            reg.counter("x_total", labelnames=("b",))
        with pytest.raises(ValueError):
            reg.gauge("y", labelnames=("a",)).set(1)
        with pytest.raises(ValueError):
            reg.gauge("y", labelnames=("a",)).labels(b="1")
    texts = []
    for mod in (metrics, ref_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("x_total", "help").inc(3)
        reg.gauge("y", "", labelnames=("a",)).labels(a="1").set(2)
        reg.histogram("z_ms", "z", buckets=(5,)).observe(7)
        texts.append(reg.render_prometheus())
    assert texts[0] == texts[1]


def test_agent_families_are_the_references():
    for name in ("ENGINE_PEER_LINKED", "ENGINE_HEARTBEATS_TOTAL"):
        got, want = getattr(metrics, name), getattr(ref_metrics, name)
        assert (got.name, got.kind, got.labelnames, got.help) == \
            (want.name, want.kind, want.labelnames, want.help)


RULES = [
    dict(point="kv_transfer.*", action="error", probability=0.5),
    dict(point="kv_transfer.pull", action="drop", after=2, max_fires=3,
         match={"uuid": "7"}),
    dict(point="kv_transfer.offer", action="delay", delay_s=0.0,
         probability=0.3, match={"sid": "b"}),
    dict(point="kv_transfer.offer", action="silence"),
]
CALLS = st.lists(st.tuples(
    st.sampled_from(["kv_transfer.offer", "kv_transfer.pull", "rpc.post"]),
    st.sampled_from([{}, {"uuid": 7}, {"uuid": "8"}, {"sid": "b"},
                     {"sid": "a"}])), max_size=40)


@settings(max_examples=100, deadline=None)
@given(st.integers(0, 2**32), st.lists(st.sampled_from(range(len(RULES))),
                                       min_size=1, max_size=4), CALLS)
def test_seeded_fault_plane_fires_on_the_same_calls(seed, which, calls):
    outcomes = []
    for mod in (faults, ref_faults):
        plane = mod.FaultPlane(seed=seed)
        plane.configure([dict(RULES[i]) for i in which])
        fired = []
        for point, ctx in calls:
            rule = plane.fire(point, **ctx)
            fired.append(None if rule is None else (rule.point, rule.action))
        outcomes.append((fired, [r.to_dict() for r in plane.rules()]))
    assert outcomes[0] == outcomes[1]


def test_fault_plane_check_and_seed_from_the_environment(monkeypatch):
    monkeypatch.setenv("XLLM_CHAOS_SEED", "41")
    assert faults.FaultPlane().seed == ref_faults.FaultPlane().seed == 41
    plane = faults.FaultPlane()
    plane.add("kv_transfer.pull", action="error", max_fires=1)
    tracer = tracing.Tracer()
    with tracer.span("kv_transfer.pull") as sp:
        with pytest.raises(faults.FaultInjected) as e:
            plane.check("kv_transfer.pull", uuid=1)
    plane.check("kv_transfer.pull", uuid=1)   # max_fires spent
    assert e.value.point == "kv_transfer.pull"
    assert [(ev["name"], ev["point"], ev["action"]) for ev in sp.events] \
        == [("fault", "kv_transfer.pull", "error")]
    with pytest.raises(ValueError):
        faults.FaultRule(point="x", action="explode")
    plane.clear()
    assert plane.rules() == [] and set(faults.FAULT_POINTS) <= \
        set(ref_faults.FAULT_POINTS)


@pytest.fixture
def tracers(monkeypatch):
    """Fresh tracers holding the same spans behind each module's TRACER,
    with ids and clocks injected."""
    out = {}
    for mod in (tracing, ref_tracing):
        tr = mod.Tracer()
        monkeypatch.setattr(mod, "TRACER", tr)
        ids = iter(range(100))
        monkeypatch.setattr(mod, "_new_span_id",
                            lambda it=ids: f"{next(it):016x}")
        monkeypatch.setattr(mod, "_now_ms", lambda: 5.0)
        ctx = mod.TraceContext("t" * 32, "root")
        mod.TRACER.start_span("engine.prefill", ctx=ctx, request_id="r",
                              instance="e:1").end()
        with mod.TRACER.span("kv_transfer.offer", ctx=ctx, request_id="r",
                             path="stream"):
            pass
        out[mod] = tr
    return out


def _bundles(recorders):
    out = []
    for rec in recorders:
        b = rec.record("kv_stream_fallback", request_id="r",
                       detail={"peer": "p:1", "bytes": 9})
        rec.record("error", trace_id="t" * 32)
        rec.record("kv_stream_fallback", request_id="unknown")
        recent = rec.recent(limit=2, kind="kv_stream_fallback")
        rows = [dict(r) for r in [b] + recent + rec.recent(limit=0)
                + rec.recent(limit=10)]
        for r in rows:
            r.pop("ts_ms")
            r.pop("hotpath", None)
        out.append(rows)
    return out


def test_flight_recorder_bundles_match(tracers):
    recs = [flightrecorder.FlightRecorder(capacity=4),
            ref_fr.FlightRecorder(capacity=4)]
    for rec in recs:
        rec.add_context_provider("engine", lambda: {"instance": "e:1",
                                                    "stats": {"running": 2}})
        rec.add_context_provider("broken", lambda: 1 / 0)
    got, want = _bundles(recs)
    assert got == want
    assert got[0]["num_spans"] == 2 and got[0]["engine"]["instance"] == "e:1"
    assert got[0]["broken"] == {"error": "division by zero"}
    for rec in recs:
        rec.remove_context_provider("engine", lambda: None)   # not its fn
        rec.remove_context_provider("broken")
        rec.configure(capacity=1)
    got, want = _bundles(recs)
    assert got == want and "engine" in got[0] and "broken" not in got[0]
    assert flightrecorder.KINDS == ref_fr.KINDS


def test_flight_recorder_appends_jsonl(tmp_path, tracers):
    rec = flightrecorder.FlightRecorder()
    rec.configure(directory=str(tmp_path))
    rec.record("kv_stream_fallback", request_id="r", detail={"b": b"\x00"})
    rec.close()
    lines = (tmp_path / "flightrecorder.jsonl").read_text().splitlines()
    assert len(lines) == 1 and '"kv_stream_fallback"' in lines[0]
    status, payload = flightrecorder.admin_flightrecorder_recent(
        {"limit": "x"})
    assert status == 400


FRAME = st.text(alphabet="abc.:_", min_size=1, max_size=4)
STACKS = st.dictionaries(st.tuples(st.sampled_from(["engine-pump", "http",
                                                    "main"]), FRAME, FRAME),
                         st.integers(1, 50), max_size=12)


@settings(max_examples=200, deadline=None)
@given(STACKS, st.integers(1, 5))
def test_folded_helpers_are_the_references(counts, top):
    text = "".join(f"{';'.join(k)} {n}\n" for k, n in counts.items())
    text += "garbage line\nrole;frame notanumber\n"
    parsed = sampler.parse_folded(text)
    assert parsed == ref_sampler.parse_folded(text) == counts
    assert sampler.summarize_stacks(parsed, top_n=top) == \
        ref_sampler.summarize_stacks(parsed, top_n=top)


def test_profiler_charges_the_ports_threads_to_their_roles():
    prof = sampler.SamplingProfiler()
    prof.configure(hz=200.0, window_s=60.0)
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(100))

    names = ("engine-loop", "gen-streamer", "agent-handler", "kv-pull_0",
             "Thread-7 (target_fn)")
    threads = [threading.Thread(target=spin, name=n) for n in names]
    want = {"engine-pump", "streamer", "http", "kv-transfer", "target_fn"}
    prof.start()
    prof.start()                      # refcounted
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while not want <= set(prof.snapshot()["roles"]) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join()
        prof.stop()
        assert prof.running()
        prof.stop()
    assert not prof.running()
    roles = set(prof.snapshot()["roles"])
    assert want <= roles
    folded = prof.folded()
    assert sampler.parse_folded(folded) == ref_sampler.parse_folded(folded)
    assert all(line.rsplit(" ", 1)[0].split(";")[0] in roles
               for line in folded.splitlines())
    prof.clear()
    assert prof.snapshot()["samples"] == 0
    assert sampler.admin_profile({"top": "x"})[0] == 400
    assert isinstance(sampler.admin_profile({"format": "folded"})[1], str)


def test_launch_counts_hold_under_concurrent_engines():
    """Engines of one process count launches from their own threads at
    once: no add is lost, and a thread's tally holds its own launches
    only (what a graph capture takes back and adds at every replay)."""
    import sys

    from xllm_service_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = 0
    tallies = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            with _build.launch_tally() as counts:
                for _ in range(2000):
                    _build.count_launch(wrapper)
            tallies[i] = dict(counts)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 2000
    assert tallies == {i: {wrapper: 2000} for i in range(16)}
    _build.count_launch(wrapper, -5)
    assert wrapper.launches == 16 * 2000 - 5

