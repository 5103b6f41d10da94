"""The overload plane's drills on the port's master against the JAX
master, on the CPU.

Every drill of ``tests/test_overload.py``'s ``TestDeadlineEndToEnd``,
``TestAdmissionShedding``, ``TestBreakerRoutingIntegration``,
``TestRetryBudgetEndToEnd``, ``TestReviewRegressions``,
``TestRelayedClientDisconnect`` and ``TestFakeEngineCapacityModel`` is a
function ``drill_x(P)``: it runs on masters of package ``P`` (each on its
own package's in-process coordination store, with the reference's fake
engines), keeps the reference drill's own assertions, and returns what it
saw: status codes, ``Retry-After``, error bodies and SSE error frames
(addresses and ids normalised), deltas of
``requests_cancelled_total{reason=...}``, breaker and instance states,
flight-record kinds, the engines' ``stop_log``, ``cancelled`` and
``accepted_requests``. The outcomes must be equal under both masters.
Drills about the engine's side (the mid-decode deadline, the capacity
model) run each package's own fake engine. Three more cases hold the
agents (the tiny llama): a port agent and a JAX agent stop a request
whose deadline passes mid-decode within one engine step, with the same
tokens and the same stop; behind either master a port agent's stream
ends at its deadline with the same error frame; and behind either master
a port agent killed mid-stream is failed over to a survivor that is sent
the prompt plus the tokens already streamed and generates only the rest
(the client's tokens are the no-fault run's, no more).

Drills that wait on time wait on the event they check, with a bound.
"""

import json
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

from xllm_service_tpu.common.faults import FAULTS as ENGINE_FAULTS
from xllm_service_tpu.testing import fake_engine as ref_fake_engine

from fakes import wait_until
from test_torch_master_multimaster import Pkg as _PlanePkg

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

SEED = 0
REPLY = "Degrade gracefully: shed what cannot be served, bound the rest."


class Pkg(_PlanePkg):
    """The modules of one package a drill touches, with the overload
    plane's singletons and the package's own fake engine."""

    def __init__(self, which):
        super().__init__(which)
        if which == "ref":
            from xllm_service_tpu import overload
            from xllm_service_tpu.common.types import (
                InstanceRuntimeState,
                now_ms,
            )
            from xllm_service_tpu.devtools import lifecycle
            from xllm_service_tpu.testing import fake_engine
        else:
            from xllm_service_tpu_torch import overload
            from xllm_service_tpu_torch.common.types import (
                InstanceRuntimeState,
                now_ms,
            )
            from xllm_service_tpu_torch.devtools import lifecycle
            from xllm_service_tpu_torch.testing import fake_engine
        self.ADMISSION = overload.ADMISSION
        self.BROWNOUT = overload.BROWNOUT
        self.RETRY_BUDGET = overload.RETRY_BUDGET
        self.State = InstanceRuntimeState
        self.now_ms = now_ms
        self.lifecycle = lifecycle
        self.own_fake_engine = fake_engine


PKGS = {w: Pkg(w) for w in ("ref", "port")}


def reset_planes():
    """Both packages' overload singletons and fault planes clean (they
    are process-global, as the reference drills' fixture says)."""
    for P in PKGS.values():
        P.FAULTS.configure((), seed=SEED)
        P.ADMISSION.configure(per_instance_limit=0)
        P.ADMISSION.reset()
        P.BROWNOUT.configure(enabled=True)
        P.BROWNOUT.reset()
        P.RETRY_BUDGET.configure(ratio=0.1, cap=50.0)
        # A brownout entered in a drill lowers the process-wide trace
        # sampling, and its reset does not give it back.
        P.TRACER.configure(sample_rate=1.0)
    ENGINE_FAULTS.configure((), seed=SEED)


@pytest.fixture(autouse=True)
def _clean_planes():
    reset_planes()
    yield
    for P in PKGS.values():
        P.FAULTS.clear()
    ENGINE_FAULTS.clear()
    reset_planes()
    for P in PKGS.values():
        P.FAULTS.clear()
    ENGINE_FAULTS.clear()


def both(drill):
    """The drill on the JAX master, then on the port's: equal outcomes."""
    want = drill(PKGS["ref"])
    reset_planes()
    got = drill(PKGS["port"])
    assert got == want, (got, want)
    return got


OPTS = dict(host="127.0.0.1", http_port=0, rpc_port=0,
            lease_ttl_s=0.5, sync_interval_s=0.2, reconcile_interval_s=0.05,
            heartbeat_silence_to_suspect_s=0.3,
            detect_disconnected_instance_interval_s=0.3,
            health_probe_attempts=1, health_probe_timeout_s=0.2,
            failover_backoff_base_s=0.05, failover_backoff_max_s=0.3,
            rpc_backoff_base_s=0.02, rpc_backoff_max_s=0.1,
            handoff_stall_timeout_s=1.5)


class Fleet:
    """Masters of package ``P`` on one in-process store, with fake
    engines (the reference's unless ``own`` names the package's own).
    ``close()`` stops whatever is still up."""

    def __init__(self, P, n_masters=1, engines=({},), own=False,
                 opts=None, **master_kw):
        self.P = P
        self.store = P.memory.MemoryStore(expiry_tick_s=0.02)
        self.masters, self.engines = [], []
        self.fe = P.own_fake_engine if own else ref_fake_engine
        try:
            for _ in range(n_masters):
                self.masters.append(self.master(opts, **master_kw))
            for kw in engines:
                self.engines.append(self.engine(**kw))
            if n_masters:
                await_fleet(self.masters, self.engines)
        except BaseException:
            self.close()
            raise

    def coord(self):
        return self.P.memory.InMemoryCoordination(self.store)

    def master(self, opts=None, **kw):
        m = self.P.Master(self.P.Options(**{**(opts or OPTS), **kw}),
                          coord=self.coord())
        m.start()
        return m

    def engine(self, **kw):
        cfg = dict(reply_text=REPLY, chunk_size=4, heartbeat_interval_s=0.1,
                   lease_ttl_s=0.5)
        cfg.update(kw)
        return self.fe.FakeEngine(self.coord(),
                                  self.fe.FakeEngineConfig(**cfg)).start()

    def close(self):
        for e in self.engines:
            e.stop()
        for m in self.masters:
            if not getattr(m, "_killed", False):
                m.stop()
        self.store.close()


def await_fleet(masters, engines, timeout=20):
    addrs = {m.scheduler.self_addr for m in masters}
    assert wait_until(lambda: all(
        all(m.scheduler.instance_mgr.get_instance_meta(e.name) is not None
            for e in engines)
        and set(m.scheduler.ownership.members()) == addrs
        for m in masters), timeout=timeout)


def base(m):
    return f"http://127.0.0.1:{m.http_port}"


def key_owned_by(router, addr):
    for i in range(10000):
        k = f"affinity-{i}"
        if router.owner_of(k) == addr:
            return k
    raise AssertionError(f"no key owned by {addr} in 10k draws")


def cancelled(P, reason):
    return P.metrics.REQUESTS_CANCELLED_TOTAL.labels(reason=reason).value()


_ADDR = re.compile(r"\d+\.\d+\.\d+\.\d+:\d+")
_IDS = re.compile(r"\b(completion|chat|cmpl|chatcmpl)-[0-9a-zA-Z-]+")


def norm(text):
    """Addresses and request ids out of an error message."""
    return _IDS.sub(r"\1-<id>", _ADDR.sub("<addr>", text))


def norm_body(r):
    """A response: status, content type, ``Retry-After`` and the body
    (JSON with its ids and messages normalised)."""
    try:
        body = r.json()
    except ValueError:
        body = norm(r.text)
    return dict(status=r.status_code,
                ctype=r.headers.get("Content-Type", "").split(";")[0],
                retry_after=r.headers.get("Retry-After"),
                body=json.loads(norm(json.dumps(body))))


def sse(r):
    """A streamed response read to its end: (text, finish reasons, error
    frames normalised)."""
    text, finishes, errors = "", [], []
    for line in r.iter_lines():
        if not line.startswith(b"data: ") or line == b"data: [DONE]":
            continue
        obj = json.loads(line[6:])
        if "error" in obj:
            errors.append(json.loads(norm(json.dumps(obj["error"]))))
        for ch in obj.get("choices", ()):
            text += ch.get("text", "")
            if ch.get("finish_reason"):
                finishes.append(ch["finish_reason"])
    return text, finishes, errors


def stop_kinds(engines, sid):
    return sorted({k for e in engines for k, s in e.stop_log if s == sid})


# ================================================== TestDeadlineEndToEnd
def drill_expired_relayed_deadline(P):
    """The owner-side hop enforces the relay's absolute deadline."""
    fl = Fleet(P)
    try:
        m, eng = fl.masters[0], fl.engines[0]
        before = cancelled(P, "deadline")
        r = requests.post(
            f"http://127.0.0.1:{m.rpc_port}"
            "/rpc/handoff?kind=completion&sid=expired-sid",
            json={"model": "fake-model", "prompt": "late", "max_tokens": 4},
            headers={"x-xllm-deadline-ms": str(P.now_ms() - 5000)},
            timeout=5)
        assert r.status_code == 504
        assert "expired" in r.text
        assert cancelled(P, "deadline") == before + 1
        assert not eng.accepted_requests
        return dict(answer=norm_body(r),
                    delta=cancelled(P, "deadline") - before,
                    accepted=len(eng.accepted_requests))
    finally:
        fl.close()


def test_expired_relayed_deadline_refused():
    out = both(drill_expired_relayed_deadline)
    assert out["answer"]["status"] == 504 and out["accepted"] == 0


class _Sink:
    """An HTTP sink for an engine's pushes; each arrival's time kept."""

    def __init__(self):
        import http.server

        pushes = self.pushes = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                pushes.append(time.monotonic())
                body = b'{"ok": true, "alive": {}}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def drill_mid_decode_expiry(P):
    """Engine-side enforcement on the package's own fake engine: it stops
    producing within one pump interval of the deadline."""
    sink = _Sink()
    pump_s = 0.05
    fl = Fleet(P, n_masters=0, own=True,
               engines=(dict(delay_s=pump_s, chunk_size=1,
                             reply_text="x" * 60),))
    eng = fl.engines[0]
    try:
        deadline = P.now_ms() + 400
        r = requests.post(f"http://{eng.name}/v1/completions", json={
            "service_request_id": "mid-decode",
            "source_service_addr": sink.addr,
            "token_ids": [1, 2, 3], "max_tokens": 1000,
            "deadline_ms": deadline}, timeout=5)
        assert r.status_code == 200
        assert wait_until(lambda: ("deadline", "mid-decode") in eng.stop_log,
                          timeout=5)
        stopped_at = time.monotonic()
        # Production stopped: nothing pushed after the stop plus a pump.
        quiet = wait_until(lambda: time.monotonic() > stopped_at
                           + 10 * pump_s, timeout=5)
        late = [t for t in sink.pushes if t > stopped_at + 2 * pump_s]
        assert quiet and not late
        assert len(sink.pushes) < 30
        return dict(status=r.status_code, stops=list(eng.stop_log),
                    late=len(late), few=len(sink.pushes) < 30)
    finally:
        fl.close()
        sink.close()


def test_mid_decode_expiry_stops_engine_within_one_pump():
    out = both(drill_mid_decode_expiry)
    assert out["stops"] == [("deadline", "mid-decode")]


def drill_service_side_expiry(P):
    """A too-slow generation 504s the client at its deadline, cancels on
    the engine, counts a deadline cancellation and records a bundle."""
    fl = Fleet(P, engines=(dict(delay_s=0.1, chunk_size=1,
                                reply_text="y" * 50),))
    m, eng = fl.masters[0], fl.engines[0]
    try:
        before = cancelled(P, "deadline")
        t0 = time.monotonic()
        r = requests.post(base(m) + "/v1/completions", json={
            "model": "fake-model", "prompt": "slow", "max_tokens": 1000,
            "timeout": 0.6}, timeout=10)
        elapsed = time.monotonic() - t0
        assert r.status_code == 504, r.text
        assert "deadline" in r.text
        assert elapsed < 3.0
        assert wait_until(lambda: cancelled(P, "deadline") >= before + 1,
                          timeout=5)
        sid = eng.accepted_requests[-1]["service_request_id"]
        assert wait_until(lambda: any(s == sid for _, s in eng.stop_log),
                          timeout=5)
        assert wait_until(lambda: any(
            rec["request_id"] == sid
            for rec in P.RECORDER.recent(kind="deadline")), timeout=5)
        # Which stop the engine logs first (its own deadline check or the
        # service's cancel) is a race in both packages: only that it
        # stopped is compared, as the reference drill asserts.
        return dict(answer=norm_body(r),
                    counted=cancelled(P, "deadline") - before >= 1,
                    stopped=bool(stop_kinds([eng], sid)),
                    cancelled=sid in eng.cancelled)
    finally:
        fl.close()


def test_service_side_expiry_cancels_and_records():
    out = both(drill_service_side_expiry)
    assert out["answer"]["status"] == 504 and out["counted"]
    assert out["stopped"]


def drill_relayed_deadline(P):
    """A relayed stream's deadline survives the hop: the owner enforces
    the accepting frontend's absolute deadline and the engine stops."""
    fl = Fleet(P, n_masters=2, engines=(dict(delay_s=0.1, chunk_size=1,
                                             reply_text="z" * 50),))
    m1, m2 = fl.masters
    eng = fl.engines[0]
    try:
        okey = key_owned_by(m1.scheduler.ownership, m2.scheduler.self_addr)
        before = cancelled(P, "deadline")
        r = requests.post(base(m1) + "/v1/completions", json={
            "model": "fake-model", "prompt": "relayed-slow",
            "max_tokens": 1000, "timeout": 0.6, "ownership_key": okey,
            "stream": True}, stream=True, timeout=15)
        status = r.status_code
        text, finishes, errors = sse(r)
        r.close()
        assert any("deadline" in json.dumps(e) for e in errors)
        assert m1.scheduler.ownership.owner_of(okey) \
            == m2.scheduler.self_addr
        assert wait_until(lambda: cancelled(P, "deadline") >= before + 1,
                          timeout=5)
        sid = eng.accepted_requests[-1]["service_request_id"]
        assert wait_until(lambda: any(s == sid for _, s in eng.stop_log),
                          timeout=5)
        return dict(status=status, finishes=finishes, errors=errors,
                    partial=0 < len(text) < 50,
                    counted=cancelled(P, "deadline") - before >= 1,
                    stopped=bool(stop_kinds([eng], sid)))
    finally:
        fl.close()


def test_deadline_enforced_across_relayed_handoff():
    out = both(drill_relayed_deadline)
    assert out["status"] == 200 and out["errors"] and out["stopped"]


# =============================================== TestAdmissionShedding
def drill_shed_under_burst(P):
    """A burst over the watermark: fast 429s with Retry-After, admitted
    requests complete, the shed rate at /admin/overload, the shed counter
    at reason="shed", and the gate drains back to 0."""
    fl = Fleet(P, admission_max_inflight_per_instance=2,
               engines=(dict(service_rate_rps=10.0, delay_s=0.0,
                             chunk_size=8),))
    m = fl.masters[0]
    try:
        before = cancelled(P, "shed")
        results, lock = [], threading.Lock()

        def one(i):
            t0 = time.monotonic()
            try:
                r = requests.post(base(m) + "/v1/completions", json={
                    "model": "fake-model", "prompt": f"b{i}",
                    "max_tokens": 8}, timeout=30)
                row = (r.status_code, time.monotonic() - t0,
                       r.headers.get("Retry-After"),
                       json.dumps(r.json()) if r.status_code != 200
                       else r.json()["choices"][0]["text"])
            except requests.RequestException:
                row = (0, time.monotonic() - t0, None, None)
            with lock:
                results.append(row)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        shed = [x for x in results if x[0] == 429]
        served = [x for x in results if x[0] == 200]
        assert shed, f"nothing shed: {results}"
        assert served, f"nothing served: {results}"
        assert max(x[1] for x in shed) < 2.0
        assert all(x[2] is not None for x in shed)
        assert cancelled(P, "shed") >= before + len(shed)
        rep = requests.get(base(m) + "/admin/overload", timeout=5).json()
        assert rep["admission"]["enabled"]
        assert rep["admission"]["shed_total"].get("interactive", 0) \
            >= len(shed)
        assert wait_until(lambda: P.ADMISSION.pending() == 0, timeout=10)
        return dict(
            statuses=sorted({x[0] for x in results}),
            whole=sorted({x[3] for x in served}),
            shed_bodies=sorted({norm(x[3]) for x in shed}),
            retry_after=sorted({x[2] for x in shed}),
            counted=cancelled(P, "shed") - before == len(shed),
            report=sorted(rep), admission=sorted(rep["admission"]),
            limit=rep["admission"].get("per_instance_limit"))
    finally:
        fl.close()


def test_shed_under_burst_keeps_admitted_requests_whole():
    out = both(drill_shed_under_burst)
    assert out["statuses"] == [200, 429] and out["counted"]
    assert out["whole"] == [REPLY]


def drill_brownout_clamp(P):
    fl = Fleet(P, brownout_batch_max_tokens=2)
    m, eng = fl.masters[0], fl.engines[0]
    try:
        P.BROWNOUT.tick(report={"breaching": ["ttft"],
                                "worst_fast_burn_rate": 50.0})
        assert P.BROWNOUT.active()
        r = requests.post(base(m) + "/v1/completions", json={
            "model": "fake-model", "prompt": "bulk", "max_tokens": 1000},
            headers={"x-request-priority": "batch"}, timeout=10)
        assert r.status_code == 200
        clamped = eng.accepted_requests[-1]["max_tokens"]
        assert clamped == 2
        text = r.json()["choices"][0]["text"]
        assert len(text) == 8
        r2 = requests.post(base(m) + "/v1/completions", json={
            "model": "fake-model", "prompt": "chat", "max_tokens": 1000},
            timeout=10)
        assert eng.accepted_requests[-1]["max_tokens"] == 1000
        return (r.status_code, clamped, text, r2.status_code,
                r2.json()["choices"][0]["text"])
    finally:
        fl.close()


def test_brownout_clamps_batch_max_tokens_end_to_end():
    assert both(drill_brownout_clamp) == (200, 2, REPLY[:8], 200, REPLY)


# ========================================== TestBreakerRoutingIntegration
BREAKER = dict(circuit_breaker_min_samples=4)


def drill_breaker_open_excludes_probe_restores(P):
    fl = Fleet(P, engines=({}, {}), circuit_breaker_open_cooldown_s=0.3,
               **BREAKER)
    m = fl.masters[0]
    e1, e2 = fl.engines
    try:
        mgr = m.scheduler.instance_mgr
        ch = mgr.get_channel(e1.name)
        for _ in range(5):
            ch.breaker.record(False)
        assert wait_until(lambda: mgr.get_instance_state(e1.name)
                          == P.State.BREAKER_OPEN, timeout=5)
        snap = mgr.routing_snapshot()
        excluded = (e1.name not in snap.schedulable,
                    e2.name in snap.schedulable)
        assert excluded == (True, True)
        for _ in range(10):
            pair = mgr.get_next_instance_pair()
            assert e1.name not in (pair.prefill_name, pair.decode_name)
        gauge = P.metrics.CIRCUIT_BREAKER_OPEN.labels(
            instance=e1.name).value()
        assert wait_until(lambda: mgr.get_instance_state(e1.name)
                          == P.State.ACTIVE, timeout=10)
        assert e1.name in mgr.routing_snapshot().schedulable
        assert ch.breaker.state() == "closed"
        return dict(excluded=excluded, gauge_open=gauge,
                    gauge_closed=P.metrics.CIRCUIT_BREAKER_OPEN.labels(
                        instance=e1.name).value(),
                    state=ch.breaker.state(),
                    opened=ch.breaker.snapshot()["open_total"])
    finally:
        fl.close()


def test_breaker_open_excludes_half_open_probe_restores():
    out = both(drill_breaker_open_excludes_probe_restores)
    assert out["gauge_open"] == 1 and out["gauge_closed"] == 0


def drill_breaker_open_then_silent(P):
    """A breaker-open instance that also goes silent is evicted."""
    fl = Fleet(P, engines=({}, {}), circuit_breaker_open_cooldown_s=60.0,
               **BREAKER)
    m = fl.masters[0]
    e1, e2 = fl.engines
    try:
        mgr = m.scheduler.instance_mgr
        ch = mgr.get_channel(e1.name)
        for _ in range(5):
            ch.breaker.record(False)
        assert wait_until(lambda: mgr.get_instance_state(e1.name)
                          == P.State.BREAKER_OPEN, timeout=5)
        e1.kill()
        assert wait_until(lambda: mgr.get_instance_meta(e1.name) is None,
                          timeout=10)
        assert e2.name in mgr.routing_snapshot().schedulable
        return (mgr.get_instance_meta(e1.name) is None,
                sorted(mgr.routing_snapshot().schedulable) == [e2.name])
    finally:
        fl.close()


def test_breaker_open_then_silent_is_evicted():
    assert both(drill_breaker_open_then_silent) == (True, True)


def drill_open_channel_fails_fast(P):
    fl = Fleet(P)
    m, e1 = fl.masters[0], fl.engines[0]
    try:
        ch = m.scheduler.instance_mgr.get_channel(e1.name)
        for _ in range(5):
            ch.breaker.record(False)
        t0 = time.monotonic()
        ok, err = ch.forward("/v1/completions", {"prompt": "x"})
        assert not ok and "circuit breaker open" in str(err)
        assert time.monotonic() - t0 < 0.5
        return ok, str(err), ch.forward_status("/v1/embeddings", {})
    finally:
        fl.close()


def test_open_channel_fails_fast():
    ok, err, status = both(drill_open_channel_fails_fast)
    assert (ok, err) == (False, "circuit breaker open")
    assert status == (503, {"error": "circuit breaker open"})


# ============================================== TestRetryBudgetEndToEnd
def drill_failover_denied_by_budget(P):
    fl = Fleet(P, engines=(dict(delay_s=0.05), dict(delay_s=0.05)),
               retry_budget_ratio=0.0, retry_budget_cap=1.0,
               failover_max_retries=3)
    m = fl.masters[0]
    try:
        assert P.RETRY_BUDGET.try_spend()
        assert P.RETRY_BUDGET.tokens() == 0.0
        ENGINE_FAULTS.configure([dict(point="engine.token", action="crash",
                                      after=2, max_fires=1)], seed=SEED)
        before = P.metrics.FAILOVER_SUCCESS_TOTAL.value()
        r = requests.post(base(m) + "/v1/completions", json={
            "model": "fake-model", "prompt": "budget", "max_tokens": 1000},
            timeout=30)
        assert r.status_code == 503
        assert "retry budget" in r.text
        rep = P.RETRY_BUDGET.report()
        assert rep["denied_total"] >= 1
        return dict(answer=norm_body(r), denied=rep["denied_total"],
                    spent=rep["spent_total"],
                    recovered=P.metrics.FAILOVER_SUCCESS_TOTAL.value()
                    - before,
                    dead=sum(1 for e in fl.engines if not e._alive))
    finally:
        ENGINE_FAULTS.configure((), seed=SEED)
        fl.close()


def test_failover_denied_when_budget_exhausted():
    out = both(drill_failover_denied_by_budget)
    assert out["answer"]["status"] == 503 and out["recovered"] == 0
    assert out["dead"] == 1


# ================================================= TestReviewRegressions
def drill_slot_released_on_raising_parser(P):
    fl = Fleet(P, admission_max_inflight_per_instance=2)
    m = fl.masters[0]
    try:
        bad = []
        for _ in range(5):
            r = requests.post(base(m) + "/v1/messages", json={
                "model": "fake-model", "max_tokens": 8,
                "temperature": "hot",
                "messages": [{"role": "user", "content": "x"}]}, timeout=5)
            assert r.status_code == 400, r.text
            bad.append(norm_body(r))
        assert P.ADMISSION.pending() == 0
        r = requests.post(base(m) + "/v1/completions", json={
            "model": "fake-model", "prompt": "ok", "max_tokens": 4},
            timeout=10)
        assert r.status_code == 200, r.text
        # The slot is given back as the handler ends, which may be just
        # after the client has the whole answer: wait for it, bounded.
        wait_until(lambda: P.ADMISSION.pending() == 0, timeout=5)
        return bad, P.ADMISSION.pending(), r.json()["choices"][0]["text"]
    finally:
        fl.close()


def test_admission_slot_released_on_raising_parser():
    bad, pending, text = both(drill_slot_released_on_raising_parser)
    assert [b["status"] for b in bad] == [400] * 5
    assert pending == 0 and text == REPLY[:16]


def drill_breaker_ignores_overload_answers(P):
    """503 (draining, queue full) and 504 (deadline) are busy, not sick;
    transport failures still trip the breaker."""
    fl = Fleet(P)
    m, eng = fl.masters[0], fl.engines[0]
    try:
        ch = m.scheduler.instance_mgr.get_channel(eng.name)
        eng.draining = True
        errs = []
        for _ in range(8):
            ok, err = ch.forward("/v1/completions", {
                "service_request_id": "busy",
                "source_service_addr": "127.0.0.1:1",
                "token_ids": [1], "max_tokens": 1})
            assert not ok
            errs.append(norm(str(err)))
        assert ch.breaker.state() == "closed"
        eng.stop()
        for _ in range(8):
            ch.cancel("gone")
        assert ch.breaker.state() == "open"
        return sorted(set(errs)), ch.breaker.state()
    finally:
        fl.close()


def test_breaker_ignores_deliberate_overload_answers():
    errs, state = both(drill_breaker_ignores_overload_answers)
    assert state == "open" and all(e.startswith("HTTP 503") for e in errs)


def drill_relayed_shed_keeps_retry_after(P):
    """A shed 429 crossing the handoff relay keeps its Retry-After."""
    fl = Fleet(P, n_masters=2, admission_max_inflight_per_instance=1)
    m1, m2 = fl.masters
    admitted = False
    try:
        okey = key_owned_by(m1.scheduler.ownership, m2.scheduler.self_addr)
        ok, _, _ = P.ADMISSION.try_admit("interactive", live=1,
                                         burn_hot=False)
        admitted = ok
        assert ok
        r = requests.post(base(m1) + "/v1/completions", json={
            "model": "fake-model", "prompt": "relayed-shed",
            "max_tokens": 4, "ownership_key": okey}, timeout=10)
        assert r.status_code == 429, r.text
        assert r.headers.get("Retry-After") is not None
        return norm_body(r)
    finally:
        if admitted:
            P.ADMISSION.release()
        fl.close()


def test_relayed_shed_keeps_retry_after():
    out = both(drill_relayed_shed_keeps_retry_after)
    assert out["status"] == 429 and out["retry_after"] == "1"


# ========================================== TestRelayedClientDisconnect
def drill_dropped_relayed_stream(P):
    """A client dropping a relayed stream: the cancel reaches the owner
    and the engines.

    The masters' leases are 2 s, not OPTS's 0.5 s: the JAX package's
    in-memory client never re-creates a leased key that ran out, so a
    keepalive thread starved past a 0.5 s lease on a loaded box drops a
    JAX master from its peer's membership for good, and the fleet never
    forms (the port's client re-creates the key). This drill is about the
    relay's cancel, not leases."""
    fl = Fleet(P, n_masters=2,
               engines=[dict(delay_s=0.1, chunk_size=1, reply_text="d" * 80)
                        for _ in range(2)], lease_ttl_s=2.0)
    m1, m2 = fl.masters
    engines = fl.engines
    try:
        okey = key_owned_by(m1.scheduler.ownership, m2.scheduler.self_addr)
        r = requests.post(base(m1) + "/v1/completions", json={
            "model": "fake-model", "prompt": "drop-me", "max_tokens": 1000,
            "stream": True, "ownership_key": okey}, stream=True, timeout=15)
        assert r.status_code == 200
        frames = 0
        for line in r.iter_lines():
            if line.startswith(b"data: "):
                frames += 1
                if frames >= 3:
                    break
        r.close()
        accepted = [q for e in engines for q in e.accepted_requests]
        assert accepted, "engine never saw the relayed dispatch"
        sid = accepted[-1]["service_request_id"]
        assert wait_until(lambda: any(sid in e.cancelled for e in engines),
                          timeout=10)
        assert wait_until(lambda: any(("cancel", sid) in e.stop_log
                                      or ("stopped", sid) in e.stop_log
                                      for e in engines), timeout=10)
        return dict(accepted=len(accepted),
                    cancelled=sum(sid in e.cancelled for e in engines),
                    stopped=bool({"cancel", "stopped"}
                                 & set(stop_kinds(engines, sid))))
    finally:
        fl.close()


def test_dropped_relayed_stream_cancels_on_engines():
    out = both(drill_dropped_relayed_stream)
    assert out["accepted"] == 1 and out["cancelled"] == 1


# ========================================== TestFakeEngineCapacityModel
def drill_bounded_accept_queue(P):
    fl = Fleet(P, n_masters=0, own=True,
               engines=(dict(service_rate_rps=1.0, accept_queue_limit=2,
                             delay_s=0.0),))
    eng = fl.engines[0]
    try:
        codes = []
        for i in range(6):
            r = requests.post(f"http://{eng.name}/v1/completions", json={
                "service_request_id": f"cap-{i}",
                "source_service_addr": "127.0.0.1:1",
                "token_ids": [1, 2, 3], "max_tokens": 4}, timeout=5)
            codes.append(r.status_code)
        assert codes.count(503) >= 2
        assert eng.rejected_overload >= 2
        assert ("overload", "cap-5") in eng.stop_log
        assert len(eng.accepted_requests) == 6
        return (codes.count(503) >= 2, codes[0],
                eng.rejected_overload == codes.count(503),
                ("overload", "cap-5") in eng.stop_log,
                [q["service_request_id"] for q in eng.accepted_requests])
    finally:
        fl.close()


def test_bounded_accept_queue_rejects_overload():
    out = both(drill_bounded_accept_queue)
    assert out[:4] == (True, 200, True, True)


def drill_service_rate_paces(P):
    fl = Fleet(P, n_masters=0, own=True,
               engines=(dict(service_rate_rps=10.0, accept_queue_limit=0,
                             delay_s=0.0),))
    eng = fl.engines[0]
    try:
        t0 = time.monotonic()
        codes = []
        for i in range(5):
            codes.append(requests.post(
                f"http://{eng.name}/v1/completions", json={
                    "service_request_id": f"pace-{i}",
                    "source_service_addr": "127.0.0.1:1",
                    "token_ids": [1], "max_tokens": 1}, timeout=5)
                .status_code)
        accept_elapsed = time.monotonic() - t0
        assert accept_elapsed < 2.0
        t1 = time.monotonic()
        assert wait_until(lambda: eng._svc_queue.qsize() == 0, timeout=5)
        drained = time.monotonic() - t1
        return codes, accept_elapsed < 2.0, drained < 5.0
    finally:
        fl.close()


def test_service_rate_paces_dispatch():
    assert both(drill_service_rate_paces) == ([200] * 5, True, True)


# =================================== the agents: a deadline mid-decode
ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=256)
DEADLINE_AFTER = 3     # tokens pushed before the clock passes the deadline


@pytest.fixture(scope="module")
def tree():
    from xllm_service_tpu.models import llama as ref_llama
    from xllm_service_tpu.models.base import tiny_config as ref_tiny

    return ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))


def _agent(which, store, tree):
    if which == "ref":
        from xllm_service_tpu.coordination.memory import InMemoryCoordination
        from xllm_service_tpu.engine import agent as mod
        from xllm_service_tpu.engine import EngineConfig
        from xllm_service_tpu.models.base import tiny_config

        a = mod.EngineAgent(
            EngineConfig(model_id="tiny-llama",
                         model=tiny_config(dtype=jnp.float32,
                                           max_context_len=256),
                         prefill_buckets=(32, 64, 256), **ENGINE_KW),
            mod.AgentConfig(host="127.0.0.1", model_id="tiny-llama",
                            heartbeat_interval_s=0.3, lease_ttl_s=1.0),
            coord=InMemoryCoordination(store), params=tree)
    else:
        from xllm_service_tpu_torch.coordination.memory import (
            InMemoryCoordination,
        )
        from xllm_service_tpu_torch.engine import agent as mod
        from xllm_service_tpu_torch.engine import EngineConfig
        from xllm_service_tpu_torch.models.base import tiny_config
        from xllm_service_tpu_torch.models.weights import (
            llama_params_from_jax,
        )

        a = mod.EngineAgent(
            EngineConfig(model=tiny_config(dtype=torch.float32,
                                           max_context_len=256),
                         **ENGINE_KW),
            mod.AgentConfig(host="127.0.0.1", model_id="tiny-llama",
                            heartbeat_interval_s=0.3, lease_ttl_s=1.0),
            coord=InMemoryCoordination(store), device="cpu",
            params=llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                         device="cpu"))
    return mod, a


def agent_deadline_run(which, tree):
    """One request to an agent (no master: its pushes are captured) whose
    deadline the agent's clock passes once DEADLINE_AFTER tokens have
    been pushed. Returns (tokens pushed, tokens pushed when the clock
    passed, the final output's finish reason and status, the engine's
    running count after, engine steps between the deadline and the
    stop)."""
    P = PKGS[which]
    store = P.memory.MemoryStore(expiry_tick_s=0.05)
    mod, agent = _agent(which, store, tree)
    sid = f"deadline-{which}"
    pushed, finals, at_deadline = [], [], []
    t0 = 10**12
    deadline = t0 + 1000
    real_now = mod.now_ms

    def clock():
        if len(pushed) >= DEADLINE_AFTER:
            if not at_deadline:
                at_deadline.append(len(pushed))
            return deadline + 1000
        return t0

    def push(dest, out):
        if out.service_request_id != sid:
            return
        for o in out.outputs:
            pushed.extend(o.token_ids)
            if o.finish_reason:
                finals.append(o.finish_reason)
        if out.finished:
            finals.append(("finished", out.status.code.name))

    mod.now_ms = clock
    agent.start()
    agent.streamer.push = push
    try:
        r = requests.post(f"http://{agent.name}/v1/completions", json={
            "service_request_id": sid, "source_service_addr": "127.0.0.1:1",
            "token_ids": list(range(5, 25)), "max_tokens": 64,
            "temperature": 0.0, "ignore_eos": True,
            "deadline_ms": deadline}, timeout=30)
        assert r.status_code == 200, r.text
        assert wait_until(lambda: any(isinstance(f, tuple) for f in finals),
                          timeout=60), (which, pushed, finals)
        running = agent.engine.stats()["running"]
        # An expired deadline at arrival is refused before any engine.
        late = requests.post(f"http://{agent.name}/v1/completions", json={
            "service_request_id": sid + "-late",
            "source_service_addr": "127.0.0.1:1",
            "token_ids": [1, 2, 3], "max_tokens": 4,
            "deadline_ms": t0 - 1}, timeout=30)
        return dict(tokens=list(pushed), crossed=at_deadline[0],
                    finals=finals, running=running,
                    late=(late.status_code, late.json()))
    finally:
        mod.now_ms = real_now
        agent.stop()
        store.close()


def test_agents_stop_a_deadline_mid_decode_as_the_jax_agent(tree):
    want = agent_deadline_run("ref", tree)
    got = agent_deadline_run("port", tree)
    assert got == want
    # The stop lands within one engine step of the crossing: the delta in
    # hand ships, then at most one more token.
    assert got["crossed"] >= DEADLINE_AFTER
    assert len(got["tokens"]) <= got["crossed"] + 2 < 64
    assert got["running"] == 0
    assert got["late"] == (504, {"error": "deadline exceeded"})


REASONS = ("deadline", "shed", "disconnect", "failover", "timeout")


def drill_agent_deadline_through_master(P, tree):
    """A port agent behind the master: a stream whose deadline passes once
    the agent has pushed DEADLINE_AFTER tokens, on one clock that the
    agent and the master's deadline checks share (both read it through
    their modules' ``now_ms``; it jumps past the deadline then). The
    client's end, the cancellation counts and the agent's engine
    afterwards."""
    import importlib

    import chip_smoke

    root = "xllm_service_tpu" if P.which == "ref" else \
        "xllm_service_tpu_torch"
    clocked = [importlib.import_module(f"{root}.{m}")
               for m in ("overload.deadline", "scheduler.scheduler")]
    store = P.memory.MemoryStore(expiry_tick_s=0.05)
    m = P.Master(P.Options(host="127.0.0.1", http_port=0, rpc_port=0,
                           lease_ttl_s=1.0, sync_interval_s=0.3,
                           reconcile_interval_s=0.1),
                 coord=P.memory.InMemoryCoordination(store))
    m.start()
    mod, agent = _agent("port", store, tree)
    clocked.append(mod)
    pushed = []
    real_now = mod.now_ms

    def clock():
        return real_now() + (10**6 if len(pushed) >= DEADLINE_AFTER else 0)
    for c in clocked:
        c.now_ms = clock
    try:
        agent.start()
        push = agent.streamer.push

        def recording(dest, out):
            for o in out.outputs:
                pushed.extend(o.token_ids)
            push(dest, out)
        agent.streamer.push = recording
        assert wait_until(lambda: m.scheduler.instance_mgr
                          .get_instance_meta(agent.name) is not None,
                          timeout=10)
        before = {r: cancelled(P, r) for r in REASONS}
        r = requests.post(base(m) + "/v1/completions", json={
            "model": "tiny-llama", "prompt": "hello there",
            "max_tokens": 100, "temperature": 0.0, "ignore_eos": True,
            "stream": True}, headers={"x-request-deadline-ms": "5000"},
            stream=True, timeout=30)
        lines = [line for line in r.iter_lines()
                 if line.startswith(b"data: ")]
        done = b"data: [DONE]" in lines
        frames = [json.loads(line[6:]) for line in lines
                  if line != b"data: [DONE]"]
        status = r.status_code
        assert wait_until(lambda: agent.engine.stats()["running"] == 0,
                          timeout=10)
        end = frames[-1]
        assert (end, done) == (chip_smoke.DEADLINE_END,
                               chip_smoke.DEADLINE_DONE), (end, done)
        assert wait_until(lambda: cancelled(P, "deadline")
                          == before["deadline"] + 1, timeout=5)
        text = "".join(c.get("text", "") for f in frames[:-1]
                       for c in f.get("choices", ()))
        return dict(status=status, end=end, done=done,
                    n_tokens=len(pushed), text=text,
                    cancelled={k: cancelled(P, k) - v
                               for k, v in before.items()},
                    running=agent.engine.stats()["running"],
                    records=sorted({rec["kind"] for rec in
                                    P.RECORDER.recent(limit=20,
                                                      kind="deadline")}))
    finally:
        for c in clocked:
            c.now_ms = real_now
        agent.stop()
        m.stop()
        store.close()


def test_agent_deadline_mid_decode_ends_as_under_the_jax_master(tree):
    """The end a client sees when its stream's deadline passes
    mid-decode: the same error frame, no ``[DONE]``, one deadline
    cancellation under both masters (the end ``chip_smoke.py``'s leg 4s
    (k) holds the card's stream to)."""
    out = both(lambda P: drill_agent_deadline_through_master(P, tree))
    assert out["status"] == 200 and out["running"] == 0
    assert out["n_tokens"] < 100


# ===================== a port agent's death mid-stream, the rest replayed
AGENT_NEW = 40
AGENT_OPTS = dict(OPTS, lease_ttl_s=0.6,
                  heartbeat_silence_to_suspect_s=0.4,
                  detect_disconnected_instance_interval_s=0.4)


def drill_agent_failover_resumes(P, tree):
    """Two port agents (the tiny llama) behind the master; the one serving
    a greedy stream killed (server, engine and heartbeats stopped, its
    lease left to lapse) after three frames. The survivor is dispatched
    the prompt plus the tokens the client already has and generates only
    the rest: the client's tokens are the no-fault run's, no more, and
    the usage counts them all."""
    import chip_smoke
    store = P.memory.MemoryStore(expiry_tick_s=0.02)
    m = P.Master(P.Options(**AGENT_OPTS),
                 coord=P.memory.InMemoryCoordination(store))
    m.start()
    agents = [_agent("port", store, tree)[1].start() for _ in range(2)]
    pushed: dict = {}
    for i, a in enumerate(agents):
        push = a.streamer.push

        def own(dest, out, i=i, push=push):
            for o in out.outputs:
                pushed.setdefault((i, out.service_request_id), []).extend(
                    o.token_ids)
            push(dest, out)
        a.streamer.push = own
        step = a.engine._decode

        def slow(*args, step=step):   # a decode step the stream can outrun
            time.sleep(0.02)
            return step(*args)
        a.engine._decode = slow
    spy, _, restore = chip_smoke.route_spy(agents)
    body = {"model": "tiny-llama", "prompt": list(range(5, 40)),
            "max_tokens": AGENT_NEW, "temperature": 0.0, "ignore_eos": True,
            "stream": True, "stream_options": {"include_usage": True}}

    def run(kill_after=None):
        r = requests.post(base(m) + "/v1/completions", json=body,
                          stream=True, timeout=60)
        sid = r.headers["x-request-id"]
        frames, killed = [], []
        for line in r.iter_lines():
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            frames.append(json.loads(line[6:]))
            if kill_after and len(frames) == kill_after and not killed:
                busy = [i for i, a in enumerate(agents)
                        if a.engine.stats()["running"]]
                assert len(busy) == 1, busy
                killed.append(busy[0])
                agents[busy[0]].coord.rm = lambda key: True
                agents[busy[0]].stop()
        usage = frames[-1].get("usage")
        finishes = [c["finish_reason"] for f in frames
                    for c in f.get("choices", ()) if c.get("finish_reason")]
        return sid, killed, usage, finishes, frames

    try:
        assert wait_until(lambda: all(
            m.scheduler.instance_mgr.get_instance_meta(a.name)
            for a in agents), timeout=15)
        sid0, _, usage0, fin0, _ = run()
        clean = next(t for (i, s), t in pushed.items() if s == sid0)
        before = P.metrics.FAILOVER_SUCCESS_TOTAL.value()
        sid, killed, usage, finishes, frames = run(kill_after=3)
        assert killed, "the stream ended before the kill"
        v = killed[0]
        replays = [b for i, b in spy if i == 1 - v
                   and b.get("service_request_id") == sid]
        assert len(replays) == 1, replays
        resume = list(replays[0]["resume_generated_token_ids"])
        assert replays[0]["token_ids"] == body["prompt"] + resume
        client = resume + pushed.get((1 - v, sid), [])
        assert pushed[(v, sid)][:len(resume)] == resume
        assert client == clean, (len(client), len(clean))
        assert usage == usage0 and usage["completion_tokens"] == AGENT_NEW
        return dict(n=len(client), resumed=0 < len(resume) < AGENT_NEW,
                    usage=usage, finishes=finishes, clean_finishes=fin0,
                    recovered=P.metrics.FAILOVER_SUCCESS_TOTAL.value()
                    - before)
    finally:
        restore()
        for a in agents:
            a.stop()
        m.stop()
        store.close()


def test_port_agent_failover_resumes_only_the_rest(tree):
    out = both(lambda P: drill_agent_failover_resumes(P, tree))
    assert out["n"] == AGENT_NEW and out["resumed"] and out["recovered"] == 1
    assert out["finishes"] == out["clean_finishes"] == ["length"]
