"""The port master's admin and fleet surface against the JAX master's, on
the CPU.

Each package's master runs on its own in-process store with its own
package's fake engine and the autoscaler on (hint actuator). The sync
loop is parked (an hour's interval) and both masters take the same
``sync_once`` passes by hand, so their planner and autoscaler state
advance alike; the same requests go through both. Then every route of the
admin surface must give the JAX master's status and body once addresses,
random ids and times are normalised: ``/admin/config`` (GET, and POST with
valid and refused knobs), ``/admin/planner``, ``/admin/autoscaler``,
``/admin/coordination``, ``/admin/overload``, ``/admin/faults`` (GET and
POST), ``/admin/slo``, ``/admin/flightrecorder/recent``, the trace routes
(local and ``scope=fleet``) and ``/metrics/fleet``; ``/admin/hotpath`` and
``/admin/profile`` (local and fleet), whose numbers are samples and
latencies, must have the same shape. The RPC app serves the local scope of
``/metrics``, the trace routes and the profile and never honours
``scope=fleet``. The fleet trace and the fleet profile are then taken
over a port agent (the tiny llama on the CPU) behind each master.
"""

import http.client
import importlib
import json
import re

import pytest
import torch

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

PKGS = {"ref": "xllm_service_tpu", "port": "xllm_service_tpu_torch"}
REPLY = "Admin pages tell an operator what the fleet did and why."

OPTS = dict(host="127.0.0.1", http_port=0, rpc_port=0, lease_ttl_s=1.0,
            sync_interval_s=3600.0, reconcile_interval_s=0.05,
            brownout_enabled=False, autoscaler_enabled=True,
            autoscaler_min_instances=1, autoscaler_max_instances=2,
            slo_ttft_ms=60000.0, slo_tpot_ms=60000.0)


def mod(P, name):
    return importlib.import_module(f"{PKGS[P]}.{name}")


class Plane:
    def __init__(self, P, engine=True, agent=False, **kw):
        self.P = P
        memory = mod(P, "coordination.memory")
        self.store = memory.MemoryStore(expiry_tick_s=0.02)
        self.master = mod(P, "master").Master(
            mod(P, "common.config").ServiceOptions(**{**OPTS, **kw}),
            coord=memory.InMemoryCoordination(self.store))
        self.master.start()
        self.engines = []
        self.sent = []   # X-Request-Id of each request this plane sent
        if engine:
            fe = mod(P, "testing.fake_engine")
            self.engines.append(fe.FakeEngine(
                memory.InMemoryCoordination(self.store),
                fe.FakeEngineConfig(reply_text=REPLY, chunk_size=8,
                                    heartbeat_interval_s=0.1,
                                    lease_ttl_s=1.0)).start())
        if agent:
            self.engines.append(port_agent(P, self.store).start())
        mgr = self.master.scheduler.instance_mgr
        assert wait_until(lambda: all(mgr.get_instance_meta(e.name)
                                      for e in self.engines), timeout=30)
        assert wait_until(lambda: all(
            mgr.load_info_ages_s().get(e.name, -1) >= 0
            for e in self.engines), timeout=30)

    def call(self, method, path, body=None, rpc=False):
        port = self.master.rpc_port if rpc else self.master.http_port
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            c.request(method, path,
                      body=json.dumps(body) if body is not None else None,
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            if r.getheader("X-Request-Id"):
                self.sent.append(r.getheader("X-Request-Id"))
            return (r.status, (r.getheader("Content-Type") or "")
                    .split(";")[0], r.read().decode())
        finally:
            c.close()

    def close(self):
        for e in self.engines:
            e.stop()
        self.master.stop()
        self.store.close()


def port_agent(P, store):
    """A port agent on the tiny llama (f32, CPU) on package ``P``'s store
    (through the port's coordination client of the same store type when
    ``P`` is the port's; the JAX master's store is reached over its
    package's in-process client, which the agent takes as it is)."""
    from xllm_service_tpu_torch.engine import EngineConfig
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.models.base import tiny_config

    coord = mod(P, "coordination.memory").InMemoryCoordination(store)
    return EngineAgent(
        EngineConfig(model=tiny_config(dtype=torch.float32,
                                       max_context_len=256),
                     num_pages=64, page_size=16, hash_block_size=32,
                     max_batch_size=4, max_seq_len=256),
        AgentConfig(host="127.0.0.1", model_id="tiny-llama",
                    heartbeat_interval_s=0.2, lease_ttl_s=1.0),
        coord=coord, device="cpu")


_ADDR = re.compile(r"\d+\.\d+\.\d+\.\d+:\d+")
_ID = re.compile(r"\b(?=[0-9a-f]*\d)[0-9a-f]{8,}\b")
_RID = re.compile(r"\b(completion|chatcmpl|chat)-\d+-[0-9a-f]{8}\b")
# Keys whose numbers are clock readings, ages or latencies.
_TIME = re.compile(r"(^|_)(ts|ms|s|age|time|at|p50|p90|p99|mean|seconds|"
                   r"value|rate)$")


def norm_str(s):
    s = s.replace("xllm_service_tpu_torch", "xllm_service_tpu")
    s = _RID.sub("RID", s)
    return _ID.sub("ID", _ADDR.sub("ADDR", s))


def norm(obj, key=""):
    """Addresses, ids and times out: every string's addresses and hex ids
    replaced, every number under a time-like key replaced."""
    if isinstance(obj, dict):
        return {norm_str(k): norm(v, k) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [norm(v, key) for v in obj]
    if isinstance(obj, str):
        return norm_str(obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool) \
            and _TIME.search(key):
        return "T"
    return obj


def shape(obj):
    """Keys and types only (sampled counts and latencies out). A profile's
    ``roles`` are named by the threads the sampler caught, so only the
    shape of each role's entry is kept."""
    if isinstance(obj, dict):
        if "roles" in obj and isinstance(obj["roles"], dict):
            obj = dict(obj, roles=sorted({json.dumps(shape(v))
                                          for v in obj["roles"].values()}))
        return {norm_str(k): shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return "list"
    return type(obj).__name__ if not isinstance(obj, bool) else "bool"


def traffic(pl):
    """Two requests, then two sync passes (planner and autoscaler)."""
    out = []
    for stream in (False, True):
        out.append(pl.call("POST", "/v1/completions", {
            "model": "fake-model", "prompt": "admin", "max_tokens": 64,
            "stream": stream})[0])
    for _ in range(2):
        pl.master.scheduler.sync_once()
    return out


@pytest.fixture(scope="module")
def planes():
    made = {}
    try:
        for P in ("ref", "port"):
            made[P] = Plane(P)
            assert traffic(made[P]) == [200, 200]
        yield made
    finally:
        for pl in made.values():
            pl.close()


def body(pl, path, rpc=False):
    status, ctype, text = pl.call("GET", path, rpc=rpc)
    return status, ctype, (json.loads(text) if ctype == "application/json"
                           else text)


def metrics_lines(text, role):
    """The fleet exposition's lines of one role, engine ones without the
    connection count (it depends on thread interleaving)."""
    return sorted(norm_str(ln) for ln in text.splitlines()
                  if f'role="{role}"' in ln
                  and "connections_created" not in ln)


EXACT = ["/admin/config", "/admin/planner", "/admin/autoscaler",
         "/admin/coordination", "/admin/overload", "/admin/faults",
         "/admin/slo", "/admin/flightrecorder/recent",
         "/admin/trace/recent", "/admin/trace/recent?scope=fleet",
         "/admin/trace/recent?limit=x", "/admin/trace",
         "/admin/trace?scope=fleet", "/admin/profile?top=x",
         "/admin/profile?scope=fleet&top=x"]


@pytest.mark.parametrize("path", EXACT)
def test_admin_route_matches_reference(planes, path):
    got, want = (body(planes[P], path) for P in ("port", "ref"))
    if path == "/admin/config":      # the options themselves: no clock
        assert got == want
    assert norm(got) == norm(want)


def _root_request(pl):
    """The ``frontend.request`` root of the last request this plane sent,
    selected by that request's id: the trace store is process-wide in
    both packages, so the newest root may be another test's."""
    recent = body(pl, "/admin/trace/recent?limit=50")[2]["traces"]
    return next(r["request_id"] for r in recent if r["root_point"]
                == "frontend.request" and r["request_id"] == pl.sent[-1])


@pytest.mark.parametrize("scope", ["", "&scope=fleet"])
def test_trace_by_request_matches_reference(planes, scope):
    out = {}
    for P, pl in planes.items():
        status, _, payload = body(
            pl, f"/admin/trace?request_id={_root_request(pl)}{scope}")
        points = sorted(s["point"] for s in payload["spans"])
        peers = sorted((norm_str(a), v["role"], v["status"])
                       for a, v in payload.get("peers", {}).items())
        out[P] = (status, points, peers, sorted(norm(payload)))
    assert out["port"] == out["ref"]
    if scope:
        assert {"engine.prefill", "engine.decode"} <= set(out["port"][1])


@pytest.mark.parametrize("path", ["/admin/hotpath", "/admin/profile",
                                  "/admin/profile?scope=fleet"])
def test_sampled_route_has_the_reference_shape(planes, path):
    got, want = (body(planes[P], path) for P in ("port", "ref"))
    assert got[:2] == want[:2] == (200, "application/json")
    assert shape(got[2]) == shape(want[2])


@pytest.mark.parametrize("scope", ["", "&scope=fleet"])
def test_folded_profile(planes, scope):
    for P in ("port", "ref"):
        status, ctype, text = body(planes[P],
                                   f"/admin/profile?format=folded{scope}")
        assert (status, ctype) == (200, "text/plain")
        assert all(re.fullmatch(r"\S.* \d+", ln)
                   for ln in text.splitlines() if ln), text[:200]


def test_metrics_fleet_matches_reference(planes):
    got, want = (body(planes[P], "/metrics/fleet") for P in ("port", "ref"))
    assert got[:2] == want[:2] == (200, "text/plain")
    for role in ("engine",):
        assert metrics_lines(got[2], role) == metrics_lines(want[2], role)
    up = [sorted(norm_str(ln) for ln in b[2].splitlines()
                 if ln.startswith("fleet_scrape_up")) for b in (got, want)]
    assert up[0] == up[1] == ['fleet_scrape_up{instance="ADDR",role="engine"} 1',
                              'fleet_scrape_up{instance="ADDR",'
                              'role="frontend"} 1']
    assert "autoscaler_last_decision_age_seconds" in got[2]


@pytest.mark.parametrize("path", ["/metrics", "/admin/trace/recent",
                                  "/admin/trace/recent?scope=fleet",
                                  "/admin/profile?scope=fleet",
                                  "/admin/config"])
def test_rpc_app_serves_local_scope_only(planes, path):
    out = {}
    for P, pl in planes.items():
        status, ctype, payload = body(pl, path, rpc=True)
        if isinstance(payload, dict):
            assert "scope" not in payload and "peers" not in payload
            payload = shape(payload)
        elif path == "/metrics":
            payload = "autoscaler_last_decision_age_seconds" in payload
        out[P] = (status, ctype, payload)
    assert out["port"] == out["ref"]
    assert out["port"][0] == (404 if path == "/admin/config" else 200)


CONFIG_POSTS = [
    {"target_ttft_ms": 750, "enable_tracing": "true",
     "trace_sample_rate": 1.0},
    {"max_waiting_requests": "12", "request_timeout_s": 120},
    {"load_balance_policy": "RR"},
    {"target_tpot_ms": -1},
    {"enable_request_trace": "maybe"},
]


@pytest.mark.parametrize("i", range(len(CONFIG_POSTS)))
def test_post_config_matches_reference(planes, i):
    out = {}
    for P, pl in planes.items():
        before = body(pl, "/admin/config")[2]
        res = pl.call("POST", "/admin/config", CONFIG_POSTS[i])
        after = body(pl, "/admin/config")[2]
        pl.call("POST", "/admin/config", {
            k: before[k] for k in CONFIG_POSTS[i] if k in before
            and k in ("target_ttft_ms", "target_tpot_ms",
                      "max_waiting_requests", "request_timeout_s",
                      "enable_tracing", "trace_sample_rate",
                      "enable_request_trace")})
        out[P] = (res, {k: after[k] for k in after if before[k] != after[k]})
    assert out["port"] == out["ref"]


FAULT_POSTS = [
    {"rules": [{"point": "engine.token", "action": "crash", "after": 3}],
     "seed": 7},
    {"rules": [{"point": "engine.accept", "action": "nonsense"}]},
    {"clear": True},
    [1, 2],
]


def test_post_faults_matches_reference(planes):
    out = {}
    for P, pl in planes.items():
        rows = [pl.call("POST", "/admin/faults", b) for b in FAULT_POSTS]
        rows.append(pl.call("GET", "/admin/faults"))
        out[P] = rows
        mod(P, "common.faults").FAULTS.clear()
    assert out["port"] == out["ref"]
    assert [r[0] for r in out["port"]] == [200, 400, 200, 400, 200]


def test_fleet_trace_and_profile_over_a_port_agent():
    out = {}
    for P in ("ref", "port"):
        pl = Plane(P, engine=False, agent=True)
        try:
            status = pl.call("POST", "/v1/completions", {
                "model": "tiny-llama", "prompt": "fleet", "max_tokens": 8,
                "temperature": 0.0})[0]
            agent = pl.engines[0]
            rid = _root_request(pl)

            def fleet():
                return body(pl, f"/admin/trace?request_id={rid}"
                                "&scope=fleet")[2]
            assert wait_until(lambda: any(
                s["point"] == "engine.decode" for s in fleet()["spans"]),
                timeout=10)
            tr = fleet()
            root = [n for n in tr["tree"]]
            assert len(root) == 1 and root[0]["point"] == "frontend.request"

            def points(node):
                return [node["point"]] + sorted(
                    p for c in node.get("children", ()) for p in points(c))
            prof = body(pl, "/admin/profile?scope=fleet")[2]
            out[P] = (status, points(root[0]),
                      {norm_str(a): v for a, v in tr["peers"].items()},
                      prof["peers"] == {agent.name: {"role": "engine",
                                                     "status": "ok"}},
                      sorted(prof))
        finally:
            pl.close()
    assert out["port"] == out["ref"]
    assert any(p.startswith("engine.") for p in out["port"][1])
    assert out["port"][3]
