"""The port's fake engine (``xllm_service_tpu_torch/testing/fake_engine.py``)
against the JAX package's, on the CPU.

Each fake engine registers in its own package's in-process store, next to
a stub master of the standard library that records what reaches it
(``/rpc/heartbeat``, ``/rpc/telemetry``, ``/rpc/generations``) and answers
as the reference master does. The same dispatches go to both engines, and
these must be equal once the engine's own name, incarnation and times are
taken out: the registration record, the heartbeats (in ``master``,
``owner`` and ``mux`` telemetry mode, with their KV events), the framing of
the Generations (batching, ``delta_seq``, usage), a resume from
``resume_generated_token_ids``, a drain mid-stream (``/rpc/drain``), the
scripted faults (``engine.token`` crash, ``engine.accept`` error and drop,
``engine.heartbeat`` silence), the modeled PD handoff, the capacity model
and ``/health``, ``/v1/models``, ``/metrics``, ``/admin/topology`` and the
trace routes.

Each package's master then serves each package's fake engine: the four
pairs give equal SSE bodies and JSON bodies.
"""

import http.client
import importlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

PKGS = {"ref": "xllm_service_tpu", "port": "xllm_service_tpu_torch"}
REPLY = "The fake engine speaks in chunks of four characters."
BLOCK = 16


def mod(P, name):
    return importlib.import_module(f"{PKGS[P]}.{name}")


class StubMaster:
    """Records the engine-facing routes; ``alive`` answers the
    Generations' alive map (a False stops the stream)."""

    def __init__(self):
        self.beats, self.telemetry, self.gens = [], [], []
        self.alive = True
        self.lock = threading.Lock()
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"     # kept alive, as a master

            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = mod("port", "rpc.wire").decode_body(
                    self.headers.get("Content-Type", "").split(";")[0],
                    self.rfile.read(n))
                resp = {"ok": True}
                with stub.lock:
                    if self.path == "/rpc/heartbeat":
                        stub.beats.append(body)
                    elif self.path == "/rpc/generations":
                        stub.gens.extend(body["gens"])
                        resp = {"alive": {g["service_request_id"]: stub.alive
                                          for g in body["gens"]}}
                    elif self.path == "/rpc/telemetry":
                        stub.telemetry.append(body["frames"])
                        alive, dest_ok = {}, {}
                        for fr in body["frames"]:
                            if fr["t"] == "hb":
                                stub.beats.append(fr["d"])
                            else:
                                stub.gens.extend(fr["d"]["gens"])
                                dest_ok[fr["dest"]] = True
                                alive.update(
                                    {g["service_request_id"]: stub.alive
                                     for g in fr["d"]["gens"]})
                        resp = {"ok": True, "dest_ok": dest_ok,
                                "alive": alive}
                data = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.srv.server_port}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


class Rig:
    """A stub master and one package's fake engine on that package's
    store (the stub is the elected master and the only service member)."""

    def __init__(self, P, **cfg):
        self.P = P
        memory = mod(P, "coordination.memory")
        fe = mod(P, "testing.fake_engine")
        rpc = mod(P, "rpc")
        self.FAULTS = mod(P, "common.faults").FAULTS
        self.FAULTS.clear()
        self.store = memory.MemoryStore(expiry_tick_s=0.02)
        self.coord = memory.InMemoryCoordination(self.store)
        self.master = StubMaster()
        self.coord.set(rpc.MASTER_KEY, self.master.addr)
        self.coord.set(rpc.SERVICE_KEY_PREFIX + self.master.addr,
                       json.dumps({"rpc_address": self.master.addr}))
        self.rpc = rpc
        self.engine = fe.FakeEngine(
            memory.InMemoryCoordination(self.store), fe.FakeEngineConfig(**{
                **dict(reply_text=REPLY, chunk_size=4, block_size=BLOCK,
                       heartbeat_interval_s=0.05, lease_ttl_s=1.0),
                **cfg})).start()

    def key(self):
        return self.rpc.instance_key(self.engine.instance_type.value,
                                     self.engine.name)

    def post(self, path, body, timeout=10):
        c = http.client.HTTPConnection("127.0.0.1", self.engine.port,
                                       timeout=timeout)
        try:
            c.request("POST", path, body=json.dumps(body),
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            return r.status, r.read().decode()
        finally:
            c.close()

    def get(self, path):
        c = http.client.HTTPConnection("127.0.0.1", self.engine.port,
                                       timeout=10)
        try:
            c.request("GET", path)
            r = c.getresponse()
            return r.status, r.getheader("Content-Type"), r.read().decode()
        finally:
            c.close()

    def dispatch(self, sid, token_ids=(1, 2, 3), **kw):
        return self.post("/v1/completions", dict(
            service_request_id=sid, request_id=sid,
            source_service_addr=self.master.addr,
            token_ids=list(token_ids), **kw))

    def gens_of(self, sid):
        with self.master.lock:
            return [g for g in self.master.gens
                    if g["service_request_id"] == sid]

    def finished(self, sid):
        return any(g["finished"] for g in self.gens_of(sid))

    def close(self):
        self.FAULTS.clear()
        self.engine.stop()
        self.master.close()
        self.store.close()


def clean_gens(rig, sid):
    out = []
    for g in rig.gens_of(sid):
        assert g.pop("instance") == rig.engine.name
        assert g.pop("incarnation") == rig.engine.incarnation_id
        out.append(g)
    return out


def both(scenario, **cfg):
    outs = {}
    for P in ("ref", "port"):
        rig = Rig(P, **cfg)
        try:
            outs[P] = scenario(rig)
        finally:
            rig.close()
    assert outs["port"] == outs["ref"], (outs["port"], outs["ref"])
    return outs["port"]


# ------------------------------------------------------------ registration
def sc_registration(rig):
    meta = json.loads(rig.coord.get(rig.key()))
    assert meta.pop("name") == meta.pop("rpc_address") == rig.engine.name
    assert meta.pop("incarnation_id") == rig.engine.incarnation_id
    assert meta["topology"].pop("host_addrs") == [rig.engine.name]
    meta.pop("register_ts_ms")
    return meta


def test_registration_record_matches_reference():
    meta = both(sc_registration)
    assert meta["type"] == "MIX" and meta["models"] == ["fake-model"]
    assert meta["wire_formats"] == ["msgpack", "json"]


# -------------------------------------------------------------- heartbeats
def sc_heartbeats(rig):
    assert rig.dispatch("hb-1", token_ids=range(3 * BLOCK + 5))[0] == 200
    assert wait_until(lambda: rig.finished("hb-1"), timeout=10)

    def stored():
        with rig.master.lock:
            return [b for b in rig.master.beats
                    if (b.get("kv_cache_event") or {}).get("stored")]
    assert wait_until(lambda: stored(), timeout=10)
    beat = dict(stored()[0])
    assert beat.pop("name") == rig.engine.name
    assert beat.pop("incarnation_id") == rig.engine.incarnation_id
    ev = beat.pop("kv_cache_event")
    ev["stored"] = [bytes(k).hex() if isinstance(k, (bytes, bytearray))
                    else k for k in ev["stored"]]
    with rig.master.lock:
        tagged = sorted({fr["t"] for frames in rig.master.telemetry
                         for fr in frames})
    return beat, ev, tagged


@pytest.mark.parametrize("mode", ["master", "owner", "mux"])
def test_heartbeats_match_reference(mode):
    beat, ev, tagged = both(sc_heartbeats, telemetry_mode=mode)
    assert len(ev["stored"]) == 3
    assert set(beat["load_metrics"]) >= {"waiting_requests_num",
                                         "running_requests_num"}
    assert tagged == (["gens", "hb"] if mode == "mux" else [])


# ------------------------------------------------------------- generations
def sc_framing(rig, **kw):
    status, body = rig.dispatch("g-1", token_ids=range(40), **kw)
    assert wait_until(lambda: rig.finished("g-1"), timeout=10)
    time.sleep(0.05)
    return status, json.loads(body), clean_gens(rig, "g-1")


@pytest.mark.parametrize("kw", [{}, {"max_tokens": 5}],
                         ids=["whole", "max_tokens"])
def test_generations_framing_matches_reference(kw):
    status, body, gens = both(lambda r: sc_framing(r, **kw))
    assert status == 200 and body == {"ok": True}
    assert [g["delta_seq"] for g in gens] == list(range(1, len(gens) + 1))
    assert gens[-1]["finished"] and "usage" in gens[-1]
    text = "".join(o["text"] for g in gens for o in g["outputs"])
    assert text == (REPLY if not kw else REPLY[:20])


def test_paced_generations_push_a_delta_each():
    _, _, gens = both(sc_framing, delay_s=0.01)
    assert all(len(g["outputs"]) == 1 for g in gens)


def sc_resume(rig):
    rig.dispatch("r-1", token_ids=list(range(10)) + [0, 1, 2],
                 resume_generated_token_ids=[0, 1, 2])
    rig.dispatch("r-2", token_ids=list(range(10)),
                 resume_generated_token_ids=list(range(99)))
    assert wait_until(lambda: rig.finished("r-1") and rig.finished("r-2"),
                      timeout=10)
    return clean_gens(rig, "r-1"), clean_gens(rig, "r-2")


def test_resume_continues_after_the_replayed_prefix():
    resumed, done = both(sc_resume)
    outs = [o for g in resumed for o in g["outputs"]]
    assert outs[0]["token_ids"] == [3]
    assert "".join(o["text"] for o in outs) == REPLY[12:]
    assert len(done) == 1 and done[0]["finished"]


def sc_stop_by_master(rig):
    rig.master.alive = False
    rig.dispatch("s-1")
    assert wait_until(lambda: ("stopped", "s-1") in rig.engine.stop_log,
                      timeout=10)
    return clean_gens(rig, "s-1"), list(rig.engine.stop_log)


def test_master_stop_ends_the_stream():
    gens, log = both(sc_stop_by_master)
    assert len(gens) == 1 and log == [("stopped", "s-1")]


# ------------------------------------------------------------------- drain
def sc_drain(rig):
    rig.dispatch("d-1")
    assert wait_until(lambda: rig.gens_of("d-1"), timeout=10)
    status, body = rig.post("/rpc/drain", {})
    draining = json.loads(rig.coord.get(rig.key()) or "{}").get("draining")
    refused = rig.dispatch("d-2")
    assert wait_until(lambda: rig.finished("d-1"), timeout=10)
    assert wait_until(lambda: rig.coord.get(rig.key()) is None, timeout=10)
    text = "".join(o["text"] for g in rig.gens_of("d-1")
                   for o in g["outputs"])
    return status, json.loads(body), draining, refused, text


def test_drain_refuses_new_work_and_finishes_the_stream():
    status, body, draining, refused, text = both(sc_drain, delay_s=0.02)
    assert (status, body) == (200, {"ok": True, "draining": True})
    assert draining is True and refused[0] == 503 and text == REPLY


# ------------------------------------------------------------------ faults
def sc_faults(rig):
    F = rig.FAULTS
    F.configure([{"point": "engine.token", "action": "crash", "after": 0,
                  "match": {"n": 3}}])
    rig.dispatch("f-crash")
    assert wait_until(lambda: not rig.engine._alive, timeout=10)
    crash = clean_gens(rig, "f-crash")
    gone = wait_until(lambda: rig.coord.get(rig.key()) is None, timeout=10)
    F.clear()
    return crash, gone, rig.engine.healthy


def test_token_crash_fault_kills_after_the_emitted_tokens():
    crash, gone, healthy = both(sc_faults)
    assert [o["token_ids"] for g in crash for o in g["outputs"]] == \
        [[0], [1], [2]]
    assert gone and healthy is False


def sc_accept_faults(rig):
    F = rig.FAULTS
    F.configure([{"point": "engine.accept", "action": "error",
                  "max_fires": 1}])
    err = rig.dispatch("a-err")
    F.configure([{"point": "engine.accept", "action": "drop",
                  "max_fires": 1}])
    drop = rig.dispatch("a-drop")
    time.sleep(0.2)
    F.clear()
    ok = rig.dispatch("a-ok")
    assert wait_until(lambda: rig.finished("a-ok"), timeout=10)
    return (err, drop, rig.gens_of("a-err"), rig.gens_of("a-drop"),
            len(rig.engine.accepted_requests))


def test_accept_faults_error_and_drop():
    err, drop, g_err, g_drop, accepted = both(sc_accept_faults)
    assert err == [503, "fault injected"] or err == (503, "fault injected")
    assert drop[0] == 200 and g_err == g_drop == [] and accepted == 2


def sc_silence(rig):
    before = rig.coord.get(rig.key()) is not None
    rig.FAULTS.configure([{"point": "engine.heartbeat",
                           "action": "silence"}])
    gone = wait_until(lambda: rig.coord.get(rig.key()) is None, timeout=10)
    rig.FAULTS.clear()
    back = wait_until(lambda: rig.coord.get(rig.key()) is not None,
                      timeout=10)
    return before, gone, back


def test_heartbeat_silence_releases_the_lease():
    assert both(sc_silence) == (True, True, True)


def sc_drills(rig):
    out = []
    rig.engine.pause()
    out.append(wait_until(lambda: rig.coord.get(rig.key()) is None,
                          timeout=10))
    rig.engine.resume()
    out.append(rig.coord.get(rig.key()) is not None)
    rig.engine.set_unhealthy()
    out.append(rig.get("/health")[0])
    rig.engine.kill()
    out.append((wait_until(lambda: rig.coord.get(rig.key()) is None,
                           timeout=10), rig.engine._alive))
    return out


def test_pause_resume_unhealthy_kill():
    assert both(sc_drills) == [True, True, 503, (True, False)]


# --------------------------------------------------- capacity and handoff
def sc_capacity(rig):
    """c-0 starts at once; c-1 waits out the service interval in the
    dispatcher; c-2 fills the one-slot accept queue; c-3 is refused."""
    statuses = [rig.dispatch("c-0")[0]]
    assert wait_until(lambda: rig.gens_of("c-0"), timeout=10)
    statuses.append(rig.dispatch("c-1")[0])
    assert wait_until(lambda: rig.engine._svc_queue.qsize() == 0, timeout=10)
    statuses += [rig.dispatch(f"c-{i}")[0] for i in (2, 3)]
    return statuses, rig.engine.rejected_overload, list(rig.engine.stop_log)


def test_service_rate_and_accept_queue():
    statuses, rejected, log = both(sc_capacity, service_rate_rps=1.0,
                                   accept_queue_limit=1)
    assert statuses == [200, 200, 200, 503] and rejected == 1
    assert log == [("overload", "c-3")]


def sc_handoff(rig):
    T = mod(rig.P, "common.types")
    peer = T.InstanceMetaInfo(
        name="10.0.0.9:1", rpc_address="10.0.0.9:1", type=T.InstanceType.DECODE,
        topology=T.TpuTopology(slice_id="other", host="h9", chip=0))
    rig.coord.set(rig.rpc.instance_key("DECODE", peer.name), peer.to_json())
    rig.dispatch("h-1", token_ids=range(64),
                 routing={"prefill_name": rig.engine.name,
                          "decode_name": peer.name})
    assert wait_until(lambda: rig.finished("h-1"), timeout=10)
    status, _, body = rig.get("/admin/topology")
    topo = json.loads(body)
    assert topo.pop("name") == rig.engine.name
    return status, topo


def test_modeled_pd_handoff():
    status, topo = both(sc_handoff, kv_handoff_bytes_per_token=1024,
                        dcn_bytes_per_s=1e7, topo_host="h1", topo_chip=0)
    assert status == 200 and topo["handoff_counts"] == {"dcn": 1}


# ------------------------------------------------------------- the surface
def sc_surface(rig):
    rig.dispatch("m-1", trace_context={"trace_id": "t" * 32,
                                       "span_id": "s" * 16})
    assert wait_until(lambda: rig.finished("m-1"), timeout=10)
    out = {}
    for path in ("/health", "/v1/models", "/metrics"):
        status, ctype, body = rig.get(path)
        out[path] = (status, ctype.split(";")[0], body)
    # Connects depend on how the heartbeat and stream threads interleave
    # on the pool (and the reference counts pooled connection objects).
    metrics = out["/metrics"][2].splitlines()
    made = [ln for ln in metrics
            if ln.startswith("engine_telemetry_connections_created ")]
    assert len(made) == 1 and int(made[0].split()[1]) >= 1
    out["/metrics"] = out["/metrics"][:2] + ("\n".join(
        ln for ln in metrics if ln not in made),)
    # The decode span ends just after the last delta is pushed.
    def trace():
        status, _, body = rig.get("/admin/trace?trace_id=" + "t" * 32)
        spans = json.loads(body)["spans"] if status == 200 else []
        return status, sorted(s["point"] for s in spans)
    wait_until(lambda: len(trace()[1]) == 3, timeout=10)
    out["trace"] = trace()
    status, _, body = rig.get("/admin/trace/recent?limit=50")
    out["recent"] = status
    status, ctype, _ = rig.get("/admin/profile?format=folded")
    out["profile"] = (status, ctype.split(";")[0])
    for link in (("/rpc/link", {"peer": {"name": "x:1"}}),
                 ("/rpc/unlink", {"peer_name": "x:1"}),
                 ("/rpc/cancel", {"service_request_id": "zzz"}),
                 ("/rpc/flip_role", {"type": "DECODE"})):
        out[link[0]] = rig.post(*link)
    out["state"] = (rig.engine.links, rig.engine.unlinks,
                    sorted(rig.engine.cancelled),
                    rig.engine.instance_type.value)
    return out


def test_engine_surface_matches_reference():
    out = both(sc_surface)
    assert out["trace"] == (200, ["engine.decode", "engine.prefill",
                                  "kv_transfer.offer"])
    assert out["state"] == (["x:1"], ["x:1"], ["zzz"], "DECODE")


# --------------------------------------------- each master, each fake engine
def serve_pair(master_pkg, engine_pkg):
    memory = mod(master_pkg, "coordination.memory")
    Options = mod(master_pkg, "common.config").ServiceOptions
    Master = mod(master_pkg, "master").Master
    fe = mod(engine_pkg, "testing.fake_engine")
    store = memory.MemoryStore(expiry_tick_s=0.02)
    m = Master(Options(host="127.0.0.1", http_port=0, rpc_port=0,
                       lease_ttl_s=0.5, sync_interval_s=0.2,
                       brownout_enabled=False),
               coord=memory.InMemoryCoordination(store))
    m.start()
    # The engine reaches the master's store through its own package's
    # client of the same in-process store type.
    e_memory = mod(engine_pkg, "coordination.memory")
    e_store = store if engine_pkg == master_pkg else None
    bridge = None
    if e_store is None:
        server = mod(master_pkg, "coordination.server").CoordinationServer(
            host="127.0.0.1", port=0, store=store)
        server.start_background()
        bridge = server
        ecoord = mod(engine_pkg, "coordination.client").TcpCoordinationClient(
            f"127.0.0.1:{server.port}")
    else:
        ecoord = e_memory.InMemoryCoordination(store)
    e = fe.FakeEngine(ecoord, fe.FakeEngineConfig(
        reply_text=REPLY, chunk_size=4, heartbeat_interval_s=0.1,
        lease_ttl_s=0.5)).start()
    try:
        assert wait_until(lambda: m.scheduler.instance_mgr.get_instance_meta(
            e.name) is not None, timeout=15)
        out = []
        for stream in (False, True):
            c = http.client.HTTPConnection("127.0.0.1", m.http_port,
                                           timeout=30)
            c.request("POST", "/v1/completions", body=json.dumps({
                "model": "fake-model", "prompt": "pair", "max_tokens": 100,
                "stream": stream}), headers={"Content-Type":
                                            "application/json"})
            r = c.getresponse()
            body = r.read()
            c.close()
            if stream:
                frames = [f for f in body.split(b"\n\n") if f]
                out.append([f.decode() if f == b"data: [DONE]"
                            else scrub(json.loads(f[6:])) for f in frames])
            else:
                out.append(scrub(json.loads(body)))
        return out
    finally:
        e.stop()
        m.stop()
        if bridge is not None:
            ecoord.close()
            bridge.stop()
        store.close()


def scrub(obj):
    if isinstance(obj, dict):
        return {k: (None if k in ("id", "created") else scrub(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


@pytest.mark.parametrize("master_pkg,engine_pkg", [
    ("ref", "port"), ("port", "ref"), ("port", "port")])
def test_each_master_serves_each_fake_engine_alike(master_pkg, engine_pkg):
    want = serve_pair("ref", "ref")
    got = serve_pair(master_pkg, engine_pkg)
    assert got == want
    assert "".join(f["choices"][0]["text"] for f in got[1][:-1]) == REPLY
