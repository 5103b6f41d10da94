"""The port's engine agent alone, against a stub master of the standard
library (and, for its pure pieces, against the reference's): request
parsing, the streamer's delivery semantics, the n-choice aggregator, the
routes it serves and the ones it refuses, registration and role changes,
the wire forms of its records, the engine's admission order and its
embeddings."""

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import requests
import torch

from xllm_service_tpu.common import request as ref_request
from xllm_service_tpu.common.types import InstanceMetaInfo as RefMeta
from xllm_service_tpu.common.types import KvCacheEvent as RefKvCacheEvent
from xllm_service_tpu.engine import agent as ref_agent
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu_torch.common import request as port_request
from xllm_service_tpu_torch.common.hashing import prefix_block_hashes
from xllm_service_tpu_torch.common.net import pick_free_port
from xllm_service_tpu_torch.common.types import (
    InstanceMetaInfo,
    InstanceType,
    KvCacheEvent,
    now_ms,
)
from xllm_service_tpu_torch.coordination.memory import (
    InMemoryCoordination,
    MemoryStore,
)
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.engine import agent as port_agent
from xllm_service_tpu_torch.models import llama
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.rpc import MASTER_KEY, instance_key, wire
from xllm_service_tpu_torch.tokenizer.factory import TokenizerFactory
from xllm_service_tpu_torch.tokenizer.simple import SimpleTokenizer

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=256)
EMBED_TOL = 1e-5   # f32 on both sides; measured at most 1.6e-6


class StubMaster:
    """Takes /rpc/generations and /rpc/heartbeat as the master does, in
    msgpack (read with the msgpack package) or JSON, and answers ``{"ok":
    true, "alive": {...}}``. It has no /rpc/telemetry (404): an agent in
    the default mux mode demotes itself to these per-endpoint routes, as
    against a master that predates the multiplexed session."""

    def __init__(self):
        self.gens: list = []
        self.heartbeats: list = []
        self.alive: dict = {}
        self.telemetry_posts = 0
        self.hold = None      # an Event: heartbeats answer once it is set
        self.held = 0
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                data = self.rfile.read(n)
                if self.path == "/rpc/telemetry":
                    stub.telemetry_posts += 1
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if "msgpack" in self.headers.get("Content-Type", ""):
                    body = msgpack.unpackb(data, raw=False)
                else:
                    body = json.loads(data)
                if self.path == "/rpc/generations":
                    stub.gens.extend(body["gens"])
                else:
                    stub.heartbeats.append(body)
                    if stub.hold is not None:      # a slow answer
                        stub.held += 1
                        stub.hold.wait(10)
                data = json.dumps({"ok": True,
                                   "alive": dict(stub.alive)}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class FakeEngine:
    def __init__(self):
        self.cancelled: list = []

    def cancel(self, sid):
        self.cancelled.append(sid)


@pytest.fixture
def master():
    m = StubMaster()
    yield m
    m.close()


def _agent(store, **kw):
    ecfg = EngineConfig(model=tiny_config(dtype=torch.float32,
                                          max_context_len=256), **ENGINE_KW)
    cfg = port_agent.AgentConfig(heartbeat_interval_s=0.1, lease_ttl_s=1.0,
                                 **kw)
    return port_agent.EngineAgent(ecfg, cfg, coord=InMemoryCoordination(store),
                                  device="cpu")


@pytest.fixture
def agent(master):
    store = MemoryStore(expiry_tick_s=0.02)
    InMemoryCoordination(store).set(MASTER_KEY, master.addr)
    a = _agent(store).start()
    yield a
    a.stop()
    store.close()


def _post(agent, path, body, ctype="application/json"):
    return requests.post(f"http://{agent.name}{path}",
                         data=json.dumps(body).encode(),
                         headers={"Content-Type": ctype}, timeout=30)


# ------------------------------------------------------- request parsing
SAMPLING_BODIES = [
    {},
    {"max_tokens": 7, "temperature": 0, "top_p": 0.5, "top_k": 20},
    {"max_completion_tokens": 9, "n": 3, "seed": 11},
    {"stop": "x", "stop_token_ids": [5, 6], "ignore_eos": True},
    {"stop": ["a", 2], "frequency_penalty": 0.5, "presence_penalty": -0.5,
     "repetition_penalty": 1.2},
    {"logprobs": True, "top_logprobs": 3},
    {"logprobs": 4},
    {"logprobs": 0},
    {"logit_bias": {"17": 2.5, "3": -100}},
    {"logit_bias": {"x": 1}},
]


@pytest.mark.parametrize("body", SAMPLING_BODIES)
def test_sampling_from_body_matches_reference(body):
    got = port_agent.EngineAgent._sampling_from_body(body)
    want = ref_agent.EngineAgent._sampling_from_body(body)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_request.SamplingParams.from_dict(
        json.loads(json.dumps(got.to_dict()))) == got


# -------------------------------------------------------------- streamer
def _delta(mod, sid, token, finished=False, index=0, usage=None):
    return mod.RequestOutput(
        service_request_id=sid, request_id=sid, finished=finished,
        outputs=[mod.SequenceOutput(index=index, token_ids=[token])],
        usage=usage)


def test_delta_seq_in_order_under_concurrent_pushes(master):
    streamer = port_agent.GenerationStreamer(FakeEngine(), flush_ms=1.0)
    streamer.instance_name, streamer.incarnation = "eng:1", "inc-7"
    n_threads, per_thread = 8, 40

    def pusher():
        for i in range(per_thread):
            streamer.push(master.addr, _delta(port_request, "c", i))

    threads = [threading.Thread(target=pusher) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    streamer.push(master.addr, _delta(port_request, "c", 0, finished=True))
    total = n_threads * per_thread + 1
    assert wait_until(lambda: len(master.gens) == total, timeout=10)
    streamer.stop()
    assert [g["delta_seq"] for g in master.gens] == list(range(1, total + 1))
    assert {(g["instance"], g["incarnation"]) for g in master.gens} == \
        {("eng:1", "inc-7")}


def test_dead_destination_is_retried_then_cancelled():
    engine = FakeEngine()
    streamer = port_agent.GenerationStreamer(engine, flush_ms=1.0)
    dead = f"127.0.0.1:{pick_free_port()}"
    streamer.push(dead, _delta(port_request, "x", 1))
    streamer.push(dead, _delta(port_request, "x", 2))
    assert wait_until(lambda: "x" in engine.cancelled, timeout=10)
    streamer.stop()
    assert streamer.direct_sends == streamer.FLUSH_RETRIES + 1


def test_request_not_alive_is_cancelled(master):
    engine = FakeEngine()
    streamer = port_agent.GenerationStreamer(engine, flush_ms=1.0)
    master.alive = {"y": False, "z": True}
    streamer.push(master.addr, _delta(port_request, "y", 1))
    assert wait_until(lambda: engine.cancelled == ["y"], timeout=10)
    streamer.stop()
    assert master.gens[0]["service_request_id"] == "y"


def test_choice_aggregator_matches_reference():
    script = [(0, 1, False, None), (1, 2, False, None), (1, 3, True, (5, 2)),
              (0, 4, False, None), (0, 5, True, (5, 3))]
    pushed = {}
    for mod, agg_cls in ((port_request, port_agent._ChoiceAggregator),
                         (ref_request, ref_agent._ChoiceAggregator)):
        out: list = []
        agg = agg_cls(2, lambda o, out=out: out.append(o.to_dict()))
        for index, token, finished, usage in script:
            agg.callback_for(index)(_delta(
                mod, "n", token, finished=finished,
                usage=mod.Usage(*usage) if usage else None))
        pushed[mod] = out
    assert pushed[port_request] == pushed[ref_request]
    assert [o["finished"] for o in pushed[port_request]] == \
        [False] * 4 + [True]
    assert pushed[port_request][-1]["usage"] == {
        "num_prompt_tokens": 5, "num_generated_tokens": 5}


# ----------------------------------------------------------------- routes
def test_accept_streams_stamped_deltas_and_heartbeats(agent, master):
    r = _post(agent, "/v1/completions", {
        "service_request_id": "s1", "token_ids": list(range(10, 80)),
        "max_tokens": 6, "temperature": 0, "ignore_eos": True,
        "source_service_addr": master.addr})
    assert r.status_code == 200 and r.json()["service_request_id"] == "s1"
    assert wait_until(lambda: any(g["finished"] for g in master.gens),
                      timeout=30)
    gens = [g for g in master.gens if g["service_request_id"] == "s1"]
    assert [g["delta_seq"] for g in gens] == list(range(1, len(gens) + 1))
    assert all(g["instance"] == agent.name
               and g["incarnation"] == agent.incarnation_id for g in gens)
    assert sum(len(g["outputs"][0]["token_ids"]) for g in gens) == 6
    assert gens[-1]["usage"]["num_generated_tokens"] == 6
    # The 70-token prompt fills two 32-token hash blocks: a later beat
    # carries them as hex, with the load and the window's latency.
    assert wait_until(lambda: any(
        len(h["kv_cache_event"]["stored"]) == 2 for h in master.heartbeats),
        timeout=10)
    beat = next(h for h in master.heartbeats
                if h["kv_cache_event"]["stored"])
    assert beat["name"] == agent.name
    assert beat["latency_metrics"]["recent_max_ttft"] > 0
    assert set(beat["load_metrics"]) == {
        "waiting_requests_num", "running_requests_num",
        "hbm_cache_usage_perc"}


def test_bad_dispatches_are_refused(agent, master):
    body = {"token_ids": [5, 6, 7], "max_tokens": 2}
    assert _post(agent, "/v1/completions", body).status_code == 400
    body["source_service_addr"] = master.addr
    # A body marked msgpack that is not (here: JSON text) is malformed.
    assert _post(agent, "/v1/completions", body,
                 ctype=wire.MSGPACK_CONTENT_TYPE).status_code == 400
    r = _post(agent, "/v1/completions",
              dict(body, deadline_ms=now_ms() - 1000))
    assert r.status_code == 504
    for path in ("/rpc/cancel", "/v1/embeddings"):
        r = requests.post(f"http://{agent.name}{path}", data=b"{",
                          timeout=30)
        assert r.status_code == 400
    assert not master.gens


@pytest.mark.parametrize("path,body,status", [
    ("/rpc/encode", {}, 400),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "what is this"},
        {"type": "image_url", "image_url": {"url": "data:,"}}]}],
        "max_tokens": 2}, 200),
])
def test_multimodal_routes_on_a_text_family(agent, master, path, body,
                                            status):
    """A text family answers the encode route 400 (it has no vision
    encoder) and serves an image chat as text, image parts unread, as the
    reference agent does."""
    r = _post(agent, path, dict(body, source_service_addr=master.addr))
    assert r.status_code == status, r.text
    if status == 400:
        assert "has no vision encoder" in r.json()["error"]
    else:
        sid = r.json()["service_request_id"]
        assert wait_until(lambda: any(
            g["finished"] and g["service_request_id"] == sid
            for g in master.gens), timeout=30)
        master.gens.clear()


@pytest.mark.parametrize("path", ["/rpc/kv_transfer", "/rpc/kv_stream_pull"])
def test_pd_routes_refuse_a_bad_frame(agent, path):
    """The PD routes are served: a body that is no msgpack frame is a 400,
    as the reference answers it."""
    r = requests.post(f"http://{agent.name}{path}", data=b"\xc1",
                      headers={"Content-Type": "application/msgpack"},
                      timeout=30)
    assert r.status_code == 400 and "bad" in r.json()["error"]


def test_prefill_role_refuses_a_decode_handoff(master):
    """A PREFILL agent routed a decode peer it cannot reach prefills, fails
    the handoff on every path and reports it to the service as
    UNAVAILABLE (the reference's behaviour); nothing else streams."""
    store = MemoryStore(expiry_tick_s=0.02)
    a = _agent(store, instance_type=InstanceType.PREFILL).start()
    try:
        body = {"token_ids": [5, 6, 7], "max_tokens": 2,
                "source_service_addr": master.addr}
        r = _post(a, "/v1/completions",
                  dict(body, service_request_id="pd-1",
                       routing={"decode_name": "127.0.0.1:1"}))
        assert r.status_code == 200
        assert wait_until(lambda: master.gens, timeout=30)
        (g,) = master.gens
        assert g["service_request_id"] == "pd-1" and g["finished"]
        assert g["status"]["code"] == int(port_request.StatusCode.UNAVAILABLE)
        assert not g["outputs"]
        assert a.kv_host_sent == a.kv_device_sent == 0
        master.gens.clear()
        # Without a routed decode peer it serves the request itself.
        assert _post(a, "/v1/completions", body).status_code == 200
        assert wait_until(lambda: any(g["finished"] for g in master.gens),
                          timeout=30)
    finally:
        a.stop()
        store.close()


def test_flip_role_link_and_drain(agent, master):
    store = agent.coord.store
    mix = instance_key("MIX", agent.name)
    assert json.loads(store.get(mix))["type"] == "MIX"
    assert _post(agent, "/rpc/flip_role", {"type": "DECODE"}).ok
    assert store.get(mix) is None
    meta = InstanceMetaInfo.from_json(
        store.get(instance_key("DECODE", agent.name)))
    assert meta.type == InstanceType.DECODE

    peer = dataclasses.replace(agent.meta(), name="127.0.0.1:9")
    r = _post(agent, "/rpc/link", {"peer": json.loads(
        dataclasses.replace(peer, num_layers=3).to_json())})
    assert r.status_code == 409 and "num_layers" in r.json()["error"]
    assert _post(agent, "/rpc/link",
                 {"peer": json.loads(peer.to_json())}).ok
    assert "127.0.0.1:9" in agent.linked_peers
    assert _post(agent, "/rpc/unlink", {"peer_name": "127.0.0.1:9"}).ok
    assert not agent.linked_peers

    key = instance_key("DECODE", agent.name)
    assert _post(agent, "/rpc/drain", {}).json()["draining"]
    assert wait_until(lambda: store.get(key) is not None and json.loads(
        store.get(key))["draining"], timeout=5)
    # Idle: the drain stops the agent after its grace window.
    assert wait_until(lambda: agent._stopped, timeout=10)
    assert store.get(key) is None


def test_cancel_route_stops_a_request(agent, master):
    body = {"service_request_id": "long", "token_ids": [5, 6, 7],
            "max_tokens": 200, "temperature": 0, "ignore_eos": True,
            "source_service_addr": master.addr}
    assert _post(agent, "/v1/completions", body).ok
    assert wait_until(lambda: master.gens, timeout=30)
    assert _post(agent, "/rpc/cancel", {"service_request_id": "long"}).ok
    assert wait_until(lambda: any(g["finished"] for g in master.gens),
                      timeout=30)
    last = master.gens[-1]
    assert last["status"]["code"] != 0 or last["finished"]
    assert sum(len(o["token_ids"]) for g in master.gens
               for o in g["outputs"]) < 200


def test_models_health_and_stats(agent):
    base = f"http://{agent.name}"
    assert requests.get(base + "/health", timeout=5).json() == \
        {"status": "ok"}
    assert requests.get(base + "/v1/models", timeout=5).json()["data"][0][
        "id"] == "tiny-llama"
    stats = requests.get(base + "/stats", timeout=5).json()
    # The default mux mode demoted itself against the stub's 404.
    assert stats["dp_size"] == 1 and stats["telemetry"]["mode"] in (
        "mux", "master")
    assert requests.get(base + "/nope", timeout=5).status_code == 404


# ----------------------------------------------------------- wire forms
def test_instance_meta_parses_with_the_reference(agent):
    mine = agent.meta()
    assert mine.wire_formats == ["msgpack", "json"]
    assert mine.topology.mesh_shape == [1]
    theirs = RefMeta.from_json(mine.to_json())
    assert json.loads(theirs.to_json()) == json.loads(mine.to_json())
    assert InstanceMetaInfo.from_json(theirs.to_json()) == mine


def test_kv_cache_event_to_dict_matches_reference():
    hashes = prefix_block_hashes(list(range(300)), 32)
    lists = dict(stored=hashes[:3], removed=[h.hex() for h in hashes[3:5]],
                 offloaded=hashes[5:])
    assert KvCacheEvent(**lists).to_dict() == \
        RefKvCacheEvent(**lists).to_dict()


def test_stop_waits_for_a_beat_in_flight(master):
    """An agent stopped while a heartbeat's POST is in flight evicts its
    master's heartbeat series only after that beat has ended: the late
    write would otherwise re-create the evicted series."""
    from xllm_service_tpu_torch.common.metrics import ENGINE_HEARTBEATS_TOTAL

    store = MemoryStore(expiry_tick_s=0.02)
    InMemoryCoordination(store).set(MASTER_KEY, master.addr)
    a = _agent(store).start()
    try:
        assert wait_until(lambda: master.heartbeats, timeout=10)
        master.hold = threading.Event()
        assert wait_until(lambda: master.held, timeout=10)
        beat = next(t for t in a._threads if t.name == "agent-heartbeat")
        threading.Timer(0.3, master.hold.set).start()
        a.stop()
        assert wait_until(lambda: not beat.is_alive(), timeout=10)
        assert (master.addr,) not in ENGINE_HEARTBEATS_TOTAL._children
    finally:
        master.hold.set()
        a.stop()
        store.close()


def test_kept_alive_replies_do_not_wait_on_nagle(agent):
    """A reply goes out in two writes; without TCP_NODELAY each request
    after the first on a kept-alive connection (the master's client keeps
    them) waits for the delayed ACK, about 40 ms on Linux. Ten requests on
    one connection stay well under the 400 ms that would cost."""
    with requests.Session() as s:
        assert s.get(f"http://{agent.name}/health", timeout=30).ok
        t = time.monotonic()
        for _ in range(10):
            assert s.get(f"http://{agent.name}/health", timeout=30).ok
        assert time.monotonic() - t < 0.2


def test_json_wire_only():
    """The JSON format is the default of ``encode_dispatch``; a body marked
    msgpack is parsed as msgpack, and a malformed one raises ValueError."""
    body, ctype = wire.encode_dispatch({"a": [1, 2]})
    assert ctype == wire.JSON_CONTENT_TYPE
    assert wire.decode_body(ctype, body) == {"a": [1, 2]}
    assert wire.decode_body(wire.MSGPACK_CONTENT_TYPE, b"\x80") == {}
    with pytest.raises(ValueError):
        wire.decode_body(wire.MSGPACK_CONTENT_TYPE, b"\x81")


def test_shared_telemetry_pool_keeps_threads_apart():
    """The heartbeat and streamer threads share one kept-alive pool: many
    threads posting at once each get their own reply (no two share a
    connection mid-request), the pool holds one destination, and it
    keeps at most its bound of idle connections."""
    import sys

    class Echo(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            data = self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Echo)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    dest = f"127.0.0.1:{server.server_address[1]}"
    pool = port_agent._Connections(timeout_s=10.0)
    bad: list = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(i):
            for j in range(25):
                body = f"{i}:{j}".encode()
                status, data = pool.post(dest, "/x", body, "text/plain")
                if (status, data) != (200, body):
                    bad.append((status, data, body))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = pool.stats()
        idle = len(pool._pools[dest][0])
    finally:
        sys.setswitchinterval(interval)
        pool.close()
        server.shutdown()
        server.server_close()
    assert not bad
    assert stats["hosts"] == 1 and stats["connections_created"] >= 1
    assert idle <= pool.MAX_PER_HOST and pool.stats()["hosts"] == 0


def test_tokenizer_factory():
    assert isinstance(TokenizerFactory.create_tokenizer(""), SimpleTokenizer)
    # A path with no tokenizer falls through to the byte tokenizer, as the
    # reference's factory does (tests/test_torch_tokenizer.py holds the
    # selection order).
    assert isinstance(TokenizerFactory.create_tokenizer("/models/llama"),
                      SimpleTokenizer)


# ------------------------------------------------------------ entry point
@pytest.mark.parametrize("flag", ["--device-offset", "--tp"])
def test_unported_flags_are_refused(flag, capsys):
    """The two flags this agent once refused are ported (the name stays
    from then): ``--tp`` builds the reference's model-axis mesh and
    ``--device-offset`` places it, with the reference's ``p.error``
    messages for an offset without a mesh and a negative one."""
    args = port_agent._parser().parse_args(
        ["--model-config", "tiny", "--tp", "2", "--device-offset", "2"])
    cfg = port_agent.engine_config(args)
    assert cfg.mesh.shape == (1, 1, 1, 1, 2)
    assert cfg.mesh_device_offset == 2
    argv = (["--device-offset", "2"] if flag == "--device-offset"
            else ["--tp", "2", "--device-offset", "-1"])
    with pytest.raises(SystemExit) as e:
        port_agent.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert ("--device-offset requires --tp > 1 (a mesh to place)" in err
            if flag == "--device-offset"
            else "--device-offset must be >= 0" in err)


@pytest.mark.parametrize("config", ["gemma_tiny", "gemma_2b"])
def test_agent_takes_the_gemma_configs_and_int8(config):
    """The reference agent's gemma configs and ``--quant int8``."""
    from xllm_service_tpu.models import gemma as ref_gemma

    args = port_agent._parser().parse_args(
        ["--model-config", config, "--quant", "int8"])
    cfg = port_agent.engine_config(args)
    want = dataclasses.replace(getattr(ref_gemma, f"{config}_config")(),
                               quant="int8")
    assert cfg.model_family == "gemma" and cfg.model.quant == "int8"
    for f in dataclasses.fields(cfg.model):
        if f.name != "dtype":
            assert getattr(cfg.model, f.name) == getattr(want, f.name)
    assert port_agent.engine_config(port_agent._parser().parse_args(
        ["--model-config", config])).model.quant == ""


def test_int8_gemma_tiny_from_engine_config_gives_the_jax_tokens():
    """``engine_config`` of ``--model-config gemma_tiny --quant int8``
    serves a request with the JAX engine's tokens on the same weights,
    each engine quantizing them itself (f32 on both sides, so that greedy
    tokens compare exactly)."""
    from xllm_service_tpu.models import gemma as ref_gemma
    from test_torch_chunked_prefill import Collector, step_until
    from test_torch_gemma import drawn_tree

    args = port_agent._parser().parse_args(
        ["--model-config", "gemma_tiny", "--quant", "int8",
         "--max-seq-len", "256", "--num-pages", "64"])
    ecfg = port_agent.engine_config(args)
    ecfg = dataclasses.replace(ecfg, model=dataclasses.replace(
        ecfg.model, dtype=torch.float32))
    rcfg = ref_gemma.gemma_tiny_config(dtype=jnp.float32, quant="int8")
    tree = drawn_tree(rcfg)
    port = InferenceEngine(ecfg, device="cpu",
                           params=llama_params_from_jax(tree, device="cpu"))
    ref = RefEngine(RefConfig(
        model=rcfg, model_family="gemma", num_pages=ecfg.num_pages,
        page_size=ecfg.page_size, max_batch_size=ecfg.max_batch_size,
        max_seq_len=ecfg.max_seq_len, prefill_buckets=(32, 64, 256)),
        params=tree)
    toks = []
    for eng, req_cls, sp_cls in ((ref, RefRequest, ref_request.SamplingParams),
                                 (port, EngineRequest,
                                  port_request.SamplingParams)):
        col = Collector()
        eng.submit(req_cls("q", token_ids=list(range(5, 45)),
                           sampling=sp_cls(max_tokens=12, temperature=0.0,
                                           ignore_eos=True),
                           on_output=col))
        step_until(eng, [col])
        eng.stop()
        toks.append(col.tokens)
    assert len(toks[1]) == 12 and toks[1] == toks[0]


@pytest.mark.parametrize("flag,value,field,want", [
    ("--slice-id", "slice-9", "slice_id", "slice-9"),
    ("--topo-host", "host-a0", "topo_host", "host-a0"),
    ("--topo-chip", "3", "topo_chip", 3),
    ("--ici-bytes-per-s", "1e9", "ici_bytes_per_s", 1e9),
    ("--dcn-bytes-per-s", "2e8", "dcn_bytes_per_s", 2e8),
])
def test_agent_takes_topology_flags(flag, value, field, want, monkeypatch):
    """The reference's placement and budget flags reach AgentConfig."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_agent(ecfg, cfg, **kw):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(port_agent, "EngineAgent", fake_agent)
    with pytest.raises(Stop):
        port_agent.main(["--model-config", "tiny", "--device", "cpu",
                         flag, value])
    assert getattr(seen["cfg"], field) == want


def test_main_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_agent.main(["--model-config", "tiny", "--coordination-addr",
                         ""])


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engines():
    cfg = ref_tiny(dtype=jnp.float32, max_context_len=256)
    tree = ref_llama.init_params(cfg, jax.random.PRNGKey(0))
    kw = dict(ENGINE_KW, max_batch_size=1)
    ref = RefEngine(RefConfig(model=cfg, prefill_buckets=(32, 64, 256),
                              **kw), params=tree)
    port = InferenceEngine(
        EngineConfig(model=tiny_config(dtype=torch.float32,
                                       max_context_len=256), **kw),
        device="cpu",
        params=llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                     device="cpu"))
    return ref, port, tree


def test_admission_order_matches_reference(engines):
    """One batch slot: the burst is admitted one request at a time, online
    before offline, then by priority, FIFO within a tie."""
    burst = [("a", False, 0), ("b", True, 5), ("c", False, 2),
             ("d", True, 0), ("e", False, 2), ("f", True, 5)]
    orders = []
    for engine, req_cls, sp_cls in (
            (engines[0], RefRequest, ref_request.SamplingParams),
            (engines[1], EngineRequest, port_request.SamplingParams)):
        order: list = []
        done = threading.Event()

        def on_output(out, order=order, done=done):
            if out.service_request_id not in order:
                order.append(out.service_request_id)
            if out.finished and len(order) == len(burst):
                done.set()

        for sid, offline, priority in burst:
            engine.submit(req_cls(
                sid, token_ids=[7, 8, 9], offline=offline, priority=priority,
                on_output=on_output,
                sampling=sp_cls(max_tokens=2, temperature=0.0,
                                ignore_eos=True)))
        t0 = time.monotonic()
        while not done.is_set():
            assert time.monotonic() - t0 < 60
            engine.step()
        orders.append(order)
    assert orders[0] == orders[1] == ["c", "e", "a", "b", "f", "d"]


def test_embed_forward_matches_reference(engines):
    _, port, tree = engines
    lens = np.array([5, 16, 1], np.int32)
    toks = np.random.default_rng(0).integers(3, 512, (3, 16)).astype(
        np.int32)
    want = np.asarray(ref_llama.embed_forward(
        tree, ref_tiny(dtype=jnp.float32, max_context_len=256),
        jnp.asarray(toks), jnp.asarray(lens)))
    got = llama.embed_forward(port.params, port.cfg.model,
                              torch.from_numpy(toks),
                              torch.from_numpy(lens)).numpy()
    assert got.shape == (3, 128) and got.dtype == np.float32
    assert np.abs(got - want).max() <= EMBED_TOL


def test_embed_runs_on_the_engine_thread(engines):
    ref, port, _ = engines
    inputs = [list(range(3, 40)), [9] * 70, [300], list(range(3, 40))]
    want = ref.embed(inputs)
    threads = []
    inner = port._embed

    def recording(lists):
        threads.append(threading.current_thread())
        return inner(lists)

    port._embed = recording
    try:
        assert np.abs(port.embed(inputs) - want).max() <= EMBED_TOL
        assert threads[-1] is threading.current_thread()   # no loop yet
        port.start()
        try:
            got = port.embed(inputs)
        finally:
            port.stop()
    finally:
        del port._embed
    assert threads[-1] is port._thread
    assert np.abs(got - want).max() <= EMBED_TOL
    np.testing.assert_array_equal(got[0], got[3])
