"""Client → the port's master → the port's agent, against client → the JAX
master → the same agent, on the CPU (the shape of
tests/test_torch_agent_e2e.py).

Two clusters, each a master on its own in-process coordination store with
one port ``EngineAgent`` (``device="cpu"``) on the JAX engine's tiny f32
llama (through ``models/weights.py::llama_params_from_jax``): one master
is the JAX package's, the other the port's. The same requests go through
both, as raw HTTP/1.1 on ``http.client``: completions, chat, streaming
with usage, ``n > 1``, logprobs, echo, token-id prompts, embeddings,
``/v1/messages`` whole and streamed, ``/v1/models``, ``/hello``,
``/health`` and ``/metrics``, and the error answers (400, 404, 405, 429
with ``Retry-After``, 503, 504). Status, content type, ``Retry-After``,
the ``X-Request-Id`` kind and the body must be equal: JSON bodies equal
but for the random ids and timestamps, SSE bodies the same event sequence
frame by frame. ``/metrics`` must carry the JAX master's families.
"""

import http.client
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.common.config import ServiceOptions as RefOptions
from xllm_service_tpu.coordination import memory as ref_memory
from xllm_service_tpu.master import Master as RefMaster
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu_torch.common.config import ServiceOptions
from xllm_service_tpu_torch.coordination import memory
from xllm_service_tpu_torch.engine import EngineConfig
from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
from xllm_service_tpu_torch.master import Master
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=256)
# Tenths of a second for failure detection on both masters alike; batch
# traffic is shed (watermark 0) so the 429 path has a deterministic case.
MASTER_KW = dict(host="127.0.0.1", http_port=0, rpc_port=0,
                 lease_ttl_s=1.0, sync_interval_s=0.3,
                 reconcile_interval_s=0.1,
                 admission_max_inflight_per_instance=8,
                 admission_batch_watermark=0.0)
PACKAGES = {"ref": (RefMaster, RefOptions, ref_memory),
            "port": (Master, ServiceOptions, memory)}


def port_agent(coord, tree, **agent_kw):
    """A port agent on the JAX tiny llama's weights (``tree``)."""
    return EngineAgent(
        EngineConfig(model=tiny_config(dtype=torch.float32,
                                       max_context_len=256), **ENGINE_KW),
        AgentConfig(host="127.0.0.1", model_id="tiny-llama",
                    heartbeat_interval_s=0.3, lease_ttl_s=1.0, **agent_kw),
        coord=coord, device="cpu",
        params=llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                     device="cpu"))


class Cluster:
    """A master of package ``which`` ("ref" or "port") with the agents
    ``makers`` build (each: coordination client -> agent)."""

    def __init__(self, which, *makers, **master_kw):
        master_cls, opts_cls, mem = PACKAGES[which]
        self.which = which
        self.store = mem.MemoryStore(expiry_tick_s=0.05)
        self.master = master_cls(opts_cls(**{**MASTER_KW, **master_kw}),
                                 coord=mem.InMemoryCoordination(self.store))
        self.master.start()
        self.agents = [make(mem.InMemoryCoordination(self.store)).start()
                       for make in makers]
        mgr = self.master.scheduler.instance_mgr
        assert wait_until(lambda: all(mgr.get_instance_meta(a.name)
                                      for a in self.agents), timeout=15)
        self.port = self.master.http_port

    def call(self, method, path, body=None, headers=None, raw=None):
        """One request on a fresh connection: (status, headers, bytes)."""
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            data = raw if raw is not None else (
                json.dumps(body).encode() if body is not None else None)
            h = {"Content-Type": "application/json", **(headers or {})}
            c.request(method, path, body=data, headers=h)
            r = c.getresponse()
            return r.status, {k.lower(): v for k, v in r.getheaders()}, \
                r.read()
        finally:
            c.close()

    def stop(self):
        for a in self.agents:
            a.stop()
        self.master.stop()
        self.store.close()


def scrub(obj):
    """Drop the random ids and wall-clock timestamps."""
    if isinstance(obj, dict):
        return {k: (None if k in ("id", "created") else scrub(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


def sse_frames(data: bytes):
    """SSE body -> [(event name, scrubbed data)], frame by frame."""
    assert data.endswith(b"\n\n"), data[-40:]
    out = []
    for frame in data.decode().split("\n\n")[:-1]:
        event, payload = "", None
        for line in frame.split("\n"):
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                payload = line[6:]
        out.append((event, payload if payload == "[DONE]"
                    else scrub(json.loads(payload))))
    return out


def normalized(resp):
    status, headers, data = resp
    ctype = headers.get("content-type", "")
    rid = headers.get("x-request-id", "")
    out = {"status": status, "content-type": ctype,
           "retry-after": headers.get("retry-after"),
           "x-request-id": rid.split("-")[0] if rid else None}
    if ctype.startswith("application/json"):
        out["body"] = scrub(json.loads(data))
    elif ctype.startswith("text/event-stream"):
        assert headers.get("transfer-encoding") == "chunked"
        out["body"] = sse_frames(data)
    else:
        out["body"] = data
    return out


@pytest.fixture(scope="module")
def tree():
    return ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def clusters(tree):
    made = [Cluster(which, lambda coord: port_agent(coord, tree))
            for which in ("ref", "port")]
    yield made
    for c in made:
        c.stop()


GREEDY = {"model": "tiny-llama", "temperature": 0, "ignore_eos": True}
CHAT = [{"role": "user", "content": "count to five"}]
CASES = {
    "completion": ("/v1/completions", {"prompt": "Hello world, this is a "
                                                 "test", "max_tokens": 8}),
    "completion_token_ids": ("/v1/completions", {
        "prompt": [5, 7, 9, 11, 13], "max_tokens": 5}),
    "completion_echo": ("/v1/completions", {
        "prompt": "echo me", "max_tokens": 3, "echo": True}),
    "completion_stream": ("/v1/completions", {
        "prompt": "tok " * 40, "max_tokens": 9, "stream": True}),
    "completion_stream_usage": ("/v1/completions", {
        "prompt": "usage please", "max_tokens": 6, "stream": True,
        "stream_options": {"include_usage": True}}),
    "chat": ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 6}),
    "chat_stream": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "stream me a reply"}],
        "max_tokens": 7, "stream": True}),
    "chat_stream_usage": ("/v1/chat/completions", {
        "messages": CHAT, "max_tokens": 5, "stream": True,
        "stream_options": {"include_usage": True}}),
    "n2": ("/v1/completions", {"prompt": "pick a number", "max_tokens": 4,
                               "n": 2}),
    "n2_stream": ("/v1/chat/completions", {
        "messages": CHAT, "max_tokens": 3, "n": 2, "stream": True}),
    "logprobs": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5,
        "logprobs": True, "top_logprobs": 2}),
    "completion_logprobs": ("/v1/completions", {
        "prompt": "logprobs", "max_tokens": 4, "logprobs": 2}),
    "stop_string": ("/v1/completions", {
        "prompt": "Hello world", "max_tokens": 12, "stop": ["e"],
        "ignore_eos": False}),
    "messages": ("/v1/messages", {
        "system": "be brief", "max_tokens": 6,
        "messages": [{"role": "user",
                      "content": [{"type": "text", "text": "hi there"}]}]}),
    "messages_stream": ("/v1/messages", {
        "max_tokens": 5, "stream": True,
        "messages": [{"role": "user", "content": "stream it"}]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generation_matches_the_jax_master(clusters, case):
    path, body = CASES[case]
    body = {**GREEDY, **body}
    want, got = (normalized(c.call("POST", path, body)) for c in clusters)
    assert want["status"] == 200, want
    assert got == want


def test_embeddings_match_the_jax_master(clusters):
    body = {"model": "tiny-llama",
            "input": ["hello world", "a completely different sentence"]}
    want, got = (normalized(c.call("POST", "/v1/embeddings", body))
                 for c in clusters)
    assert want["status"] == 200
    assert got == want


ERRORS = {
    "invalid_json": ("POST", "/v1/completions", None, b"{not json", {}),
    "not_an_object": ("POST", "/v1/chat/completions", None, b"[1, 2]", {}),
    "empty_messages": ("POST", "/v1/chat/completions",
                       {"model": "tiny-llama", "messages": []}, None, {}),
    "empty_prompt": ("POST", "/v1/completions",
                     {"model": "tiny-llama", "prompt": ""}, None, {}),
    "bad_field": ("POST", "/v1/completions",
                  {"model": "tiny-llama", "prompt": "x", "n": "two"},
                  None, {}),
    "messages_without_max_tokens": ("POST", "/v1/messages", {
        "model": "tiny-llama", "messages": [{"role": "user",
                                             "content": "x"}]}, None, {}),
    "deadline_expired": ("POST", "/v1/completions",
                         {"model": "tiny-llama", "prompt": "late"}, None,
                         {"x-request-deadline-ms": "0.5"}),
    "batch_shed": ("POST", "/v1/completions",
                   {"model": "tiny-llama", "prompt": "bulk"}, None,
                   {"x-request-priority": "batch"}),
    "unknown_route": ("GET", "/v1/unknown", None, None, {}),
    "unknown_admin_route": ("GET", "/nothing/here", None, None, {}),
    "wrong_method": ("GET", "/v1/completions", None, None, {}),
    "models": ("GET", "/v1/models", None, None, {}),
    "hello": ("GET", "/hello", None, None, {}),
    "health": ("GET", "/health", None, None, {}),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_answers_match_the_jax_master(clusters, case):
    method, path, body, raw, headers = ERRORS[case]
    want, got = (normalized(c.call(method, path, body, headers, raw))
                 for c in clusters)
    assert got == want


def test_no_instances_answers_503_as_the_jax_master():
    bare = [Cluster(which) for which in ("ref", "port")]
    try:
        want, got = (normalized(c.call(
            "POST", "/v1/completions",
            {"model": "tiny-llama", "prompt": "x"})) for c in bare)
        assert want["status"] == 503
        assert got == want
    finally:
        for c in bare:
            c.stop()


def test_metrics_families_are_the_jax_masters(clusters):
    def families(c):
        _, headers, data = c.call("GET", "/metrics")
        assert headers["content-type"] == "text/plain; charset=utf-8"
        return dict(re.findall(r"^# TYPE (\S+) (\S+)$", data.decode(),
                               re.M))
    want, got = (families(c) for c in clusters)
    for name in ("server_request_in_total",
                 "time_to_first_token_latency_milliseconds",
                 "inter_token_latency_milliseconds",
                 "instance_inflight_requests"):
        assert name in got
    assert got == want


def test_keep_alive_serves_several_requests_on_one_connection(clusters):
    port = clusters[1]
    c = http.client.HTTPConnection("127.0.0.1", port.port, timeout=60)
    try:
        for i in range(3):
            c.request("POST", "/v1/completions", body=json.dumps(
                {**GREEDY, "prompt": f"again {i}", "max_tokens": 2,
                 "stream": bool(i % 2)}),
                headers={"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200 and r.read()
    finally:
        c.close()


def test_sse_deltas_leave_the_socket_as_they_are_written(clusters):
    """A streamed response arrives as several chunks of chunked transfer,
    the first a whole SSE frame: a delta is flushed when it is written,
    not held until the response ends."""
    port = clusters[1]
    c = http.client.HTTPConnection("127.0.0.1", port.port, timeout=60)
    try:
        c.request("POST", "/v1/completions", body=json.dumps(
            {**GREEDY, "prompt": "slow stream", "max_tokens": 40,
             "stream": True}), headers={"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 200
        chunks = []
        while True:
            piece = r.read1(1 << 20)
            if not piece:
                break
            chunks.append(piece)
        assert chunks[0].startswith(b"data: {") and \
            chunks[0].endswith(b"\n\n")
        assert len(chunks) > 1
        assert chunks[-1].endswith(b"data: [DONE]\n\n")
    finally:
        c.close()
