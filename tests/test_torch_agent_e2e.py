"""Client → reference master → the port's engine agent → streamed tokens,
on the CPU (the shape of tests/test_e2e_real_engine.py).

Two clusters, each an unchanged reference ``Master`` on its own
``InMemoryCoordination`` store: one serves the JAX ``EngineAgent``, the
other the port's ``EngineAgent`` (``device="cpu"``). Both engines get the
JAX engine's tiny f32 params (the port's through
``models/weights.py::llama_params_from_jax``). The same completions, chat,
streaming, ``n > 1`` and logprob requests go through both masters:

- greedy text (from the master's responses) and token ids (recorded at each
  agent's streamer, keyed by the master's ``X-Request-Id``) are identical;
- top logprobs agree within 1e-4 absolute (measured: at most 1.2e-6);
- ``/v1/embeddings`` agree within 1e-4 absolute (measured: at most 8.3e-7).

The rest mirrors test_e2e_real_engine.py's 18 cases against the port's
cluster (its second ``TestNChoices`` shadows the first there; both are
kept here, under two names). The agent runs in its default telemetry mode
(mux, msgpack) against the master's defaults. ``/rpc/encode`` is served:
this llama agent answers it 400, having no vision encoder, as the
reference agent does (tests/test_torch_epd_e2e.py serves it).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

from xllm_service_tpu.common.config import ServiceOptions
from xllm_service_tpu.coordination.memory import (
    InMemoryCoordination,
    MemoryStore,
)
from xllm_service_tpu.engine.agent import AgentConfig as RefAgentConfig
from xllm_service_tpu.engine.agent import EngineAgent as RefAgent
from xllm_service_tpu.engine.config import EngineConfig as RefEngineConfig
from xllm_service_tpu.master import Master
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu_torch.engine import EngineConfig
from xllm_service_tpu_torch.engine.agent import (
    AgentConfig,
    EngineAgent,
    _parser,
    engine_config,
)
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=256)
LOGPROB_TOL = 1e-4
EMBED_TOL = 1e-4


def _options():
    return ServiceOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                          lease_ttl_s=1.0, sync_interval_s=0.3,
                          reconcile_interval_s=0.1)


def _port_agent(store, tree, heartbeat_interval_s=0.3, **engine_kw):
    return EngineAgent(
        EngineConfig(model=tiny_config(dtype=torch.float32,
                                       max_context_len=256),
                     **ENGINE_KW, **engine_kw),
        AgentConfig(host="127.0.0.1", model_id="tiny-llama",
                    heartbeat_interval_s=heartbeat_interval_s,
                    lease_ttl_s=1.0),
        coord=InMemoryCoordination(store), device="cpu",
        params=llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                     device="cpu"))


def _record(agent):
    """Token ids each agent's streamer pushes, per (service id, choice)."""
    log: dict = {}
    push = agent.streamer.push

    def recording_push(dest, out):
        for o in out.outputs:
            log.setdefault((out.service_request_id, o.index), []).extend(
                o.token_ids)
        push(dest, out)

    agent.streamer.push = recording_push
    return log


class _Cluster:
    def __init__(self, make_agent):
        self.store = MemoryStore(expiry_tick_s=0.05)
        self.master = Master(_options(), coord=InMemoryCoordination(self.store))
        self.master.start()
        self.agent = make_agent(self.store).start()
        self.tokens = _record(self.agent)
        assert wait_until(
            lambda: self.master.scheduler.instance_mgr.get_instance_meta(
                self.agent.name) is not None, timeout=10)
        self.base = f"http://127.0.0.1:{self.master.http_port}"

    def stop(self):
        self.agent.stop()
        self.master.stop()
        self.store.close()


@pytest.fixture(scope="module")
def tree():
    return ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def clusters(tree):
    ref = _Cluster(lambda store: RefAgent(
        RefEngineConfig(model_id="tiny-llama",
                        model=ref_tiny(dtype=jnp.float32,
                                       max_context_len=256),
                        prefill_buckets=(32, 64, 256), **ENGINE_KW),
        RefAgentConfig(host="127.0.0.1", model_id="tiny-llama",
                       heartbeat_interval_s=0.3, lease_ttl_s=1.0),
        coord=InMemoryCoordination(store), params=tree))
    port = _Cluster(lambda store: _port_agent(store, tree))
    yield ref, port
    port.stop()
    ref.stop()


@pytest.fixture(scope="module")
def cluster(clusters):
    """The port's cluster as (master, agent), as test_e2e_real_engine's."""
    port = clusters[1]
    return port.master, port.agent


def _base(master):
    return f"http://127.0.0.1:{master.http_port}"


# ---------------------------------------------------------------- parity
PARITY = {
    "completion": ("/v1/completions", {
        "prompt": "Hello world, this is a test", "max_tokens": 8}),
    "chat": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "count to five"}],
        "max_tokens": 6}),
    "chat_stream": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "stream me a reply"}],
        "max_tokens": 7, "stream": True}),
    "completion_stream": ("/v1/completions", {
        "prompt": "tok " * 40, "max_tokens": 9, "stream": True}),
    "n3": ("/v1/completions", {"prompt": "pick a number", "max_tokens": 4,
                               "n": 3}),
    "logprobs": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5,
        "logprobs": True, "top_logprobs": 2}),
}


def _serve(cluster, path, body):
    """One request through a master: (choice index -> text, logprob rows,
    the agent's token ids per choice)."""
    body = {"model": "tiny-llama", "temperature": 0, "ignore_eos": True,
            **body}
    r = requests.post(cluster.base + path, json=body, timeout=120,
                      stream=bool(body.get("stream")))
    assert r.status_code == 200, r.text
    sid = r.headers["X-Request-Id"]
    texts: dict = {}
    lps: list = []
    if body.get("stream"):
        for line in r.iter_lines():
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            for c in json.loads(line[6:]).get("choices") or ():
                piece = c.get("text")
                if piece is None:
                    piece = (c.get("delta") or {}).get("content") or ""
                texts[c["index"]] = texts.get(c["index"], "") + piece
    else:
        for c in r.json()["choices"]:
            texts[c["index"]] = c.get("text", (c.get("message") or {})
                                      .get("content"))
            lps += ((c.get("logprobs") or {}).get("content") or [])
    assert wait_until(lambda: len(
        [k for k in cluster.tokens if k[0] == sid]) == len(texts), timeout=10)
    ids = {k[1]: v for k, v in cluster.tokens.items() if k[0] == sid}
    return texts, lps, ids


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity_with_the_jax_agent(clusters, case):
    ref, port = clusters
    path, body = PARITY[case]
    want_text, want_lps, want_ids = _serve(ref, path, body)
    got_text, got_lps, got_ids = _serve(port, path, body)
    assert got_text == want_text
    assert got_ids == want_ids
    assert all(len(v) == body["max_tokens"] for v in got_ids.values())
    assert len(got_lps) == len(want_lps)
    for g, w in zip(got_lps, want_lps):
        assert g["token"] == w["token"]
        assert abs(g["logprob"] - w["logprob"]) <= LOGPROB_TOL
        assert [t["token"] for t in g["top_logprobs"]] == \
            [t["token"] for t in w["top_logprobs"]]
        for gt, wt in zip(g["top_logprobs"], w["top_logprobs"]):
            assert abs(gt["logprob"] - wt["logprob"]) <= LOGPROB_TOL


def test_embeddings_parity_with_the_jax_agent(clusters):
    ref, port = clusters
    body = {"model": "tiny-llama",
            "input": ["hello world", "a completely different sentence",
                      "x" * 70]}
    got, want = (np.asarray([d["embedding"] for d in requests.post(
        c.base + "/v1/embeddings", json=body, timeout=120).json()["data"]])
        for c in (port, ref))
    assert got.shape == want.shape == (3, 128)
    assert np.abs(got - want).max() <= EMBED_TOL


@pytest.fixture(scope="module")
def chunked_clusters(tree):
    """Both agents with chunked prefill (32-token chunks), as the
    reference agent's ``--prefill-chunk 32`` sets it."""
    chunk = engine_config(_parser().parse_args(
        ["--prefill-chunk", "32"])).prefill_chunk_tokens
    ref = _Cluster(lambda store: RefAgent(
        RefEngineConfig(model_id="tiny-llama",
                        model=ref_tiny(dtype=jnp.float32,
                                       max_context_len=256),
                        prefill_buckets=(32, 64, 256),
                        prefill_chunk_tokens=chunk, **ENGINE_KW),
        RefAgentConfig(host="127.0.0.1", model_id="tiny-llama",
                       heartbeat_interval_s=0.3, lease_ttl_s=1.0),
        coord=InMemoryCoordination(store), params=tree))
    port = _Cluster(lambda store: _port_agent(
        store, tree, prefill_chunk_tokens=chunk))
    yield ref, port
    port.stop()
    ref.stop()


def test_the_agent_takes_prefill_chunk():
    args = _parser().parse_args(["--prefill-chunk", "64", "--model-config",
                                 "tiny", "--max-seq-len", "256"])
    cfg = engine_config(args)
    assert cfg.prefill_chunk_tokens == 64
    cfg.validate()
    assert engine_config(_parser().parse_args([])).prefill_chunk_tokens == 0


def test_chunked_request_parity_with_the_jax_agent(chunked_clusters):
    """A prompt of six 32-token chunks, streamed, through the reference
    master to each agent: the port's text and token ids are the JAX
    agent's; its stats report the chunked path's counters and spans."""
    ref, port = chunked_clusters
    body = {"prompt": "chunked prefill " * 12, "max_tokens": 8,
            "stream": True}
    want_text, _, want_ids = _serve(ref, "/v1/completions", body)
    got_text, _, got_ids = _serve(port, "/v1/completions", body)
    assert got_text == want_text and got_ids == want_ids
    assert all(len(v) == 8 for v in got_ids.values())
    stats = requests.get(f"http://{port.agent.name}/stats", timeout=5).json()
    assert stats["sarathi_rides"] == 0 and stats["preemption_count"] == 0
    assert stats["ttft_spans"]["engine_prefill_ms"] > 0


def test_encode_route_on_a_text_family_is_refused(cluster):
    """The route is served; a llama agent has no vision encoder and says
    so with a 400, as the reference agent does."""
    master, agent = cluster
    r = requests.post(f"http://{agent.name}/rpc/encode", data=b"{}",
                      timeout=5)
    assert r.status_code == 400
    assert "has no vision encoder" in r.json()["error"]


@pytest.mark.parametrize("path,kind", [
    ("/metrics", "text"), ("/admin/trace/recent", "traces"),
    ("/admin/flightrecorder/recent", "records"),
    ("/admin/profile", "roles"), ("/admin/profile?format=folded", "text")])
def test_newly_served_agent_routes_answer(cluster, path, kind):
    """The routes the agent once refused are served."""
    master, agent = cluster
    r = requests.get(f"http://{agent.name}{path}", timeout=5)
    assert r.status_code == 200, r.text
    if kind == "text":
        assert r.headers["Content-Type"].startswith("text/plain")
    else:
        assert kind in r.json()


# ------------------------------------------- test_e2e_real_engine's cases
class TestRealEngineE2E:
    def test_non_stream_completion(self, cluster):
        master, agent = cluster
        r = requests.post(_base(master) + "/v1/completions", json={
            "model": "tiny-llama", "prompt": "Hello world, this is a test",
            "max_tokens": 8, "temperature": 0, "ignore_eos": True,
        }, timeout=120)
        assert r.status_code == 200, r.text
        body = r.json()
        assert body["usage"]["completion_tokens"] == 8
        assert body["choices"][0]["finish_reason"] == "length"

    def test_streaming_chat_and_determinism(self, cluster):
        master, agent = cluster

        def run_once():
            r = requests.post(_base(master) + "/v1/chat/completions", json={
                "model": "tiny-llama",
                "messages": [{"role": "user", "content": "count to five"}],
                "max_tokens": 6, "temperature": 0, "ignore_eos": True,
                "stream": True,
            }, stream=True, timeout=120)
            assert r.status_code == 200
            chunks = []
            for line in r.iter_lines():
                if line.startswith(b"data: ") and line != b"data: [DONE]":
                    chunks.append(json.loads(line[6:]))
            return "".join(c["choices"][0]["delta"].get("content") or ""
                           for c in chunks if c.get("choices"))

        text1, text2 = run_once(), run_once()
        assert text1 == text2   # greedy => deterministic
        assert len(text1) > 0

    def test_logprobs_over_http(self, cluster):
        master, agent = cluster
        r = requests.post(_base(master) + "/v1/chat/completions", json={
            "model": "tiny-llama",
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 3, "temperature": 0, "ignore_eos": True,
            "logprobs": True, "top_logprobs": 2,
        }, timeout=120)
        body = r.json()
        lp = body["choices"][0]["logprobs"]["content"]
        assert len(lp) == 3
        assert len(lp[0]["top_logprobs"]) == 2

    def test_heartbeat_populates_kv_index_and_load(self, cluster):
        master, agent = cluster
        # 64+ token prompt → at least one 32-token hash block cached.
        requests.post(_base(master) + "/v1/completions", json={
            "model": "tiny-llama", "prompt": "x" * 200, "max_tokens": 2,
            "temperature": 0, "ignore_eos": True}, timeout=120)
        assert wait_until(
            lambda: master.scheduler.kvcache_mgr.num_blocks() > 0, timeout=10)
        infos = master.scheduler.instance_mgr.get_load_infos()
        assert agent.name in infos

    def test_engine_stats_endpoint(self, cluster):
        master, agent = cluster
        r = requests.get(f"http://{agent.name}/stats", timeout=5)
        stats = r.json()
        assert "kv_usage_perc" in stats and "cached_blocks" in stats

    def test_prometheus_metrics(self, cluster):
        master, agent = cluster
        r = requests.get(f"http://{agent.name}/metrics", timeout=5)
        assert r.status_code == 200
        assert "engine_generated_tokens_total" in r.text
        assert "engine_kv_usage_perc" in r.text
        assert "engine_sarathi_rides_total" in r.text


class TestNChoicesGreedy:
    def test_n_greater_than_one(self, cluster):
        master, agent = cluster
        r = requests.post(_base(master) + "/v1/completions", json={
            "model": "tiny-llama", "prompt": "pick a number",
            "max_tokens": 4, "temperature": 0, "ignore_eos": True, "n": 3,
        }, timeout=120)
        assert r.status_code == 200, r.text
        body = r.json()
        choices = body["choices"]
        assert sorted(c["index"] for c in choices) == [0, 1, 2]
        # Greedy => all three choices identical text.
        assert len({c["text"] for c in choices}) == 1
        assert all(c["finish_reason"] == "length" for c in choices)
        assert body["usage"]["completion_tokens"] == 12
        assert body["usage"]["prompt_tokens"] > 0

    def test_n_with_seed_distinct_choices(self, cluster):
        master, agent = cluster
        r = requests.post(_base(master) + "/v1/completions", json={
            "model": "tiny-llama", "prompt": "vary " * 30,
            "max_tokens": 5, "temperature": 1.5, "top_k": 200, "seed": 7,
            "ignore_eos": True, "n": 2,
        }, timeout=120)
        body = r.json()
        assert len(body["choices"]) == 2
        # Per-choice seeds (seed+k) should usually give distinct samples.
        texts = {c["text"] for c in body["choices"]}
        assert len(texts) == 2


class TestLiveProfilingTables:
    def test_tables_fit_from_measured_traffic(self, cluster):
        """After real traffic, the agent's advertised SLO tables come from
        engine telemetry (not the cold-start defaults) and the master's
        predictor refits from them on heartbeat re-registration."""
        master, agent = cluster
        for words in (4, 20, 60):
            r = requests.post(_base(master) + "/v1/completions", json={
                "model": "tiny-llama", "prompt": "tok " * words,
                "max_tokens": 6, "temperature": 0, "ignore_eos": True},
                timeout=120)
            assert r.status_code == 200, r.text
        assert len(agent.engine.ttft_samples) >= 3
        ttft_table, tpot_table = agent.profiling_tables()
        assert ttft_table != agent.DEFAULT_TTFT_TABLE
        assert len(ttft_table) >= 3
        assert all(ms > 0 for _, ms in ttft_table)
        assert wait_until(
            lambda: master.scheduler.instance_mgr.get_instance_meta(
                agent.name).ttft_profiling_data == ttft_table
            or agent.profiling_tables()[0] !=
            ttft_table, timeout=10)
        entry = master.scheduler.instance_mgr._instances[agent.name]
        assert entry.predictor.has_ttft
        measured = entry.predictor.predict_ttft(16)
        assert measured >= 0.0


class TestGracefulDrain:
    def test_drain_excludes_from_scheduling_and_finishes_inflight(
            self, store, tree):
        """A draining instance takes no new traffic (scheduler excludes it
        on the next refresh) but its in-flight stream finishes intact."""
        import threading

        master = Master(_options(), coord=InMemoryCoordination(store))
        master.start()
        agent = _port_agent(store, tree, heartbeat_interval_s=0.2).start()
        try:
            assert wait_until(
                lambda: master.scheduler.instance_mgr.get_instance_meta(
                    agent.name) is not None, timeout=10)
            base = f"http://127.0.0.1:{master.http_port}"
            result = {}

            def long_req():
                r = requests.post(base + "/v1/completions", json={
                    "model": "tiny-llama", "prompt": "drain me",
                    "max_tokens": 40, "temperature": 0,
                    "ignore_eos": True, "stream": True},
                    stream=True, timeout=120)
                chunks = [ln for ln in r.iter_lines()
                          if ln.startswith(b"data: ")]
                result["done"] = chunks[-1] == b"data: [DONE]"
                result["n"] = len(chunks)

            t = threading.Thread(target=long_req)
            t.start()
            assert wait_until(
                lambda: agent.aggregate_stats()["running"] > 0, timeout=30)
            dr = threading.Thread(target=agent.drain,
                                  kwargs={"timeout_s": 60})
            dr.start()
            assert wait_until(
                lambda: not master.scheduler.has_available_instances(),
                timeout=10)
            r = requests.post(base + "/v1/completions", json={
                "model": "tiny-llama", "prompt": "new", "max_tokens": 4},
                timeout=30)
            assert r.status_code == 503
            t.join(timeout=120)
            dr.join(timeout=120)
            assert result.get("done"), result
            assert result["n"] > 2
        finally:
            agent.stop()
            master.stop()


class TestEmbeddings:
    def test_embeddings_end_to_end(self, cluster):
        master, agent = cluster
        base = _base(master)
        r = requests.post(base + "/v1/embeddings", json={
            "model": "tiny-llama",
            "input": ["hello world", "a completely different sentence"],
        }, timeout=120)
        assert r.status_code == 200, r.text
        body = r.json()
        assert body["object"] == "list"
        assert len(body["data"]) == 2
        v0 = body["data"][0]["embedding"]
        v1 = body["data"][1]["embedding"]
        assert len(v0) == agent.engine.cfg.model.hidden_size
        assert v0 != v1
        assert body["usage"]["prompt_tokens"] > 0
        r2 = requests.post(base + "/v1/embeddings", json={
            "model": "tiny-llama", "input": "hello world"}, timeout=120)
        np.testing.assert_allclose(
            np.asarray(r2.json()["data"][0]["embedding"]),
            np.asarray(v0), rtol=1e-4, atol=1e-5)


class TestEcho:
    def test_completions_echo(self, cluster):
        master, agent = cluster
        base = _base(master)
        body = {"model": "tiny-llama", "prompt": "echo this prompt",
                "max_tokens": 4, "temperature": 0, "ignore_eos": True,
                "echo": True}
        r = requests.post(base + "/v1/completions", json=body, timeout=120)
        assert r.status_code == 200, r.text
        assert r.json()["choices"][0]["text"].startswith("echo this prompt")

        r = requests.post(base + "/v1/completions",
                          json={**body, "stream": True}, stream=True,
                          timeout=120)
        chunks = [json.loads(ln[6:]) for ln in r.iter_lines()
                  if ln.startswith(b"data: ") and ln != b"data: [DONE]"]
        texts = [c["choices"][0]["text"] for c in chunks if c["choices"]]
        assert texts[0] == "echo this prompt"


class TestNChoices:
    def test_n_choices_end_to_end(self, cluster):
        master, agent = cluster
        base = _base(master)
        r = requests.post(base + "/v1/completions", json={
            "model": "tiny-llama", "prompt": [11, 12, 13, 14, 15] * 8,
            "max_tokens": 6, "temperature": 0, "ignore_eos": True,
            "n": 2}, timeout=120)
        assert r.status_code == 200, r.text
        choices = r.json()["choices"]
        assert len(choices) == 2
        assert {c["index"] for c in choices} == {0, 1}
        assert choices[0]["text"] == choices[1]["text"]
        assert all(c["finish_reason"] == "length" for c in choices)
        usage = r.json()["usage"]
        assert usage["completion_tokens"] == 12   # 6 per choice

    def test_n_choices_distinct_when_sampled(self, cluster):
        master, agent = cluster
        base = _base(master)
        r = requests.post(base + "/v1/completions", json={
            "model": "tiny-llama", "prompt": [21, 22, 23, 24] * 6,
            "max_tokens": 8, "temperature": 1.3, "seed": 7,
            "ignore_eos": True, "n": 2}, timeout=120)
        assert r.status_code == 200, r.text
        choices = r.json()["choices"]
        assert len(choices) == 2
        assert choices[0]["text"] != choices[1]["text"]


class TestAnthropicMessages:
    def test_messages_non_stream(self, cluster):
        master, agent = cluster
        base = _base(master)
        r = requests.post(base + "/v1/messages", json={
            "model": "tiny-llama", "max_tokens": 6,
            "system": "You are terse.",
            "messages": [{"role": "user", "content": "hello"}],
            "temperature": 0, "ignore_eos": True,
        }, timeout=120)
        assert r.status_code == 200, r.text
        body = r.json()
        assert body["type"] == "message"
        assert body["role"] == "assistant"
        assert body["id"].startswith("msg_")
        assert body["content"][0]["type"] == "text"
        assert body["content"][0]["text"]
        assert body["stop_reason"] == "max_tokens"
        assert body["usage"]["input_tokens"] > 0
        assert body["usage"]["output_tokens"] == 6

    def test_messages_missing_max_tokens(self, cluster):
        master, _ = cluster
        r = requests.post(_base(master) + "/v1/messages", json={
            "model": "tiny-llama",
            "messages": [{"role": "user", "content": "x"}]}, timeout=30)
        assert r.status_code == 400

    def test_messages_streaming_event_sequence(self, cluster):
        master, _ = cluster
        r = requests.post(_base(master) + "/v1/messages", json={
            "model": "tiny-llama", "max_tokens": 5, "stream": True,
            "messages": [{"role": "user",
                          "content": [{"type": "text", "text": "hi"}]}],
            "temperature": 0, "ignore_eos": True,
        }, stream=True, timeout=120)
        assert r.status_code == 200
        events = []
        for ln in r.iter_lines():
            if ln.startswith(b"event: "):
                events.append(ln[7:].decode())
        assert events[0] == "message_start"
        assert events[1] == "content_block_start"
        assert "content_block_delta" in events
        assert events[-3:] == ["content_block_stop", "message_delta",
                               "message_stop"]
