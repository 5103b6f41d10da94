"""The port's agent in the reference's default deployment, on the CPU,
through unchanged reference masters (``telemetry_ingest_mode="shard"``)
and beside the JAX agent on the same weights:

- mux telemetry: the master ingests the port's beats (load view and KV
  index fill), dispatches msgpack to it by itself, and the greedy tokens
  are the JAX agent's;
- two masters: the port's beats reach the owner the JAX agent's resolver
  picks; killing that owner moves them to its successor with no SUSPECT
  on the way; a master without ``/rpc/telemetry`` (404) demotes the port's
  agent to the elected-master funnel as it demotes the JAX agent, and a
  400/415 on the msgpack beat demotes it to JSON;
- ``/admin/trace?scope=fleet`` on the master holds the port's engine spans
  in one tree, as with the JAX agent; the ``/metrics`` families are the
  JAX agent's;
- ``dp_size 2``: the four cases of tests/test_dp_replicas.py against the
  port's agent, and its tokens equal to the JAX agent's at ``dp_size 2``;
- PD under a fault rule: a streamed handoff whose pull is failed by
  ``FAULTS`` falls back inline with the same tokens, leaves the
  ``kv_transfer`` spans, and exactly one ``kv_stream_fallback`` flight
  record carrying the prefill agent's ``engine`` context.
"""

import json
import re
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

from xllm_service_tpu.common.config import ServiceOptions
from xllm_service_tpu.common.types import InstanceRuntimeState
from xllm_service_tpu.common.types import InstanceType as RefType
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
from xllm_service_tpu.multimaster.ownership import (
    TelemetryOwnerResolver as RefResolver,
)
from xllm_service_tpu_torch.common.faults import FAULTS
from xllm_service_tpu_torch.common.flightrecorder import RECORDER
from xllm_service_tpu_torch.common.metrics import ENGINE_HEARTBEATS_TOTAL
from xllm_service_tpu_torch.common.tracing import TRACER
from xllm_service_tpu_torch.common.types import InstanceType
from xllm_service_tpu_torch.engine import EngineConfig
from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.rpc import MASTER_KEY, SERVICE_KEY_PREFIX

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=256)
GREEDY = {"model": "tiny-llama", "temperature": 0, "ignore_eos": True}


def _opts(**kw) -> ServiceOptions:
    base = dict(host="127.0.0.1", http_port=0, rpc_port=0, lease_ttl_s=0.5,
                sync_interval_s=0.2, reconcile_interval_s=0.05,
                heartbeat_silence_to_suspect_s=0.6,
                detect_disconnected_instance_interval_s=0.3,
                health_probe_attempts=1, health_probe_timeout_s=0.2,
                # The fleet views' fan-out, with room for a loaded box.
                fleet_peer_timeout_s=10.0,
                # Brownout sheds trace sampling while the JAX engine's
                # first requests compile; the trace test needs every span.
                brownout_enabled=False)
    base.update(kw)
    return ServiceOptions(**base)


def _master(store, **kw) -> Master:
    m = Master(_opts(**kw), coord=InMemoryCoordination(store))
    m.start()
    return m


@pytest.fixture(scope="module")
def tree():
    return ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))


def _port(store, tree, dp=1, itype=InstanceType.MIX, hb=0.1, engine_kw=None,
          **agent_kw):
    return EngineAgent(
        EngineConfig(model=tiny_config(dtype=torch.float32,
                                       max_context_len=256),
                     **dict(ENGINE_KW, **(engine_kw or {}))),
        AgentConfig(host="127.0.0.1", model_id="tiny-llama",
                    instance_type=itype, heartbeat_interval_s=hb,
                    lease_ttl_s=1.0, dp_size=dp, **agent_kw),
        coord=InMemoryCoordination(store), device="cpu",
        params=llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                     device="cpu"))


def _jax(store, tree, dp=1, hb=0.1, engine_kw=None, **agent_kw):
    return RefAgent(
        RefEngineConfig(model_id="tiny-llama",
                        model=ref_tiny(dtype=jnp.float32,
                                       max_context_len=256),
                        prefill_buckets=(32, 64, 256),
                        **dict(ENGINE_KW, **(engine_kw or {}))),
        RefAgentConfig(host="127.0.0.1", model_id="tiny-llama",
                       heartbeat_interval_s=hb, lease_ttl_s=1.0,
                       dp_size=dp, **agent_kw),
        coord=InMemoryCoordination(store), params=tree)


def _record(agent):
    """Token ids the agent's streamer pushes, per service request id."""
    log: dict = {}
    push = agent.streamer.push

    def recording_push(dest, out):
        for o in out.outputs:
            log.setdefault(out.service_request_id, []).extend(o.token_ids)
        push(dest, out)

    agent.streamer.push = recording_push
    return log


class _Cluster:
    """A reference master and agents (started in the given order); the
    last agent's pushes are recorded."""

    def __init__(self, *makers, masters=1):
        self.store = MemoryStore(expiry_tick_s=0.05)
        self.masters = [_master(self.store) for _ in range(masters)]
        self.master = self.masters[0]
        self.agents = [make(self.store).start() for make in makers]
        self.agent = self.agents[-1]
        self.tokens = _record(self.agent)
        addrs = {m.scheduler.self_addr for m in self.masters}
        assert wait_until(lambda: all(
            all(m.scheduler.instance_mgr.get_instance_meta(a.name)
                for a in self.agents)
            and set(m.scheduler.ownership.members()) == addrs
            for m in self.masters), timeout=20)
        self.base = f"http://127.0.0.1:{self.master.http_port}"

    def serve(self, body, base=None):
        """One completion: (text, the recorded agent's token ids, sid)."""
        r = requests.post((base or self.base) + "/v1/completions",
                          json=dict(GREEDY, **body), timeout=120)
        assert r.status_code == 200, r.text
        sid = r.headers["X-Request-Id"]
        assert wait_until(lambda: sid in self.tokens, timeout=10)
        return r.json()["choices"][0]["text"], self.tokens[sid], sid

    def stop(self):
        for a in self.agents:
            a.stop()
        for m in self.masters:
            m.stop()
        self.store.close()


PROMPTS = ["Hello world, this is a test", "tok " * 40, "x" * 70]


def _drop_labelled_children():
    """Drop every child series of the agents' labelled families in both
    packages' registries. The registries belong to the process, so agents
    of an earlier test file in this worker leave their children behind: a
    JAX agent's linked PD peer kept ``engine_peer_linked`` in the
    reference's exposition, absent from the port's."""
    from xllm_service_tpu.common import metrics as ref_metrics
    from xllm_service_tpu_torch.common import metrics as port_metrics

    for m in (ref_metrics.ENGINE_PEER_LINKED,
              ref_metrics.ENGINE_HEARTBEATS_TOTAL,
              port_metrics.ENGINE_PEER_LINKED,
              port_metrics.ENGINE_HEARTBEATS_TOTAL):
        for values in list(m._children):
            m.remove(**dict(zip(m.labelnames, values)))


@pytest.fixture(scope="module")
def clusters(tree):
    """One master each: the JAX agent's cluster and the port's, both in
    the default mux mode. The port agent's dispatch bodies' content types
    are recorded."""
    _drop_labelled_children()
    jax_c = _Cluster(lambda s: _jax(s, tree))
    port_c = _Cluster(lambda s: _port(s, tree))
    agent = port_c.agent
    ctypes: list = []
    route = agent._route

    def recording_route(method, path, req):
        if path == "/v1/completions":
            ctypes.append(req.ctype)
        return route(method, path, req)

    agent._route = recording_route
    port_c.ctypes = ctypes
    yield jax_c, port_c
    port_c.stop()
    jax_c.stop()


class TestMux:
    def test_greedy_tokens_are_the_jax_agents(self, clusters):
        jax_c, port_c = clusters
        for p in PROMPTS:
            want = jax_c.serve({"prompt": p, "max_tokens": 7})[:2]
            got = port_c.serve({"prompt": p, "max_tokens": 7})[:2]
            assert got == want

    def test_master_dispatches_msgpack_by_itself(self, clusters):
        _, port_c = clusters
        port_c.serve({"prompt": "negotiate", "max_tokens": 2})
        assert port_c.ctypes and all(
            "msgpack" in c for c in port_c.ctypes), port_c.ctypes
        meta = port_c.master.scheduler.instance_mgr.get_instance_meta(
            port_c.agent.name)
        assert meta.wire_formats == ["msgpack", "json"]

    def test_beats_fill_the_masters_views(self, clusters):
        _, port_c = clusters
        master, agent = port_c.master, port_c.agent
        port_c.serve({"prompt": "y" * 200, "max_tokens": 2})
        assert wait_until(
            lambda: master.scheduler.kvcache_mgr.num_blocks() > 0,
            timeout=10)
        mgr = master.scheduler.instance_mgr
        assert agent.name in mgr.get_load_infos()
        assert wait_until(lambda: 0 <= mgr.load_info_ages_s().get(
            agent.name, -1) < 2, timeout=10)
        tel = agent.telemetry_stats()
        assert tel["mode"] == "mux" and tel["owner"] == \
            master.scheduler.self_addr
        assert tel["mux_sends"] > 0 and tel["direct_sends"] == 0
        assert tel["hosts"] == 1

    def test_fleet_trace_holds_the_engine_spans_in_one_tree(self, clusters):
        views = []
        for c in clusters:
            _, _, sid = c.serve({"prompt": "trace me", "max_tokens": 4})

            def fleet():
                r = requests.get(c.base + "/admin/trace", params={
                    "request_id": sid, "scope": "fleet"}, timeout=10)
                body = r.json()
                points = sorted(s["point"] for s in body.get("spans", ()))
                return r.status_code, body, points

            # The frontend span is recorded when the master's response
            # has gone out, the engine's decode span at the last delta.
            assert wait_until(lambda: {"frontend.request", "engine.decode"}
                              <= set(fleet()[2]), timeout=30)
            status, body, points = fleet()
            assert status == 200 and len(body["tree"]) == 1, body["tree"]
            engine = [s for s in body["spans"]
                      if s["point"].startswith("engine.")]
            assert {s["instance"] for s in engine} == {c.agent.name}
            by_id = {s["span_id"]: s for s in body["spans"]}
            assert all(by_id[s["parent_span_id"]]["point"]
                       in ("frontend.request", "scheduler.schedule")
                       for s in engine)
            views.append(points)
        assert views[0] == views[1]
        r = requests.get(f"http://{clusters[1].agent.name}"
                         "/admin/trace/recent", timeout=10)
        assert r.status_code == 200 and r.json()["traces"]

    def test_metrics_families_are_the_jax_agents(self, clusters):
        def families(agent):
            text = requests.get(f"http://{agent.name}/metrics",
                                timeout=10).text
            types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
            samples = {(m.group(1), tuple(sorted(re.findall(
                r'(\w+)="', m.group(2) or ""))))
                for m in re.finditer(r"^([a-z_]+)(\{[^}]*\})? \S+$", text,
                                     re.M)}
            return types, samples, text

        # A labelled family renders once its first child exists, in both
        # registries: wait until each agent's first beat is counted and its
        # TYPE and sample sets are the same on two scrapes running.
        def settled(agent):
            last = []

            def same_twice():
                types, samples, _ = families(agent)
                now = (types, samples)
                ok = "engine_heartbeats_total" in types and last == [now]
                last[:] = [now]
                return ok
            return same_twice

        for c in clusters:
            assert wait_until(settled(c.agent), timeout=30)
        (jt, js, _), (pt, ps, text) = (families(c.agent) for c in clusters)
        assert pt == jt
        # The heartbeat family's label value is each agent's own master.
        assert {s for s in ps if s[0] != "engine_heartbeats_total"} == \
            {s for s in js if s[0] != "engine_heartbeats_total"}
        assert ("engine_heartbeats_total", ("master",)) in ps
        gen = int(re.search(r"^engine_generated_tokens_total (\d+)$", text,
                            re.M).group(1))
        assert gen == clusters[1].agent.aggregate_stats()["total_generated"]


# --------------------------------------------------------- two masters
def _owner_pair(cluster):
    mgrs = {m: m.scheduler.instance_mgr for m in cluster.masters}
    owner = next(m for m, mgr in mgrs.items()
                 if mgr.owns_telemetry(cluster.agent.name))
    other = next(m for m in cluster.masters if m is not owner)
    return owner, other


def test_beats_reach_the_owner_the_jax_agent_picks(tree):
    c = _Cluster(lambda s: _port(s, tree), masters=2)
    try:
        owner, other = _owner_pair(c)
        agent = c.agent
        want = RefResolver(InMemoryCoordination(c.store), agent.name)()
        assert want == owner.scheduler.self_addr
        assert wait_until(lambda: agent.telemetry_owner() == want,
                          timeout=10)
        omgr = owner.scheduler.instance_mgr
        assert wait_until(lambda: 0 <= omgr.load_info_ages_s().get(
            agent.name, -1) < 2, timeout=10)
        # Served through the non-owner: its deltas ride the owner's relay.
        text, toks, _ = c.serve({"prompt": "relay me", "max_tokens": 5},
                                base=f"http://127.0.0.1:"
                                     f"{other.http_port}")
        assert len(toks) == 5 and text
        rendered = ENGINE_HEARTBEATS_TOTAL.render()
        assert f'master="{want}"' in rendered
        assert f'master="{other.scheduler.self_addr}"' not in rendered
        tel = agent.telemetry_stats()
        assert tel["mode"] == "mux" and tel["hosts"] == 1
        assert tel["direct_sends"] == 0 and tel["mux_sends"] > 0
    finally:
        c.stop()


def test_owner_kill_moves_beats_to_the_successor(tree):
    c = _Cluster(lambda s: _port(s, tree), masters=2)
    killer = None
    try:
        owner, survivor = _owner_pair(c)
        agent = c.agent
        smgr = survivor.scheduler.instance_mgr
        observed: list = []
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                st = smgr.get_instance_state(agent.name)
                if not observed or observed[-1] != st:
                    observed.append(st)
                time.sleep(0.02)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        killer = owner.kill()
        assert wait_until(lambda: smgr.owns_telemetry(agent.name),
                          timeout=10)
        assert wait_until(lambda: agent.telemetry_owner()
                          == survivor.scheduler.self_addr, timeout=10)
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            age = smgr.load_info_ages_s().get(agent.name, -1)
            assert age == -1 or age < 2.0
            time.sleep(0.05)
        assert 0 <= smgr.load_info_ages_s().get(agent.name, -1) < 2.0
        stop.set()
        watcher.join(timeout=5)
        assert InstanceRuntimeState.SUSPECT not in observed, observed
        text, toks, _ = c.serve({"prompt": "after the kill",
                                 "max_tokens": 4},
                                base=f"http://127.0.0.1:"
                                     f"{survivor.http_port}")
        assert len(toks) == 4
    finally:
        c.agent.stop()
        for m in c.masters:
            if m is not owner or killer is None:
                m.stop()
        if killer is not None:
            killer.join(timeout=15)
        c.store.close()


class _LegacyMaster:
    """A master that predates the multiplexed session: ``/rpc/telemetry``
    answers 404; ``/rpc/heartbeat`` takes msgpack (or, with
    ``reject_msgpack``, answers it 415 and takes only JSON)."""

    def __init__(self, reject_msgpack=False):
        self.beats: list = []
        self.telemetry_posts = 0
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                data = self.rfile.read(n)
                packed = "msgpack" in self.headers.get("Content-Type", "")
                status, reply = 200, {"ok": True, "alive": {}}
                if self.path == "/rpc/telemetry":
                    stub.telemetry_posts += 1
                    status = 404
                elif packed and reject_msgpack:
                    status = 415
                elif self.path == "/rpc/heartbeat":
                    stub.beats.append((packed, msgpack.unpackb(
                        data, raw=False) if packed else json.loads(data)))
                out = json.dumps(reply).encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("reject_msgpack", [False, True])
def test_a_legacy_master_demotes_the_agent_as_the_references(
        tree, reject_msgpack):
    store = MemoryStore(expiry_tick_s=0.05)
    stub = _LegacyMaster(reject_msgpack)
    coord = InMemoryCoordination(store)
    coord.set(SERVICE_KEY_PREFIX + stub.addr, "{}")
    coord.set(MASTER_KEY, stub.addr)
    agents = [_jax(store, tree).start(), _port(store, tree).start()]
    try:
        assert wait_until(lambda: all(
            sum(1 for _, b in stub.beats if b["name"] == a.name) >= 2
            for a in agents), timeout=15)
        for a in agents:
            assert a.telemetry_stats()["mode"] == "master"
            assert a._hb_wire == ("json" if reject_msgpack else "msgpack")
        kinds = {(b["name"], packed) for packed, b in stub.beats}
        for a in agents:
            assert (a.name, not reject_msgpack) in kinds
        assert stub.telemetry_posts >= 2
    finally:
        for a in agents:
            a.stop()
        stub.close()
        coord.close()
        store.close()


# ---------------------------------------------------------- dp_size 2
DP_KW = dict(max_batch_size=2, decode_horizon=2)


@pytest.fixture(scope="module")
def dp_cluster(tree):
    c = _Cluster(lambda s: _port(s, tree, dp=2, hb=0.3, engine_kw=DP_KW))
    yield c
    c.stop()


class TestDpReplicas:
    def test_two_replicas_advertised(self, dp_cluster):
        agent = dp_cluster.agent
        assert len(agent.engines) == 2
        meta = dp_cluster.master.scheduler.instance_mgr.get_instance_meta(
            agent.name)
        assert meta.dp_size == 2
        stats = requests.get(f"http://{agent.name}/stats", timeout=5).json()
        assert stats["dp_size"] == 2
        text = requests.get(f"http://{agent.name}/metrics", timeout=5).text
        assert "\nengine_dp_size 2\n" in text
        # Replica 1 shares replica 0's weight tensors (one device).
        w0, w1 = (e.params["embed"]["embedding"] for e in agent.engines)
        assert w0 is w1
        assert agent.engines[0].kv_pages.data_ptr() != \
            agent.engines[1].kv_pages.data_ptr()

    def test_output_matches_dp1(self, dp_cluster, tree):
        body = {"prompt": "replicate this output", "max_tokens": 6}
        dp_text, dp_toks, _ = dp_cluster.serve(body)
        one = _Cluster(lambda s: _port(s, tree, engine_kw=DP_KW))
        try:
            assert one.serve(body)[:2] == (dp_text, dp_toks)
        finally:
            one.stop()

    def test_concurrent_capacity_doubles(self, dp_cluster):
        agent = dp_cluster.agent
        peak = [0, 0]
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                for i, e in enumerate(agent.engines):
                    peak[i] = max(peak[i], e.stats()["running"])
                stop.wait(0.01)

        w = threading.Thread(target=watch, daemon=True)
        w.start()
        results: list = []

        def fire(i):
            r = requests.post(dp_cluster.base + "/v1/completions", json=dict(
                GREEDY, prompt=f"distinct prefix number {i} " * 4,
                max_tokens=24), timeout=120)
            results.append(r.status_code)

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        w.join(timeout=5)
        assert results == [200] * 4
        assert peak[0] > 0 and peak[1] > 0

    def test_prefix_affinity(self, dp_cluster):
        agent = dp_cluster.agent
        block = agent.engine.cfg.hash_block_size
        for start in (50, 7, 300):
            toks = list(range(start, start + 40))
            first = agent._pick_engine(toks)
            assert first is agent.engines[hash(tuple(toks[:block])) % 2]
            for _ in range(3):
                assert agent._pick_engine(toks) is first

    def test_cancel_fans_out_and_stats_sum(self, dp_cluster):
        agent = dp_cluster.agent
        seen = []
        for e in agent.engines:
            cancel = e.cancel
            e.cancel = lambda sid, c=cancel: (seen.append(sid), c(sid))
        try:
            agent.cancel("nope")
        finally:
            for e in agent.engines:
                del e.cancel
        assert seen == ["nope", "nope"]
        st = agent.aggregate_stats()
        per = [e.stats() for e in agent.engines]
        assert st["total_generated"] == sum(s["total_generated"]
                                            for s in per)
        assert st["kv_usage_perc"] == max(s["kv_usage_perc"] for s in per)

    def test_kv_events_of_both_replicas_reach_the_index(self, dp_cluster):
        """Prompts placed on each replica: their blocks reach the master's
        KV index through the merged heartbeat events."""
        agent, master = dp_cluster.agent, dp_cluster.master
        tok = agent.engine.tokenizer
        prompts, seen = {}, set()
        for i in range(64):
            p = f"replica placement probe {i} " * 8
            r = agent.engines.index(agent._pick_engine(tok.encode(p)))
            if r not in seen:
                seen.add(r)
                prompts[r] = p
            if len(seen) == 2:
                break
        assert seen == {0, 1}
        before = master.scheduler.kvcache_mgr.num_blocks()
        blocks = 0
        for r, p in prompts.items():
            dp_cluster.serve({"prompt": p, "max_tokens": 2})
            blocks += len(tok.encode(p)) // agent.engine.cfg.hash_block_size
            assert agent.engines[r].stats()["cached_blocks"] > 0
        assert wait_until(lambda: master.scheduler.kvcache_mgr.num_blocks()
                          >= before + blocks, timeout=10)

    def test_replicas_take_their_own_spill_files(self, tree, tmp_path):
        store = MemoryStore(expiry_tick_s=0.05)
        path = str(tmp_path / "spill")
        agent = _port(store, tree, dp=2, engine_kw=dict(
            kv_tier_dram_bytes=1 << 20, kv_tier_ssd_bytes=1 << 20,
            kv_tier_ssd_path=path))
        try:
            assert [e.cfg.kv_tier_ssd_path for e in agent.engines] == \
                [path, path + ".1"]
            assert all(e.tier_store is not None for e in agent.engines)
        finally:
            agent.stop()
            store.close()

    def test_tokens_equal_the_jax_agent_at_dp2(self, dp_cluster, tree):
        jax_c = _Cluster(lambda s: _jax(s, tree, dp=2, hb=0.3,
                                        engine_kw=DP_KW))
        try:
            for p in PROMPTS[:2]:
                body = {"prompt": p, "max_tokens": 6}
                assert dp_cluster.serve(body)[:2] == jax_c.serve(body)[:2]
        finally:
            jax_c.stop()


# ------------------------------------------------ PD under a fault rule
def test_pd_stream_fallback_under_a_pull_fault(tree):
    """A PD pair through the master, the prefill side streaming every
    payload. The first handoff streams; the second's pull is failed by a
    FAULTS rule, and the handoff falls back inline: the same tokens, the
    spans of both paths under the request's trace, and one flight record
    with the prefill agent's engine context."""
    # The decode agent first: the prefill agent's "engine" context
    # provider is then the registered one.
    c = _Cluster(lambda s: _port(s, tree, itype=InstanceType.DECODE),
                 lambda s: _port(s, tree, itype=InstanceType.PREFILL,
                                 kv_stream_threshold_bytes=0))
    dec, pre = c.agents
    c.tokens = _record(dec)
    try:
        assert wait_until(lambda: pre.name in dec.linked_peers
                          and dec.name in pre.linked_peers, timeout=10)
        body = {"prompt": "disaggregate me please", "max_tokens": 6}
        want = c.serve(body)[:2]
        assert (pre.kv_stream_sent, dec.kv_stream_received) == (1, 1)
        RECORDER.clear()
        FAULTS.add("kv_transfer.pull", action="error", max_fires=1)
        got_text, got_toks, sid = c.serve(body)
        assert (got_text, got_toks) == want
        assert (pre.kv_stream_sent, pre.kv_host_sent) == (1, 2)
        assert (dec.kv_stream_received, dec.kv_host_received) == (1, 2)
        records = RECORDER.recent(kind="kv_stream_fallback")
        assert len(records) == 1
        (rec,) = records
        assert rec["request_id"] == sid and rec["detail"]["peer"] == dec.name
        assert rec["engine"]["instance"] == pre.name
        assert rec["num_spans"] >= 3
        status, trace = TRACER.query_trace(request_id=sid)
        assert status == 200
        spans = {(s["point"], s["attrs"].get("path")): s
                 for s in trace["spans"]}
        pull = spans[("kv_transfer.pull", "stream")]
        assert pull["status"].startswith("ERROR") and \
            pull["events"][0]["name"] == "fault"
        assert ("kv_transfer.offer", "stream") in spans
        assert ("kv_transfer.offer", "host") in spans
        assert spans[("engine.decode", None)]["attrs"]["injected"] is True
        assert spans[("engine.prefill", None)]["instance"] == pre.name
        assert len({s["trace_id"] for s in trace["spans"]}) == 1
    finally:
        FAULTS.clear()
        c.stop()
