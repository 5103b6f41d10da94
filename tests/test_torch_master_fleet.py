"""The port's master over fleets, against the JAX master on the same
fleets, on the CPU.

- CAR over two MIX port agents: the same requests, sent one at a time
  with each agent's KV events in the index before the next, land on the
  same agents in the same order under both masters, and a request sharing
  two hash blocks with an earlier one goes to the agent holding them,
  whose prefix hits rise.
- A PD pair of port agents linked and routed by the master: both sides
  linked, every request sent to the prefill agent with the decode agent
  named, and the same bodies as the JAX master's pair.
- Failure detection: a port agent killed (its lease left to lapse, its
  server gone) goes LEASE_LOST, then SUSPECT, then is evicted, and the
  next requests complete on the survivor, as under the JAX master; and
  the reference's chaos drills on its fake engines (a crash mid-stream
  failed over byte for byte, or ended with the reference's error frame
  when the retry budget is 0) end the same way under both masters.

Failure detection runs on tenths of a second on both masters alike.
"""

import json
import re
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.common.faults import FAULTS
from xllm_service_tpu.common.metrics import (
    FAILOVER_SUCCESS_TOTAL as REF_FAILOVER_SUCCESS,
)
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu.testing.fake_engine import FakeEngine, FakeEngineConfig
from xllm_service_tpu_torch.common.metrics import FAILOVER_SUCCESS_TOTAL
from xllm_service_tpu_torch.common.types import InstanceType

from fakes import wait_until
from test_torch_master_e2e import GREEDY, Cluster, normalized, port_agent

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

BLOCK = 32   # the agents' hash block; the masters' CAR block size
FAST = dict(lease_ttl_s=0.6, reconcile_interval_s=0.05,
            heartbeat_silence_to_suspect_s=0.4,
            detect_disconnected_instance_interval_s=0.4,
            health_probe_attempts=1, health_probe_timeout_s=0.2,
            sync_interval_s=0.2, failover_backoff_base_s=0.05,
            failover_backoff_max_s=0.3, rpc_backoff_base_s=0.02,
            rpc_backoff_max_s=0.1)


@pytest.fixture(scope="module")
def tree():
    return ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))


def _served_by(agents):
    """Which agent streamed each request: service id -> agent index."""
    log: dict = {}
    for i, agent in enumerate(agents):
        push = agent.streamer.push

        def recording(dest, out, i=i, push=push):
            log.setdefault(out.service_request_id, i)
            push(dest, out)
        agent.streamer.push = recording
    return log


def _kill(agent):
    """Process death, as the master sees it: the server and heartbeats
    stop and the lease is left to lapse (no deregistration)."""
    agent.coord.rm = lambda key: True
    agent.stop()


# --------------------------------------------------------------- CAR (g)
def _car_run(which, tree):
    c = Cluster(which, lambda co: port_agent(co, tree),
                lambda co: port_agent(co, tree), block_size=BLOCK,
                load_balance_policy="CAR")
    served = _served_by(c.agents)
    kvm = c.master.scheduler.kvcache_mgr
    mgr = c.master.scheduler.instance_mgr
    tok = c.master.scheduler.tokenizer
    shared = "the shared system preamble " * 8
    prompts = [shared + "first question", "an unrelated prompt " * 4,
               shared + "second question", "another one entirely " * 3,
               shared + "third"]
    order, hits = [], []

    def settled():
        """Every agent's telemetry fresh and idle, with its current KV
        usage (CAR scores usage, and docks stale entries)."""
        infos = mgr.get_load_infos()
        return not mgr.stale_load_names() and all(
            a.name in infos and infos[a.name].updated_ms
            and infos[a.name].load.waiting_requests_num == 0
            and infos[a.name].load.running_requests_num == 0
            and infos[a.name].load.hbm_cache_usage_perc
            == a.engine.stats()["kv_usage_perc"]
            for a in c.agents)
    try:
        assert wait_until(settled, timeout=10)
        for p in prompts:
            status, headers, data = c.call("POST", "/v1/completions", {
                **GREEDY, "prompt": p, "max_tokens": 4})
            assert status == 200, data
            sid = headers["x-request-id"]
            assert wait_until(lambda: sid in served, timeout=10)
            i = served[sid]
            order.append(i)
            hits.append([a.engine.stats()["prefix_hits"] for a in c.agents])
            # The next routing decision sees this request's KV events and
            # an idle fleet.
            ids = tok.encode(p)
            nblocks = len(ids) // BLOCK
            assert wait_until(
                lambda: kvm.match(ids).scores.get(c.agents[i].name, 0)
                >= nblocks, timeout=10)
            assert wait_until(settled, timeout=10)
        return order, hits, [a.name for a in c.agents]
    finally:
        c.stop()


def test_car_choices_match_the_jax_master(tree):
    want_order, want_hits, _ = _car_run("ref", tree)
    got_order, got_hits, names = _car_run("port", tree)
    assert got_order == want_order
    assert got_hits == want_hits
    # The second and third shared-prefix requests follow the first one's
    # blocks, and their agent counts a prefix hit each time.
    first = got_order[0]
    assert got_order[2] == got_order[4] == first
    assert got_hits[2][first] == got_hits[0][first] + 1
    assert got_hits[4][first] == got_hits[2][first] + 1


# ----------------------------------------------------------------- PD (h)
def test_pd_pair_linked_and_routed_as_the_jax_master(tree):
    results = []
    for which in ("ref", "port"):
        c = Cluster(which,
                    lambda co: port_agent(co, tree,
                                          instance_type=InstanceType.PREFILL),
                    lambda co: port_agent(co, tree,
                                          instance_type=InstanceType.DECODE))
        try:
            pre, dec = c.agents
            assert wait_until(lambda: pre.name in dec.linked_peers
                              and dec.name in pre.linked_peers, timeout=10)
            before = pre.engine.stats()["total_generated"]
            out = [normalized(c.call("POST", "/v1/completions", {
                **GREEDY, "prompt": "disaggregate me please",
                "max_tokens": 6, **extra}))
                for extra in ({}, {"stream": True})]
            out.append(normalized(c.call("POST", "/v1/chat/completions", {
                **GREEDY, "messages": [{"role": "user", "content": "pd"}],
                "max_tokens": 5, "stream": True,
                "stream_options": {"include_usage": True}})))
            # The decode side generated every token; the prefill side none.
            assert pre.engine.stats()["total_generated"] == before
            assert dec.engine.stats()["total_generated"] >= 16
            results.append(out)
        finally:
            c.stop()
    assert results[0][0]["status"] == 200
    assert results[1] == results[0]


def test_port_master_routes_the_pair(tree):
    c = Cluster("port",
                lambda co: port_agent(co, tree,
                                      instance_type=InstanceType.PREFILL),
                lambda co: port_agent(co, tree,
                                      instance_type=InstanceType.DECODE))
    try:
        pre, dec = c.agents
        routing = c.master.scheduler.lb_policy.select_instances_pair
        from xllm_service_tpu_torch.common.request import Request
        r = routing(Request(token_ids=list(range(40))))
        assert (r.prefill_name, r.decode_name) == (pre.name, dec.name)
        assert wait_until(lambda: pre.name in dec.linked_peers, timeout=10)
    finally:
        c.stop()


# ----------------------------------------------------- failure detection (i)
def _detect_run(which, tree):
    c = Cluster(which, lambda co: port_agent(co, tree),
                lambda co: port_agent(co, tree), **FAST)
    served = _served_by(c.agents)
    mgr = c.master.scheduler.instance_mgr
    try:
        victim, survivor = c.agents
        _kill(victim)
        states = []

        def watch():
            entry = mgr._instances.get(victim.name)
            st = entry.state.value if entry is not None else "EVICTED"
            if not states or states[-1] != st:
                states.append(st)
            return st == "EVICTED"
        assert wait_until(watch, timeout=15, interval=0.01)
        outs = []
        for i in range(3):
            status, headers, data = c.call("POST", "/v1/completions", {
                **GREEDY, "prompt": f"after the death {i}",
                "max_tokens": 4})
            outs.append((status, served.get(headers.get("x-request-id"))))
        return states, outs
    finally:
        c.agents[1].stop()
        c.master.stop()
        c.store.close()


def test_killed_agent_is_evicted_as_by_the_jax_master(tree):
    want_states, want_outs = _detect_run("ref", tree)
    got_states, got_outs = _detect_run("port", tree)
    assert got_outs == want_outs == [(200, 1)] * 3
    assert got_states[-1] == want_states[-1] == "EVICTED"
    # LEASE_LOST (the probe still answered, or not yet run) and SUSPECT
    # come in the reference's order; a fast tick may skip the first.
    order = ["ACTIVE", "LEASE_LOST", "SUSPECT", "EVICTED"]
    for states in (got_states, want_states):
        assert states == sorted(states, key=order.index)
        assert "SUSPECT" in states


REPLY = "Resilience is the art of continuing exactly where you left off."


def _fake_engine(coord):
    cfg = FakeEngineConfig(reply_text=REPLY, chunk_size=4, delay_s=0.05,
                           heartbeat_interval_s=0.1, lease_ttl_s=0.5)
    return FakeEngine(coord, cfg)


def _stream(c):
    status, headers, data = c.call("POST", "/v1/completions", {
        "model": "fake-model", "prompt": "chaos", "stream": True,
        "max_tokens": 1000})
    assert status == 200
    text, finishes, errors = "", [], []
    for frame in data.decode().split("\n\n"):
        if not frame.startswith("data: ") or frame == "data: [DONE]":
            continue
        obj = json.loads(frame[6:])
        if "error" in obj:
            err = obj["error"]
            errors.append({**err, "message": re.sub(
                r"\d+\.\d+\.\d+\.\d+:\d+", "<addr>", err["message"])})
        for ch in obj.get("choices", ()):
            text += ch.get("text", "")
            if ch.get("finish_reason"):
                finishes.append(ch["finish_reason"])
    return text, finishes, errors


@pytest.fixture()
def armed_faults():
    FAULTS.configure((), seed=0)
    yield
    FAULTS.clear()


@pytest.mark.parametrize("retries", [3, 0], ids=["failover", "budget-0"])
def test_midstream_crash_ends_as_under_the_jax_master(armed_faults,
                                                      retries):
    outcomes = []
    for which, metric in (("ref", REF_FAILOVER_SUCCESS),
                          ("port", FAILOVER_SUCCESS_TOTAL)):
        c = Cluster(which, _fake_engine, _fake_engine,
                    failover_max_retries=retries, request_timeout_s=60,
                    **{**FAST, "lease_ttl_s": 0.5})
        try:
            clean = _stream(c)
            FAULTS.configure([dict(point="engine.token", action="crash",
                                   after=4, max_fires=1)], seed=0)
            before = metric.value()
            t0 = time.monotonic()
            out = _stream(c)
            assert time.monotonic() - t0 < 20     # no hang to the timeout
            dead = sum(1 for e in c.agents if not e._alive)
            outcomes.append((clean, out, metric.value() - before, dead))
        finally:
            FAULTS.configure((), seed=0)
            for e in c.agents:
                if e._alive:
                    e.stop()
            c.master.stop()
            c.store.close()
    assert outcomes[1] == outcomes[0]
    clean, out, recovered, dead = outcomes[1]
    assert clean == (REPLY, ["stop"], []) and dead == 1
    if retries:
        assert out == clean and recovered == 1
    else:
        assert out[2] and recovered == 0
