"""The port's runtime verifiers (``xllm_service_tpu_torch/devtools``)
against the reference's, and the port's master and agent under all four.

1. Each package's own classes are misused in the same way, with its
   verifiers armed: an inverted lock order, a lock held across a fault
   point, a mutated RCU publication, a write without its lock, a leaked
   and a doubly released admission slot. The port's verifiers must record
   the same kinds and counts of violation as the reference's.
2. A drill: the port's master, its in-memory coordination and a tiny
   llama port agent on the CPU, built with all four verifiers armed.
   Streams are served, one is cancelled by its client, the agent dies
   (its lease lapses, it does not deregister) and the master evicts it.
   No verifier may record a violation, no strict pair may stay
   unbalanced, and the tokens must equal the same drill's with the
   verifiers off (where nothing on the path is instrumented).
"""

import collections
import contextlib
import http.client
import importlib
import json
import threading

import pytest
import torch

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

PACKAGES = ("xllm_service_tpu", "xllm_service_tpu_torch")


def _devtools(pkg):
    return {name: importlib.import_module(f"{pkg}.devtools.{name}")
            for name in ("locks", "rcu", "ownership", "lifecycle")}


def _reset(dt):
    for name in ("locks", "rcu", "ownership", "lifecycle"):
        dt[name].reset_violations()
    dt["lifecycle"].reset_balances()


@contextlib.contextmanager
def armed(pkg):
    """All four verifiers of ``pkg`` on, for objects built inside."""
    dt = _devtools(pkg)
    _reset(dt)
    for name in ("locks", "rcu", "ownership", "lifecycle"):
        dt[name].set_debug(True)
    try:
        yield dt
    finally:
        for name in ("ownership", "rcu", "lifecycle", "locks"):
            dt[name].set_debug(False)
        _reset(dt)


def _kinds(vs):
    return collections.Counter(v.kind for v in vs)


def misuse(pkg):
    """Every misuse once; the kinds each verifier recorded."""
    budget_mod = importlib.import_module(f"{pkg}.overload.retry_budget")
    adm_mod = importlib.import_module(f"{pkg}.overload.admission")
    mgr_mod = importlib.import_module(f"{pkg}.scheduler.instance_mgr")
    faults = importlib.import_module(f"{pkg}.common.faults")
    with armed(pkg) as dt:
        budget = budget_mod.RetryBudget()
        adm = adm_mod.AdmissionController()
        # Lock order: the budget's lock (838) is taken before the
        # admission gate's (832).
        with budget._lock:
            with adm._lock:
                pass
        # A hold across a fault point (a modeled blocking call).
        with adm._lock:
            faults.FAULTS.fire("rpc.post")
        # A mutated publication.
        snap = dt["rcu"].publish(mgr_mod.RoutingSnapshot({}))
        with pytest.raises(dt["rcu"].RcuMutationError):
            snap.built_ms = 0
        # A write without the declared lock.
        budget._tokens = 3.0
        # A slot admitted twice, released three times: one double release,
        # then one more admit that is never released (a strict leak).
        assert adm.try_admit("online", live=1, burn_hot=False)[0]
        adm.release()
        adm.release()
        assert adm.try_admit("online", live=1, burn_hot=False)[0]
        return {
            "locks": _kinds(dt["locks"].violations()),
            "rcu": _kinds(dt["rcu"].violations()),
            "ownership": _kinds(dt["ownership"].violations()),
            "lifecycle": _kinds(dt["lifecycle"].violations()),
            "strict": collections.Counter(
                (v.kind, v.pair) for v in dt["lifecycle"].strict_imbalances()),
        }


def test_misuse_is_recorded_as_the_reference_records_it():
    ref, port = (misuse(pkg) for pkg in PACKAGES)
    assert port == ref
    assert port["locks"] == {"lock-order": 1, "held-across-yield": 1}
    assert port["rcu"] == {"frozen-mutation": 1}
    assert port["ownership"] == {"state-lock": 1}
    assert port["lifecycle"] == {"double-release": 1}
    assert port["strict"] == {("leak", "admission-slot"): 1}


def test_verifiers_off_instrument_nothing():
    """Normal mode is a passthrough: plain locks, the published object
    itself, the classes' own ``__setattr__``."""
    from xllm_service_tpu_torch.devtools import locks, ownership, rcu
    from xllm_service_tpu_torch.overload.retry_budget import RetryBudget
    from xllm_service_tpu_torch.scheduler.instance_mgr import InstanceMgr

    assert not (locks.debug_enabled() or rcu.debug_enabled()
                or ownership.debug_enabled())
    lk = locks.make_lock("probe", order=1)
    assert type(lk) is type(threading.Lock())
    obj = {"a": [1]}
    assert rcu.publish(obj) is obj
    assert RetryBudget.__setattr__ is object.__setattr__
    assert InstanceMgr.__setattr__ is object.__setattr__


# ---------------------------------------------------------------- the drill
def _cluster(armed_pkg):
    from xllm_service_tpu_torch.common.config import ServiceOptions
    from xllm_service_tpu_torch.coordination import memory
    from xllm_service_tpu_torch.engine import EngineConfig
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.master import Master
    from xllm_service_tpu_torch.models.base import tiny_config

    store = memory.MemoryStore(expiry_tick_s=0.05)
    # Failure detection in tenths of a second (the fleet drills' values).
    master = Master(ServiceOptions(
        host="127.0.0.1", http_port=0, rpc_port=0, lease_ttl_s=0.6,
        sync_interval_s=0.2, reconcile_interval_s=0.05,
        heartbeat_silence_to_suspect_s=0.4,
        detect_disconnected_instance_interval_s=0.4,
        health_probe_attempts=1, health_probe_timeout_s=0.2),
        coord=memory.InMemoryCoordination(store))
    master.start()
    agent = EngineAgent(
        EngineConfig(model=tiny_config(dtype=torch.float32,
                                       max_context_len=256),
                     num_pages=64, page_size=16, hash_block_size=32,
                     max_batch_size=4, max_seq_len=256),
        AgentConfig(host="127.0.0.1", model_id="tiny-llama",
                    heartbeat_interval_s=0.2, lease_ttl_s=0.6),
        coord=memory.InMemoryCoordination(store), device="cpu").start()
    mgr = master.scheduler.instance_mgr
    assert wait_until(lambda: mgr.get_instance_meta(agent.name), timeout=15)
    return store, master, agent


def _post(port, body, read_all=True):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request("POST", "/v1/completions", body=json.dumps(body).encode(),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    if not read_all:
        first = r.fp.readline()   # the first SSE line, then hang up
        c.close()
        return first
    data = r.read()
    c.close()
    assert r.status == 200, data
    return data


def _texts(sse: bytes):
    out = []
    for frame in sse.decode().split("\n\n"):
        if frame.startswith("data: ") and frame != "data: [DONE]":
            out += [ch["text"] for ch in json.loads(frame[6:])["choices"]]
    return "".join(out)


def drill(arm: bool):
    ctx = armed("xllm_service_tpu_torch") if arm \
        else contextlib.nullcontext()
    with ctx as dt:
        store, master, agent = _cluster(arm)
        port = master.http_port
        try:
            texts = []
            for prompt in ("alpha beta", "gamma"):
                texts.append(_texts(_post(port, {
                    "model": "tiny-llama", "prompt": prompt,
                    "max_tokens": 12, "temperature": 0, "stream": True})))
            whole = json.loads(_post(port, {
                "model": "tiny-llama", "prompt": "delta", "max_tokens": 8,
                "temperature": 0}))
            texts.append(whole["choices"][0]["text"])
            # A client that hangs up mid-stream: the master cancels it.
            assert _post(port, {"model": "tiny-llama", "prompt": "epsilon",
                                "max_tokens": 200, "temperature": 0,
                                "stream": True}, read_all=False)
            sched = master.scheduler
            assert wait_until(lambda: not sched._requests, timeout=30)
            # The agent dies: no more beats, its lease lapses, it never
            # deregisters; the master evicts it.
            agent._wake.set()
            agent.coord.close()
            mgr = sched.instance_mgr
            assert wait_until(lambda: mgr.get_instance_meta(agent.name)
                              is None, timeout=20)
        finally:
            agent.stop()
            master.stop()
            store.close()
        found = None
        if dt is not None:
            found = {name: [str(v) for v in dt[name].violations()]
                     for name in ("locks", "rcu", "ownership", "lifecycle")}
            found["strict"] = [str(v) for v in
                               dt["lifecycle"].strict_imbalances()]
        return texts, found


def test_master_and_agent_under_all_four_verifiers():
    plain, none_found = drill(arm=False)
    assert none_found is None
    texts, found = drill(arm=True)
    assert found == {"locks": [], "rcu": [], "ownership": [],
                     "lifecycle": [], "strict": []}
    assert texts == plain
    assert all(texts)
