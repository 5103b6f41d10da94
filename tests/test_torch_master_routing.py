"""RR and CAR routing and the global KV index of the port against the JAX
package's, on the same instance snapshots and KV events.

Each case draws (seeded, and by hypothesis) a fleet of PREFILL, DECODE and
MIX instances with heartbeat loads, KV events (stored, offloaded to DRAM
and SSD, removed) and a stream of requests whose prompts share prefixes.
Both packages' ``InstanceMgr`` (fake channels, no threads),
``GlobalKVCacheMgr`` and policies get the same registrations, heartbeats,
events and requests, in the same order. Every ``Routing`` must be equal in
order, and ``GlobalKVCacheMgr.match`` must give the same overlap scores.
The master's KV-frame upload is held to the reference's too: a replica of
either package mirrors the other's frames into the same index.
"""

import random

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from xllm_service_tpu.common import config as ref_config
from xllm_service_tpu.common import hashing as ref_hashing
from xllm_service_tpu.common import request as ref_request
from xllm_service_tpu.common import types as ref_types
from xllm_service_tpu.coordination import memory as ref_memory
from xllm_service_tpu.scheduler import global_kvcache_mgr as ref_kv
from xllm_service_tpu.scheduler import instance_mgr as ref_im
from xllm_service_tpu.scheduler import policies as ref_policies
from xllm_service_tpu_torch.common import config, hashing, request, types
from xllm_service_tpu_torch.coordination import memory
from xllm_service_tpu_torch.scheduler import global_kvcache_mgr as kv
from xllm_service_tpu_torch.scheduler import instance_mgr as im
from xllm_service_tpu_torch.scheduler import policies

from fakes import FakeChannel, make_meta, wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

BLOCK = 8
REF = dict(config=ref_config, hashing=ref_hashing, request=ref_request,
           types=ref_types, memory=ref_memory, kv=ref_kv, im=ref_im,
           policies=ref_policies)
PORT = dict(config=config, hashing=hashing, request=request, types=types,
            memory=memory, kv=kv, im=im, policies=policies)


def _draw_case(rng: random.Random) -> dict:
    """A fleet, its loads, KV events and requests, as plain data."""
    roles = (["PREFILL"] * rng.randint(0, 3) + ["DECODE"] * rng.randint(0, 3)
             + ["MIX"] * rng.randint(0, 3))
    if not any(r in ("PREFILL", "MIX") for r in roles):
        roles.append("MIX")
    names = [f"10.0.0.{i}:{9000 + i}" for i in range(len(roles))]
    loads = {n: (rng.randint(0, 6), round(rng.random(), 3),
                 rng.randint(0, 4)) for n in names if rng.random() < 0.8}
    prefixes = [[rng.randrange(1000) for _ in range(BLOCK * rng.randint(1, 5))]
                for _ in range(4)]
    events = []
    for _ in range(rng.randint(0, 10)):
        toks = rng.choice(prefixes)
        nb = rng.randint(1, len(toks) // BLOCK)
        kind = rng.choice(["stored", "stored", "stored", "offloaded",
                           "removed"])
        events.append((rng.choice(names), kind, toks[:nb * BLOCK]))
    reqs = []
    for _ in range(rng.randint(1, 8)):
        base = rng.choice(prefixes)
        cut = rng.randint(0, len(base))
        reqs.append(base[:cut] + [rng.randrange(1000)
                                  for _ in range(rng.randint(0, 12))])
    return dict(roles=roles, names=names, loads=loads, events=events,
                reqs=reqs)


def _run(pkg, case, policy_name, max_waiting=8):
    FakeChannel.reset()
    T = pkg["types"]
    store = pkg["memory"].MemoryStore(expiry_tick_s=0.05)
    coord = pkg["memory"].InMemoryCoordination(store)
    opts = pkg["config"].ServiceOptions(block_size=BLOCK,
                                        max_waiting_requests=max_waiting)
    mgr = pkg["im"].InstanceMgr(coord, opts,
                                channel_factory=FakeChannel.factory,
                                start_threads=False)
    kvm = pkg["kv"].GlobalKVCacheMgr(coord, block_size=BLOCK)
    out = []
    try:
        for name, role in zip(case["names"], case["roles"]):
            meta = T.InstanceMetaInfo.from_json(
                make_meta(name, incarnation_id="inc-" + name).to_json())
            meta.type = T.InstanceType(role)
            assert mgr.register_instance(meta, link_peers=False)
        for name, (waiting, hbm, running) in case["loads"].items():
            mgr.record_instance_heartbeat(
                name, "inc-" + name,
                T.LoadMetrics(waiting_requests_num=waiting,
                              hbm_cache_usage_perc=hbm,
                              running_requests_num=running),
                T.LatencyMetrics(recent_max_ttft=10.0, recent_max_tbt=5.0))
        for name, kind, toks in case["events"]:
            keys = pkg["hashing"].prefix_block_hashes(toks, BLOCK)
            kvm.record_updated_kvcaches(name, T.KvCacheEvent(**{kind: keys}))
        policy = pkg["policies"].create_policy(policy_name, mgr, kvm, opts)
        for toks in case["reqs"]:
            ov = kvm.match(toks)
            r = policy.select_instances_pair(
                pkg["request"].Request(token_ids=list(toks)))
            out.append((sorted((k, round(v, 9)) for k, v in ov.scores.items()),
                        ov.max_block_num, ov.matched_blocks,
                        r.prefill_name, r.decode_name, r.encode_name))
    finally:
        mgr.stop()
        kvm.stop()
        coord.close()
        store.close()
    return out


@pytest.mark.parametrize("policy_name", ["RR", "CAR"])
@pytest.mark.parametrize("seed", range(12))
def test_routing_matches_reference_seeded(seed, policy_name):
    case = _draw_case(random.Random(seed))
    got = _run(PORT, case, policy_name)
    assert got == _run(REF, case, policy_name)
    assert all(r[3] for r in got)   # every request found a prefill


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31), policy_name=st.sampled_from(
    ["RR", "CAR"]), max_waiting=st.integers(1, 16))
def test_routing_matches_reference_drawn(seed, policy_name, max_waiting):
    case = _draw_case(random.Random(seed))
    assert _run(PORT, case, policy_name, max_waiting) == \
        _run(REF, case, policy_name, max_waiting)


def test_car_takes_the_prefix_holder():
    """Two MIX instances, one holding a prompt's blocks: CAR picks it in
    both packages, and the overlap score counts its blocks."""
    toks = list(range(4 * BLOCK))
    case = dict(roles=["MIX", "MIX"], names=["a:1", "b:2"], loads={},
                events=[("b:2", "stored", toks[:2 * BLOCK])],
                reqs=[toks, toks[:BLOCK] + [999]])
    for pkg in (PORT, REF):
        res = _run(pkg, case, "CAR")
        assert res[0][0] == [("b:2", 2.0)] and res[0][3] == "b:2"
        assert res[1][0] == [("b:2", 1.0)] and res[1][3] == "b:2"


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port-master-ref-replica",
                              "ref-master-port-replica"])
def test_kv_frames_mirror_across_packages(writer, reader):
    """The master's frame upload (delta frames, then a compaction) read
    by the other package's replica through one coordination store."""
    rng = random.Random(7)
    store = ref_memory.MemoryStore(expiry_tick_s=0.05)
    wc, rc = (ref_memory.InMemoryCoordination(store),
              ref_memory.InMemoryCoordination(store))
    opts = writer["config"].ServiceOptions(block_size=BLOCK)
    master = writer["kv"].GlobalKVCacheMgr(wc, block_size=BLOCK,
                                           is_master=True, options=opts)
    replica = reader["kv"].GlobalKVCacheMgr(rc, block_size=BLOCK,
                                            is_master=False)
    prompts = [[rng.randrange(500) for _ in range(BLOCK * 4)]
               for _ in range(5)]
    try:
        for step in range(6):
            name = f"i{step % 3}:1"
            toks = prompts[step % len(prompts)]
            keys = writer["hashing"].prefix_block_hashes(toks, BLOCK)
            kind = ["stored", "stored", "offloaded", "removed"][step % 4]
            master.record_updated_kvcaches(
                name, writer["types"].KvCacheEvent(**{kind: keys}))
            master.upload_kvcache()

            def same():
                return all(
                    replica.match(p).scores == master.match(p).scores
                    for p in prompts)
            assert wait_until(same, timeout=5)
    finally:
        master.stop()
        replica.stop()
        wc.close()
        rc.close()
        store.close()
