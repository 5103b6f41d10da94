"""The SLO_AWARE policy of the port against the JAX package's, on the CPU.

- ``select_pair_on_slo`` on seeded and hypothesis-drawn fleets (role
  lists, request loads, fitted TTFT/TPOT predictors or none, stale
  names, the topology plane on or off): the same pair, the same
  ``estimated_ttft_ms`` and the same flips sent to the sink; the policy
  falls back to round robin for an untokenized request.
- ``create_policy("SLO_AWARE")`` builds the policy (a master process
  started with ``--load-balance-policy SLO_AWARE``:
  ``tests/test_torch_master_failover.py``).
- A replica at SLO_AWARE routes a request of its own over a PREFILL and
  two DECODE fake engines, and the flip its policy proposes (an idle
  surplus decode back to prefill) reaches the elected master, which
  enacts it: the engine's registration moves on both frontends, under
  JAX masters and under port masters alike.
"""

import random
from types import SimpleNamespace

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from xllm_service_tpu.common import topology as ref_topo
from xllm_service_tpu.common.config import ServiceOptions as RefOptions
from xllm_service_tpu.common.request import Request as RefRequest
from xllm_service_tpu.common.time_predictor import TimePredictor as RefTP
from xllm_service_tpu.common.types import InstanceMetaInfo as RefMeta
from xllm_service_tpu.common.types import InstanceType as RefIT
from xllm_service_tpu.scheduler.instance_mgr import InstanceMgr as RefMgr
from xllm_service_tpu.scheduler.policies import slo_aware as ref_slo
from xllm_service_tpu_torch.common import topology as topo
from xllm_service_tpu_torch.common.config import ServiceOptions
from xllm_service_tpu_torch.common.request import Request
from xllm_service_tpu_torch.common.time_predictor import TimePredictor
from xllm_service_tpu_torch.common.types import InstanceMetaInfo
from xllm_service_tpu_torch.common.types import InstanceType
from xllm_service_tpu_torch.scheduler.instance_mgr import InstanceMgr
from xllm_service_tpu_torch.scheduler.policies import (
    SloAwarePolicy,
    create_policy,
)
from xllm_service_tpu_torch.scheduler.policies import slo_aware

from fakes import wait_until
from test_torch_master_multimaster import PKGS, Plane, both, completion

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

SIDES = {
    "ref": SimpleNamespace(topo=ref_topo, Options=RefOptions,
                           Request=RefRequest, TP=RefTP, Meta=RefMeta,
                           IT=RefIT, slo=ref_slo, Mgr=RefMgr),
    "port": SimpleNamespace(topo=topo, Options=ServiceOptions,
                            Request=Request, TP=TimePredictor,
                            Meta=InstanceMetaInfo, IT=InstanceType,
                            slo=slo_aware, Mgr=InstanceMgr),
}
ROLES = ("PREFILL", "DECODE", "MIX")


def draw_fleet(rng: random.Random) -> dict:
    """A fleet description both packages build from: instances with roles,
    predictor tables (or none), KV layouts, placements, request loads,
    stale names, the prompt and the options."""
    n = rng.randint(1, 6)
    insts = []
    for i in range(n):
        ttft = None if rng.random() < 0.25 else [
            [x, rng.uniform(1, 20) + rng.uniform(0, 0.05) * x
             + rng.uniform(0, 1e-5) * x * x]
            for x in (64, 256, 1024, 4096)]
        tpot = None if rng.random() < 0.25 else [
            [b, t, rng.uniform(2, 30) + rng.uniform(0, 3) * b
             + rng.uniform(0, 1e-3) * t]
            for b, t in ((1, 100), (4, 2000), (8, 8000), (16, 30000))]
        insts.append(dict(
            name=f"10.0.{i % 3}.{i}:80{i}", role=rng.choice(ROLES),
            ttft=ttft, tpot=tpot,
            layout=rng.choice([(0, 0, 0), (32, 8, 128), (28, 4, 128)]),
            slice=rng.choice(["s0", "s1", ""]), host=f"h{rng.randint(0, 2)}"))
    names = [d["name"] for d in insts]
    loads = {nm: (rng.randint(0, 3), rng.randint(0, 5000),
                  rng.randint(0, 12), rng.randint(0, 40000))
             for nm in names if rng.random() < 0.8}
    return dict(
        insts=insts, loads=loads,
        stale=sorted(nm for nm in names if rng.random() < 0.2),
        prompt_len=rng.randint(1, 3000),
        target_tpot_ms=rng.choice([5.0, 20.0, 50.0, 200.0]),
        stale_load_penalty=rng.choice([0.0, 0.5, 2.0]),
        topology_tradeoff=rng.choice([0.0, 0.25]),
        topo_active=rng.random() < 0.5,
        kv_bytes_per_token=rng.choice([0, 131072]))


def run_side(which: str, fleet: dict):
    """``select_pair_on_slo`` of one package on the fleet: (prefill name,
    decode name, estimated TTFT, the flips sent to the sink)."""
    S = SIDES[which]
    entries, coords = {}, {}
    prefill, decode = [], []
    for d in fleet["insts"]:
        p = S.TP()
        if d["ttft"]:
            p.fit_ttft(d["ttft"])
        if d["tpot"]:
            p.fit_tpot(d["tpot"])
        layers, heads, hd = d["layout"]
        meta = S.Meta(name=d["name"], type=S.IT(d["role"]),
                      num_layers=layers, num_kv_heads=heads, head_dim=hd)
        entries[d["name"]] = SimpleNamespace(meta=meta, predictor=p)
        coords[d["name"]] = S.topo.Coord(d["slice"] or f"host:{d['host']}",
                                         d["host"], -1, bool(d["slice"]))
        if d["role"] in ("PREFILL", "MIX"):
            prefill.append(d["name"])
        if d["role"] in ("DECODE", "MIX"):
            decode.append(d["name"])
    snap = SimpleNamespace(prefill=tuple(prefill), decode=tuple(decode),
                           entries=entries, coords=coords,
                           topo_active=fleet["topo_active"])
    flips = []
    mgr = SimpleNamespace(
        routing_snapshot=lambda: snap,
        get_request_loads=lambda: dict(fleet["loads"]),
        stale_load_names=lambda: set(fleet["stale"]),
        request_flip=lambda n, t: flips.append(("mgr", n, t.value)),
        get_next_instance_pair=lambda: "rr")
    opts = S.Options(target_tpot_ms=fleet["target_tpot_ms"],
                     stale_load_penalty=fleet["stale_load_penalty"],
                     topology_tradeoff=fleet["topology_tradeoff"],
                     topology_kv_bytes_per_token=fleet[
                         "kv_bytes_per_token"])
    req = S.Request(service_request_id="slo-1",
                    token_ids=list(range(fleet["prompt_len"])))
    r = S.slo.select_pair_on_slo(mgr, opts, req)
    # Through the policy object with a sink of its own, and through the
    # instance manager's entry point (the sink then is request_flip).
    req2 = S.Request(service_request_id="slo-2",
                     token_ids=list(range(fleet["prompt_len"])))
    pol = S.slo.SloAwarePolicy(mgr, opts, flip_sink=lambda n, t: flips
                               .append(("sink", n, t.value)))
    r2 = pol.select_instances_pair(req2)
    mgr._opts = opts
    req3 = S.Request(service_request_id="slo-3",
                     token_ids=list(range(fleet["prompt_len"])))
    r3 = S.Mgr.select_instance_pair_on_slo(mgr, req3)
    rr = pol.select_instances_pair(S.Request(service_request_id="slo-4"))
    pairs = [(x.prefill_name, x.decode_name) for x in (r, r2, r3)]
    ttfts = [q.metrics.estimated_ttft_ms for q in (req, req2, req3)]
    return pairs, ttfts, flips, rr


def _assert_parity(fleet):
    want = run_side("ref", fleet)
    got = run_side("port", fleet)
    assert got == want, (got, want, fleet)
    return got


@pytest.mark.parametrize("seed", range(16))
def test_select_pair_on_slo_matches_the_reference(seed):
    pairs, _, flips, rr = _assert_parity(draw_fleet(random.Random(seed)))
    assert rr == "rr"
    assert pairs[0] == pairs[1] == pairs[2]


def test_seeded_fleets_cover_flips_and_pd_pairs():
    """The seeds above reach both flip directions and a PD pair."""
    seen = set()
    for seed in range(400):
        pairs, _, flips, _ = run_side("port", draw_fleet(random.Random(seed)))
        seen.update(t for _, _, t in flips)
        if pairs[0][1]:
            seen.add("pair")
        if seen >= {"DECODE", "PREFILL", "pair"}:
            break
    assert seen >= {"DECODE", "PREFILL", "pair"}, seen


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(min_value=0, max_value=2 ** 31))
def test_select_pair_on_slo_on_drawn_fleets(seed):
    _assert_parity(draw_fleet(random.Random(seed)))


def test_create_policy_builds_slo_aware():
    pol = create_policy("slo_aware", SimpleNamespace(), None,
                        ServiceOptions())
    assert isinstance(pol, SloAwarePolicy) and pol.flip_sink is None


# ------------------------------------------- SLO_AWARE on a replica, flips
def drill_slo_replica_flip(P):
    """Two masters at SLO_AWARE over a PREFILL and two DECODE fake
    engines. The replica's request finds the prefill busy and both
    decodes idle: it routes the pair and proposes the surplus decode's
    flip to PREFILL, which the elected master enacts."""
    ref_types = __import__("xllm_service_tpu.common.types",
                           fromlist=["InstanceType"]).InstanceType
    pl = Plane(P, engines=({"instance_type": ref_types.PREFILL},
                           {"instance_type": ref_types.DECODE},
                           {"instance_type": ref_types.DECODE}),
               load_balance_policy="SLO_AWARE")
    try:
        m1, m2 = pl.masters
        pre, d1, d2 = (e.name for e in pl.engines)
        mgr = m2.scheduler.instance_mgr
        assert wait_until(lambda: set(mgr.routing_snapshot().decode)
                          == {d1, d2}, timeout=10)
        order = list(mgr.routing_snapshot().decode)
        busy = {pre: (1, 100, 0, 0), d1: (0, 0, 0, 0), d2: (0, 0, 0, 0)}
        mgr.get_request_loads = lambda: dict(busy)
        mgr.stale_load_names = lambda: set()
        chosen = []
        policy = m2.scheduler.lb_policy
        select = policy.select_instances_pair

        def spy(req):
            r = select(req)
            chosen.append((r.prefill_name, r.decode_name))
            return r
        policy.select_instances_pair = spy
        okey = next(k for k in (f"slo-{i}" for i in range(1000))
                    if m2.scheduler.ownership.owner_of(k)
                    == m2.scheduler.self_addr)
        out = completion(m2, okey, prompt="route me by the SLO")
        flipped = order[1]
        PREFILL = P.types.InstanceType.PREFILL
        moved = wait_until(lambda: all(
            (meta := m.scheduler.instance_mgr.get_instance_meta(flipped))
            is not None and meta.type == PREFILL
            for m in (m1, m2)), timeout=10)
        engine = next(e for e in pl.engines if e.name == flipped)
        return dict(
            kind=type(policy).__name__, replica=not m2.scheduler.is_master,
            status=out.status,
            pair=[(p == pre, d == order[0]) for p, d in chosen],
            moved=moved, engine=engine.instance_type.value)
    finally:
        pl.close()


def test_slo_aware_replica_routes_and_its_flip_reaches_the_master():
    assert both(drill_slo_replica_flip) == dict(
        kind="SloAwarePolicy", replica=True, status=200,
        pair=[(True, True)], moved=True, engine="PREFILL")

