"""SLO-aware policy: predictive TTFT/TPOT pair selection with dynamic PD
flipping (copy of ``xllm_service_tpu/scheduler/policies/slo_aware.py``).

Built on the LOCK-FREE data plane, as RR and CAR are: the whole selection reads the RCU routing snapshot (role lists +
predictor coefficients) and the published request-load view
(``InstanceMgr.get_request_loads``) — no `_metrics_lock` fleet re-scan on
the schedule path. Scoring is staleness-aware: instances whose load
telemetry stopped flowing (``InstanceMgr.stale_load_names``) get their
predicted cost inflated by ``stale_load_penalty`` so fresh telemetry
wins ties; relative staleness keeps absolute SLO thresholds undistorted
at bootstrap (all-stale = no discount).

Flip decisions (an overloaded decode fleet flips an idle prefill, a
surplus decode flips back) are emitted through a pluggable ``flip_sink``:
by default ``InstanceMgr.request_flip`` (enacted by the reconcile
thread, never the request path; a replica proxies the hint to the elected
master's ``/rpc/flip_hint``); with the closed-loop autoscaler enabled
the scheduler rewires the sink to the controller's ``propose_flip`` so
there is exactly ONE actuation path (autoscaler/controller.py).
"""

from __future__ import annotations

from typing import Callable, Optional

from .base import LoadBalancePolicy
from ...common import topology as topo
from ...common.request import Request
from ...common.types import InstanceType, Routing

#: Empty request-load tuple: (num_prefill_requests, num_prefill_tokens,
#: num_decode_requests, num_decode_tokens).
_NO_LOAD = (0, 0, 0, 0)


def select_pair_on_slo(mgr, opts, req: Request,
                       flip_sink: Optional[Callable] = None) -> Routing:
    """Shared selection kernel (also the body of
    ``InstanceMgr.select_instance_pair_on_slo``):

    1. prefill = argmin estimated prefill completion time (TTFT predictor
       over queued prefill tokens + this prompt).
    2. decode = first decode instance whose predicted TPOT at (batch+1)
       meets `target_tpot_ms`.
    3. If no decode meets the target and prefill headroom exists, flip an
       idle PREFILL → DECODE; if the decode fleet is over-provisioned (an
       idle decode) flip one DECODE → PREFILL — both through `flip_sink`.
    """
    prompt_len = len(req.token_ids)
    snap = mgr.routing_snapshot()
    loads = mgr.get_request_loads()
    if flip_sink is None:
        flip_sink = mgr.request_flip
    prefills = [(n, snap.entries[n]) for n in snap.prefill]
    decodes = [(n, snap.entries[n]) for n in snap.decode]
    if not prefills:
        return Routing()

    # Staleness discount (multi-master: a non-elected frontend scores
    # off the LOADMETRICS mirror, refreshed once per master sync tick;
    # an entry whose telemetry stopped flowing looks idle forever).
    stale = mgr.stale_load_names()
    stale_factor = 1.0 + max(0.0, opts.stale_load_penalty)

    # 1) best prefill by estimated time-to-serve this prompt.
    def prefill_cost(item):
        name, entry = item
        np_tok = loads.get(name, _NO_LOAD)[1]
        if entry.predictor.has_ttft:
            cost = entry.predictor.predict_ttft(np_tok + prompt_len)
        else:
            cost = float(np_tok + prompt_len)
        return cost * (stale_factor if name in stale else 1.0)

    best_prefill_name, best_prefill = min(prefills, key=prefill_cost)
    req.metrics.estimated_ttft_ms = best_prefill.predictor.predict_ttft(
        loads.get(best_prefill_name, _NO_LOAD)[1] + prompt_len)

    if not decodes:
        return Routing(prefill_name=best_prefill_name)

    # Topology plane (docs/topology.md): model the prefill→decode KV
    # handoff per candidate — payload from the prefill's advertised KV
    # layout (or the configured bytes-per-token stand-in), wire time by
    # link class. Candidates scan cheapest-link-first (stable sort: the
    # legacy order survives within a link class), and the modeled
    # transfer time joins the predicted TTFT below. Dormant on flat
    # fleets (single effective slice) — ordering and score unchanged.
    tradeoff = max(0.0, getattr(opts, "topology_tradeoff", 0.0))
    transfer_ms: dict[str, float] = {}
    if tradeoff > 0 and getattr(snap, "topo_active", False):
        cp = snap.coords[best_prefill_name]
        nbytes = topo.kv_handoff_bytes(best_prefill.meta, prompt_len) \
            or getattr(opts, "topology_kv_bytes_per_token", 0) * prompt_len
        for name, _e in decodes:
            link = topo.link_class(cp, snap.coords[name])
            transfer_ms[name] = 1000.0 * topo.transfer_cost(
                nbytes, link,
                getattr(opts, "topology_ici_bytes_per_s", 0.0),
                getattr(opts, "topology_dcn_bytes_per_s", 0.0))
        if nbytes > 0:
            decodes = sorted(decodes, key=lambda it: transfer_ms[it[0]])

    # 2) first decode meeting the TPOT target.
    chosen_decode: Optional[str] = None
    for name, entry in decodes:
        _, _, nd_req, nd_tok = loads.get(name, _NO_LOAD)
        tpot = entry.predictor.predict_tpot(
            nd_req + 1, nd_tok + prompt_len) \
            if entry.predictor.has_tpot else 0.0
        if name in stale:
            tpot *= stale_factor
        if tpot <= opts.target_tpot_ms:
            chosen_decode = name
            break

    if chosen_decode is None:
        # 3) overloaded decode fleet: propose a P→D flip of an idle
        # prefill through the sink (reference `instance_mgr.cpp:
        # 1023-1063`); the flip's engine RPC + coordination writes run
        # on the reconcile path — never on this request path, where a
        # slow engine would stall the client's TTFT. This request falls
        # back least-loaded; the flipped capacity serves the ones after
        # it. A stale idle-looking prefill is NOT flipped: its telemetry
        # may hide live load.
        idle_prefill = next(
            (n for n, e in prefills
             if n != best_prefill_name
             and loads.get(n, _NO_LOAD)[0] == 0
             and n not in stale
             and e.meta.type == InstanceType.PREFILL),
            None)
        if idle_prefill is not None and len(prefills) > 1:
            flip_sink(idle_prefill, InstanceType.DECODE)
        chosen_decode = min(
            decodes, key=lambda it: loads.get(it[0], _NO_LOAD)[3])[0]
    else:
        # Opportunistic D→P flip when some decode instance is completely
        # idle and prefill queue is deep (reference auto flip at zero
        # decode load, `instance_mgr.cpp:900-902`).
        if len(decodes) > 1 \
                and loads.get(best_prefill_name, _NO_LOAD)[0] > 0:
            idle_decode = next(
                (n for n, e in decodes
                 if n != chosen_decode
                 and loads.get(n, _NO_LOAD)[2] == 0
                 and n not in stale
                 and e.meta.type == InstanceType.DECODE),
                None)
            surplus = sum(1 for n, _ in decodes
                          if loads.get(n, _NO_LOAD)[2] == 0)
            if idle_decode is not None and surplus > 1:
                flip_sink(idle_decode, InstanceType.PREFILL)

    if chosen_decode == best_prefill_name:
        return Routing(prefill_name=best_prefill_name)
    # Predicted TTFT now includes the modeled KV-handoff wire time for
    # the pair actually chosen (0 for mix-collapse and flat fleets).
    req.metrics.estimated_ttft_ms += transfer_ms.get(chosen_decode, 0.0)
    return Routing(prefill_name=best_prefill_name, decode_name=chosen_decode)


class SloAwarePolicy(LoadBalancePolicy):
    """Untokenized requests fall back to RR; tokenized ones go through
    the lock-free predictive selection above. ``flip_sink`` (None: the
    instance manager's ``request_flip``) takes the flips it proposes."""

    def __init__(self, instance_mgr, options=None,
                 flip_sink: Optional[Callable] = None):
        self._mgr = instance_mgr
        self._opts = options
        self.flip_sink = flip_sink

    def select_instances_pair(self, request: Request) -> Routing:
        if not request.token_ids:
            return self._mgr.get_next_instance_pair()
        opts = self._opts if self._opts is not None else self._mgr._opts
        return select_pair_on_slo(self._mgr, opts, request,
                                  flip_sink=self.flip_sink)
