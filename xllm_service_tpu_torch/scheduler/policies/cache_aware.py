"""Cache-aware routing (CAR).

Parity: reference `cache_aware_routing.cpp:22-85` —
``score = matched_blocks / max_block_num − hbm_cache_usage_perc −
waiting / max_waiting`` per candidate, argmax per role; prefix match comes
from the GlobalKVCacheMgr.

Hot-path contract: this runs on every schedule when CAR is the configured
policy, so the whole selection is LOCK-FREE — ``match()`` walks the
RCU-published prefix index with the request's memoized block hashes
(``Request.prefix_hashes``: hashed once, in the tokenize stage), and
``get_load_infos()`` reads the instance manager's published load snapshot.
"""

from __future__ import annotations

from .base import LoadBalancePolicy
from ...common import topology as topo
from ...common.request import Request
from ...common.types import InstanceType, Routing

_PREFILL_TYPES = (InstanceType.PREFILL, InstanceType.MIX, InstanceType.DEFAULT)
_DECODE_TYPES = (InstanceType.DECODE, InstanceType.MIX)


class CacheAwareRoutingPolicy(LoadBalancePolicy):
    def __init__(self, instance_mgr, kvcache_mgr, options):
        self._mgr = instance_mgr
        self._kv = kvcache_mgr
        self._opts = options

    def select_instances_pair(self, request: Request) -> Routing:
        if not request.token_ids:
            return self._mgr.get_next_instance_pair()
        overlap = self._kv.match(
            request.token_ids,
            block_hashes=request.prefix_hashes(self._opts.block_size))
        infos = self._mgr.get_load_infos()
        max_blocks = max(overlap.max_block_num, 1)
        max_waiting = max(self._opts.max_waiting_requests, 1)
        # Staleness discount (multi-master frontends score off mirrored
        # telemetry): an entry whose load stopped updating looks idle and
        # cache-hot forever — dock it `stale_load_penalty` score units so
        # fresh telemetry wins. Relative staleness: the set is empty when
        # ALL entries are equally stale (bootstrap / idle fleet), where a
        # uniform discount carries no signal.
        stale = self._mgr.stale_load_names()
        penalty = max(0.0, self._opts.stale_load_penalty)

        def score(info) -> float:
            matched = overlap.scores.get(info.name, 0.0)
            return (matched / max_blocks
                    - info.load.hbm_cache_usage_perc
                    - info.load.waiting_requests_num / max_waiting
                    - (penalty if info.name in stale else 0.0))

        prefills = [i for i in infos.values()
                    if i.schedulable and i.type in _PREFILL_TYPES]
        decodes = [i for i in infos.values()
                   if i.schedulable and i.type in _DECODE_TYPES]
        if not prefills:
            return Routing()
        best_p = max(prefills, key=score)
        if not decodes:
            return Routing(prefill_name=best_p.name)
        # Topology-aware decode tier (docs/topology.md): dock each decode
        # candidate by `topology_tradeoff * link_penalty` for the link
        # class of the prefill→decode KV handoff — a cross-slice DCN
        # partner beats a same-slice ICI one only when its load/cache
        # advantage exceeds the knob. Armed only when the candidates span
        # >= 2 effective slices; flat fleets score exactly as before.
        tradeoff = max(0.0, getattr(self._opts, "topology_tradeoff", 0.0))
        dscore = score
        if tradeoff > 0 and topo.fleet_topo_active(
                [topo.Coord(i.slice_id, i.host)
                 for i in prefills + decodes]):
            cp = topo.Coord(best_p.slice_id, best_p.host)

            def dscore(info) -> float:
                link = topo.link_class(
                    cp, topo.Coord(info.slice_id, info.host))
                return score(info) - tradeoff * topo.link_penalty(link)

        best_d = max(decodes, key=dscore)
        if best_d.name == best_p.name:
            # Collision: the top decode candidate is the instance already
            # chosen for prefill (only a MIX node can appear in both
            # lists). On a PD-disaggregated fleet, collapsing both stages
            # onto it would silently drop the decode leg — take the
            # second-best DEDICATED decode instead. When the only
            # alternatives are other MIX nodes, collapse onto the winner:
            # a MIX instance serves both stages natively, and splitting
            # two MIX nodes pays a cross-instance KV handoff for capacity
            # the collapsed instance already has.
            others = [i for i in decodes if i.name != best_p.name
                      and i.type == InstanceType.DECODE]
            if not others:
                return Routing(prefill_name=best_p.name)
            best_d = max(others, key=dscore)
        return Routing(prefill_name=best_p.name, decode_name=best_d.name)
