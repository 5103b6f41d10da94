"""Planner: fleet-level scaling + PD-ratio decisions.

Reference parity: `docs/en/overview.md:56-60` names the Planner ("makes
global optimized decisions, such as instances scaling in/out or PD role
switching") as a system component but ships no code for it — the design
here is ours. The Planner runs on the master's sync cadence and:

- computes fleet pressure from heartbeat telemetry (waiting depth, KV
  usage, recent TTFT/TPOT vs the SLO targets),
- enacts PD-ratio corrections through InstanceMgr.request_flip (executed
  by the reconcile thread, never a request path),
- publishes scale-out/in *hints* to a coordination key
  (`XLLM:PLANNER:decision`) and the admin API — the actual instance
  lifecycle belongs to an external autoscaler (on TPU: whatever manages
  slice reservations), which watches that key.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Optional

from ..common.config import ServiceOptions
from ..common.metrics import PLANNER_SCALE_HINT
from ..common.types import InstanceType
from ..devtools import ownership as _ownership
from ..utils import get_logger

logger = get_logger(__name__)

PLANNER_KEY = "XLLM:PLANNER:decision"


@dataclass
class PlanDecision:
    ts_ms: int = 0
    # Positive = add instances, negative = remove (hint for an external
    # autoscaler; the service never kills instances itself).
    scale_hint: int = 0
    prefill_pressure: float = 0.0
    decode_pressure: float = 0.0
    kv_pressure: float = 0.0
    flips_requested: list = field(default_factory=list)
    reasons: list = field(default_factory=list)
    # Telemetry freshness of the load-info view this decision was planned
    # from (multi-master: a plan computed off a stale mirror should say
    # so). max_load_age_s is -1 when no entry ever updated.
    max_load_age_s: float = 0.0
    stale_load_entries: list = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(asdict(self))


@_ownership.verify_state
class Planner:
    # Pressure thresholds (fractions of capacity / SLO).
    SCALE_OUT_PRESSURE = 1.5    # waiting ≥ 1.5x running capacity
    SCALE_IN_PRESSURE = 0.1     # fleet nearly idle
    KV_PRESSURE = 0.92          # KV pools nearly full
    MIN_FLEET = 1

    def __init__(self, instance_mgr, options: ServiceOptions):
        self._mgr = instance_mgr
        self._opts = options
        self.last_decision: Optional[PlanDecision] = None
        # Flip actuation sink: by default straight into the instance
        # manager's pending-flip queue (today's behavior); with the
        # closed-loop autoscaler enabled the scheduler rewires this to
        # the controller's propose_flip, so there is exactly ONE
        # actuation path (autoscaler/controller.py) and the controller's
        # cooldown/hysteresis guards govern planner-driven flips too.
        self.flip_sink = instance_mgr.request_flip

    def plan_once(self) -> PlanDecision:
        d = PlanDecision(ts_ms=int(time.time() * 1000))
        infos = list(self._mgr.get_load_infos().values())
        if not infos:
            d.scale_hint = self.MIN_FLEET
            d.reasons.append("no instances registered")
            return self._finish(d)

        ages = self._mgr.load_info_ages_s()
        d.max_load_age_s = max(ages.values(), default=0.0)
        d.stale_load_entries = sorted(self._mgr.stale_load_names())
        if d.stale_load_entries:
            d.reasons.append(
                f"load telemetry stale for {len(d.stale_load_entries)} "
                f"instance(s); their scoring is discounted")

        n = len(infos)
        waiting = sum(i.load.waiting_requests_num for i in infos)
        running = sum(i.load.running_requests_num for i in infos)
        kv_max = max(i.load.hbm_cache_usage_perc for i in infos)
        capacity = max(1, running + n)   # rough headroom proxy
        pressure = waiting / capacity
        d.kv_pressure = kv_max

        prefills = [i for i in infos if i.type == InstanceType.PREFILL]
        decodes = [i for i in infos if i.type == InstanceType.DECODE]
        d.prefill_pressure = (
            sum(i.load.waiting_requests_num for i in prefills) /
            max(1, len(prefills))) if prefills else 0.0
        d.decode_pressure = (
            sum(i.load.running_requests_num for i in decodes) /
            max(1, len(decodes))) if decodes else 0.0

        # TPOT SLO breach on decodes with idle prefills -> request a flip
        # (the same corrective the SLO policy applies per-request, but
        # driven fleet-wide from telemetry). Target selection runs on
        # the RCU load-info snapshot (`infos` above — no manager lock),
        # staleness-aware like the rebuilt SLO policy: stale entries are
        # neither breach evidence (their worst-TBT sample may predate an
        # instance restart) nor flip candidates (an idle-LOOKING stale
        # prefill may be carrying load its telemetry stopped reporting).
        stale = set(d.stale_load_entries)
        slow_decodes = [
            i for i in decodes
            if i.latency.recent_max_tbt > self._opts.target_tpot_ms
            and i.name not in stale]
        idle_prefills = [
            i for i in prefills if i.load.waiting_requests_num == 0
            and i.load.running_requests_num == 0
            and i.name not in stale]
        # Topology locality (docs/topology.md): flip WITHIN a slice
        # before across one — a flipped prefill serves the slow decode's
        # slice, so its future PD partners ride ICI, not DCN. Falls back
        # to any idle prefill when no same-slice candidate exists; on
        # flat fleets every instance shares one effective slice and the
        # preference is a no-op (load-info slice_id is always populated
        # with the effective coordinate).
        idle_prefill = None
        if idle_prefills:
            slow_slices = {i.slice_id for i in slow_decodes}
            idle_prefill = next(
                (i.name for i in idle_prefills if i.slice_id in slow_slices),
                idle_prefills[0].name)
        if slow_decodes and idle_prefill and len(prefills) > 1:
            self.flip_sink(idle_prefill, InstanceType.DECODE)
            d.flips_requested.append([idle_prefill, "DECODE"])
            d.reasons.append("decode TPOT over target; flipping idle "
                             "prefill")

        if pressure >= self.SCALE_OUT_PRESSURE or kv_max >= self.KV_PRESSURE:
            d.scale_hint = max(1, round(n * 0.5))
            d.reasons.append(
                f"pressure={pressure:.2f} kv={kv_max:.2f}: scale out")
        elif pressure <= self.SCALE_IN_PRESSURE and waiting == 0 \
                and running == 0 and n > self.MIN_FLEET and kv_max < 0.5:
            d.scale_hint = -1
            d.reasons.append("fleet idle: scale in")
        return self._finish(d)

    def _finish(self, d: PlanDecision) -> PlanDecision:
        self.last_decision = d
        # Export the headline decision so SLO dashboards / the autoscaler
        # can read it off /metrics without polling /admin/planner.
        PLANNER_SCALE_HINT.set(d.scale_hint)
        return d
