"""Counters, gauges and histograms with Prometheus text export (copy of
the instruments of ``xllm_service_tpu/common/metrics.py`` and of its
families: the master's, the overload and coordination planes', and the
engine agent's two).

Instruments may declare ``labelnames``; a call site then takes a child
series with ``.labels(peer=...)`` (every declared label, by keyword) and
the family renders each child with escaped label pairs in declared order
(``_bucket`` lines put ``le`` first). Reads take the lock the writers
take, so a histogram's buckets, sum and count render consistently.
"""

from __future__ import annotations

import re as _re
import threading
from bisect import bisect_right
from typing import Any, Iterable, Optional

from ..devtools import lifecycle as _lifecycle


def _escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(pairs: Iterable[tuple[str, str]]) -> str:
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}" if inner else ""


class _Metric:
    kind = ""

    def __init__(self, name: str, help_: str, labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        # Set on children made by labels(); () on families and plain series.
        self._labelvalues: tuple[str, ...] = ()
        self._lock = threading.Lock()   # lock-order: 810
        self._children: dict[tuple[str, ...], Any] = {}

    def _label_suffix(self,
                      extra: Optional[tuple[str, str]] = None) -> str:
        pairs: list[tuple[str, str]] = [extra] if extra else []
        pairs += list(zip(self.labelnames, self._labelvalues))
        return _render_labels(pairs)

    def _child_key(self, kw: dict[str, Any]) -> tuple[str, ...]:
        if not self.labelnames:
            raise ValueError(
                f"metric {self.name} declares no labels; call inc()/set()/"
                f"observe() directly")
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} requires exactly labels "
                f"{self.labelnames}, got {tuple(sorted(kw))}")
        return tuple(str(kw[k]) for k in self.labelnames)

    def _new_child(self) -> "_Metric":
        return type(self)(self.name, self.help)

    def labels(self, **kw: Any):
        key = self._child_key(kw)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                child.labelnames = self.labelnames
                child._labelvalues = key
                self._children[key] = child
                _lifecycle.note_series_created(self.name, key)
            return child

    def remove(self, **kw: Any) -> None:
        """Drop one child series, so the exposition stops exporting a label
        set whose subject is gone (use :func:`evict_series`)."""
        key = self._child_key(kw)
        with self._lock:
            self._children.pop(key, None)

    def _check_unlabeled(self, op: str) -> None:
        if self.labelnames and not self._labelvalues:
            raise ValueError(f"metric {self.name} is labeled; use "
                             f".labels(...).{op}()")


class _Scalar(_Metric):
    def __init__(self, name: str, help_: str = "",
                 labelnames: Iterable[str] = ()):
        super().__init__(name, help_, labelnames)
        self._v = 0.0

    def inc(self, v: float = 1.0) -> None:
        self._check_unlabeled("inc")
        with self._lock:
            self._v += v

    def value(self) -> float:
        """Plain series: its value. Labeled family: the sum over children."""
        with self._lock:
            v = self._v
            children = list(self._children.values())
        return v + sum(c.value() for c in children)

    def render(self) -> str:
        with self._lock:
            v = self._v
            children = sorted(self._children.items())
        if self.labelnames and not self._labelvalues:
            return "".join(c.render() for _, c in children)
        return f"{self.name}{self._label_suffix()} {v}\n"


class Counter(_Scalar):
    kind = "counter"


class Gauge(_Scalar):
    kind = "gauge"

    def set(self, v: float) -> None:
        self._check_unlabeled("set")
        with self._lock:
            self._v = float(v)


_DEFAULT_BUCKETS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000,
                    10000, 30000)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: Iterable[float] = _DEFAULT_BUCKETS,
                 labelnames: Iterable[str] = ()):
        super().__init__(name, help_, labelnames)
        self.buckets = sorted(buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0

    def _new_child(self) -> "Histogram":
        return Histogram(self.name, self.help, self.buckets)

    def observe(self, v: float) -> None:
        self._check_unlabeled("observe")
        with self._lock:
            self._counts[bisect_right(self.buckets, v)] += 1
            self._sum += v
            self._n += 1

    def count(self) -> int:
        with self._lock:
            n = self._n
            children = list(self._children.values())
        return n + sum(c.count() for c in children)

    def mean(self) -> float:
        with self._lock:
            s, n = self._sum, self._n
            children = list(self._children.values())
        for c in children:
            with c._lock:
                s += c._sum
                n += c._n
        return s / n if n else 0.0

    def render(self) -> str:
        with self._lock:
            counts = list(self._counts)
            total_sum, total_n = self._sum, self._n
            children = sorted(self._children.items())
        if self.labelnames and not self._labelvalues:
            return "".join(c.render() for _, c in children)
        out = []
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(f"{self.name}_bucket"
                       f"{self._label_suffix(('le', str(b)))} {cum}\n")
        cum += counts[-1]
        out.append(f"{self.name}_bucket"
                   f"{self._label_suffix(('le', '+Inf'))} {cum}\n")
        out.append(f"{self.name}_sum{self._label_suffix()} {total_sum}\n")
        out.append(f"{self.name}_count{self._label_suffix()} {total_n}\n")
        return "".join(out)


def evict_series(metric: _Metric, **labels: Any) -> None:
    """Drop one labeled child series when its subject goes away (an
    instance evicted, a PD peer unlinked, the heartbeat master changed),
    so a long-lived process's exposition stays bounded.

    This is the single blessed release site for the ``metric-series``
    effect pair (devtools/lifecycle.py): xlint's ``pair-evict`` rule
    flags direct ``.remove()`` calls outside this module, and under
    ``XLLM_LEAK_DEBUG=1`` the evicted key is tombstoned so a later
    stale write re-creating the series (the gauge-resurrection bug) is
    reported."""
    key = metric._child_key(labels)
    metric.remove(**labels)
    _lifecycle.note_series_evicted(metric.name, key)


def relabel_prometheus_text(text: str, instance: str, role: str,
                            strip_comments: bool = False) -> str:
    """Stamp fleet-target labels onto a scraped Prometheus exposition
    (the /metrics/fleet merge): every sample line gains
    ``instance="<addr>",role="frontend|engine"``. A series that already
    carries an ``instance`` label (the master's per-engine series) keeps
    it as ``exported_instance`` — the same collision rule Prometheus
    federation applies with honor_labels=false. Comment/blank lines pass
    through (or are dropped with ``strip_comments`` — the fleet merge
    strips foreign sources' ``# TYPE`` lines, which would duplicate);
    unparseable lines are dropped rather than corrupting the merged
    exposition."""
    extra = (f'instance="{_escape_label_value(instance)}",'
             f'role="{_escape_label_value(role)}"')

    def _is_value(v: str) -> bool:
        try:
            float(v.split()[0])
            return True
        except (ValueError, IndexError):
            return False

    out: list[str] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            if line and not strip_comments:
                out.append(line)
            continue
        brace = line.find("{")
        if brace < 0:
            # name value [ts]
            parts = line.split(None, 1)
            if len(parts) != 2 or not _is_value(parts[1]):
                continue
            out.append(f"{parts[0]}{{{extra}}} {parts[1]}")
            continue
        close = line.rfind("}")
        if close < brace:
            continue
        name, labels, rest = line[:brace], line[brace + 1:close], \
            line[close + 1:].lstrip()
        if not rest or not _is_value(rest):
            continue
        labels = _re.sub(r"(^|,)instance=", r"\1exported_instance=",
                         labels)
        inner = f"{labels},{extra}" if labels else extra
        out.append(f"{name}{{{inner}}} {rest}")
    return "\n".join(out) + ("\n" if out else "")


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()   # lock-order: 814

    def counter(self, name: str, help_: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(
            name, lambda: Counter(name, help_, labelnames), Counter,
            labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(
            name, lambda: Gauge(name, help_, labelnames), Gauge, labelnames)

    def histogram(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS,
                  labelnames: Iterable[str] = ()) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help_, buckets, labelnames),
            Histogram, labelnames)

    def _get_or_create(self, name, factory, cls, labelnames=()):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as "
                                f"{type(m).__name__}")
            elif m.labelnames != tuple(labelnames):
                raise TypeError(
                    f"metric {name} already registered with labels "
                    f"{m.labelnames}, not {tuple(labelnames)}")
            return m

    def render_prometheus(self) -> str:
        parts = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                parts.append(f"# HELP {m.name} {m.help}\n")
            parts.append(f"# TYPE {m.name} {m.kind}\n")
            parts.append(m.render())
        return "".join(parts)


# Global registry + the reference's instruments (`metrics.h:108-111`).
# TTFT/ITL carry {instance, policy} so tail latency can be attributed to a
# routing decision; the frontend counter carries the API kind.
REGISTRY = MetricsRegistry()
SERVER_REQUEST_IN_TOTAL = REGISTRY.counter(
    "server_request_in_total", "Total requests accepted by the HTTP frontend",
    labelnames=("kind",))
TTFT_MS = REGISTRY.histogram(
    "time_to_first_token_latency_milliseconds", "TTFT per request (ms)",
    labelnames=("instance", "policy"))
ITL_MS = REGISTRY.histogram(
    "inter_token_latency_milliseconds", "Inter-token latency (ms)",
    labelnames=("instance", "policy"))

# Per-instance live-load gauges (service-side view of the fleet; phase is
# prefill|decode) + engine-reported queue depth from heartbeats.
INSTANCE_INFLIGHT_REQUESTS = REGISTRY.gauge(
    "instance_inflight_requests",
    "In-flight requests the scheduler has accounted to an instance",
    labelnames=("instance", "phase"))
INSTANCE_QUEUE_DEPTH = REGISTRY.gauge(
    "instance_queue_depth",
    "Engine-reported waiting queue depth (from heartbeats)",
    labelnames=("instance",))

# Failure-handling observability (beyond the reference, which exposes no
# failure-path instruments at all): transparent-failover outcomes, channel
# retry pressure, and fleet eviction churn.
FAILOVER_ATTEMPTS_TOTAL = REGISTRY.counter(
    "failover_attempts_total",
    "Re-dispatch attempts for requests on failed instances "
    "(instance = the failed one)",
    labelnames=("instance",))
FAILOVER_SUCCESS_TOTAL = REGISTRY.counter(
    "failover_success_total",
    "Requests successfully re-dispatched after an instance failure "
    "(instance = the surviving target)",
    labelnames=("instance",))
RPC_RETRIES_TOTAL = REGISTRY.counter(
    "rpc_retries_total", "Engine-channel RPC attempts beyond the first",
    labelnames=("instance",))
INSTANCE_EVICTIONS_TOTAL = REGISTRY.counter(
    "instance_evictions_total", "Instances removed from the fleet",
    labelnames=("instance",))
# Successor of requests_cancelled_on_failure_total (which only counted
# the failover-surfaced subset): every service-side cancellation, by
# cause. Bounded label set (the four causes below) — no eviction needed,
# unlike the per-instance series above.
REQUESTS_CANCELLED_TOTAL = REGISTRY.counter(
    "requests_cancelled_total",
    "Requests cancelled by the service, by cause "
    "(deadline = per-request deadline / GC timeout expiry, disconnect = "
    "client went away, shed = admission control refused it, failover = "
    "instance failure with no replay path or budget exhausted)",
    labelnames=("reason",))

# Fleet observability plane (docs/observability.md): locally-exported
# control-plane freshness gauges (previously visible only as
# /admin/hotpath JSON), the SLO burn-rate surface (common/slo.py), and
# the anomaly flight recorder's capture counter. The freshness gauges
# are refreshed at scrape time by the /metrics handler — no background
# thread.
ROUTING_SNAPSHOT_AGE_SECONDS = REGISTRY.gauge(
    "routing_snapshot_age_seconds",
    "Age of the published RCU routing snapshot (how stale this "
    "frontend's lock-free fleet view is)")
LOADINFO_MAX_AGE_SECONDS = REGISTRY.gauge(
    "loadinfo_max_age_seconds",
    "Age of the stalest per-instance load-info entry (-1 = never "
    "updated)")
LOADINFO_STALE_INSTANCES = REGISTRY.gauge(
    "loadinfo_stale_instances",
    "Instances whose load telemetry is older than loadinfo_stale_after_s "
    "(relative staleness: 0 when all entries are equally stale)")
KVCACHE_FRAME_LOG_SEQ = REGISTRY.gauge(
    "kvcache_frame_log_seq",
    "Next coordination KV-index frame-log sequence number (replicas "
    "lagging this have not applied the newest frames)")
PLANNER_SCALE_HINT = REGISTRY.gauge(
    "planner_scale_hint",
    "Latest planner scale decision (positive = add instances, negative "
    "= remove; hint for an external autoscaler)")
# Closed-loop autoscaler (autoscaler/, docs/autoscaling.md): enacted
# action counts by kind, the controller's live fleet view by role, and
# the age of the newest decision (a stuck control loop shows up here
# before it shows up as an unserved burst). fleet_size and the decision
# age are refreshed at tick time and at scrape time.
HOTPATH_CPU_SECONDS = REGISTRY.counter(
    "hotpath_cpu_seconds_total",
    "Master hot-loop CPU seconds by coarse loop (ingest = heartbeat/"
    "telemetry-frame ingest, route = schedule, stream = generation-delta "
    "ingest) — the per-master scaling-evidence series; frame-level "
    "breakdown lives at /admin/profile",
    labelnames=("loop",))
NATIVE_PATH_ACTIVE = REGISTRY.gauge(
    "native_path_active",
    "1 when the libhotcore.so native fast path serves this component "
    "(wire = LOADFRAME/telemetry msgpack, sse = delta-frame assembly, "
    "rendezvous = ownership hashing, tokenizer = byte-id encode); 0 = "
    "pure-Python fallback — a degraded process in a fleet scrape",
    labelnames=("component",))
AUTOSCALER_ACTIONS_TOTAL = REGISTRY.counter(
    "autoscaler_actions_total",
    "Actions enacted by the autoscaler controller, by kind "
    "(scale_out|scale_in|drain|flip|hold)",
    labelnames=("action",))
FLEET_SIZE = REGISTRY.gauge(
    "fleet_size",
    "Schedulable instances per role as seen by this frontend's routing "
    "snapshot (draining/suspect excluded; role=draining counts retiring "
    "instances)",
    labelnames=("role",))
AUTOSCALER_LAST_DECISION_AGE_SECONDS = REGISTRY.gauge(
    "autoscaler_last_decision_age_seconds",
    "Seconds since the autoscaler controller last completed a decision "
    "tick (-1 = never ticked / disabled)")
# Overload-hardening plane (overload/, docs/robustness.md): admission
# gate depth, brownout state, retry-budget level (scrape-time refreshed
# by the /metrics handler) and per-instance breaker state (written on
# reconcile transitions; series evicted with the instance).
ADMISSION_PENDING_REQUESTS = REGISTRY.gauge(
    "admission_pending_requests",
    "In-flight requests admitted through the overload-admission gate")
BROWNOUT_ACTIVE = REGISTRY.gauge(
    "brownout_active",
    "1 while the frontend is in brownout (SLO burn breaching on both "
    "windows: batch max_tokens clamped, optional work shed)")
RETRY_BUDGET_TOKENS = REGISTRY.gauge(
    "retry_budget_tokens",
    "Remaining global retry-budget tokens (failover + relay recovery "
    "spend from this bucket; empty = retries fail fast)")
CIRCUIT_BREAKER_OPEN = REGISTRY.gauge(
    "circuit_breaker_open",
    "1 while an instance's engine channel is OPEN/HALF_OPEN (excluded "
    "from routing like SUSPECT until a half-open probe closes it)",
    labelnames=("instance",))
SLO_BURN_RATE = REGISTRY.gauge(
    "slo_burn_rate",
    "Error-budget burn rate per objective and rolling window "
    "(1.0 = budget-neutral pace; see /admin/slo)",
    labelnames=("objective", "window"))
FLIGHT_RECORDS_TOTAL = REGISTRY.counter(
    "flight_records_total",
    "Anomaly bundles captured by the flight recorder",
    labelnames=("kind",))

# Engine-agent-side labeled series (the agent's /metrics appends the
# registry render to its hand-rolled engine_* text). Both are evicted
# when their label subject goes away — ENGINE_PEER_LINKED on PD unlink,
# ENGINE_HEARTBEATS_TOTAL when the master changes — mirroring the
# master's evicted-instance series eviction (instance_mgr), so a
# long-lived engine doesn't grow /metrics without bound.
ENGINE_PEER_LINKED = REGISTRY.gauge(
    "engine_peer_linked",
    "PD peers currently linked to this engine agent (1 per live link)",
    labelnames=("peer",))
ENGINE_HEARTBEATS_TOTAL = REGISTRY.counter(
    "engine_heartbeats_total",
    "Heartbeats this agent pushed, by destination master",
    labelnames=("master",))

# Multi-master service plane (multimaster/): ownership handoffs between
# active frontends and owner-death recoveries. `owner` is the TARGET
# master of the forward (small cardinality: one series per replica).
HANDOFF_FORWARDED_TOTAL = REGISTRY.counter(
    "handoff_forwarded_total",
    "Requests relayed to their owning master by an accepting frontend",
    labelnames=("owner",))
HANDOFF_SERVED_TOTAL = REGISTRY.counter(
    "handoff_served_total",
    "Foreign-accepted requests served by this master as owner")
HANDOFF_RECOVERIES_TOTAL = REGISTRY.counter(
    "handoff_recoveries_total",
    "Mid-flight re-ownerships after an owning master died "
    "(owner = the rendezvous successor)",
    labelnames=("owner",))
HANDOFF_JOURNAL_REPLAYS_TOTAL = REGISTRY.counter(
    "handoff_journal_replays_total",
    "Relayed-stream reconnects served from the owner's seq-numbered "
    "delta journal (exact replay — no pipeline re-run, no splice risk)")

# Sharded telemetry-ingest plane: heartbeat ingest by shard
# verdict, coalesced load-frame publication, and the master->master
# generation-delta relay behind the multiplexed engine session.
HEARTBEATS_INGESTED_TOTAL = REGISTRY.counter(
    "heartbeats_ingested_total",
    "Heartbeats ingested by this frontend, by telemetry-shard verdict "
    "(owned = this master owns the instance's ingest, foreign = "
    "membership race / legacy engine still funneling to the elected "
    "master)",
    labelnames=("shard",))
LOADFRAMES_PUBLISHED_TOTAL = REGISTRY.counter(
    "loadframes_published_total",
    "Coalesced load/lease frames this master published for its "
    "telemetry shard")
LOADFRAMES_APPLIED_TOTAL = REGISTRY.counter(
    "loadframes_applied_total",
    "Peer owners' load/lease frames mirrored into this frontend's "
    "lock-free load-info view")
TELEMETRY_GENS_RELAYED_TOTAL = REGISTRY.counter(
    "telemetry_gens_relayed_total",
    "Generation-delta batches relayed master->master for engines whose "
    "multiplexed telemetry session lands here but whose request owner "
    "is another frontend",
    labelnames=("dest",))
LOADINFO_AGE_SECONDS = REGISTRY.gauge(
    "loadinfo_age_seconds",
    "Per-instance load-info snapshot age (scrape-time refreshed; -1 = "
    "never updated) — the staleness signal SLO/CAR scoring discounts by, "
    "now observable instead of inferred",
    labelnames=("instance",))

# Coordination-plane static stability: degraded-mode serving
# when the coordination plane is unreachable — plane health, outage
# accounting, reconnect churn, and the held-actions backlog.
COORDINATION_CONNECTED = REGISTRY.gauge(
    "coordination_connected",
    "1 while the coordination plane answers liveness probes, 0 while "
    "the health monitor classifies it DEGRADED/RECOVERING")
COORDINATION_DEGRADED_SECONDS_TOTAL = REGISTRY.counter(
    "coordination_degraded_seconds_total",
    "Cumulative seconds this frontend spent serving in degraded mode "
    "(coordination plane unreachable; census frozen, mastership sticky)")
COORDINATION_RECONNECTS_TOTAL = REGISTRY.counter(
    "coordination_reconnects_total",
    "Successful coordination-client reconnects (each one re-auths, "
    "re-subscribes watches, and re-establishes leased keys)")
COORDINATION_HELD_ACTIONS = REGISTRY.gauge(
    "coordination_held_actions",
    "Depth of the held-actions log: ownership-changing actions "
    "(evictions, drains, flips, frame publishes, autoscaler enactment) "
    "suspended while the coordination plane is degraded")
COORDINATION_FROZEN_EVENTS_TOTAL = REGISTRY.counter(
    "coordination_frozen_events_total",
    "Census events ignored under the degraded-mode freeze (lease-lapse "
    "verdicts and missed-lease sweeps suppressed while the plane is "
    "down)",
    labelnames=("kind",))
