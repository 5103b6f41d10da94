"""Service configuration.

Parity: the reference's three-tier config (SURVEY.md §5.6): gflags
(`common/global_gflags.cpp:20-149`) copied into a fluent `Options` object
(`common/options.h:25-92`) plus env vars. Here: one dataclass with every
reference knob (same defaults), constructible from argparse CLI flags and
env vars; live-reloadable SLO targets (the reference exposes target_ttft /
target_tpot via brpc flag reload, `global_gflags.cpp:122-132` — we expose
them via the admin HTTP endpoint).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field


@dataclass
class ServiceOptions:
    """All orchestration-plane knobs (reference defaults preserved)."""

    # --- serving endpoints (reference `global_gflags.cpp:25,38`) ---
    host: str = "0.0.0.0"
    http_port: int = 8888
    rpc_port: int = 8889
    num_http_threads: int = 32
    num_rpc_threads: int = 32
    max_concurrency: int = 0          # 0 = unlimited
    # --- model / tokenization ---
    tokenizer_path: str = ""
    model_id: str = ""
    # --- coordination (reference `etcd_addr/namespace`) ---
    coordination_addr: str = ""       # "" => in-process memory backend
    coordination_namespace: str = ""
    coordination_username: str = field(
        default_factory=lambda: os.environ.get("ETCD_USERNAME", ""))
    coordination_password: str = field(
        default_factory=lambda: os.environ.get("ETCD_PASSWORD", ""))
    # --- scheduling ---
    # CAR is the default: its schedule path is as cheap as RR's, and it
    # is no worse than RR on zero-overlap traffic and far better on
    # cache-hot mixes.
    load_balance_policy: str = "CAR"  # RR | CAR | SLO_AWARE
    block_size: int = 128             # prefix-hash block (`global_gflags.cpp:114-116`)
    max_waiting_requests: int = 1024  # CAR normalization denominator
    # CAR tier weights: what one matched block is worth per residence tier
    # (HBM hits reuse directly; DRAM/SSD hits pay an onload first). Fed to
    # GlobalKVCacheMgr, which bakes them into the per-block score tuples.
    tier_weight_hbm: float = 1.0
    tier_weight_dram: float = 0.6
    tier_weight_ssd: float = 0.3
    # Master→coordination KV-index sync: delta frames per full-state
    # compaction (scheduler/global_kvcache_mgr.py). Lower = replicas
    # bootstrap faster; higher = less periodic full-upload work.
    kvcache_frame_compact_every: int = 64
    # SLO targets, live-reloadable (`global_gflags.cpp:122-132`).
    target_ttft_ms: float = 1000.0
    target_tpot_ms: float = 50.0
    # --- ICI-topology-aware placement (common/topology.py, docs/topology.md) ---
    # How much load-skew advantage (in CAR score units / normalized link
    # penalty) a cross-slice DCN partner must show before it beats a
    # same-slice ICI partner. 0 disables the plane entirely (flat
    # placement); the plane is also dormant whenever the fleet's
    # effective coordinates collapse into a single slice, so flat fleets
    # see zero routing change at any knob value.
    topology_tradeoff: float = 0.25
    # Scheduler-side modeled link budgets (bytes/s) for transfer_cost —
    # mirror the engine BandwidthAccountant budgets so the master's
    # predicted handoff time matches what the engines actually pace.
    # 0 = use the class-default bandwidths (account-only fleets).
    topology_ici_bytes_per_s: float = 0.0
    topology_dcn_bytes_per_s: float = 0.0
    # Modeled KV bytes per prompt token for instances that don't
    # advertise a KV layout (fake engines); real engines' advertised
    # num_layers/num_kv_heads/head_dim/kv_dtype win when present.
    topology_kv_bytes_per_token: int = 0
    # --- engine RPC channel (reference fixes 3 retries with no backoff,
    #     `instance_mgr.cpp:480-498`; here both are knobs and retries back
    #     off exponentially with jitter) ---
    rpc_timeout_s: float = 5.0
    rpc_retries: int = 3
    rpc_backoff_base_s: float = 0.05
    rpc_backoff_max_s: float = 1.0
    # --- transparent failover (beyond the reference's cancel-and-surface:
    #     in-flight requests on a dead instance are re-dispatched, decode
    #     resumed by prompt extension; 0 disables = reference behavior) ---
    failover_max_retries: int = 3
    failover_backoff_base_s: float = 0.05
    failover_backoff_max_s: float = 2.0
    # --- failure detection (`global_gflags.cpp:95-113`) ---
    heartbeat_interval_s: float = 3.0
    lease_ttl_s: float = 3.0
    health_probe_attempts: int = 2
    health_probe_timeout_s: float = 1.0
    heartbeat_silence_to_suspect_s: float = 3.0
    detect_disconnected_instance_interval_s: float = 15.0
    reconcile_interval_s: float = 1.0
    sync_interval_s: float = 3.0      # master upload loop cadence
    readiness_check_interval_s: float = 3.0
    # --- output parsing preferences (`global_gflags.cpp:134-142`) ---
    tool_call_parser: str = "auto"
    reasoning_parser: str = "auto"
    # --- tracing / debug ---
    enable_request_trace: bool = False
    trace_dir: str = "trace"
    # Hop-propagated span tracing (common/tracing.py): in-memory ring of
    # spans behind /admin/trace. Off = every span call is a no-op attribute
    # check (<2%, benchmarks/bench_tracing_overhead.py). Spans are also
    # mirrored to the RequestTracer JSONL when enable_request_trace is on.
    enable_tracing: bool = True
    trace_span_capacity: int = 2048
    # Head sampling with tail-based keep (common/tracing.py): the fraction
    # of traces recorded into the queryable ring. Sampled-out traces park
    # in a bounded pending buffer and are PROMOTED whenever the request
    # ends anomalously (failover, error, SLO breach) — so always-on
    # tracing stays viable at high QPS without losing the traces worth
    # debugging. 1.0 = record everything (default).
    trace_sample_rate: float = 1.0
    # --- fleet observability plane (docs/observability.md) ---
    # Per-peer deadline for /admin/trace?scope=fleet and /metrics/fleet
    # fan-out: a dead agent degrades the view (partial-result marker),
    # never the endpoint.
    fleet_peer_timeout_s: float = 2.0
    # Bounded fan-out concurrency for fleet scrapes/queries.
    fleet_scrape_concurrency: int = 8
    # /metrics/fleet TTL cache: scrape storms against the fleet endpoint
    # hit the cache, not every engine.
    metrics_fleet_cache_ttl_s: float = 2.0
    # SLO objectives for the burn-rate monitor (common/slo.py): a TTFT/
    # TPOT observation over its target — or a failed request — burns
    # error budget; budget is the allowed bad fraction. Burn rates are
    # tracked over a fast and a slow rolling window (Google-SRE
    # multi-window multi-burn-rate) and served at /admin/slo + /metrics.
    slo_ttft_ms: float = 1000.0
    slo_tpot_ms: float = 50.0
    slo_error_budget: float = 0.01
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    # Burn-rate alert threshold: an objective is "breaching" when BOTH
    # windows burn at or above this multiple of budget-neutral pace.
    slo_burn_alert: float = 14.4
    # Anomaly flight recorder (common/flightrecorder.py): bounded ring of
    # post-mortem bundles (trace tree + hotpath stages + load snapshot)
    # captured on SLO breach / failover / error / KV-stream fallback.
    flightrecorder_capacity: int = 64
    # Continuous-profiling plane (profiling/sampler.py): always-on
    # wall-clock sampling at profile_hz (0 disables; ~19 Hz default — a
    # non-round rate so the sampler never phase-locks with periodic
    # loops; overhead gate <=1% via benchmarks/bench_profile_overhead).
    # Folded stacks rotate on profile_window_s; per-role distinct-stack
    # tables and stack depth are bounded (overflow is charged to a
    # visible "(overflow)" bucket, never unbounded memory).
    profile_hz: float = 19.0
    profile_window_s: float = 30.0
    profile_max_stacks: int = 256
    profile_max_depth: int = 24
    # --- closed-loop fleet autoscaler (autoscaler/, docs/autoscaling.md) ---
    # Master-gated control loop turning SLO burn rates + planner pressure
    # into SCALE_OUT / SCALE_IN(drain) / FLIP actions through a pluggable
    # actuator. Default OFF for one release: with the controller off the
    # planner keeps today's hint-only behavior (scale_hint published to
    # XLLM:PLANNER:decision, flips enacted directly by the planner/SLO
    # policy) — turning it on funnels every actuation through the
    # controller, the single actuation path.
    autoscaler_enabled: bool = False
    # Actuator backend: "hint" publishes typed action records to a
    # coordination key (today's external-autoscaler contract); "local"
    # launches/stops engine agent processes on this box (drills, benches,
    # single-host deployments).
    autoscaler_actuator: str = "hint"
    # Fleet bounds the controller never crosses (draining instances count
    # toward the max until they deregister).
    autoscaler_min_instances: int = 1
    autoscaler_max_instances: int = 8
    # Hysteresis: consecutive breaching ticks before a SCALE_OUT /
    # consecutive idle ticks before a SCALE_IN (one tick per sync pass).
    autoscaler_breach_ticks: int = 2
    autoscaler_idle_ticks: int = 5
    # Growth step per SCALE_OUT as a fraction of the desired fleet
    # (always at least one instance, clamped to the max).
    autoscaler_scale_out_step: float = 0.5
    # Per-action cooldowns: after an action of a kind, no further action
    # of that kind until the cooldown elapses. Replacement of lost
    # capacity (live < desired) bypasses the scale-out cooldown but rides
    # the spawn-retry backoff below.
    autoscaler_scale_out_cooldown_s: float = 20.0
    autoscaler_scale_in_cooldown_s: float = 45.0
    autoscaler_flip_cooldown_s: float = 10.0
    # Hold-state guard: when the stalest load-info entry is older than
    # this (or an instance never reported), the controller HOLDs — a
    # control loop acting on dead telemetry amplifies outages.
    autoscaler_stale_hold_s: float = 15.0
    # Graceful drain: a DRAINING instance whose in-flight work is done
    # deregisters after this grace; one that can't drain by the deadline
    # is deregistered anyway (its stragglers ride the normal failover
    # path).
    autoscaler_drain_grace_s: float = 1.0
    autoscaler_drain_deadline_s: float = 120.0
    # Actuator spawn-failure retry (exponential backoff with jitter): a
    # failed launch never wedges the loop — the controller re-tries the
    # replacement on a later tick.
    autoscaler_spawn_retry_base_s: float = 1.0
    autoscaler_spawn_retry_max_s: float = 30.0
    # Bounded decision log behind /admin/autoscaler.
    autoscaler_decision_log_capacity: int = 256
    # Local actuator launch command template (shell-split; {port} and
    # {coordination_addr} placeholders). "" = the built-in fake-engine
    # launcher (examples/run_fake_engine.py) — drills and benches
    # exercise the full loop against real OS processes.
    autoscaler_spawn_cmd: str = ""
    # JSONL dump directory ("" = in-memory ring only).
    flightrecorder_dir: str = ""
    # --- overload-hardening plane (overload/, docs/robustness.md) ---
    # Default per-request deadline budget in ms (0 = none). A request's
    # own `timeout` body field (seconds) or `x-request-deadline-ms`
    # header wins; the absolute deadline propagates through the enriched
    # payload and the handoff wire and is enforced at every hop —
    # admission, scheduler GC, mid-stream ingest, and the engines. The
    # blunt `request_timeout_s` GC remains the backstop bound.
    default_request_deadline_ms: float = 0.0
    # Admission gate: max in-flight admitted requests per live instance
    # (limit = this x live fleet size off the RCU routing snapshot;
    # 0 = admission control disabled). Requests over the watermark get a
    # fast 429 + Retry-After instead of queueing.
    admission_max_inflight_per_instance: int = 0
    # Batch-priority (x-request-priority: batch) watermark as a fraction
    # of the admission limit; batch is shed entirely while the SLO burn
    # is hot (brownout state).
    admission_batch_watermark: float = 0.5
    admission_retry_after_s: float = 1.0
    # Brownout: when any SLO objective breaches on BOTH burn windows,
    # degrade before refusing — clamp batch max_tokens and shed optional
    # work (trace head-sampling drops to brownout_trace_sample_rate);
    # lifts after recover_ticks consecutive clean sync passes.
    brownout_enabled: bool = True
    brownout_batch_max_tokens: int = 32
    brownout_recover_ticks: int = 2
    brownout_trace_sample_rate: float = 0.0
    # Per-instance circuit breaker on the engine channel (rpc/breaker.py):
    # a rolling error/timeout window flips the channel OPEN — the routing
    # snapshot excludes the instance like SUSPECT — and a half-open probe
    # (reconcile thread) restores it.
    circuit_breaker_enabled: bool = True
    circuit_breaker_window_s: float = 30.0
    circuit_breaker_min_samples: int = 5
    circuit_breaker_failure_ratio: float = 0.5
    circuit_breaker_open_cooldown_s: float = 5.0
    # Global retry budget across failover + relay recovery (token
    # bucket: each accepted request deposits `ratio` tokens, each retry
    # spends one; cap = burst allowance, 0 disables).
    retry_budget_ratio: float = 0.1
    retry_budget_cap: float = 50.0
    debug_log: bool = field(
        default_factory=lambda: os.environ.get("ENABLE_XLLM_DEBUG_LOG", "") not in ("", "0", "false"))
    # --- multi-master service plane (multimaster/) ---
    # Every replica is an ACTIVE frontend; requests are owned by exactly
    # one master via rendezvous hashing of the request id over the live
    # service records (docs/multi_master.md).
    multimaster_ownership: bool = True
    # Mine generated request ids until the accepting frontend owns them
    # (expected N draws on an N-replica plane) so the common case pays no
    # forward hop. Off = ids are assigned by pure rendezvous (~(N-1)/N of
    # accepts relay through /rpc/handoff — useful to drill the path).
    multimaster_mine_owned_ids: bool = True
    # Owner attempts per relayed request: the first POST plus
    # (attempts-1) deterministic re-ownership recoveries.
    handoff_max_attempts: int = 3
    # Max silence between reads of the owner's response before the relay
    # treats the owner as hung and re-owns (a killed-but-not-closed owner
    # — SIGKILL mid-accept, a stalled event loop — leaves the TCP
    # connection open; without a read deadline the relayed stream would
    # stall forever instead of failing over). Engine token gaps beyond
    # this are pathological.
    handoff_stall_timeout_s: float = 60.0
    # Load-info staleness (multi-master replicas score routing off
    # coordination-mirrored telemetry): entries older than this are
    # discounted by CAR/SLO scoring, up to `stale_load_penalty` score
    # units (CAR) / a proportional predicted-TPOT inflation (SLO).
    loadinfo_stale_after_s: float = 9.0
    stale_load_penalty: float = 0.5
    # Telemetry-ingest plane. "shard": each ACTIVE master
    # ingests heartbeats/load only for the instances it owns under the
    # rendezvous telemetry map, runs failure detection only for them,
    # and publishes a coalesced load/lease frame per sync tick
    # (XLLM:LOADFRAME:<self>) that every other frontend mirrors — the
    # elected master's ingest funnel is spread 1/N. "master": the
    # reference-shaped legacy funnel (elected master ingests everything,
    # publishes per-instance LOADMETRICS keys, replicas mirror) — the
    # bench baseline and the mixed-version escape hatch. A string knob,
    # not a bool: store_true CLI bools can't be turned off.
    telemetry_ingest_mode: str = "shard"
    # --- coordination-plane static stability ---
    # Degraded-mode serving when the coordination plane is unreachable:
    # the health monitor classifies CONNECTED -> DEGRADED -> RECOVERING
    # from client-side evidence; while degraded the fleet census is
    # frozen (lease lapses stop producing SUSPECT/evict — liveness falls
    # back to direct heartbeat silence over the mux sessions), the
    # elected master stays sticky, and ownership-changing actions are
    # held in a bounded log for replay-or-discard at recovery. "on" /
    # "off" — a string knob, not a bool: store_true CLI bools can't be
    # turned off, and the outage bench needs the control leg.
    coordination_degraded_mode: str = "on"
    # Consecutive failed plane probes (one per sync tick) before the
    # monitor declares DEGRADED. 2 ticks x sync_interval_s rides out a
    # single blip without engaging the freeze.
    coordination_degraded_after_ticks: int = 2
    # While degraded: an owned instance whose direct heartbeats (mux
    # session) have been silent this long goes SUSPECT anyway — the
    # silent-AND-lease-lapsed instance still dies; a chatty one never
    # does. Deliberately longer than heartbeat_silence_to_suspect_s:
    # without lease-lapse corroboration, silence alone needs more
    # benefit of the doubt.
    degraded_heartbeat_silence_s: float = 10.0
    # Recovery storm damping: each entity (master, engine agent) delays
    # its post-outage re-assertion by a deterministic per-entity jitter
    # drawn from [0, this window), so re-registrations spread instead of
    # thundering the just-recovered plane. Also caps the coordination
    # client's randomized reconnect backoff.
    coordination_reconnect_jitter_s: float = 5.0
    # Bound on the held-actions log (oldest coalesced entries are
    # dropped-and-counted beyond it).
    coordination_held_log_capacity: int = 256
    # Handoff delta journal (exact replay dedup): how long the owner
    # keeps buffering a relayed stream's deltas after the relay
    # connection breaks, waiting for a reconnect — beyond it the request
    # is cancelled like a plain disconnect. 0 disables the journal.
    handoff_journal_grace_s: float = 10.0
    # --- request registry ---
    num_output_threads: int = 16      # per-request output-ordering lanes
    request_timeout_s: float = 600.0
    # Dedicated bounded pool for Scheduler.schedule (template/tokenize/
    # route/bind): isolates admission from the default executor, where it
    # would queue behind generations ingest and failover backoff sleeps.
    num_schedule_threads: int = 8

    def with_overrides(self, **kw) -> "ServiceOptions":
        return dataclasses.replace(self, **kw)

    @classmethod
    def add_cli_args(cls, p: argparse.ArgumentParser) -> None:
        for f in dataclasses.fields(cls):
            name = "--" + f.name.replace("_", "-")
            if f.type in ("bool", bool):
                p.add_argument(name, action="store_true", default=None)
            else:
                p.add_argument(name, default=None)

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "ServiceOptions":
        opts = cls()
        for f in dataclasses.fields(cls):
            v = getattr(args, f.name, None)
            if v is None:
                continue
            cur = getattr(opts, f.name)
            if isinstance(cur, bool):
                setattr(opts, f.name, bool(v))
            elif isinstance(cur, int):
                setattr(opts, f.name, int(v))
            elif isinstance(cur, float):
                setattr(opts, f.name, float(v))
            else:
                setattr(opts, f.name, v)
        return opts
