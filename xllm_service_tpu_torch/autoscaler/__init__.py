"""Closed-loop fleet autoscaler (port of ``xllm_service_tpu/autoscaler``;
docs/autoscaling.md).

The control plane that finally CONSUMES the telemetry the earlier rounds
built: the SLO burn-rate monitor (common/slo.py), the planner's fleet
pressure (scheduler/planner.py) and the load-info freshness surface feed
a master-gated decision loop (:class:`AutoscalerController`) that emits
typed, rate-limited actions — SCALE_OUT, SCALE_IN (graceful DRAIN),
FLIP — through a pluggable :class:`FleetActuator`:

- :class:`HintActuator` preserves the publish-a-coordination-key
  contract for external infrastructure (slice reservation managers,
  k8s operators) — the reference's "instance lifecycle belongs to an
  external autoscaler" stance, now with typed action records.
- :class:`LocalProcessActuator` actually launches/stops engine agent
  processes on this box, so chaos drills and the closed-loop bench
  (benchmarks/autoscale_bench.py) exercise the full loop.

The decision kernel itself (:func:`decide`) is a pure function over
immutable inputs — hysteresis, per-action cooldowns, min/max fleet
bounds and the stale-telemetry hold guard are all unit-testable without
a fleet.
"""

from .controller import (
    Action,
    AutoscalerConfig,
    AutoscalerController,
    KernelInputs,
    KernelState,
    decide,
)
from .actuator import (
    FleetActuator,
    HintActuator,
    LocalProcessActuator,
    create_actuator,
)

__all__ = [
    "Action",
    "AutoscalerConfig",
    "AutoscalerController",
    "KernelInputs",
    "KernelState",
    "decide",
    "FleetActuator",
    "HintActuator",
    "LocalProcessActuator",
    "create_actuator",
]
