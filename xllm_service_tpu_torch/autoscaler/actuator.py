"""Fleet actuators: how autoscaler decisions touch the world (port of
``xllm_service_tpu/autoscaler/actuator.py``; locks are plain
``threading.Lock``s and the default launcher runs the port's fake engine).

The controller decides; an actuator enacts. Two shipped backends:

- :class:`HintActuator` — publishes typed action records to
  coordination keys. This preserves the pre-autoscaler contract
  ("instance lifecycle belongs to an external autoscaler", which
  watched ``XLLM:PLANNER:decision``): external infrastructure — a TPU
  slice-reservation manager, a k8s operator — watches
  ``XLLM:AUTOSCALER:*`` and performs the lifecycle itself.
- :class:`LocalProcessActuator` — launches/stops engine agent
  processes on THIS box (default: the port's fake engine,
  ``python -m xllm_service_tpu_torch.testing.fake_engine``; any agent
  command via
  ``autoscaler_spawn_cmd``). Chaos drills and the closed-loop bench
  run the full loop against real OS processes through it.

Failure contract: ``scale_out`` returns the number actually launched;
anything less than requested makes the controller back off and retry on
a later tick — a broken launcher never wedges the decision loop. A
spawned process that dies (or never registers) is detected as missing
capacity by the next ticks and replaced through the same path.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Optional

from ..common.config import ServiceOptions
from ..common.types import now_ms
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from ..utils import get_logger, pick_free_port

logger = get_logger(__name__)

#: Coordination keys the hint actuator publishes (external-infra API).
AUTOSCALER_DECISION_KEY = "XLLM:AUTOSCALER:decision"
AUTOSCALER_ACTION_KEY_PREFIX = "XLLM:AUTOSCALER:action:"

#: The default launcher's engine: the port's fake engine (the
#: reference's ``examples/run_fake_engine.py`` imports the JAX package).
FAKE_ENGINE_MODULE = "xllm_service_tpu_torch.testing.fake_engine"
_REPO_ROOT = str(Path(__file__).resolve().parent.parent.parent)


class FleetActuator:
    """Interface. All methods must be cheap and non-raising — they run
    on the scheduler's sync thread."""

    name = "none"

    def scale_out(self, count: int, reason: str,
                  slice_id: str = "") -> int:
        """Launch `count` instances; returns how many were actually
        started (less than `count` = failure, retried with backoff).
        ``slice_id`` is the target slice for the new capacity ("" = any):
        replacement spawns name the slice that lost instances so
        placement re-converges where the failure happened
        (docs/topology.md)."""
        return 0

    def scale_in(self, instance: str, reason: str) -> bool:
        """A drain of `instance` was initiated (routing already excludes
        it; the engine self-stops once idle). Record/forward the intent;
        final teardown happens in :meth:`reap` once it left the fleet."""
        return True

    def pending(self, live: set) -> int:
        """Launches in flight: instances this actuator started that have
        not yet joined `live` (the registered fleet). The controller
        subtracts these from missing capacity, so a launch that takes a
        few seconds to register is not re-launched every tick. Return 0
        when launches are not observable (hint actuator: external infra
        owns the lifecycle)."""
        return 0

    def reap(self, instance: str) -> None:
        """`instance` finished draining and left the fleet — release
        whatever this actuator holds for it."""

    def stop(self) -> None:
        """Service shutdown: release everything."""


@_ownership.verify_state
class HintActuator(FleetActuator):
    """Publishes action records for external infrastructure. Every
    enacted action lands under a fresh ``XLLM:AUTOSCALER:action:<seq>``
    key (watchable as a stream, TTL-bounded) and the latest fleet target
    is mirrored at ``XLLM:AUTOSCALER:decision`` — the successor of the
    planner's bare ``scale_hint`` integer, with the action, instance and
    reason attached."""

    name = "hint"

    #: Re-publish window: an unsatisfied replacement hint (external
    #: infra hasn't acted yet) is re-announced at most this often.
    REPUBLISH_S = 10.0
    #: Action-record TTL: the stream is a notification channel, not a
    #: log — consumed records expire on their own.
    ACTION_TTL_S = 300.0

    def __init__(self, coord):
        self._coord = coord
        self._lock = make_lock("autoscaler.hint_actuator", order=18)  # lock-order: 18
        self._seq = 0
        self._last_publish: dict[str, tuple[float, int]] = {}

    def _publish(self, record: dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            seq = self._seq
        record["seq"] = seq
        record["ts_ms"] = now_ms()
        body = json.dumps(record)
        self._coord.set(AUTOSCALER_ACTION_KEY_PREFIX + str(seq), body,
                        ttl_s=self.ACTION_TTL_S)
        self._coord.set(AUTOSCALER_DECISION_KEY, body)

    def scale_out(self, count: int, reason: str,
                  slice_id: str = "") -> int:
        now = time.monotonic()
        key = f"scale_out:{slice_id}"
        with self._lock:
            last = self._last_publish.get(key)
            if last is not None and last[1] == count \
                    and now - last[0] < self.REPUBLISH_S:
                return count   # identical unsatisfied hint: don't spam
            self._last_publish[key] = (now, count)
        self._publish({"action": "scale_out", "count": count,
                       "reason": reason, "slice_id": slice_id})
        return count

    def scale_in(self, instance: str, reason: str) -> bool:
        self._publish({"action": "scale_in", "instance": instance,
                       "reason": reason, "phase": "draining"})
        return True

    def reap(self, instance: str) -> None:
        self._publish({"action": "scale_in", "instance": instance,
                       "phase": "drained"})


@_ownership.verify_state
class LocalProcessActuator(FleetActuator):
    """Launches engine agent processes on this box. The spawn command is
    a shell-split template with ``{port}`` / ``{coordination_addr}``
    placeholders; default is the fake-engine launcher, which makes the
    closed loop drillable with zero hardware. The instance NAME of a
    spawned engine is ``host:port`` (both launchers bind the advertised
    port we pass), so drain completion maps back to the process."""

    name = "local"

    #: Runaway guard: never track more live child processes than this
    #: (controller bugs or a never-registering child must not fork-bomb
    #: the box). Scale-outs beyond it report failure -> backoff.
    def __init__(self, options: ServiceOptions, host: str = "127.0.0.1",
                 spawn_cmd: str = "", log_dir: Optional[str] = None):
        self._opts = options
        self._host = host
        self._spawn_cmd = spawn_cmd or options.autoscaler_spawn_cmd
        self._log_dir = Path(log_dir or os.environ.get(
            "XLLM_AUTOSCALER_LOGDIR", tempfile.gettempdir()))
        self._max_procs = max(2, options.autoscaler_max_instances * 2)
        self._lock = make_lock("autoscaler.local_actuator", order=18)  # lock-order: 18
        self._procs: dict[str, subprocess.Popen] = {}
        self._spawned_at: dict[str, float] = {}
        self.launched_total = 0
        self.spawn_failures_total = 0

    #: A launched child that has not registered within this window no
    #: longer counts as pending — the replacement path retries (and the
    #: runaway cap bounds the damage if it keeps happening).
    SPAWN_PENDING_TIMEOUT_S = 20.0

    def _command(self, port: int, slice_id: str = "") -> list[str]:
        if self._spawn_cmd:
            tmpl = shlex.split(self._spawn_cmd)
            return [part.format(port=port,
                                coordination_addr=self._opts.coordination_addr,
                                slice_id=slice_id)
                    for part in tmpl]
        cmd = [sys.executable, "-m", FAKE_ENGINE_MODULE,
               "--coordination-addr", self._opts.coordination_addr,
               "--host", self._host, "--port", str(port)]
        if slice_id:
            cmd += ["--slice-id", slice_id]
        return cmd

    def _env(self) -> Optional[dict[str, str]]:
        """The default launcher's environment: the package's root on
        ``PYTHONPATH``, so ``-m`` finds it from any working directory.
        A spawn command runs in this process's environment."""
        if self._spawn_cmd:
            return None
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO_ROOT, env.get("PYTHONPATH", "")) if p)
        return env

    def _reap_dead_locked(self) -> None:
        for name, p in list(self._procs.items()):
            if p.poll() is not None:
                logger.warning("autoscaler child %s exited rc=%s", name,
                               p.returncode)
                self._procs.pop(name, None)
                self._spawned_at.pop(name, None)

    def pending(self, live: set) -> int:
        now = time.monotonic()
        with self._lock:
            self._reap_dead_locked()
            return sum(
                1 for name in self._procs
                if name not in live
                and now - self._spawned_at.get(name, now)
                < self.SPAWN_PENDING_TIMEOUT_S)

    def scale_out(self, count: int, reason: str,
                  slice_id: str = "") -> int:
        launched = 0
        for _ in range(max(0, count)):
            with self._lock:
                self._reap_dead_locked()
                if len(self._procs) >= self._max_procs:
                    logger.warning(
                        "autoscaler: %d tracked children >= cap %d; "
                        "refusing further launches", len(self._procs),
                        self._max_procs)
                    break
            port = pick_free_port(self._host)
            name = f"{self._host}:{port}"
            cmd = self._command(port, slice_id)
            try:
                with open(self._log_dir / f"autoscaled_{port}.log",
                          "w") as log:
                    p = subprocess.Popen(cmd, stdout=log,
                                         stderr=subprocess.STDOUT,
                                         env=self._env())
            except OSError as e:
                with self._lock:
                    self.spawn_failures_total += 1
                logger.warning("autoscaler spawn failed (%s): %s",
                               cmd[0], e)
                continue
            # Immediate-death check (bad flags, missing interpreter):
            # catches the cheap failures now; slower ones (engine never
            # registers) surface as missing capacity on later ticks.
            time.sleep(0.05)
            if p.poll() is not None:
                with self._lock:
                    self.spawn_failures_total += 1
                logger.warning("autoscaler child %s died at launch rc=%s",
                               name, p.returncode)
                continue
            with self._lock:
                self._procs[name] = p
                self._spawned_at[name] = time.monotonic()
                self.launched_total += 1
            launched += 1
            logger.info("autoscaler launched %s (%s)", name, reason)
        return launched

    def scale_in(self, instance: str, reason: str) -> bool:
        # The drain is already in motion (routing excludes the instance;
        # the engine self-stops once idle). Nothing to do until it
        # leaves the fleet — reap() finishes the job. Instances this
        # actuator did not launch (operator-started) drain the same way;
        # there is just no process to reap.
        return True

    def reap(self, instance: str) -> None:
        with self._lock:
            p = self._procs.pop(instance, None)
            self._spawned_at.pop(instance, None)
        if p is None:
            return
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        logger.info("autoscaler reaped %s (rc=%s)", instance, p.returncode)

    def live_children(self) -> list[str]:
        with self._lock:
            self._reap_dead_locked()
            return sorted(self._procs)

    def stop(self) -> None:
        with self._lock:
            procs = dict(self._procs)
            self._procs.clear()
        for name, p in procs.items():
            if p.poll() is None:
                p.terminate()
        for name, p in procs.items():
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()


def create_actuator(options: ServiceOptions, coord) -> FleetActuator:
    """Actuator factory (``autoscaler_actuator`` knob): "hint" (default,
    the external-infra contract) or "local" (process lifecycle on this
    box)."""
    kind = (options.autoscaler_actuator or "hint").lower()
    if kind == "hint":
        return HintActuator(coord)
    if kind == "local":
        if not options.coordination_addr and not options.autoscaler_spawn_cmd:
            logger.warning(
                "local actuator with the in-process coordination backend: "
                "spawned engines cannot join this fleet unless "
                "autoscaler_spawn_cmd points them at a reachable "
                "coordination server")
        return LocalProcessActuator(options)
    raise ValueError(f"unknown autoscaler actuator: {kind!r}")
