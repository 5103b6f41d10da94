"""Lockstep driver of one engine instance over several processes (port of
``xllm_service_tpu/engine/multihost_driver.py``).

Each process runs one ``InferenceEngine`` over a mesh that spans the
processes (``parallel/mesh.py::process_mesh``): every forward is a series
of collectives, so every rank must run the same steps in the same order.
As in the reference, the driver mirrors the request event stream:

- the PRIMARY owns the outward surface (agent registration, the
  Generations stream, HTTP) and queues every engine-visible event
  (submit, cancel, shutdown);
- every ``tick()`` broadcasts the queued events (the control plane,
  ``parallel/multihost.py::broadcast_bytes``, packed with
  ``rpc/msgpack_lite.py``), applies them on every rank in the same order,
  then each rank runs the same ``engine.step()``. Scheduling inside the
  engine is a function of the event order and the step count, never of
  the wall clock, so every rank admits, decodes and preempts alike and the
  collectives line up. Tensors never pass through this path.

Followers drop ``on_output`` deltas (the primary streams them); every
rank reads the same sampled rows, because the logits they are sampled
from are gathered to every rank.

It covers the generate and cancel core (``n`` > 1 fan-out and the
online/offline priorities included). PD handoff (prefill_only,
injected_kv), multimodal embeddings, preemption resumes and embeddings are
refused, by ``submit`` and by the agent's proxy, rather than run on one
rank and deadlock the collectives, as the reference refuses them.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..common.request import RequestOutput, SamplingParams
from ..devtools.locks import make_lock
from ..parallel import multihost
from ..rpc import msgpack_lite
from .engine import EngineRequest, InferenceEngine

logger = logging.getLogger(__name__)


class MultihostEngineDriver:
    """Wraps an engine so that submit and cancel become broadcast events
    and ``tick()`` is the collective step every rank runs in lockstep."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        # submit()/cancel() run on agent threads while tick() drains on
        # the lockstep thread: the pending events and their callbacks
        # share one lock, so an event and its callback are registered
        # together against the drain.
        self._lock = make_lock("multihost_driver.pending", order=52)  # lock-order: 52
        self._pending: list[dict] = []
        self._callbacks: dict[int, object] = {}
        self._cb_seq = 0
        self._shutdown = False
        #: whether the last tick's step did work: the same decision on
        #: every rank, so every rank may nap on it without leaving
        #: lockstep.
        self.last_worked = True
        self._idle_ticks = 0
        # Cuts the primary's idle nap short when an event arrives
        # (followers finish their nap and wait in the broadcast: the
        # collective is the barrier).
        self._wake = threading.Event()

    # ------------------------------------------------------- primary API
    def submit(self, req: EngineRequest) -> None:
        assert multihost.is_primary(), "followers never receive requests"
        if (req.prefill_only or req.injected_kv is not None
                or req.injected_first_token is not None
                or req.mm_embeds is not None
                or req.resume_output_ids):
            raise NotImplementedError(
                "multihost mode mirrors plain generate requests only; "
                "PD handoff / multimodal / preemption-resume submits are "
                "not wired to follower hosts yet")
        with self._lock:
            # Keyed by a driver-local id: service_request_id is not unique
            # (n > 1 submits one request a choice).
            self._cb_seq += 1
            key = self._cb_seq
            self._callbacks[key] = req.on_output
            self._pending.append({
                "op": "submit",
                "cb": key,
                "service_request_id": req.service_request_id,
                "request_id": req.request_id,
                "token_ids": list(req.token_ids),
                "sampling": req.sampling.to_dict(),
                "offline": req.offline,
                "priority": req.priority,
            })
        self._wake.set()

    def cancel(self, service_request_id: str) -> None:
        assert multihost.is_primary()
        with self._lock:
            self._pending.append({"op": "cancel",
                                  "id": service_request_id})
        self._wake.set()

    def shutdown(self) -> None:
        assert multihost.is_primary()
        with self._lock:
            self._pending.append({"op": "shutdown"})
        self._wake.set()

    # ---------------------------------------------------------- lockstep
    def tick(self) -> bool:
        """One collective iteration on every rank. Returns False once a
        shutdown event has been applied (followers leave their loop)."""
        payload: Optional[bytes] = None
        if multihost.is_primary():
            with self._lock:
                drained, self._pending = self._pending, []
            payload = msgpack_lite.packb(drained)
        raw = multihost.broadcast_bytes(payload)
        events = msgpack_lite.unpackb(raw) if raw else []
        for ev in events:
            self._apply(ev)
        if self._shutdown:
            return False
        try:
            self.last_worked = self.engine.step()
        except Exception as e:  # noqa: BLE001 — as the engine's own loop
            # A step failure comes from the same program on the same
            # inputs, so every rank raises here together; each fails its
            # in-flight requests (followers have none to answer) and keeps
            # ticking, so the control plane stays aligned: a dead tick
            # thread would leave the other ranks in broadcast_bytes.
            logger.exception("lockstep engine step failed")
            self.engine._fail_all(str(e))
            self.last_worked = False
        if self.last_worked:
            self._idle_ticks = 0
        else:
            self._idle_ticks += 1
        return True

    def idle_nap(self) -> None:
        """Nap after a tick without work (2 ms doubling to 64 ms), so an
        idle instance stops hammering the control plane. On the primary a
        submit or cancel ends the nap at once; a follower naps in full and
        then the broadcast aligns it with the primary."""
        if self._idle_ticks:
            self._wake.wait(min(0.002 * (1 << min(self._idle_ticks, 5)),
                                0.064))
            self._wake.clear()

    def follower_loop(self) -> None:
        assert not multihost.is_primary()
        logger.info("multihost follower %d/%d entering lockstep loop",
                    multihost.process_index(), multihost.process_count())
        while self.tick():
            self.idle_nap()
        logger.info("multihost follower exiting (shutdown event)")

    # ------------------------------------------------------------ events
    def _apply(self, ev: dict) -> None:
        op = ev.get("op")
        if op == "submit":
            if multihost.is_primary():
                with self._lock:
                    on_output = self._callbacks.pop(ev["cb"], _drop)
            else:
                on_output = _drop
            self.engine.submit(EngineRequest(
                service_request_id=ev["service_request_id"],
                request_id=ev.get("request_id", ""),
                token_ids=list(ev["token_ids"]),
                sampling=SamplingParams.from_dict(ev["sampling"]),
                on_output=on_output,
                offline=bool(ev.get("offline", False)),
                priority=int(ev.get("priority", 0))))
        elif op == "cancel":
            self.engine.cancel(ev["id"])
        elif op == "shutdown":
            self._shutdown = True
        else:
            logger.warning("unknown multihost event %r", op)


def _drop(out: RequestOutput) -> None:
    """A follower's output sink."""


class MultihostEngineProxy:
    """The engine as the agent sees it on the PRIMARY of a mesh over
    processes: submit and cancel become mirrored events, ``start()`` and
    ``stop()`` own the collective tick loop, and everything else (cfg,
    stats, page counts, ...) is the wrapped engine's. Entry points that
    touch the devices and are NOT mirrored to the followers raise instead
    of deadlocking the collectives (they would run on one rank only);
    the driver refuses the unsupported submit fields itself."""

    _UNSAFE = ("extract_kv_pages", "extract_kv_pages_device",
               "inject_kv_pages", "embed", "prefill_only")

    def __init__(self, driver: MultihostEngineDriver):
        self._driver = driver
        self._engine = driver.engine
        self._thread: Optional[threading.Thread] = None

    def submit(self, req: EngineRequest) -> None:
        self._driver.submit(req)

    def cancel(self, service_request_id: str) -> None:
        self._driver.cancel(service_request_id)

    def start(self):
        def loop():
            while self._driver.tick():
                self._driver.idle_nap()   # as follower_loop

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="multihost-tick")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._driver.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._engine.stop()

    def __getattr__(self, name: str):
        if name in MultihostEngineProxy._UNSAFE:
            raise NotImplementedError(
                f"{name} is not mirrored to follower hosts yet "
                "(multihost mode covers the generate/cancel core)")
        return getattr(self._engine, name)
