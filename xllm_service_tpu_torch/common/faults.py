"""Deterministic fault injection (copy of
``xllm_service_tpu/common/faults.py``), with every fault point of the
port's I/O layers:

=====================  ==================================================
point                  where it is checked
=====================  ==================================================
``rpc.post``           ``rpc/channel.py`` before every POST attempt
``rpc.get``            ``rpc/channel.py`` before every GET attempt
``coord.call``         ``coordination/client.py`` before each request
``coord.connect``      ``coordination/client.py`` on every (re)connect
``coord.outage``       ``coordination/memory.py`` plane liveness ping
``kv_transfer.offer``  ``engine/kv_transfer.py``, the prefill-side offer
                       (device and streamed paths)
``kv_transfer.pull``   ``engine/kv_transfer.py``, the decode-side pull
                       (device and streamed paths)
``engine.accept``      ``testing/fake_engine.py`` request admission
``engine.token``       ``testing/fake_engine.py`` before each generated
                       delta
``engine.heartbeat``   ``testing/fake_engine.py`` heartbeat loop
=====================  ==================================================

A :class:`FaultRule` names a point (a glob), an action, and when it fires:
``match`` narrows by the call site's context, ``after`` skips the first N
matching hits, ``max_fires`` bounds the fires, ``probability`` draws from
the plane's one seeded ``random.Random`` (seed ``XLLM_CHAOS_SEED``, default
0), so a fixed seed replays the same fault schedule. :meth:`FaultPlane.
check` sleeps on ``delay`` and raises :class:`FaultInjected` on ``error``
or ``drop``; a fired rule also lands as an event on the calling thread's
active span.
"""

from __future__ import annotations

import fnmatch
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from random import Random
from typing import Any, Iterable, Optional

logger = logging.getLogger(__name__)

#: Actions understood by at least one fault point.
ACTIONS = ("error", "drop", "delay", "disconnect", "crash", "silence")

#: Registry of every fault point compiled into the I/O layers. xlint's
#: fault-point rule enforces the bidirectional contract: every
#: ``FAULTS.check("name")``/``FAULTS.fire("name")`` call site must name a
#: point registered here, and every registered point must have at least
#: one live call site (no dead fault points). Keep the table in the module
#: docstring in sync — it is the human-readable view of this dict.
FAULT_POINTS: dict[str, str] = {
    "rpc.post": "rpc/channel.py before every POST attempt",
    "rpc.get": "rpc/channel.py before every GET attempt",
    "coord.call": "coordination/client.py before each request",
    "coord.connect": "coordination/client.py on every (re)connect",
    "coord.outage": "coordination/memory.py plane liveness ping",
    "kv_transfer.offer": "engine/kv_transfer.py prefill-side offer",
    "kv_transfer.pull": "engine/kv_transfer.py decode-side pull",
    "engine.accept": "testing/fake_engine.py request admission",
    "engine.token": "testing/fake_engine.py before each generated delta",
    "engine.heartbeat": "testing/fake_engine.py heartbeat loop",
}

# Yield-point hook: every fire() marks a modeled blocking-I/O site. The
# instrumented-lock detector (devtools.locks) installs itself here under
# XLLM_LOCK_DEBUG=1 to flag locks held across I/O; None costs one attribute
# read per fault point.
_yield_hook = None


def set_yield_hook(hook) -> None:
    global _yield_hook
    _yield_hook = hook


class FaultInjected(RuntimeError):
    """Raised at a fault point whose matched rule demands a failure."""

    def __init__(self, point: str, rule: "FaultRule"):
        super().__init__(f"fault injected at {point}: {rule.action}")
        self.point = point
        self.rule = rule


@dataclass
class FaultRule:
    """One scripted fault. `point` may be a glob (``kv_transfer.*``);
    `match` narrows by call-site context (e.g. ``{"sid": "req-1"}``);
    `after` skips the first N matching hits; `max_fires` bounds how often
    the rule fires."""

    point: str
    action: str = "error"
    probability: float = 1.0
    delay_s: float = 0.0
    after: int = 0
    max_fires: Optional[int] = None
    match: dict[str, Any] = field(default_factory=dict)
    hits: int = 0
    fires: int = 0

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {ACTIONS})")

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultRule":
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})


class FaultPlane:
    """Thread-safe registry of fault rules with a seeded RNG."""

    def __init__(self, seed: Optional[int] = None):
        if seed is None:
            seed = int(os.environ.get("XLLM_CHAOS_SEED", "0"))
        self.seed = seed
        self._lock = threading.Lock()   # lock-order: 800
        self._rng = Random(seed)
        self._rules: list[FaultRule] = []

    def configure(self, rules: Iterable[Any] = (),
                  seed: Optional[int] = None) -> None:
        """Replace all rules (and reseed). Takes FaultRule instances or
        plain dicts."""
        parsed = [r if isinstance(r, FaultRule) else FaultRule.from_dict(r)
                  for r in rules]
        with self._lock:
            if seed is not None:
                self.seed = seed
            self._rng = Random(self.seed)
            self._rules = parsed

    def add(self, point: str, **kw: Any) -> FaultRule:
        rule = FaultRule(point=point, **kw)
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    def rules(self) -> list[FaultRule]:
        with self._lock:
            return list(self._rules)

    def fire(self, point: str, **ctx: Any) -> Optional[FaultRule]:
        """Return the first rule that triggers at `point` (counters
        advanced), or None. Callers enact the returned rule's action."""
        hook = _yield_hook
        if hook is not None:
            # Lock-debug mode: every fault point is a blocking-I/O marker.
            hook(point)
        if not self._rules:   # fast path: the plane is almost always empty
            return None
        fired: Optional[FaultRule] = None
        with self._lock:
            for rule in self._rules:
                if rule.point != point and \
                        not fnmatch.fnmatchcase(point, rule.point):
                    continue
                if any(str(ctx.get(k)) != str(v)
                       for k, v in rule.match.items()):
                    continue
                rule.hits += 1
                if rule.hits <= rule.after:
                    continue
                if rule.max_fires is not None and \
                        rule.fires >= rule.max_fires:
                    continue
                if rule.probability < 1.0 and \
                        self._rng.random() >= rule.probability:
                    continue
                rule.fires += 1
                fired = rule
                break
        if fired is not None:
            logger.info("fault fired at %s: %s (ctx=%s)",
                        point, fired.action, ctx)
            # Self-explaining chaos drills: the injection lands as an event
            # on whatever span the calling thread is inside. Lazy import:
            # under XLLM_LOCK_DEBUG the lock factory imports this module at
            # its own import time, so a top-level tracing import would cycle
            # (faults -> tracing -> devtools.locks -> faults).
            from . import tracing

            tracing.add_event("fault", point=point, action=fired.action)
        return fired

    def check(self, point: str, **ctx: Any) -> None:
        """For I/O call sites: sleep on `delay`, raise FaultInjected on
        `error`/`drop`, ignore actions the site does not model."""
        rule = self.fire(point, **ctx)
        if rule is None:
            return
        if rule.action == "delay":
            time.sleep(rule.delay_s)
            return
        if rule.action in ("error", "drop"):
            raise FaultInjected(point, rule)


#: The process's plane; empty by default (one attribute read a point).
FAULTS = FaultPlane()
